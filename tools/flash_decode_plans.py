#!/usr/bin/env python3
"""flash_decode's split plans against each other on one card.

    python3 tools/flash_decode_plans.py

At qwen3-0.6b's last serve step (B 8, S 576, L 574, H 16, K 8, hd 128,
bf16) and at a cache past the L2 (S 8192, L 8190), times the kernel's C
launcher at n_split = 8 down to 2 blocks a (batch, KV head) (each with the
smallest split, a multiple of 16, that covers S), and
``scaled_dot_product_attention`` over the filled prefix, by CUDA-graph
replay in turns (5 rounds, each in order and then reversed), beside the
clusters of each plan the card holds at once (``flash_decode.max_clusters``;
B x K are needed), each plan one cluster a (batch, KV head).
``flash_decode.plan``'s choice is marked. Plans of several clusters a pair
(small B·K): ``tools/fd_small_bk_ab.py``. The card's
name and power limit come first; then one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from kernel_host_ab import graph_ms, in_turns  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

B, H, K, hd = 8, 16, 8, 128


def launcher(split, n_split, S):
    fwd = build.load("flash_decode").flash_decode_fwd

    def call(q, k, v, length):
        o = torch.empty_like(q)
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  length.data_ptr(), o.data_ptr(), None, None, B, S, H, K,
                  hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                  k.stride(2), v.stride(0), v.stride(1), v.stride(2), 1,
                  hd ** -0.5, split, n_split, n_split,
                  torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash_decode")
        return o
    return call


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi}
    for S in (576, 8192):
        L = S - 2
        length = torch.tensor(L, dtype=torch.int32, device="cuda")
        sets = [tuple(torch.randn(s, generator=gen, device="cuda")
                      .to(torch.bfloat16) for s in
                      ((B, H, hd), (B, S, K, hd), (B, S, K, hd))) + (length,)
                for _ in range(6 if S == 576 else 2)]
        calls = 64 if S == 576 else 8
        plans = {}
        for n in range(fd.MAX_SPLIT, 1, -1):
            split = -(-S // n // fd.TILE) * fd.TILE
            plans[split, -(-S // split)] = None
        chosen = fd.plan(B, K, S)
        fns, clusters = {}, {}
        for split, n in plans:
            name = f"split {split} x {n}" + (" (plan)" if (split, n) ==
                                             chosen else "")
            call = launcher(split, n, S)
            torch.testing.assert_close(call(*sets[0]).float(),
                                       ref.flash_decode(*sets[0]).float(),
                                       atol=2e-2, rtol=2e-2)
            fns[name] = lambda call=call: graph_ms(call, sets, calls)
            clusters[name] = fd.max_clusters(n, H // K)

        def sdpa(q, k, v, n, L=L):
            return F.scaled_dot_product_attention(
                q[:, :, None], k[:, :L + 1].transpose(1, 2),
                v[:, :L + 1].transpose(1, 2), enable_gqa=True)
        fns["SDPA"] = lambda: graph_ms(sdpa, sets, calls)
        times = in_turns(fns)
        out[f"S {S}"] = {name: {"ms (median, min, max)": t,
                                "clusters held at once": clusters.get(name),
                                "clusters needed": B * K}
                         for name, t in times.items()}
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
