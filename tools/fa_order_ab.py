#!/usr/bin/env python3
"""The wgmma forward of ``flash_attention`` in another checkout's launch
order against this one's, on one card.

    python3 tools/fa_order_ab.py [OLD_DIR] [--rounds N] [--only hd,...]

Run from the root of the new checkout. OLD_DIR (optional) is another
checkout of the repo (the parent, unpacked with ``git archive``); its
``kernels/build.py`` is loaded as a second module, so its library builds
from its own ``csrc/`` into its own ``_build/``, and its
``kernels/flash_attention.py`` is loaded over that module (as
``tools/fa_bwd_ab.py`` does). At each arch's prefill shape, causal bf16, B
8 x T 512 (4 input sets, past the 50 MB L2 together):

- hd 256, gemma-7b (H 16, K 16), also at B 2 (K/V 17 MB: within the L2);
- hd 160, stablelm-12b (H 32, K 8); hd 128, qwen3-0.6b (H 16, K 8);
  hd 64, musicgen-medium (H 24, K 24);

it checks that the new ``out`` and ``lse`` (the serve call, and the
training forward's ``with_lse``) are the old ones bit for bit, then times
by CUDA-graph replay, in turns (each round old, new, new, old, then
``scaled_dot_product_attention``), and prints the medians, their ranges,
and the device ms per (batch, head). The card's name and power limit come
first; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from fa_bwd_ab import load_module  # noqa: E402  (tools/)
from kernel_host_ab import graph_ms  # noqa: E402  (tools/)
from serve_shard_parity import smi  # noqa: E402  (tools/)
from repro_torch.kernels import flash_attention as new_fa  # noqa: E402
from repro_torch.kernels.cost import attention_work  # noqa: E402

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
CASES = {  # name: (B, T, H, K, hd)
    "gemma-7b hd 256": (8, 512, 16, 16, 256),
    "gemma-7b hd 256 B 2": (2, 512, 16, 16, 256),
    "stablelm-12b hd 160": (8, 512, 32, 8, 160),
    "qwen3-0.6b hd 128": (8, 512, 16, 8, 128),
    "musicgen-medium hd 64": (8, 512, 24, 24, 64),
}


def old_wrapper(old: Path):
    kdir = old / "src/repro_torch/kernels"
    old_build = load_module("old_build", kdir / "build.py")
    old_build.build_all(["flash_attention"])
    mod = load_module("old_flash_attention", kdir / "flash_attention.py")
    mod.build = old_build
    return mod


def sdpa(q, k, v):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)


def work(B, T, H, K, hd):
    """The bound as ``chip_smoke.py`` counts it (``cost.attention_work``):
    the causal products at 989 TFLOP/s, or q, k, v and o moved once at
    3.35 TB/s."""
    flops, nbytes = attention_work(B, T, H, K, hd)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3, nbytes


def in_turns(fns, sets, calls, rounds):
    got = {n: [] for n in fns}
    for _ in range(rounds):
        for n in fns:
            got[n].append(graph_ms(fns[n], sets, calls))
    return {n: (statistics.median(v), min(v), max(v)) for n, v in got.items()}


def fmt(t):
    return f"{t[0]:.4f} ({t[1]:.4f}-{t[2]:.4f})"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("old", nargs="?", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fa_order_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = smi()
    print(card, flush=True)
    old = old_wrapper(args.old) if args.old is not None else None
    only = {int(h) for h in args.only.split(",") if h}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    out = {"card": card}
    for name, (B, T, H, K, hd) in CASES.items():
        if only and hd not in only:
            continue
        sets = [tuple(torch.randn(s, generator=gen, device="cuda").to(bf)
                      for s in ((B, T, H, hd), (B, T, K, hd),
                                (B, T, K, hd))) for _ in range(4)]
        row = {"shape": [B, T, H, K, hd]}
        fns = {"new": new_fa.flash_attention}
        if old is not None:
            fns = {"old": old.flash_attention, "new": new_fa.flash_attention}
            q, k, v = sets[0]
            a, b = old.flash_attention(q, k, v), new_fa.flash_attention(q, k, v)
            (ao, al), (bo, bl) = (m.flash_attention_fwd(q, k, v, True,
                                                         with_lse=True)
                                  for m in (old, new_fa))
            row["bit_for_bit"] = bool(torch.equal(a, b) and torch.equal(ao, bo)
                                      and torch.equal(al, bl))
            if not row["bit_for_bit"]:
                raise AssertionError(f"{name}: the new order's out or lse "
                                     f"differ from the old order's")
        turns = dict(fns)
        if old is not None:
            turns = {"old": fns["old"], "new": fns["new"],
                     "new ": fns["new"], "old ": fns["old"]}
        turns["SDPA"] = sdpa
        times = in_turns(turns, sets, 8, args.rounds)
        merged = {}
        for n, t in times.items():
            merged.setdefault(n.strip(), []).append(t)
        times = {n: (statistics.median([x[0] for x in ts]),
                     min(x[1] for x in ts), max(x[2] for x in ts))
                 for n, ts in merged.items()}
        bound, nbytes = work(B, T, H, K, hd)
        row.update({f"{n} ms (median, min, max)": t for n, t in times.items()},
                   bound_ms=bound, bytes=nbytes,
                   new_us_per_batch_head=times["new"][0] * 1e3 / (B * H))
        print(f"{name} (B {B}, T {T}, H {H}, K {K}): "
              + ", ".join(f"{n} {fmt(t)} ms" for n, t in times.items())
              + f"; bound {bound:.4f} ms ({nbytes:.4g} B); new "
              f"{row['new_us_per_batch_head']:.3f} us a (batch, head)"
              + (f"; bit for bit: {row['bit_for_bit']}" if old else ""),
              flush=True)
        out[name] = row
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
