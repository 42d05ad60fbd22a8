#!/usr/bin/env python3
"""``flash_decode`` at small B·K: another checkout's plan against this
one's, on one card.

    python3 tools/fd_small_bk_ab.py [OLD_DIR] [--rounds N]

Run from the root of the new checkout. OLD_DIR (optional) is another
checkout of the repo (the parent, unpacked with ``git archive``); its
``kernels/build.py`` and ``kernels/flash_decode.py`` are loaded as second
modules (as ``tools/kernel_host_ab.py`` does), so its library builds from
its own ``csrc/``. At H 16, K 8, hd 128, bf16 (the LSE row's heads) and B
1, 2 and 4 x S 32,768, 131,072 and 524,288, a full cache (length S - 1),
and at qwen3-0.6b's last serve step (B 8, S 576, length 574), it:

- checks each new route against the plain version (2e-2 of the largest
  |out|), the LSE route's ``out`` rounded to bf16 against the other
  route's bit for bit, and two calls bit for bit; at the serve shape the
  new plain route against the old one bit for bit;
- times by CUDA-graph replay, in turns (each round old, new, new, old for
  the LSE route and then for the plain one), and SDPA over the cache
  where S is at most 131,072 (at 524,288 its GQA expansion of K and V
  would take 8.6-34 GB);
- prints each plan (blocks a pair, blocks a cluster) and how many such
  clusters the card holds at once, the bound (the bytes of
  ``cost.decode_work`` at 3.35 TB/s) and the rate.

The card's name and power limit come first; the last line is one JSON
object.
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
from repro_torch.kernels import flash_decode as new_fd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.cost import decode_work  # noqa: E402

PEAK_BYTES = 3.35e12
H, K, hd = 16, 8, 128
SHAPES = [(B, S) for S in (32_768, 131_072, 524_288) for B in (1, 2, 4)] + \
    [(8, 576)]
SDPA_MAX_S = 131_072


def old_module(old: Path):
    kdir = old / "src/repro_torch/kernels"
    old_build = load_module("old_build", kdir / "build.py")
    old_build.build_all(["flash_decode"])
    mod = load_module("old_flash_decode", kdir / "flash_decode.py")
    mod.build = old_build
    return mod


def check(name, fd, q, k, v, n):
    """The route pair of ``fd`` against the plain version (taken a batch
    row at a time); returns the plain route's out."""
    rows = [ref.flash_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], n)
            for b in range(q.shape[0])]
    want = torch.cat(rows).float()
    got = fd.flash_decode(q, k, v, n)
    out, _ = fd.flash_decode(q, k, v, n, with_lse=True)
    err = float((got.float() - want).abs().max())
    if err > 2e-2 * float(want.abs().max()):
        raise AssertionError(f"{name}: max abs err {err}")
    if not torch.equal(out.to(q.dtype), got):
        raise AssertionError(f"{name}: the LSE route's out rounded is not "
                             f"the plain route's")
    if not torch.equal(got, fd.flash_decode(q, k, v, n)):
        raise AssertionError(f"{name}: two calls differ")
    return got, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("old", nargs="?", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fd_small_bk_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = smi()
    print(card, flush=True)
    mods = {"new": new_fd}
    if args.old is not None:
        mods = {"old": old_module(args.old), "new": new_fd}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    out = {"card": card}
    for B, S in SHAPES:
        L = S - 2 if S == 576 else S - 1
        n = torch.tensor(L, dtype=torch.int32, device="cuda")
        n_sets = max(1, min(4, (1 << 28) // (4 * B * S * K * hd)))
        sets = [(torch.randn((B, H, hd), generator=gen, device="cuda").to(bf),
                 torch.randn((B, S, K, hd), generator=gen,
                             device="cuda").to(bf),
                 torch.randn((B, S, K, hd), generator=gen,
                             device="cuda").to(bf), n)
                for _ in range(n_sets)]
        name = f"B {B} S {S}"
        row = {"length": L, "sets": n_sets}
        outs = {}
        for m, fd in mods.items():
            split, n_split = fd.plan(B, K, S)
            cl = fd.cluster(n_split) if hasattr(fd, "cluster") else n_split
            row[f"{m} plan"] = {"split": split, "blocks a pair": n_split,
                                "blocks a cluster": cl,
                                "blocks": B * K * n_split,
                                "clusters held at once":
                                    new_fd.max_clusters(cl, H // K)}
            outs[m], row[f"{m} max abs err"] = check(f"{name} {m}", fd,
                                                     *sets[0])
        if S == 576 and "old" in outs:
            row["serve shape bit for bit"] = bool(torch.equal(outs["old"],
                                                              outs["new"]))
            if not row["serve shape bit for bit"]:
                raise AssertionError("the serve shape's out changed")
        calls = max(2, min(32, int(2e7 // (B * S * K))))
        fns = {}
        for route, lse in (("lse", True), ("plain", False)):
            order = ["old", "new", "new", "old"] if "old" in mods else ["new"]
            for i, m in enumerate(order):
                fns[f"{m} {route}#{i}"] = (
                    lambda q, k, v, n, fd=mods[m], lse=lse:
                    fd.flash_decode(q, k, v, n, with_lse=lse))
        if S <= SDPA_MAX_S:
            fns["SDPA#0"] = lambda q, k, v, n, L=L: \
                F.scaled_dot_product_attention(
                    q[:, :, None], k[:, :L + 1].transpose(1, 2),
                    v[:, :L + 1].transpose(1, 2), enable_gqa=True)
        got = {}
        for _ in range(args.rounds):
            for key, fn in fns.items():
                got.setdefault(key.split("#")[0], []).append(
                    graph_ms(fn, sets, calls))
        _, nbytes = decode_work(B, L, H, K, hd, 2, with_lse=True)
        bound = nbytes / PEAK_BYTES * 1e3
        times = {k: (statistics.median(v), min(v), max(v))
                 for k, v in got.items()}
        row.update({f"{k} ms (median, min, max)": t
                    for k, t in times.items()}, bound_ms=bound,
                   bytes=nbytes)
        print(f"{name} (H {H}, K {K}, hd {hd}, length {L}, {n_sets} sets, "
              f"{calls} calls a graph): "
              + ", ".join(f"{k} {t[0]:.4f} ({t[1]:.4f}-{t[2]:.4f}) ms, "
                          f"{nbytes / t[0] / 1e9:.2f} TB/s"
                          for k, t in times.items())
              + f"; bound {bound:.4f} ms ({nbytes:.4g} B); plans "
              + "; ".join(f"{m}: {row[f'{m} plan']}" for m in mods),
              flush=True)
        out[name] = row
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
