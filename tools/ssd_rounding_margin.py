#!/usr/bin/env python3
"""How close the tensor-core ssd's rounding comes to the bf16 parity gate,
on the CPU.

    python3 tools/ssd_rounding_margin.py [--heads 8] [--seeds 2]

Draws bf16 inputs as ``models/ssm.py`` hands them to ``ssd`` (x, B_ and C
slices of one conv-output row, one group; dt = softplus(normal), A =
-exp(0.3 normal)) at mamba2-1.3b's batch, prompt, head dim, state and
chunk, with fewer heads, and runs three arithmetics of csrc/ssd.cu's
chunked form in f32 against the step-by-step plain version (``ref.ssd``):

- ``one``: the masked scores and the carried state rounded once to bf16
  before their products;
- ``hi+lo``: both as bf16 hi + lo, as the kernel computes them;
- ``exact``: no rounding but the inputs' and y's own.

x·w is rounded to bf16 in the first two. For each it prints the largest
|error| / (atol + rtol |want|) of y and h_last at the parity gate atol =
rtol = 2e-2 (1.0 is the gate), so a design can be judged before a card
runs it. Torch only.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

BF = torch.bfloat16
LOG2E = 1.4426950408889634
TOL = 2e-2


def bf(t):
    return t.to(BF).float()


def hilo(t):
    hi = bf(t)
    return hi + bf(t - hi)


def chunked(x, dt, A, B_, C, chunk, mode):
    """csrc/ssd.cu's chunked arithmetic in f32 with ``mode``'s rounding;
    (y in bf16, h_last in f32)."""
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    xf, bb, cc = (t.float().transpose(1, 2) for t in (x, B_, C))
    a2 = A.float() * LOG2E
    dth = dt.float().transpose(1, 2)
    round_op = {"one": bf, "hi+lo": hilo, "exact": lambda t: t}[mode]
    h = torch.zeros((Bb, H, P, N))
    ys = []
    for c0 in range(0, T, chunk):
        q = min(chunk, T - c0)
        xs, bs, cs = (t[:, :, c0:c0 + q] for t in (xf, bb, cc))
        d = dth[:, :, c0:c0 + q]
        cum = torch.cumsum(d * a2[None, :, None], dim=-1)
        clast = cum[..., -1:]
        xw = xs * (torch.exp2(clast - cum) * d)[..., None]
        if mode != "exact":
            xw = bf(xw)
        causal = torch.ones(q, q).tril().bool()
        decay = torch.exp2((cum[..., :, None] - cum[..., None, :])
                           .masked_fill(~causal, -float("inf")))
        s = (cs @ bs.transpose(-1, -2)) * (decay * d[..., None, :])
        y = torch.exp2(cum)[..., None] * (cs @ round_op(h).transpose(-1, -2))
        ys.append(y + round_op(s) @ xs)
        h = torch.exp2(clast)[..., None] * h + xw.transpose(-1, -2) @ bs
    return torch.cat(ys, dim=2).transpose(1, 2).to(x.dtype), h


def ratio(got, want):
    want = want.float()
    return float(((got.float() - want).abs() / (TOL + TOL * want.abs()))
                 .max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args()
    B, T, P, N, Q = 8, 512, 64, 128, 128      # mamba2-1.3b's serve call
    H = args.heads
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        buf = torch.randn((B, T, H * P + 2 * N), generator=gen).to(BF) * 0.5
        x = buf[..., :H * P].unflatten(-1, (H, P))
        b_, c_ = (buf[..., H * P + i * N:H * P + (i + 1) * N][:, :, None]
                  .expand(B, T, H, N) for i in range(2))
        dt = F.softplus(torch.randn((B, T, H), generator=gen))
        A = -torch.exp(0.3 * torch.randn(H, generator=gen))
        want_y, want_h = ref.ssd(x, dt, A, b_, c_)
        for mode in ("one", "hi+lo", "exact"):
            y, h = chunked(x, dt, A, b_, c_, Q, mode)
            print(f"seed {seed} B {B} T {T} H {H} P {P} N {N} chunk {Q} "
                  f"{mode:6s}: y {ratio(y, want_y):.3f}, h_last "
                  f"{ratio(h, want_h):.3f} of the gate (CPU)", flush=True)


if __name__ == "__main__":
    main()
