#!/usr/bin/env python3
"""How far ``ssd_bwd`` lies from an f64 oracle, beside the plain f32 version.

    python3 tools/ssd_bwd_precision.py [--seeds 12] [--emulate]

Draws f32 SSD inputs as ``models/ssm.py`` hands them over (x and one
group's B_ and C slices of one conv-output row, B_ and C stride 0 over
heads; dt = softplus(normal), A = -exp(0.3 normal)) at B 2, T 300, H 4,
head dim 64, state 128, and for each seed takes the five gradients of the
scan at a normal dy three ways: the f64 oracle (autograd of the step-by-step
recurrence in f64), the plain f32 version (``ref.ssd_bwd``) and, on a CUDA
card, the kernel (``kernels/ssd.py::ssd_bwd``). It prints, for each
gradient, the largest |got - oracle| over the seeds relative to the
oracle's largest |value|: the f32 gate is 1e-4 of that.

``--emulate`` runs on the CPU instead: csrc/ssd_bwd.cu's two walks written
out in torch, once all in f32 and once in f64 from the f32 inputs on, as
the kernel walks them, for dA only, the gradient their q recurrence sets.
Torch only.
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

NAMES = ("dx", "ddt", "dA", "dB_", "dC")
B, T, H, P, N = 2, 300, 4, 64, 128


def inputs(gen, device):
    buf = torch.randn((B, T, H * P + 2 * N), generator=gen,
                      device=device) * 0.5
    x = buf[..., :H * P].unflatten(-1, (H, P))
    Bc, Cc = (buf[..., H * P + i * N:H * P + (i + 1) * N][:, :, None]
              .expand(B, T, H, N) for i in range(2))
    dt = F.softplus(torch.randn((B, T, H), generator=gen, device=device))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device=device))
    dy = torch.randn((B, T, H, P), generator=gen, device=device)
    return x, dt, A, Bc, Cc, dy


def oracle(x, dt, A, Bc, Cc, dy):
    """The five gradients by autograd of the recurrence in f64."""
    with torch.enable_grad():
        ins = [t.detach().double().requires_grad_() for t in
               (x, dt, A, Bc, Cc)]
        x_, dt_, A_, B_, C_ = ins
        h = x_.new_zeros((B, H, P, N))
        ys = []
        for t in range(T):
            h = (h * torch.exp(dt_[:, t] * A_)[..., None, None]
                 + (dt_[:, t, :, None] * x_[:, t])[..., None]
                 * B_[:, t, :, None, :])
            ys.append(torch.einsum("bhpn,bhn->bhp", h, C_[:, t]))
        return torch.autograd.grad(torch.stack(ys, 1), ins, dy.double())


def emulated_dA(x, dt, A, Bc, Cc, dy, wide):
    """dA by the kernel's two walks; ``wide``: in f64 from the f32 inputs
    on, as the kernel walks them, else all in f32."""
    f = torch.float64 if wide else torch.float32
    x, dt, A, Bc, Cc, dy = (t.to(f) for t in (x, dt, A, Bc, Cc, dy))
    a = torch.exp(dt * A)
    st = x.new_zeros((B, H, P, N))
    yd = []
    for t in range(T):
        st = a[:, t, :, None, None] * st + (
            (dt[:, t, :, None] * x[:, t])[..., None] * Bc[:, t, :, None, :])
        yd.append((Cc[:, t] * torch.einsum("bhpn,bhp->bhn", st,
                                           dy[:, t])).sum(-1))
    q, dA = x.new_zeros((B, H)), x.new_zeros(H)
    G, a_next = st.new_zeros(st.shape), x.new_ones((B, H))
    for t in reversed(range(T)):
        G = a_next[..., None, None] * G + dy[:, t][..., None] \
            * Cc[:, t][:, :, None, :]
        xu = (x[:, t] * torch.einsum("bhpn,bhn->bhp", G, Bc[:, t])).sum(-1)
        q = q + yd[t] - dt[:, t] * xu
        dA = dA + (dt[:, t] * q).sum(0)
        a_next = a[:, t]
    return dA


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--emulate", action="store_true",
                    help="the kernel's arithmetic on the CPU, dA only")
    args = ap.parse_args(argv)
    device = "cpu" if args.emulate else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: pass --emulate for the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.kernels.ssd import ssd_bwd
        print(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=device).manual_seed(1)
    worst: dict = {}
    for _ in range(args.seeds):
        ins = inputs(gen, device)
        want = oracle(*ins)
        if args.emulate:
            runs = {"f32 emulation": {"dA": emulated_dA(*ins, wide=False)},
                    "kernel emulation": {"dA": emulated_dA(*ins,
                                                           wide=True)}}
        else:
            runs = {"plain f32": dict(zip(NAMES, ref.ssd_bwd(*ins))),
                    "kernel": dict(zip(NAMES, ssd_bwd(*ins)))}
        for who, got in runs.items():
            for i, name in enumerate(NAMES):
                if name in got:
                    w = want[i]
                    rel = float((got[name].double() - w).abs().max()
                                / w.abs().max())
                    key = (who, name)
                    worst[key] = max(worst.get(key, 0.0), rel)
    print(f"B {B} T {T} H {H} P {P} N {N}, {args.seeds} seeds: largest "
          f"|got - f64 oracle| / max |oracle|")
    for (who, name), rel in sorted(worst.items()):
        print(f"  {who:>16} {name:>4} {rel:.3g}")


if __name__ == "__main__":
    main()
