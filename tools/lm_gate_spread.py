#!/usr/bin/env python3
"""Which gradients of the full-width f32 LM train step part on the card.

    python3 tools/lm_gate_spread.py [--arch mamba2-1.3b] [--seeds 3]

``chip_smoke.py`` phase 14(b) holds one ``make_lm_train_step`` at full
width in f32 (TF32 off, B 2 x T 64) through the cuda ops against the
all-plain path (``dispatch.using("ref")``, its SSD stepped in f64). This
takes the same step from the same params and batch (``lm_gate_inputs`` at
the gate's seed, then the seeds after it) and sets against the all-plain
run:

  cuda ops        the gated run;
  held forward    the all-plain run with the SSD forward kernel's output
                  (``held_ssd``), so only the backward differs from the
                  cuda run's on an SSM arch;
  perturbed       the all-plain run with each SSD output multiplied by
                  1 + 1e-6 · s, s a fixed pattern in [-1, 1]: how far each
                  gradient moves at a rounding-sized change of the forward,
                  whatever kernel makes it;
  f32 steps       the all-plain run with the SSD recurrence stepped in
                  f32, as the reference steps it (its backward by
                  autograd in f32 too).

For each it prints loss and grad_norm relative to the all-plain run's and
the five leaves farthest from it, then a table by leaf kind (the layer
index replaced by *): each kind's share of the squared grad_norm, each
variant's gradients' largest distance from the all-plain ones relative to
each leaf's largest, at worst over the layers, and last the cuda run's
from the held forward's (the backward kernel's own part).
Needs a CUDA card; torch only.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (LM_GATE_B, LM_GATE_SEED, LM_GATE_T,  # noqa: E402
                        held_ssd, leaf_rel, lm_gate_inputs, step_grads)
from repro_torch.kernels import dispatch, ref  # noqa: E402

PERTURB = 1e-6
BWD = "cuda vs held"     # the backward kernel against the plain backward


def perturbed_ssd(x, dt, A, B_, C, chunk=128):
    """The plain SSD with its output moved by a relative ``PERTURB`` in a
    fixed pattern (the same at the checkpoint's recomputation)."""
    y, h = ref.ssd(x, dt, A, B_, C)
    i = torch.arange(y.numel(), device=y.device, dtype=torch.float64)
    s = torch.sin(i * 12.9898 + 78.233).reshape(y.shape)
    return y * (1 + PERTURB * s).to(y.dtype), h


def f32_ssd(x, dt, A, B_, C, chunk=128):
    """The plain SSD stepped in f32, as the reference steps it."""
    return ref.ssd(x, dt, A, B_, C, step_dtype=torch.float32)


VARIANTS = {
    "cuda ops": None,
    "held forward": held_ssd,
    "perturbed": perturbed_ssd,
    "f32 steps": f32_ssd,
}


def run(step, state, batch, tcfg, variant):
    if variant is None:
        m, _, g = step_grads(step, state, batch, tcfg)
        return m, g
    with dispatch.replaced("ssd", "ref", variant), dispatch.using("ref"):
        m, _, g = step_grads(step, state, batch, tcfg)
    return m, g


def kind(name):
    return re.sub(r"\.\d+\.", ".*.", name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}; {args.arch} f32, B {LM_GATE_B} "
          f"x T {LM_GATE_T}; the gate's seed is {LM_GATE_SEED}", flush=True)
    for seed in range(LM_GATE_SEED, LM_GATE_SEED + args.seeds):
        cfg, tcfg, step, state, batch = lm_gate_inputs(args.arch, seed)
        with dispatch.using("ref"):
            wm, _, wg = step_grads(step, state, batch, tcfg)
        names = list(wg)
        print(f"  seed {seed}: all-plain loss {wm['loss']:.6f}, grad_norm "
              f"{wm['grad_norm']:.6f}", flush=True)
        kinds = sorted({kind(n) for n in names})
        sq = {n: float(wg[n].double().square().sum()) for n in names}
        share = {k: sum(v for n, v in sq.items() if kind(n) == k)
                 / sum(sq.values()) for k in kinds}
        worst, cuda = {}, None
        for vname, variant in VARIANTS.items():
            m, g = run(step, state, batch, tcfg, variant)
            rel = leaf_rel(g, wg)
            worst[vname] = {k: max(rel[n] for n in names if kind(n) == k)
                            for k in kinds}
            top = sorted(rel, key=rel.get, reverse=True)[:5]
            d_loss, d_norm = (abs(m[k] - wm[k]) / abs(wm[k])
                              for k in ("loss", "grad_norm"))
            print(f"    {vname:>12}: loss {m['loss']:.6f} ({d_loss:.3g}), "
                  f"grad_norm {m['grad_norm']:.6f} ({d_norm:.3g}); worst "
                  f"leaves " + ", ".join(f"{n} {rel[n]:.3g}" for n in top),
                  flush=True)
            if variant is None:
                cuda = g
            elif variant is held_ssd:
                rel = leaf_rel(cuda, g)
                worst[BWD] = {k: max(rel[n] for n in names if kind(n) == k)
                              for k in kinds}
            del g
        del cuda
        columns = list(VARIANTS) + [BWD]
        print(f"    {'leaf kind':<34} {'share':>9} " + " ".join(
            f"{v:>12}" for v in columns))
        for k in sorted(kinds, key=lambda k: -worst["cuda ops"][k]):
            print(f"    {k:<34} {share[k]:9.3g} " + " ".join(
                f"{worst[v][k]:12.3g}" for v in columns))
        del cfg, step, state, batch, wg
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
