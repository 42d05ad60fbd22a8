#!/usr/bin/env python3
"""Where mamba2-1.3b's full-width f32 serve gate (``chip_smoke.py`` phase
4, ``phase_full_width_f32``: the ``cuda`` and ``ref`` logits of a prefill of
B 2 x 256 and 4 teacher-forced decode steps at atol = rtol = 1e-3) spends
its margin, on one card.

    python3 tools/mamba2_gate_margin.py [--fresh 8] [--no-replay]
        [--layers-for replay,1]

Run from the root of a checkout. The two runs differ in one place: the
prefill's SSD scan is the CUDA kernel's f32 route (``csrc/ssd.cu``, the
state carried in f32 in shared memory) under ``cuda`` and the plain
version stepping in f64 (``kernels/ref.py::ssd``) under ``ref``; decode
steps the SSM layers without a kernel in both. For each draw of weights
and tokens it prints the gate's ratio (the largest |cuda - ref| / (1e-3 +
1e-3 |ref|); the gate fails above 1) and, for the draws ``--layers-for``
names, a line a layer of the prefill:

- the relative L2 distance between the two runs of the residual stream
  after the layer, of its SSD output y and of its last state h_last;
- the kernel alone on the ``ref`` run's inputs of that layer against the
  f64 plain version's outputs (what the kernel adds where it is called),
  and beside it the plain version stepping in f32 on the same inputs (what
  an f32 recurrence adds).

Draws: ``replay`` is the one that read 1.31e-3 (PR 31's chip run 7):
phase 3 as it ran then, its long_500k decode cases drawing from the
shared generator (``chip_smoke.fd_long_cases``'s draws replayed on it),
then phase 4's qwen3 gate, then mamba2 from where the generator stands.
``1`` .. ``--fresh`` draw from ``torch.Generator().manual_seed(s)``. The
card's name and power limit come first; the last line is one JSON object,
also written to ``chiprun_out/mamba2_gate_margin.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, dispatch, ops, ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

TOL = 1e-3


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


class Record:
    """The SSD calls (inputs and outputs) and the residual stream after
    each layer while entered: ``models/ssm.py`` looks ``kops.ssd`` up, and
    ``transformer.prefill`` ``_ffn``, at each call."""

    def __enter__(self):
        self.ssd, self.resid = [], []
        self.real_ssd, self.real_ffn = ops.ssd, transformer._ffn

        def ssd(x, dt, A, B_, C, chunk=128, mode=None):
            y, h = self.real_ssd(x, dt, A, B_, C, chunk=chunk, mode=mode)
            # h_last becomes the decode cache's state, updated in place
            self.ssd.append(((x, dt, A, B_, C, chunk), y, h.clone()))
            return y, h

        def ffn(p, x, cfg, aux=True):
            out = self.real_ffn(p, x, cfg, aux=aux)
            self.resid.append(out[0])
            return out

        ops.ssd, transformer._ffn = ssd, ffn
        return self

    def __exit__(self, *exc):
        ops.ssd, transformer._ffn = self.real_ssd, self.real_ffn


def draw_long_cases(gen):
    """``chip_smoke.fd_long_cases``'s draws, on ``gen``, in its order."""
    S, H, K, hd = cs.LONG_S, 32, 8, 128
    for B, dtype in ((1, torch.bfloat16), (1, torch.float32),
                     (4, torch.bfloat16)):
        q = (cs.randn(gen, (B, H, hd), torch.float32) * 3).to(dtype)
        k, v = (cs.randn(gen, (B, S, K, hd), dtype) for _ in range(2))
        del q, k, v
        torch.cuda.empty_cache()
    return 0


def measure(gen, name, layers):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.with_overrides(cs.get_config(cs.SSM_ARCH), dtype="float32",
                            param_dtype="float32")
    policy = cs.BackbonePolicy(cfg, generator=gen)
    B, T, steps = 2, 256, 4
    toks = torch.randint(0, cfg.vocab_size, (B, T + steps), generator=gen,
                         device="cuda")
    logits, recs = {}, {}
    for mode in ("cuda", "ref"):
        with dispatch.using(mode):
            with Record() as rec:
                lg, _, caches = policy.prefill(toks[:, :T], T + steps)
            out = [lg]
            for t in range(T, T + steps):
                lg, _, caches = policy.decode(toks[:, t:t + 1], caches)
                out.append(lg)
        logits[mode] = torch.stack(out)[..., :cfg.vocab_size].float()
        recs[mode] = rec
    got, want = logits["cuda"], logits["ref"]
    ratio_by_step = [float(((g - w).abs() / (TOL + TOL * w.abs())).max())
                     for g, w in zip(got, want)]
    res = {"draw": name, "gate_ratio": max(ratio_by_step),
           "ratio_by_step": ratio_by_step,
           "max_abs_err": float((got - want).abs().max()),
           "logits_rel": rel(got, want)}
    print(f"[{name}] mamba2 f32 {cfg.num_layers}L: gate ratio "
          f"{res['gate_ratio']:.4f} (prefill, decode steps: "
          f"{', '.join(f'{r:.4f}' for r in ratio_by_step)}), max abs err "
          f"{res['max_abs_err']:.4g}, logits relative L2 "
          f"{res['logits_rel']:.3e}", flush=True)
    if layers:
        rows = []
        a, b = recs["cuda"], recs["ref"]
        for i, ((args, y64, h64), (_, y, h)) in enumerate(zip(b.ssd, a.ssd)):
            yk, hk = ops.ssd(*args[:5], chunk=args[5], mode="cuda")
            y32, h32 = ref.ssd(*args[:5], step_dtype=torch.float32)
            row = {"layer": i, "resid": rel(a.resid[i], b.resid[i]),
                   "y": rel(y, y64), "h_last": rel(h, h64),
                   "kernel_y": rel(yk, y64), "kernel_h": rel(hk, h64),
                   "f32_step_y": rel(y32, y64), "f32_step_h": rel(h32, h64)}
            rows.append(row)
            print(f"[{name}] layer {i:2d}: relative L2 cuda vs ref: "
                  f"residual {row['resid']:.3e}, y {row['y']:.3e}, h_last "
                  f"{row['h_last']:.3e}; on ref's inputs: kernel y "
                  f"{row['kernel_y']:.3e} h {row['kernel_h']:.3e}, f32 "
                  f"steps y {row['f32_step_y']:.3e} h "
                  f"{row['f32_step_h']:.3e}", flush=True)
        res["layers"] = rows
    del policy, caches, recs
    torch.cuda.empty_cache()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fresh", type=int, default=8)
    ap.add_argument("--no-replay", action="store_true")
    ap.add_argument("--layers-for", default="replay,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mamba2_gate_margin: CUDA is not available", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    print(smi, flush=True)
    build.build_all()
    detail = set(args.layers_for.split(","))
    t0 = time.perf_counter()
    out = {"card": smi, "draws": []}
    if not args.no_replay:
        gen = torch.Generator(device="cuda").manual_seed(0)
        real, cs.fd_long_cases = cs.fd_long_cases, lambda: draw_long_cases(
            gen)
        try:
            cs.phase_parity(gen)
        finally:
            cs.fd_long_cases = real
        cs.phase_full_width_f32(gen, cs.ARCH)
        out["draws"].append(measure(gen, "replay", "replay" in detail))
    for s in range(1, args.fresh + 1):
        gen = torch.Generator(device="cuda").manual_seed(s)
        out["draws"].append(measure(gen, str(s), str(s) in detail))
    ratios = [d["gate_ratio"] for d in out["draws"]]
    print(f"gate ratios {[f'{r:.4f}' for r in ratios]}: max {max(ratios):.4f}"
          f" in {time.perf_counter() - t0:.1f} s", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out/mamba2_gate_margin.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({"card": smi, "gate_ratios": ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
