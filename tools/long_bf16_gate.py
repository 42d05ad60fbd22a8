#!/usr/bin/env python3
"""Readings for ``tools/serve_shard_parity.py``'s bf16 gate (``--bf16-tol``),
on one card: jamba-v0.1-52b int8 at long_500k in bf16.

    python3 tools/long_bf16_gate.py [--seeds 0,1,2] [--smoke --device cpu]

Run from the root of a checkout. The one-card policy (int8 weights from
seed 0, as the tool's) decodes a cache of 524,288 positions (B 1, drawn
from seed 13 + s, as ``_long_caches``) for 1 + 4 tokens (seed 5 + s) at
each seed s, four ways, each from fresh caches with its MoE routing
recorded (``RoutingLog``):

- ``kernel``: flash_decode's kernel (P rounded to bf16 per split);
- ``bf16 P``: its plain version with P rounded to bf16 at one global max
  (``rounded_p``): the yardstick of the sound readings;
- ``f32 P``: its plain version, P unrounded (the tool's yardstick up to
  now);
- ``kernel again``: the kernel's decode once more, from fresh caches of
  the same draw: how far two runs of one program lie apart;
- ``fp8 P``: P rounded to ``torch.float8_e4m3fn``, and ``lost split``: the
  bf16-P plain version without the cache's first split of positions (as
  ``flash_decode.plan`` splits it): the controls, decodes the gate must
  fail.

For each pair it prints the relative L2 distance of the logits by step
and the MoE routing flips by step; the steps before a decode's first flip
are the ones the gate holds. The sound readings are ``kernel`` against
``bf16 P``, the controls' ``fp8 P`` and ``lost split`` against ``bf16 P``:
a limit can sit between them only if the largest held sound reading is
below the smallest held reading of a control.

Every way also goes through the attention-output gate of
``tools/serve_shard_parity.py`` (``LayerGate``): each attention layer's
output at every step against flash_decode's plain version on the same
inputs, in bf16 units of the plain output's largest |value|, limit 1 (fixed
before any reading). It holds only if it passes ``kernel`` (and ``kernel
again``) and fails both controls at every seed; its readings by way and
step are printed beside the logits'.

The card's name and power limit come first; the last line is one JSON
object, also written to ``chiprun_out/long_bf16_gate.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import serve_shard_parity as ssp  # noqa: E402  (tools/)


def rounded_p(p_dtype, drop=None):
    """flash_decode's plain version (``kernels/ref.py::flash_decode``, one
    global max over the cache, no splits) with P = exp(s - max) rounded to
    ``p_dtype`` before P V and its sum taken unrounded in f32: at bf16 the
    kernel's rounding of P; at ``torch.float8_e4m3fn``, or with the
    positions ``drop`` = (lo, hi) left out (a lost split), a control the
    bf16 gate must fail. Without ``with_lse``: one card's decode."""
    def fd(q, k, v, length, with_lse=False):
        if with_lse:
            raise NotImplementedError("rounded_p: one card's decode only")
        B, H, hd = q.shape
        S, K = k.shape[1], k.shape[2]
        qg = q.reshape(B, K, H // K, hd)
        s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) \
            / math.sqrt(hd)
        pos = torch.arange(S, device=q.device)
        keep = pos <= length
        if drop is not None:
            keep &= (pos < drop[0]) | (pos >= drop[1])
        s = s.masked_fill(~keep, -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bkgs,bskh->bkgh", p.to(p_dtype).float(),
                         v.float()) / p.sum(-1, keepdim=True)
        return torch.where(length >= 0, o, 0.0).reshape(B, H, hd).to(
            q.dtype)
    return fd


WAYS = ("kernel", "kernel again", "bf16 P", "f32 P", "fp8 P", "lost split")
PAIRS = (("kernel", "bf16 P"), ("kernel again", "kernel"),
         ("fp8 P", "bf16 P"), ("lost split", "bf16 P"), ("f32 P", "bf16 P"),
         ("kernel", "f32 P"))
CONTROLS = ("fp8 P", "lost split")


def decode_ways(pol, cfg, S, toks, seed, dev):
    """{way: logits by step}, {way: its RoutingLog}, {way: its LayerGate}."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.flash_decode import flash_decode, plan
    split, _ = plan(1, cfg.num_kv_heads, S)
    fns = {"kernel": None, "kernel again": None,
           "bf16 P": rounded_p(torch.bfloat16),
           "f32 P": ref.flash_decode,
           "fp8 P": rounded_p(torch.float8_e4m3fn),
           "lost split": rounded_p(torch.bfloat16, drop=(0, split))}
    backend = "cuda" if dev.type == "cuda" else "ref"
    kernel = flash_decode if dev.type == "cuda" else ref.flash_decode
    logits, routes, gates = {}, {}, {}
    for way in WAYS:
        caches = ssp._long_caches(pol, cfg, S, dev, seed=13 + seed)
        gate = ssp.LayerGate()
        with ssp.RoutingLog() as log, dispatch.replaced(
                "flash_decode", backend, gate.wrap(fns[way] or kernel)):
            out, _, _ = ssp._decode_steps(pol, caches, toks, False, dev)
        logits[way], routes[way], gates[way] = out, log, gate
        del caches
        ssp._free(dev)
    return logits, routes, gates


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("long_bf16_gate: CUDA is not available", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
    smi = ssp.smi() if dev.type == "cuda" else "cpu"
    print(smi, flush=True)
    t0 = time.perf_counter()
    cfg = ssp._config(ssp.JAMBA, args.smoke)
    S = 64 if args.smoke else ssp.LONG_CACHE
    pol = ssp._policy(cfg, dev)
    print(f"{cfg.name} int8 {cfg.dtype} {cfg.num_layers}L d{cfg.d_model} on "
          f"one card, cache {S}: policy built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {"card": smi, "seeds": {}, "layer_gate": {}}
    sound, control = [], {}
    layer = {way: [] for way in WAYS}      # the gate's verdict at each seed
    for seed in map(int, args.seeds.split(",")):
        toks = torch.randint(0, cfg.vocab_size, (1, 1 + ssp.LONG_STEPS),
                             generator=torch.Generator(dev).manual_seed(
                                 5 + seed), device=dev)
        logits, routes, gates = decode_ways(pol, cfg, S, toks, seed, dev)
        n = len(logits["kernel"])
        out["layer_gate"][seed] = {w: g.by_step(n) for w, g in gates.items()}
        for way, g in gates.items():
            layer[way].append(g.ok())
        print(f"seed {seed}: the attention-output gate, the largest "
              f"|difference| from the plain version in bf16 units of its "
              f"largest |out| by step (limit {ssp.LayerGate.LIMIT:g}): "
              + "; ".join(f"{w} {[f'{u:.3g}' for u in g.by_step(n)]} "
                          f"({'passes' if g.ok() else 'fails'})"
                          for w, g in gates.items()), flush=True)
        row = {}
        for way, base in PAIRS:
            dist = [ssp._rel(g, w) for g, w in zip(logits[way],
                                                   logits[base])]
            flips = ssp.flips_by_step(routes[way], routes[base], n)
            _, held = ssp.held_before_flip(dist, flips, 0.0)
            row[f"{way} vs {base}"] = {"rel": dist, "flips": flips,
                                       "held": held}
            print(f"seed {seed}: {way} against {base}: relative L2 of the "
                  f"logits by step {[f'{d:.3e}' for d in dist]}, routing "
                  f"flips {flips} (the first {held} steps held)", flush=True)
        k = row["kernel vs bf16 P"]
        sound += k["rel"][:k["held"]]
        for way in CONTROLS:
            c = row[f"{way} vs bf16 P"]
            control.setdefault(way, []).extend(c["rel"][:c["held"]])
        out["seeds"][seed] = row
    out.update(sound_max=max(sound, default=None),
               control_min={w: min(c, default=None)
                            for w, c in control.items()},
               seconds=time.perf_counter() - t0)
    out["separate"] = {w: out["sound_max"] is not None and m is not None
                       and out["sound_max"] < m
                       for w, m in out["control_min"].items()}
    sound_ok = all(layer["kernel"]) and all(layer["kernel again"])
    out["layer_gate_holds"] = {w: sound_ok and not any(layer[w])
                               for w in CONTROLS}
    print(f"the attention-output gate passes the kernel at every seed: "
          f"{sound_ok}; fails each control at every seed: "
          f"{ {w: not any(layer[w]) for w in CONTROLS} }; so it holds "
          f"(passes the kernel, fails the control): "
          f"{out['layer_gate_holds']}", flush=True)
    print(f"held sound readings (kernel vs bf16 P): max "
          f"{out['sound_max']}; held control readings against bf16 P, the "
          f"smallest: {out['control_min']}; separate from the sound ones: "
          f"{out['separate']}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out/long_bf16_gate.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "sound_max",
                                          "control_min", "separate",
                                          "layer_gate_holds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
