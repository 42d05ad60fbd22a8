#!/usr/bin/env python3
"""Sharded serving over 4 ranks: a model one card cannot hold, and the
context-parallel decode of a 524,288-token cache.

    python3 tools/serve_shard_parity.py [--device cuda|cpu] [--smoke]
        [--part dbrx|long|all]

Spawns 4 ranks (NCCL over 4 cards on ``cuda``, gloo on ``cpu``) and runs,
in one process group:

(i) dbrx: dbrx-132b with int8 weights (131.6 GB: no one card holds it).
    First at depth 4 in f32 (TF32 off), on every rank, the one-card
    policy (at the mesh's tp, so that the padded heads are the same
    model) and then the sharded one on ``2x2`` and ``1x4`` from the same
    seed: a prefill of B 8 x 512 and 4 teacher-forced decode steps, the
    gathered logits held to the one card's within ``--tol`` (1e-3, the
    full-width serving gate of ``chip_smoke.py``'s phase 4, as the
    relative L2 error of each step's logits), their greedy tokens
    compared, and both runs' decode steps timed after the first (a
    warm-up). In bf16 the TP ranks' partial sums, added in another order,
    flip the routing of near-tied tokens, which moves whole logits rows:
    f32 holds the layout to the one card's, bf16 is what is timed. Then
    at full size (40 layers) in bf16 on ``2x2`` and ``1x4``: a prefill of
    B 8 x 512 and 63 serve steps through ``rl/actor.py`` (64 tokens):
    prefill ms, decode ms a token, tok/s, each card's
    ``max_memory_allocated``, and one more serve step under
    ``torch.profiler`` (device busy, NCCL kernels, idle share).
(ii) long: jamba-v0.1-52b with int8 weights at ``long_500k``, in f32
    and then in the config's bf16: B 1, a KV cache of 524,288 positions
    (17.2 GB in f32) and SSM caches drawn from the seed, ``4x1`` (data 4,
    the sequence split over it: 131,072 positions a rank), a warm-up and
    4 timed context-parallel decode steps; then rank 0 alone decodes the
    same cache with the one-card policy (52 GB of weights) the same way.
    In f32 the logits of every step are held to the one card's within
    ``--tol``. In bf16 the yardstick is the one card's decode with
    flash_decode's plain version (an f32 softmax, P unrounded), run on
    the same cache. The kernel rounds P to bf16, and a MoE router near a
    tie may then pick other experts for a token, which moves whole logits
    rows from that step on. So each decode's router choices are recorded
    (every call of ``models.moe.route``) and compared with the plain
    decode's step by step: the flips (tokens whose ordered top-k
    differ) are counted at each step, the logits of the one card's
    kernel decode and of the context-parallel decode are held to the
    plain decode's within the fixed ``--bf16-tol`` (2e-2, relative L2)
    at every step before that decode's first flip, and from the first
    flip on their distances are printed and held to nothing. The gate sits
    at the noise floor of jamba's bf16 stack: on one card a plain decode
    with P in fp8, or without a split of the cache, lands no farther from
    the bf16-P plain decode than the kernel does (``tools/long_bf16_gate.py``
    on an H100: sound readings up to 2.560e-2, the controls from 1.963e-2
    and 2.046e-2). So in bf16 each decode's attention is also held where
    it is computed (``LayerGate``): in one more, untimed, decode of fresh
    caches each way, every attention layer's output at every step (on 4x1
    the rows after ``plan.merge_decode``) against flash_decode's plain
    version on the same inputs, within one bf16 unit of the plain output's
    largest |value|. Decode ms a token both ways (each step between syncs
    of the card, the median of the 4), and one more context-parallel step
    under ``torch.profiler``.

``--smoke`` runs both at the archs' smoke configs (2 layers, B 8 x 16, a
cache of 64), which the CPU holds. Rank 0 prints; the script exits
non-zero if a rank fails or a comparison misses its gate. Torch only.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from lm_shard_parity import profiled  # noqa: E402  (tools/)

DBRX, JAMBA = "dbrx-132b", "jamba-v0.1-52b"
RANKS = 4
PARITY_DEPTH, PARITY_STEPS = 4, 4
LONG_CACHE, LONG_STEPS = 524_288, 4     # timed steps, after a warm-up


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _say(rank, *a):
    if rank == 0:
        print(*a, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _config(arch, smoke, depth=None, f32=False):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if smoke:
        cfg = dataclasses.replace(cfg, num_layers=2)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    return dataclasses.replace(cfg, num_layers=depth) if depth else cfg


def _policy(cfg, dev, mesh=None, tp=None):
    from repro_torch.models.policy import BackbonePolicy
    return BackbonePolicy(cfg, device=dev, quantize="int8", mesh=mesh, tp=tp,
                          generator=torch.Generator(dev).manual_seed(0))


def _whole(pol, logits, cp=False):
    """The global (B, V) logits from this rank's block."""
    from repro_torch.distributed import plan as P
    if pol.plan is None:
        return logits.float()
    with P.scope(pol.plan):
        lg = P.gather_nograd(logits, -1, "model")
        if not cp:
            lg = P.gather_nograd(lg, 0, "data")
    return lg.float()


def _forced(pol, prompt, steps, dev):
    """(logits of a prefill and ``steps`` teacher-forced decode steps, the
    median ms of the decode steps after the first, each between syncs)."""
    S = prompt.shape[1]
    lg, _, caches = pol.prefill(pol.rows(prompt[:, :S - steps]), S)
    out, times = [_whole(pol, lg)], []
    for t in range(S - steps, S):
        _sync(dev)
        t0 = time.perf_counter()
        lg, _, caches = pol.decode(pol.rows(prompt[:, t:t + 1]), caches)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        out.append(_whole(pol, lg))
    return out, statistics.median(times[1:])


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


class RoutingLog:
    """Records the experts ``models.moe.route`` picks at each call while it
    is entered (``moe_apply`` looks ``route`` up in its module at each
    call, so the package needs no hook)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        real = self.real = moe.route

        def recorded(params, x, cfg):
            probs, gate, eidx = real(params, x, cfg)
            self.calls.append(eidx.clone())
            return probs, gate, eidx

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.real


def flips_by_step(got: RoutingLog, want: RoutingLog, steps: int) -> list:
    """Tokens whose ordered top-k experts differ between two decodes, summed
    over each step's route calls (the calls of a step are consecutive)."""
    if len(got.calls) != len(want.calls) or len(got.calls) % steps:
        raise AssertionError(f"{len(got.calls)} route calls against "
                             f"{len(want.calls)} over {steps} steps")
    per = len(got.calls) // steps
    return [sum(int((g != w).any(-1).sum()) for g, w in zip(
        got.calls[t * per:(t + 1) * per], want.calls[t * per:(t + 1) * per]))
        for t in range(steps)]


def held_before_flip(rel: list, flips: list, tol: float):
    """(ok, the steps held): every step before the first flip within
    ``tol``; the steps from the first flip on are held to nothing."""
    first = next((t for t, f in enumerate(flips) if f), len(flips))
    return all(r <= tol for r in rel[:first]), first


class LayerGate:
    """Holds each decode attention's output to the plain version on the
    same inputs: ``wrap(fn)`` is a flash_decode backend that runs ``fn``
    (the kernel, or a control) and ``ref.flash_decode`` on the same q, k,
    v and length, and records, at every call (each attention layer of each
    step), the largest |difference| of the two outputs rounded to the
    model's dtype, in units of the bf16 unit of the plain output's largest
    |value| (2^(floor(log2 max|out|) - 7)). On the LSE route (the
    context-parallel decode) both are first merged over the ranks
    (``plan.merge_decode``, a collective every rank runs), so the reading is
    of the merged rows. The gate's limit is one unit: phase 3's hold of the
    kernel at long_500k. Its yardstick runs on the inputs of the decode it
    holds, so a routing flip does not move it: every step is held."""

    LIMIT = 1.0

    def __init__(self):
        self.units = []

    def wrap(self, fn):
        from repro_torch.distributed import plan as P
        from repro_torch.kernels import ref

        def gated(q, k, v, length, with_lse=False):
            got = fn(q, k, v, length, with_lse=with_lse)
            want = ref.flash_decode(q, k, v, length, with_lse=with_lse)
            g, w = (P.merge_decode(*x) if with_lse else x
                    for x in (got, want))
            g, w = (x.to(q.dtype).float() for x in (g, w))
            top = float(w.abs().max())
            unit = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 \
                else 2.0 ** -133
            self.units.append(float((g - w).abs().max()) / unit)
            return got
        return gated

    def by_step(self, steps: int) -> list:
        """The largest reading of each step (its layers' calls)."""
        per = len(self.units) // steps
        return [max(self.units[t * per:(t + 1) * per]) for t in range(steps)]

    def ok(self) -> bool:
        return bool(self.units) and max(self.units) <= self.LIMIT


def _mesh(spec):
    from repro_torch.launch import mesh as tmesh
    return tmesh.make_mesh(tuple(int(x) for x in spec.split("x")),
                           ("data", "model"))


def _peaks(dev):
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))
                         if dev.type == "cuda" else 0.0], device=dev)
    parts = [torch.zeros_like(peak) for _ in range(RANKS)]
    dist.all_gather(parts, peak)
    return [round(float(x) / 2**30, 2) for x in parts]


def _free(dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def dbrx(rank, args, dev) -> bool:
    """(i): dbrx-132b int8, depth 4 against one card, then full size."""
    from repro_torch.rl import actor
    B, T = 8, (16 if args.smoke else 512)
    new = 8 if args.smoke else 64
    ok = True
    cfg4 = _config(DBRX, args.smoke, None if args.smoke else PARITY_DEPTH,
                   f32=True)
    prompt = torch.randint(0, cfg4.vocab_size, (B, T + PARITY_STEPS),
                           generator=torch.Generator(dev).manual_seed(7),
                           device=dev)
    for spec in ("2x2", "1x4"):
        mesh = _mesh(spec)
        pol = _policy(cfg4, dev, tp=mesh.shape["model"])
        want, ms1 = _forced(pol, prompt, PARITY_STEPS, dev)
        del pol
        _free(dev)
        pol = _policy(cfg4, dev, mesh)
        got, ms = _forced(pol, prompt, PARITY_STEPS, dev)
        rel = [_rel(g, w) for g, w in zip(got, want)]
        agree = sum(float((g.argmax(-1) == w.argmax(-1)).float().mean())
                    for g, w in zip(got, want)) / len(got)
        good = max(rel) <= args.tol
        ok &= good
        _say(rank, f"[dbrx] {cfg4.name} int8 {cfg4.num_layers}L --mesh "
                   f"{spec} against one card, B {B} x {T} prefill + "
                   f"{PARITY_STEPS} decode steps: relative L2 error of the "
                   f"logits by step {[f'{r:.3e}' for r in rel]} (gate "
                   f"{args.tol}: {'ok' if good else 'MISSED'}), greedy "
                   f"tokens agree {agree:.4f}; decode {ms:.2f} ms a step "
                   f"sharded, {ms1:.2f} on one card (median of the "
                   f"{PARITY_STEPS - 1} after a warm-up step)")
        del pol, got, want
        _free(dev)
    cfg = _config(DBRX, args.smoke)
    for spec in ("2x2", "1x4"):
        t0 = time.perf_counter()
        pol = _policy(cfg, dev, _mesh(spec))
        _sync(dev)
        init_s = time.perf_counter() - t0
        gen = torch.Generator(dev).manual_seed(11)
        prefill = actor.make_prefill_step(pol, T + new)
        serve = actor.make_serve_step(pol)
        # one warm generate of 2 tokens, then the timed one
        tok, _, caches = prefill(prompt[:, :T], gen)
        serve(tok, caches, gen)
        del caches
        _sync(dev)
        t0 = time.perf_counter()
        tok, _, caches = prefill(prompt[:, :T], gen)
        _sync(dev)
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(new - 1):
            tok, _, caches = serve(tok, caches, gen)
            out.append(tok)
        _sync(dev)
        t2 = time.perf_counter()
        prefill_ms, decode_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3 / (new - 1)
        box = {"tok": tok, "caches": caches}

        def one():
            box["tok"], _, box["caches"] = serve(box["tok"], box["caches"],
                                                 gen)
        prof = "; " + profiled(one, dev) if dev.type == "cuda" else ""
        _say(rank, f"[dbrx] {cfg.name} int8 {cfg.num_layers}L d"
                   f"{cfg.d_model} --mesh {spec}: B {B} x {T} + {new} "
                   f"tokens: prefill {prefill_ms:.2f} ms, decode "
                   f"{decode_ms:.2f} ms a token, "
                   f"{B * new / (t2 - t0):.1f} tok/s; max_memory_allocated "
                   f"a card (GiB) {_peaks(dev)}; init {init_s:.1f} s; "
                   f"tokens finite and in the vocab "
                   f"{bool((torch.cat(out, 1) < cfg.vocab_size).all())}"
                   f"{prof}")
        # the step functions hold the policy: all go before the next mesh
        del pol, caches, out, box, tok, prefill, serve, one
        _free(dev)
    return ok


def _long_caches(pol, cfg, S, dev, seed=13):
    """Global caches of B 1 and S positions, S - 2 - LONG_STEPS filled (a
    warm-up and LONG_STEPS steps, then the profiled one, fill the rest),
    drawn from ``seed`` layer by layer in the caches' dtype."""
    from repro_torch.models import transformer as tr
    g = torch.Generator(dev).manual_seed(seed)
    caches = tr.init_caches(cfg, 1, S, device=dev, tp=pol.tp)
    fill = S - 2 - LONG_STEPS
    for c in caches.kv:
        if c is not None:
            for t in (c.k, c.v):
                for s0 in range(0, fill, 1 << 16):
                    s1 = min(fill, s0 + (1 << 16))
                    t[:, s0:s1].copy_(torch.randn(
                        t[:, s0:s1].shape, generator=g, device=dev))
    for c in caches.ssm:
        if c is not None:
            c.conv.copy_(torch.randn(c.conv.shape, generator=g, device=dev))
            c.state.copy_(0.1 * torch.randn(c.state.shape, generator=g,
                                            device=dev))
    return caches._replace(length=torch.full((), fill, dtype=torch.int32,
                                             device=dev))


def _decode_steps(pol, caches, toks, cp, dev):
    """(the logits of a decode step a token of ``toks``, each step's ms
    between syncs of the card, the caches after them)."""
    out, times = [], []
    for t in range(toks.shape[1]):
        _sync(dev)
        t0 = time.perf_counter()
        lg, _, caches = pol.decode(toks[:, t:t + 1], caches,
                                   context_parallel=cp)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        out.append(_whole(pol, lg, cp=True))
    return out, times, caches


def _ms(times) -> str:
    return (f"{statistics.median(times[1:]):.2f} ms a token (steps "
            f"{', '.join(f'{t:.2f}' for t in times)}, the first a warm-up)")


def long(rank, args, dev) -> bool:
    """(ii): jamba int8 at long_500k, context-parallel on 4x1, against one
    card's decode of the same cache, in f32 and then in bf16."""
    ok = True
    for f32 in (True, False):
        ok &= _long_one(rank, args, dev, f32)
    return ok


def _gated_decode(pol, cfg, S, toks, cp, dev) -> LayerGate:
    """A decode of fresh caches (the timed runs' draw) with flash_decode's
    backend wrapped by a ``LayerGate``: its readings. Untimed."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.flash_decode import flash_decode
    gate = LayerGate()
    caches = _long_caches(pol, cfg, S, dev)
    if cp:
        caches = pol.shard_caches(caches, context_parallel=True)
    backend, fn = (("cuda", flash_decode) if dev.type == "cuda"
                   else ("ref", ref.flash_decode))
    with dispatch.replaced("flash_decode", backend, gate.wrap(fn)):
        _decode_steps(pol, caches, toks, cp, dev)
    del caches
    _free(dev)
    return gate


def _long_one(rank, args, dev, f32) -> bool:
    from repro_torch.kernels import dispatch, ref
    cfg = _config(JAMBA, args.smoke, f32=f32)
    S = 64 if args.smoke else LONG_CACHE
    toks = torch.randint(0, cfg.vocab_size, (1, 1 + LONG_STEPS),
                         generator=torch.Generator(dev).manual_seed(5),
                         device=dev)
    pol = _policy(cfg, dev, _mesh("4x1"))
    glob = _long_caches(pol, cfg, S, dev)
    caches = pol.shard_caches(glob, context_parallel=True)   # copies
    del glob
    _free(dev)
    local = next(c for c in caches.kv if c is not None).k.shape
    with RoutingLog() as cp_routes:
        got, times, caches = _decode_steps(pol, caches, toks, True, dev)
    peaks = _peaks(dev)
    prof = ""
    if dev.type == "cuda":      # one more step, under the profiler
        prof = "; " + profiled(lambda: pol.decode(
            toks[:, :1], caches, context_parallel=True), dev)
    del caches
    _free(dev)
    cp_gate = None if f32 else _gated_decode(pol, cfg, S, toks, True, dev)
    del pol
    _free(dev)
    ok = True
    if rank == 0:
        one = _policy(cfg, dev)
        caches = _long_caches(one, cfg, S, dev)
        with RoutingLog() as kernel_routes:
            want, times1, _ = _decode_steps(one, caches, toks, False, dev)
        rel = [_rel(g, w) for g, w in zip(got, want)]
        gib = torch.cuda.max_memory_allocated(dev) / 2**30 \
            if dev.type == "cuda" else 0.0
        if f32:
            ok = max(rel) <= args.tol
            verdict = f"(gate {args.tol}: {'ok' if ok else 'MISSED'})"
        else:
            del caches
            caches = _long_caches(one, cfg, S, dev)
            with RoutingLog() as plain_routes, dispatch.replaced(
                    "flash_decode", "cuda", ref.flash_decode):
                plain, _, _ = _decode_steps(one, caches, toks, False, dev)
            n = len(plain)
            cp = [_rel(g, p) for g, p in zip(got, plain)]
            own = [_rel(w, p) for w, p in zip(want, plain)]
            cp_flips = flips_by_step(cp_routes, plain_routes, n)
            own_flips = flips_by_step(kernel_routes, plain_routes, n)
            cp_ok, cp_held = held_before_flip(cp, cp_flips, args.bf16_tol)
            own_ok, own_held = held_before_flip(own, own_flips,
                                                args.bf16_tol)
            ok = cp_ok and own_ok
            caches = None
            _free(dev)
            own_gate = _gated_decode(one, cfg, S, toks, False, dev)
            layer_ok = cp_gate.ok() and own_gate.ok()
            ok = ok and layer_ok
            layers = (f"; the attention-output gate (each attention "
                      f"layer's decode output against flash_decode's plain "
                      f"version on the same inputs, largest |difference| "
                      f"in bf16 units of the plain output's largest "
                      f"|value|, limit {LayerGate.LIMIT:g} at every layer "
                      f"and step): the context-parallel decode by step "
                      f"{[f'{u:.3g}' for u in cp_gate.by_step(n)]}, the "
                      f"one card's kernel decode by step "
                      f"{[f'{u:.3g}' for u in own_gate.by_step(n)]}, "
                      f"{'ok' if layer_ok else 'MISSED'}")
            verdict = (f"(no gate: another split of the sequence); from the "
                       f"one card's decode with flash_decode's plain "
                       f"version by step: the context-parallel decode "
                       f"{[f'{r:.3e}' for r in cp]}, routing flips "
                       f"{cp_flips}; the one card's kernel decode "
                       f"{[f'{r:.3e}' for r in own]}, routing flips "
                       f"{own_flips} (held to {args.bf16_tol} before "
                       f"each one's first flip: the first {cp_held} and "
                       f"{own_held} of {n} steps, "
                       f"{'ok' if cp_ok and own_ok else 'MISSED'}; nothing "
                       f"held from a first flip on){layers}")
        print(f"[long] {cfg.name} int8 {cfg.dtype} {cfg.num_layers}L "
              f"d{cfg.d_model} long_500k: B 1, a cache of {S} "
              f"({S - 2 - LONG_STEPS} filled, drawn from the seed), --mesh "
              f"4x1 context-parallel (local KV {tuple(local)}): decode "
              f"{_ms(times)}; max_memory_allocated a card (GiB) "
              f"{peaks}{prof}; one card, the same cache: {_ms(times1)}, "
              f"{gib:.2f} GiB; relative L2 error of the logits by step "
              f"{[f'{r:.3e}' for r in rel]} {verdict}", flush=True)
        del one, caches
        _free(dev)
    flag = torch.tensor([float(ok)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag)


def rank_main(rank, port, args, device_type):
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        kw = {"device_id": dev}
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // RANKS))
        dev, kw = torch.device("cpu"), {}
    if rank > 0:
        sys.stdout = open(os.devnull, "w")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=RANKS,
        timeout=datetime.timedelta(seconds=900), **kw)
    ok = True
    try:
        if args.part in ("dbrx", "all"):
            ok &= dbrx(rank, args, dev)
        if args.part in ("long", "all"):
            ok &= long(rank, args, dev)
    finally:
        dist.destroy_process_group()
    if not ok:
        raise SystemExit(f"rank {rank}: a comparison missed its gate")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--part", default="all", choices=("dbrx", "long", "all"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--bf16-tol", type=float, default=2e-2)
    args = ap.parse_args(argv)
    device_type = torch.device(args.device).type
    if device_type == "cuda" and torch.cuda.device_count() < RANKS:
        raise SystemExit(f"needs {RANKS} cards; this machine has "
                         f"{torch.cuda.device_count()}")
    if device_type == "cuda":
        print(smi(), flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(port, args, device_type), nprocs=RANKS)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
