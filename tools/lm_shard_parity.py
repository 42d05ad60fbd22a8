#!/usr/bin/env python3
"""The LM FSDP/TP plan over 4 ranks: agreement between meshes, and a
model one card cannot hold.

    python3 tools/lm_shard_parity.py [--device cuda|cpu] [--smoke]
        [--part parity|train|all] [--ranks 4]

Spawns ``--ranks`` ranks (NCCL over as many cards on ``cuda``, gloo on
``cpu``) and runs, in one process group:

(i) parity: stablelm-12b at full width, depth 4, in f32 (TF32 off), one
    ``make_lm_train_step`` at B 4 x T 64 on each mesh of the ranks
    (``2x2``, ``1x4``, ``4x1`` at 4 ranks) against the unsharded step on
    one card, which every rank runs first from the same seed: the loss,
    grad_norm and each rank's blocks of the gradients (read back from the
    first moments) against the same blocks of the unsharded step's,
    within ``--tol`` (1e-4; the gradients relative to each leaf's
    largest). The updated params are held within 2 x lr: AdamW's first
    step moves each by about lr · sign(g), so a gradient entry near zero
    that float rounding flips moves its param by 2 x lr.
(ii) train: gemma-7b at full width and full depth (28 layers) in bf16
    through the launcher (``launch.train --arch gemma-7b --mesh M``), B 8
    x T 256, ``--steps`` 10 steps on ``4x1`` and then ``2x2``: the median
    ms a step, tokens/s, each card's peak memory, the collectives a step,
    and one more step under ``torch.profiler`` on rank 0 (device ms, the
    device's idle share, the NCCL kernels' time) with its kernel
    launches.

``--smoke`` runs both at the archs' smoke configs (stablelm depth 2 with 4
KV heads, B 4 x T 16; gemma B 8 x T 16, 2 steps), which the CPU holds. Rank 0 prints; the
script exits non-zero if a rank fails or (i) disagrees. Torch only.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

MESHES = {4: ("2x2", "1x4", "4x1"), 2: ("1x2", "2x1"), 1: ("1x1",)}
PARITY_ARCH, TRAIN_ARCH = "stablelm-12b", "gemma-7b"
# the unsharded f32 step holds params, gradients and two moments, old and
# new: 7 copies of 8.6 GB at depth 4, where depth 8 needs 91 GB of the 80
PARITY_DEPTH = 4


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _mesh(spec):
    from repro_torch.launch import mesh as tmesh
    shape = tuple(int(x) for x in spec.split("x"))
    return tmesh.make_mesh(shape, ("data", "model"))


def _say(rank, *a):
    if rank == 0:
        print(*a, flush=True)


def parity(rank, args, dev):
    """(i): every mesh's step against the unsharded one."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs import with_overrides
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.buffer import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.policy import BackbonePolicy
    from repro_torch.optim.adamw import tree_map
    from repro_torch.rl.learner import init_train_state, make_lm_train_step

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    base = get_smoke_config(PARITY_ARCH) if args.smoke else \
        get_config(PARITY_ARCH)
    # at smoke size 4 KV heads, so that no mesh pads them (tp 4 would pad
    # the smoke config's 2 to 4, another model); the full config has 8
    cfg = with_overrides(base, dtype="float32", param_dtype="float32",
                         num_layers=2 if args.smoke else PARITY_DEPTH,
                         **({"num_kv_heads": 4} if args.smoke else {}))
    B, T = 4, (16 if args.smoke else 64)
    tcfg = TrainConfig(warmup_steps=0)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def batch():
        return random_batch(cfg, B, T, torch.Generator(
            device=dev).manual_seed(1))

    def grads(st, m):
        """The step's gradients, read back from the first moments:
        m = (1 - b1) · clip · g after one step."""
        clip = min(1.0, tcfg.max_grad_norm / max(float(m["grad_norm"]),
                                                 1e-12)) \
            if tcfg.max_grad_norm else 1.0
        return tree_map(lambda x: x / ((1 - tcfg.adam_b1) * clip), st.opt.m)

    t0 = time.perf_counter()
    pol = BackbonePolicy(cfg, device=dev, generator=gen())
    st, m = make_lm_train_step(pol, tcfg, loss_chunk=T)(
        init_train_state(pol.params()), batch())
    want = {k: float(v) for k, v in m.items()}
    ref, ref_g = st.params, grads(st, m)
    del pol, st
    _say(rank, f"[parity] {cfg.name} f32 {cfg.num_layers}L d{cfg.d_model} "
               f"B {B} T {T}: the unsharded step on one card, loss "
               f"{want['loss']:.7f} grad_norm {want['grad_norm']:.7f} "
               f"({time.perf_counter() - t0:.1f} s)")
    lr = float(m["lr"])
    worst = 0.0
    for spec in MESHES[args.ranks]:
        mesh = _mesh(spec)
        t0 = time.perf_counter()
        pol = BackbonePolicy(cfg, device=dev, generator=gen(), mesh=mesh)
        step = make_lm_train_step(pol, tcfg, loss_chunk=T)
        shd.reset_collectives()
        st, m = step(init_train_state(pol.params()), batch())
        coll = dict(shd.COLLECTIVES)
        ps = pol.pspecs(shd.make_rules(mesh))
        g_err, p_err = [], []

        def block(r, s):
            return r[pol.plan.block(r.shape, s)].float()
        tree_map(lambda x, r, s: g_err.append(
            float((x.float() - block(r, s)).abs().max())
            / max(float(r.abs().max()), 1e-30)), grads(st, m), ref_g, ps)
        tree_map(lambda x, r, s: p_err.append(
            float((x.float() - block(r, s)).abs().max())), st.params, ref,
            ps)
        err = torch.tensor([max(g_err), max(p_err) / lr] + [
            abs(float(m[k]) - want[k]) / max(abs(want[k]), 1e-30)
            for k in ("loss", "grad_norm")], device=dev)
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        err = err.tolist()
        worst = max(worst, err[0], err[2], err[3])
        _say(rank, f"[parity] --mesh {spec} (dp {pol.plan.dp}, tp "
                   f"{pol.plan.tp}): loss {float(m['loss']):.7f} grad_norm "
                   f"{float(m['grad_norm']):.7f}; against the unsharded "
                   f"step: gradients apart by {err[0]:.3g} of their leaf's "
                   f"largest at worst, loss by {err[2]:.3g}, grad_norm by "
                   f"{err[3]:.3g} (relative), the updated params by "
                   f"{err[1]:.3g} x lr at worst; collectives {coll}; "
                   f"{time.perf_counter() - t0:.1f} s")
        if err[1] > 2.0 + 1e-3:
            raise AssertionError(f"--mesh {spec}: a param moved {err[1]} x "
                                 f"lr away from the unsharded step's")
        del pol, step, st
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if worst > args.tol:
        raise AssertionError(f"the meshes disagree with the unsharded step "
                             f"by {worst:.3g} > {args.tol}")


def train(rank, args, dev):
    """(ii): gemma-7b at full depth through the launcher on each mesh."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch_train

    cfg = get_smoke_config(TRAIN_ARCH) if args.smoke else \
        get_config(TRAIN_ARCH)
    B, T = 8, (16 if args.smoke else 256)
    steps = 2 if args.smoke else args.steps
    for spec in ("4x1", "2x2") if args.ranks == 4 else MESHES[args.ranks]:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        argv = ["--arch", TRAIN_ARCH, "--mesh", spec, "--batch", str(B),
                "--seq", str(T), "--steps", str(steps), "--save-every", "0",
                "--device", str(dev)] + (["--smoke"] if args.smoke else [])
        run = launch_train.main(argv)
        wall = time.perf_counter() - t0
        step_ms = run.loop.monitor.median * 1e3
        peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))
                             if dev.type == "cuda" else 0.0], device=dev)
        peaks = [torch.zeros_like(peak) for _ in range(args.ranks)]
        dist.all_gather(peaks, peak)
        batch = next(run.batches(0))
        box = {"ts": run.state}

        def one():
            box["ts"], _ = run.step(box["ts"], batch)
        build.reset_launches()
        if dev.type == "cuda":
            prof = "; " + profiled(one, dev)
        else:
            one()
            prof = ""
        prof += f"; its launches {dict(build.LAUNCHES)}"
        m = run.metrics
        _say(rank, f"[train] {cfg.name} {cfg.dtype} {cfg.num_layers}L "
                   f"d{cfg.d_model} --mesh {spec}, B {B} x T {T}, {steps} "
                   f"steps: median step {step_ms:.2f} ms, "
                   f"{B * T / step_ms * 1e3:.0f} tokens/s, last loss "
                   f"{float(m['loss']):+.4f} grad_norm "
                   f"{float(m['grad_norm']):.3f}; max_memory_allocated a "
                   f"card (GiB) "
                   f"{[round(float(x) / 2**30, 2) for x in peaks]}; "
                   f"{wall:.1f} s with the build{prof}")
        del run, box, batch


def profiled(fn, dev) -> str:
    """One call of ``fn`` under ``torch.profiler``: the device's busy time
    as the union of its kernels' intervals (the NCCL stream runs beside
    the compute stream, so a sum of kernel times can pass the wall), the
    NCCL kernels' share of it, and the idle share against the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    ivs = sorted((e.time_range.start, e.time_range.end, "nccl" in e.name)
                 for e in p.events() if e.device_type == DeviceType.CUDA)
    if not ivs:
        return "the profiler saw no device time (not measured)"
    busy, nccl, end = 0.0, 0.0, None
    for a, b, is_nccl in ivs:
        nccl += (b - a) * is_nccl
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    busy, nccl = busy / 1e3, nccl / 1e3
    return (f"a profiled step: device busy {busy:.2f} ms of {wall:.2f} ms "
            f"wall (idle {100 * (1 - busy / wall):.1f}%), NCCL kernels "
            f"{nccl:.2f} ms of it (summed, overlapping the compute)")


def rank_main(rank, port, args, device_type):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        kw = {"device_id": dev}
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.ranks))
        dev, kw = torch.device("cpu"), {}
    if rank > 0:
        sys.stdout = open(os.devnull, "w")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=args.ranks, timeout=datetime.timedelta(seconds=600), **kw)
    try:
        if args.part in ("parity", "all"):
            parity(rank, args, dev)
        if args.part in ("train", "all"):
            train(rank, args, dev)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4, choices=sorted(MESHES))
    ap.add_argument("--part", default="all",
                    choices=("parity", "train", "all"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-4)
    args = ap.parse_args(argv)
    device_type = torch.device(args.device).type
    if device_type == "cuda" and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"--ranks {args.ranks} needs {args.ranks} cards; "
                         f"this machine has {torch.cuda.device_count()}")
    if device_type == "cuda":
        print(smi(), flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(port, args, device_type), nprocs=args.ranks)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
