#!/usr/bin/env python3
"""Two checkouts of the repo against each other on one card: the host time
of a quantised decode-step matmul, and qwen3-0.6b's decode speed in bf16,
int8 and int4.

    python3 tools/quant_decode_ab.py OLD_DIR NEW_DIR [--order 0,1,1,0]

Each turn of ``--order`` is a fresh process that imports ``repro_torch``
from that checkout's ``src`` (both are built first, in parallel, so no turn
pays nvcc). A turn measures, at B 8 and K = N = 1024 (a decode step's
wq), the host microseconds per call of ``params.matmul`` on an int8 weight
(the use site), of ``ops.quant_matmul`` (dispatch and wrapper), of the
wrapper alone and of its C launcher alone through ctypes, and of
``params.matmul`` on the bf16 weight (``x @ w``, which no checkout's
``quant_matmul`` touches: it reads the host's own speed); each is the
median of 5 rounds of 3000 back-to-back calls taken in turns. Then, for
qwen3-0.6b at full width with random weights from seed 0, batch 8, prompt
512 and 64 new tokens (bf16, int8, int4): one ``generate`` (tok/s), then a
prefill and 63 decode steps timed apart (ms/token), and the device time of
8 profiled decode steps. Each turn prints one JSON line. Then one process
of NEW_DIR times its wrapper and C launcher beside OLD_DIR's in turns (the
old wrapper module and library loaded beside the new ones) and profiles
its wrapper with cProfile: one more JSON line. The last line is the
medians of the turns by checkout. The card's name and power limit come
first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, PROMPT, NEW = 8, 512, 64
KERNELS = ("flash_attention", "flash_decode", "quant_matmul")


def host_us(fn, calls=3000):
    """Host microseconds per call of ``fn`` over back-to-back calls."""
    import torch
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def host_times(gen):
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models.params import matmul
    bf = torch.bfloat16
    x = torch.randn((B, 1024), generator=gen, device="cuda").to(bf)
    w = torch.randint(-127, 128, (1024, 1024), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(1024, generator=gen, device="cuda") / (127 * 32)
    quant, plain = {"w": w, "w_scale": s}, {"w": (w.float() * s).to(bf)}
    x3 = x[:, None]
    out = torch.empty((B, 1024), dtype=bf, device="cuda")
    fwd = build.load("quant_matmul").quant_matmul_fwd
    args = (x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), B,
            1024, 1024, x.stride(0), 1, w.stride(0), 1024, 1, 0, 0, 1, 1,
            torch.cuda.current_stream().cuda_stream)
    fns = {"use site": lambda: matmul(quant, "w", x3, bf),
           "ops": lambda: ops.quant_matmul(x, w, s),
           "wrapper": lambda: quant_matmul(x, w, s),
           "C launch": lambda: fwd(*args),
           "bf16 use site": lambda: matmul(plain, "w", x3, bf)}
    us = {k: [] for k in fns}
    for _ in range(5):
        for k, fn in fns.items():
            us[k].append(host_us(fn))
    return {k: statistics.median(v) for k, v in us.items()}


def decode_device_ms(serve, state, steps=8):
    """Device ms per decode step from the profiler's kernel events, or None
    when it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state[0], _, state[1] = serve(state[0], state[1], state[2])
        torch.cuda.synchronize()
    dev = [e.device_time_total for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    return sum(dev) / 1e3 / steps if dev else None


def serve_times(gen):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.policy import BackbonePolicy
    from repro_torch.rl import actor
    cfg = get_config("qwen3-0.6b")
    out = {}
    for q in (None, "int8", "int4"):
        policy = BackbonePolicy(cfg, generator=gen, quantize=q)
        prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                               device="cuda")
        max_len = PROMPT + NEW
        actor.generate(policy, prompt, 2, gen, max_len=max_len)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actor.generate(policy, prompt, NEW, gen, max_len=max_len)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        prefill = actor.make_prefill_step(policy, max_len)
        serve = actor.make_serve_step(policy)
        tok, _, caches = prefill(prompt, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NEW - 1):
            tok, _, caches = serve(tok, caches, gen)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
        tok, _, caches = prefill(prompt, gen)      # room for 8 more steps
        state = [tok, caches, gen]
        out[q or "bf16"] = {"tok/s": B * NEW / total,
                            "decode ms/token": decode_ms,
                            "decode device ms/step":
                                decode_device_ms(serve, state)}
        del policy, caches, state
        torch.cuda.empty_cache()
    return out


def inproc(old: Path):
    """In this checkout's process, its wrapper and C launcher beside the
    old checkout's (its ``quant_matmul.py`` loaded as a second module over
    this checkout's ``build``, its built library loaded by path), timed in
    turns with ``x @ w`` on the bf16 weight; then a cProfile of this
    checkout's wrapper, its top functions by own time."""
    import cProfile
    import ctypes
    import importlib.util
    import pstats
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_matmul import quant_matmul
    spec = importlib.util.spec_from_file_location(
        "old_quant_matmul", old / "src/repro_torch/kernels/quant_matmul.py")
    old_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_mod)
    fn, argtypes = build.SIGNATURES["quant_matmul"]
    old_lib = ctypes.CDLL(str(next(
        (old / "src/repro_torch/kernels/_build").glob("quant_matmul-*.so"))))
    getattr(old_lib, fn).argtypes = argtypes
    getattr(old_lib, fn).restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((B, 1024), generator=gen, device="cuda").to(bf)
    w = torch.randint(-127, 128, (1024, 1024), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(1024, generator=gen, device="cuda") / (127 * 32)
    wb = (w.float() * s).to(bf)
    out = torch.empty((B, 1024), dtype=bf, device="cuda")
    args = (x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), B,
            1024, 1024, x.stride(0), 1, w.stride(0), 1024, 1, 0, 0, 1, 1,
            torch.cuda.current_stream().cuda_stream)
    new_fwd = getattr(build.load("quant_matmul"), fn)
    old_fwd = getattr(old_lib, fn)
    fns = {"wrapper, old": lambda: old_mod.quant_matmul(x, w, s),
           "wrapper, new": lambda: quant_matmul(x, w, s),
           "C launch, old": lambda: old_fwd(*args),
           "C launch, new": lambda: new_fwd(*args),
           "bf16 x @ w": lambda: x @ wb}
    us = {k: [] for k in fns}
    for _ in range(5):
        for k, f in fns.items():
            us[k].append(host_us(f))
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(3000):
        quant_matmul(x, w, s)
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return {"host us, one process": {k: statistics.median(v)
                                     for k, v in us.items()},
            "cProfile of the wrapper, own us a call": {
                f"{Path(f).name}:{line} {name}": tt / 3000 * 1e6
                for (f, line, name), (_, _, tt, _, _) in top}}


def measure():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {"host us": host_times(gen), "serve": serve_times(gen)}


def child(root: Path, *flags) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             *flags], cwd=root, env=env,
                            stdout=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*", type=Path)
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--child", choices=("build", "measure", "inproc"))
    ap.add_argument("--old", type=Path, help="with --child=inproc")
    args = ap.parse_args(argv)
    if args.child == "build":
        from repro_torch.kernels import build
        build.build_all(KERNELS)
        return 0
    if args.child == "measure":
        print(json.dumps(measure()), flush=True)
        return 0
    if args.child == "inproc":
        print(json.dumps(inproc(args.old)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(args.dirs) < 2:
        print("quant_decode_ab: needs a CUDA card and two checkouts",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dirs = [d.resolve() for d in args.dirs]
    builds = [child(d, "--child=build") for d in dirs]
    if any([p.wait() for p in builds]):
        return 1
    turns = {}
    for i in [int(i) for i in args.order.split(",") if i]:
        proc = child(dirs[i], "--child=measure")
        got = proc.communicate()[0]
        if proc.returncode:
            return proc.returncode
        run = json.loads(got.strip().splitlines()[-1])
        print(json.dumps({"dir": str(args.dirs[i]), **run}), flush=True)
        turns.setdefault(str(args.dirs[i]), []).append(run)
    summary = {}
    for d, runs in turns.items():
        med = {"host us": {k: statistics.median(r["host us"][k]
                                                for r in runs)
                           for k in runs[0]["host us"]}}
        for q in runs[0]["serve"]:
            med[q] = {}
            for k in runs[0]["serve"][q]:
                got = [r["serve"][q][k] for r in runs
                       if r["serve"][q][k] is not None]
                med[q][k] = statistics.median(got) if got else None
        summary[d] = med
    proc = child(dirs[1], "--child=inproc", f"--old={dirs[0]}")
    got = proc.communicate()[0]
    if proc.returncode:
        return proc.returncode
    print(got.strip().splitlines()[-1], flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
