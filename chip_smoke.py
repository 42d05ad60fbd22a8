#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one Hopper card (H100) and nvcc. It builds the port's kernels from
``src/repro_torch/kernels/csrc`` and runs five phases, each printing one
line; any failure ends the run with a traceback and a non-zero exit:

  1. device      CUDA present, compute capability 9.x, nvidia-smi name/limit
  2. build       nvcc builds every kernel (one process per source, together)
  3. parity      each kernel against its plain PyTorch version on the card at
                 the serve shapes and edge shapes: bf16 at 2e-2, f32 at 1e-4
                 with TF32 off
  4. full width  qwen3-0.6b in f32 (TF32 off): the cuda and ref backends on
                 prefill last-token logits and 4 teacher-forced decode steps,
                 atol = rtol = 1e-3
  5. serve       qwen3-0.6b in bf16, batch 8, prompt 512, 64 new tokens
                 through ``rl.actor.generate``; the launch counters must read
                 28 (flash_attention) and 28 x 63 (flash_decode); prints
                 prefill ms, decode ms/token, tok/s, a profile of one
                 prefill and 8 decode steps (device time, idle share, top
                 kernels), and each kernel's ms beside its plain version's,
                 its bound and ``scaled_dot_product_attention`` (a yardstick
                 the port never calls)

Then one JSON line of the kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config, with_overrides  # noqa: E402
from repro_torch.kernels import build, dispatch, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.models.policy import BackbonePolicy  # noqa: E402
from repro_torch.rl import actor  # noqa: E402

ARCH = "qwen3-0.6b"
BATCH, PROMPT, NEW = 8, 512, 64
PEAK_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:74"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:65"),
}


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, arg_sets, iters):
    """Mean ms of ``fn`` over ``iters`` calls, cycling through ``arg_sets``
    (together larger than the 50 MB L2, so inputs come from HBM)."""
    for args in arg_sets:
        fn(*args)
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, tol):
    err = max_err(got, want)
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: max abs err {err} beyond "
                             f"atol=rtol={tol}")
    return err


# -- phases -------------------------------------------------------------------

def phase_device():
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        raise RuntimeError(f"compute capability {major}.{minor}, need 9.x")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1 device] {torch.cuda.get_device_name(0)} cc {major}.{minor} "
          f"count {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    t0 = time.perf_counter()
    paths = build.build_all()
    for name in paths:
        build.load(name)
    print(f"[2 build] built and loaded {sorted(paths)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def phase_parity(gen):
    """Each kernel against its plain version; returns the max abs error of
    each kernel at the serve shapes in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {"flash_attention": 0.0, "flash_decode": 0.0}
    cases = 0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        # (B, T, H, K, hd): the serve shape, then ragged and small-head edges
        for shape in ((BATCH, PROMPT, 16, 8, 128), (2, 200, 16, 8, 128),
                      (3, 77, 8, 2, 64), (2, 130, 4, 2, 32)):
            B, T, H, K, hd = shape
            q = randn(gen, (B, T, H, hd), dtype)
            k, v = (randn(gen, (B, T, K, hd), dtype) for _ in range(2))
            err = check_close(f"flash_attention {shape} {dtype}",
                              flash_attention(q, k, v),
                              ref.flash_attention(q, k, v), tol)
            if shape[0] == BATCH and dtype == torch.bfloat16:
                errs["flash_attention"] = err
            cases += 1
        # (B, S, H, K, hd) x cache fill
        S = PROMPT + NEW
        for shape in ((BATCH, S, 16, 8, 128), (3, 100, 8, 2, 64),
                      (2, 64, 4, 1, 32)):
            B, S_, H, K, hd = shape
            for fill in (0.0, 0.6, 1.0):
                q = randn(gen, (B, H, hd), dtype)
                k, v = (randn(gen, (B, S_, K, hd), dtype) for _ in range(2))
                length = torch.tensor(int(fill * (S_ - 1)), dtype=torch.int32,
                                      device="cuda")
                err = check_close(f"flash_decode {shape} fill {fill} {dtype}",
                                  flash_decode(q, k, v, length),
                                  ref.flash_decode(q, k, v, length), tol)
                if shape[0] == BATCH and dtype == torch.bfloat16:
                    errs["flash_decode"] = max(errs["flash_decode"], err)
                cases += 1
    sync()
    print(f"[3 parity] {cases} cases pass; serve-shape bf16 max abs err "
          f"{errs}", flush=True)
    return errs


def phase_full_width_f32(gen):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = with_overrides(get_config(ARCH), dtype="float32",
                         param_dtype="float32")
    policy = BackbonePolicy(cfg, generator=gen)
    B, T, steps = 2, 256, 4
    toks = torch.randint(0, cfg.vocab_size, (B, T + steps), generator=gen,
                         device="cuda")
    logits = {}
    for mode in ("cuda", "ref"):
        with dispatch.using(mode):
            lg, _, caches = policy.prefill(toks[:, :T], T + steps)
            out = [lg]
            for t in range(T, T + steps):
                lg, _, caches = policy.decode(toks[:, t:t + 1], caches)
                out.append(lg)
        logits[mode] = torch.stack(out)
    err = check_close("full-width f32 cuda vs ref", logits["cuda"],
                      logits["ref"], 1e-3)
    print(f"[4 full width] {cfg.name} f32 {cfg.num_layers}L d{cfg.d_model}: "
          f"cuda vs ref logits over prefill + {steps} decode steps, max abs "
          f"err {err} (|logit| max {float(logits['ref'].abs().max())})",
          flush=True)
    del policy, caches
    torch.cuda.empty_cache()


def phase_serve(gen):
    cfg = get_config(ARCH)
    policy = BackbonePolicy(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    max_len = PROMPT + NEW
    actor.generate(policy, prompt, 2, gen, max_len=max_len)     # warm-up
    sync()

    build.reset_launches()
    t0 = time.perf_counter()
    out = actor.generate(policy, prompt, NEW, gen, max_len=max_len)
    sync()
    total_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want = {"flash_attention": cfg.num_layers,
            "flash_decode": cfg.num_layers * (NEW - 1)}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if out.shape != (BATCH, NEW) or out.dtype != torch.int32 or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {out.shape} {out.dtype}")

    # the same path split into its two phases, for their times
    prefill = actor.make_prefill_step(policy, max_len)
    serve = actor.make_serve_step(policy)
    t0 = time.perf_counter()
    tok, value, caches = prefill(prompt, gen)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    lg, _, _ = policy.prefill(prompt, max_len)
    if not (bool(torch.isfinite(lg[:, :cfg.vocab_size]).all())
            and bool(torch.isfinite(value).all())):
        raise AssertionError("non-finite prefill logits or values")
    t0 = time.perf_counter()
    for _ in range(NEW - 1):
        tok, _, caches = serve(tok, caches, gen)
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    tok_s = BATCH * NEW / total_s
    print(f"[5 serve] {cfg.name} bf16 B{BATCH} prompt {PROMPT} +{NEW} tokens: "
          f"generate {total_s * 1e3:.1f} ms, {tok_s:.1f} tok/s; prefill "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms/token; launches "
          f"{launches}", flush=True)

    # where the time goes: one profiled prefill, then 8 profiled decode steps
    state = {}

    def run_prefill():
        state["tok"], _, state["caches"] = prefill(prompt, gen)

    def run_decode():
        state["tok"], _, state["caches"] = serve(state["tok"], state["caches"],
                                                 gen)

    profile_steps("prefill", run_prefill, 1, prefill_ms)
    profile_steps("decode step", run_decode, 8, decode_ms)
    del policy, caches
    torch.cuda.empty_cache()
    return launches


def profile_steps(label, fn, steps, wall_ms):
    """Profile ``steps`` calls of ``fn``; print the device time per step
    against ``wall_ms`` (the same step timed without the profiler), the
    device's idle share, the kernels run per step and the top kernels."""
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        sync()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"[5 serve] {label}: device time not measured (the profiler "
              f"saw no device events)", flush=True)
        return
    by_name: dict = {}
    for e in dev:
        name = e.name.replace("void ", "").replace("(anonymous namespace)::",
                                                   "")
        name = re.split(r"[<(]", name)[0].split("::")[-1]
        by_name[name] = by_name.get(name, 0.0) + e.device_time_total / 1e3
    busy = sum(by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[5 serve] {label}: device {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle {100 * (1 - busy / wall_ms):.1f}%), {len(dev) / steps:.0f} "
          f"device ops/step; top: " + ", ".join(
              f"{n[:40]} {t / steps:.3f} ms" for n, t in top), flush=True)


def kernel_rows(gen, launches, errs):
    """Times at the serve shapes: kernel, plain version, SDPA, and bound."""
    bf = torch.bfloat16
    H, K, hd = 16, 8, 128
    rows = []

    # prefill attention: 4 input sets of 33.6 MB
    fa_sets = [(randn(gen, (BATCH, PROMPT, H, hd), bf),
                randn(gen, (BATCH, PROMPT, K, hd), bf),
                randn(gen, (BATCH, PROMPT, K, hd), bf)) for _ in range(4)]
    flops = 2 * BATCH * H * hd * PROMPT * (PROMPT + 1)   # causal pairs only
    nbytes = 2 * (2 * BATCH * PROMPT * H * hd + 2 * BATCH * PROMPT * K * hd)
    rows.append(("flash_attention", flops, nbytes,
                 cuda_ms(flash_attention, fa_sets, 20),
                 cuda_ms(ref.flash_attention, fa_sets, 10),
                 cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                     q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     is_causal=True, enable_gqa=True), fa_sets, 20)))
    del fa_sets

    # decode attention at the last serve step: 6 cache sets of 18.9 MB
    S = PROMPT + NEW
    L = S - 2                                        # newest valid index
    length = torch.tensor(L, dtype=torch.int32, device="cuda")
    fd_sets = [(randn(gen, (BATCH, H, hd), bf),
                randn(gen, (BATCH, S, K, hd), bf),
                randn(gen, (BATCH, S, K, hd), bf), length) for _ in range(6)]
    flops = 4 * BATCH * H * hd * (L + 1)
    nbytes = 2 * (2 * BATCH * (L + 1) * K * hd + 2 * BATCH * H * hd)
    rows.append(("flash_decode", flops, nbytes,
                 cuda_ms(flash_decode, fd_sets, 200),
                 cuda_ms(ref.flash_decode, fd_sets, 50),
                 cuda_ms(lambda q, k, v, n: F.scaled_dot_product_attention(
                     q[:, :, None], k[:, :L + 1].transpose(1, 2),
                     v[:, :L + 1].transpose(1, 2), enable_gqa=True),
                     fd_sets, 200)))
    del fd_sets

    out = []
    for name, flops, nbytes, ms, plain_ms, lib_ms in rows:
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        src, replaces = KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib_ms})
        print(f"[5 serve] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms by "
              f"{out[-1]['bound_by']}: {flops:.4g} FLOP, {nbytes:.4g} B)",
              flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = phase_device()
    phase_build()
    errs = phase_parity(gen)
    phase_full_width_f32(gen)
    launches = phase_serve(gen)
    rows = kernel_rows(gen, launches, errs)
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
