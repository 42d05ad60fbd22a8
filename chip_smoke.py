#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one Hopper card (H100) and nvcc. It builds the port's kernels from
``src/repro_torch/kernels/csrc`` and runs six phases, each printing its
lines; any failure ends the run with a traceback and a non-zero exit:

  1. device      CUDA present, compute capability 9.x, nvidia-smi name/limit
  2. build       nvcc builds every kernel (one process per source, together)
  3. parity      each kernel against its plain PyTorch version on the card at
                 the serve and training shapes and edge shapes: attention
                 bf16 at 2e-2, f32 at 1e-4 with TF32 off; GAE f32 at 1e-5;
                 SSD (y and h_last) bf16 at the serve shape at 2e-2, f32 at
                 edge shapes (ragged T, T = 1, T < chunk, x a strided view,
                 stride-0 B_/C, two groups) at 1e-4
  4. full width  qwen3-0.6b and mamba2-1.3b in f32 (TF32 off): the cuda and
                 ref backends on prefill last-token logits and 4
                 teacher-forced decode steps, atol = rtol = 1e-3
  5. serve       qwen3-0.6b, then mamba2-1.3b, in bf16, batch 8, prompt 512,
                 64 new tokens through ``rl.actor.generate``; the launch
                 counters must read 28 (flash_attention), 28 x 63
                 (flash_decode), 0 (gae, ssd) for qwen3 and 48 (ssd), 0 (the
                 others) for mamba2; prints prefill ms, decode ms/token,
                 tok/s, a profile of one prefill and 8 decode steps (device
                 time, idle share, top kernels), and each kernel's ms beside
                 its plain version's, its bound and, for attention,
                 ``scaled_dot_product_attention`` (a yardstick the port never
                 calls)
  6. train       Ocean PPO through ``rl.trainer.Trainer`` on the card, f32:
                 (a) bandit and squared solve (score >= 0.9) at their presets
                 (64 envs x 64 steps, hidden 64, seed 0) within 150k / 300k
                 steps; (b) each of the eight envs runs 2 updates at 4096
                 envs x 64 steps with finite metrics; (c) full size: squared
                 at 4096 envs x 64 steps (262,144 transitions per update),
                 4 epochs x 4 minibatches, hidden 128, K = 1: 2 warm-up and
                 5 timed updates, one launch under
                 ``torch.cuda.set_sync_debug_mode("error")``, one update split
                 into rollout and learn; the counters must read one gae
                 launch per update and 0 for the others; prints
                 sps, rollout / learn / launch ms per update, and a profile
                 of one update; then the GAE kernel's ms beside its plain
                 version's and its bound

Then one JSON line of the kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import itertools
import json
import math
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
from repro_torch.configs.ocean import ocean_tcfg, preset  # noqa: E402
from repro_torch.envs.ocean import OCEAN  # noqa: E402
from repro_torch.kernels import build, dispatch, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.gae import gae  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.models.policy import BackbonePolicy  # noqa: E402
from repro_torch.rl import actor  # noqa: E402
from repro_torch.rl.engine import METRIC_KEYS  # noqa: E402
from repro_torch.rl.trainer import Trainer  # noqa: E402

ARCH, SSM_ARCH = "qwen3-0.6b", "mamba2-1.3b"
BATCH, PROMPT, NEW = 8, 512, 64
PEAK_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:74"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:65"),
    "gae": ("src/repro_torch/kernels/csrc/gae.cu",
            "src/repro/kernels/gae_scan.py:56"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/kernels/ssd.py:69"),
}
# mamba2-1.3b's SSD at the serve shape: heads, head dim, state, groups, chunk
SSD_H, SSD_P, SSD_N, SSD_G, SSD_Q = 64, 64, 128, 1, 128
TRAIN_ENVS, TRAIN_UNROLL = 4096, 64     # the full-size training update
GAMMA, LAM = 0.95, 0.95                 # ocean_tcfg's gamma, TrainConfig's


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
    errs = {"flash_attention": 0.0, "flash_decode": 0.0, "gae": 0.0,
            "ssd": 0.0}
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
    # GAE at the training shapes: (B, T) views of (T, B)-stored tensors, as
    # the learner passes them, and a ragged B
    for B, T in ((TRAIN_ENVS, TRAIN_UNROLL), (64, 64), (1000, 37)):
        for done_p in (0.0, 0.1, 0.5):
            r, v, d, lv = gae_inputs(gen, B, T, done_p)
            err = check_close(f"gae ({B}, {T}) done_p {done_p}",
                              gae(r.T, v.T, d.T, lv, GAMMA, LAM),
                              ref.gae(r.T, v.T, d.T, lv, GAMMA, LAM), 1e-5)
            if B == TRAIN_ENVS:
                errs["gae"] = max(errs["gae"], err)
            cases += 1
    # SSD: the serve shape in bf16 as models/ssm.py hands it over, then
    # edge shapes in f32 (B, T, H, P, N, G, chunk, x a view of the conv
    # output)
    for shape, dtype, tol in (
            ((BATCH, PROMPT, SSD_H, SSD_P, SSD_N, SSD_G, SSD_Q, True),
             torch.bfloat16, 2e-2),
            ((2, 300, 4, 64, 128, 1, 128, False), torch.float32, 1e-4),
            ((2, 1, 4, 64, 128, 1, 128, True), torch.float32, 1e-4),
            ((3, 50, 4, 16, 16, 1, 128, True), torch.float32, 1e-4),
            ((2, 200, 8, 64, 128, 1, 128, True), torch.float32, 1e-4),
            ((2, 96, 4, 16, 16, 2, 16, True), torch.float32, 1e-4),
            ((2, 64, 3, 16, 32, 3, 16, False), torch.float32, 1e-4),
            ((1, 70, 2, 128, 128, 1, 128, False), torch.float32, 1e-4)):
        B, T, H, P, N, G, Q, view = shape
        args = ssd_inputs(gen, B, T, H, P, N, G, dtype, view)
        (y, h), (ry, rh) = ssd(*args, chunk=Q), ref.ssd(*args)
        err = max(check_close(f"ssd y {shape} {dtype}", y, ry, tol),
                  check_close(f"ssd h_last {shape} {dtype}", h, rh, tol))
        if B == BATCH:
            errs["ssd"] = err
        cases += 1
    sync()
    print(f"[3 parity] {cases} cases pass; max abs err at the serve shapes "
          f"(bf16) and the training shape (gae, f32): {errs}", flush=True)
    return errs


def ssd_inputs(gen, B, T, H, P, N, G, dtype, view):
    """SSD inputs as models/ssm.py hands them to the kernel: B_ and C slices
    of one (B, T, H*P + 2*G*N) conv-output buffer, each head h reading group
    h // (H/G) (a stride-0 view for one group, a copy for more), and with
    ``view`` x a slice of the same buffer; dt = softplus(normal) and
    A = -exp(0.3 normal), as the JAX package's test_ssd_sweep draws them."""
    buf = randn(gen, (B, T, H * P + 2 * G * N), dtype) * 0.5
    x = buf[..., :H * P].unflatten(-1, (H, P)) if view \
        else randn(gen, (B, T, H, P), dtype) * 0.5
    bc = [buf[..., H * P + i * G * N:H * P + (i + 1) * G * N]
          .unflatten(-1, (G, N)).unsqueeze(-2).expand(B, T, G, H // G, N)
          .flatten(-3, -2) for i in range(2)]
    dt = F.softplus(torch.randn((B, T, H), generator=gen, device="cuda"))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device="cuda"))
    return x, dt, A, bc[0], bc[1]


def gae_inputs(gen, B, T, done_p):
    """(T, B)-stored rewards, values (f32) and dones (bool), (B,) last
    value."""
    r, v = (torch.randn((T, B), generator=gen, device="cuda")
            for _ in range(2))
    d = torch.rand((T, B), generator=gen, device="cuda") < done_p
    lv = torch.randn(B, generator=gen, device="cuda")
    return r, v, d, lv


def phase_full_width_f32(gen, arch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = with_overrides(get_config(arch), dtype="float32",
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
          f"err {err} (|logit| max "
          f"{float(logits['ref'][..., :cfg.vocab_size].abs().max())})",
          flush=True)
    del policy, caches
    torch.cuda.empty_cache()


def serve_launches(cfg):
    """The kernel launches one ``generate`` of NEW tokens must make: one
    prefill kernel per attention or SSM layer, one decode kernel per
    attention layer and step (SSM layers decode without a kernel)."""
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    return {"flash_attention": attn, "flash_decode": attn * (NEW - 1),
            "ssd": cfg.num_layers - attn, "gae": 0}


def phase_serve(gen, arch):
    cfg = get_config(arch)
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
    want = serve_launches(cfg)
    if any(launches[k] != n for k, n in want.items()):
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

    profile_steps("5 serve", f"{cfg.name} prefill", run_prefill, 1,
                  prefill_ms)
    profile_steps("5 serve", f"{cfg.name} decode step", run_decode, 8,
                  decode_ms)
    del policy, caches
    torch.cuda.empty_cache()
    return launches


def device_times(fn, steps):
    """Run ``fn`` ``steps`` times under the profiler; returns (device ms by
    kernel name, device ops), or (None, 0) if it saw no device events."""
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        sync()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None, 0
    by_name: dict = {}
    for e in dev:
        name = e.name.replace("void ", "").replace("(anonymous namespace)::",
                                                   "")
        name = re.split(r"[<(]", name)[0].split("::")[-1]
        by_name[name] = by_name.get(name, 0.0) + e.device_time_total / 1e3
    return by_name, len(dev)


def profile_steps(tag, label, fn, steps, wall_ms):
    """Profile ``steps`` calls of ``fn``; print the device time per step
    against ``wall_ms`` (the same step timed without the profiler), the
    device's idle share, the kernels run per step and the top kernels."""
    by_name, ops = device_times(fn, steps)
    if by_name is None:
        print(f"[{tag}] {label}: device time not measured (the profiler "
              f"saw no device events)", flush=True)
        return
    busy = sum(by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[{tag}] {label}: device {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle {100 * (1 - busy / wall_ms):.1f}%), {ops / steps:.0f} "
          f"device ops/step; top: " + ", ".join(
              f"{n[:40]} {t / steps:.3f} ms" for n, t in top), flush=True)


def phase_train():
    """Ocean PPO on the card through the Trainer: solve, every env, and the
    full-size update. Returns the launch counts of the full-size run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # (a) solve at the presets
    for name in ("bandit", "squared"):
        p = preset(name)
        tr = Trainer(OCEAN[name](), ocean_tcfg(name), hidden=p.hidden,
                     recurrent=p.recurrent, seed=0)
        t0 = time.perf_counter()
        m = tr.train(p.total_steps, target_score=p.target_score)
        wall = time.perf_counter() - t0
        if not m["score"] >= p.target_score:
            raise AssertionError(f"{name} unsolved in {p.total_steps} steps: "
                                 f"score {m['score']}")
        print(f"[6 train] (a) {name} SOLVED score {m['score']:.3f} at "
              f"{m['env_steps']} env steps (budget {p.total_steps}) in "
              f"{wall:.2f} s wall", flush=True)

    # (b) every env: 2 updates at the full batch
    for name in OCEAN:
        p = preset(name)
        tr = Trainer(OCEAN[name](), ocean_tcfg(name, num_envs=TRAIN_ENVS),
                     hidden=p.hidden, recurrent=p.recurrent, seed=0)
        sync()
        t0 = time.perf_counter()
        tr.train(2 * tr.steps_per_update)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        last = tr.history[-1]
        bad = [k for k in METRIC_KEYS if not math.isfinite(last[k])]
        if len(tr.history) != 2 or bad:
            raise AssertionError(f"{name}: {len(tr.history)} updates, "
                                 f"non-finite {bad}")
        print(f"[6 train] (b) {name}: 2 updates of {tr.steps_per_update} "
              f"transitions, {ms:.1f} ms/update, score {last['score']:.3f}, "
              f"episodes {last['episodes']:.0f}", flush=True)

    # (c) the full-size update
    tcfg = ocean_tcfg("squared", num_envs=TRAIN_ENVS)
    tr = Trainer(OCEAN["squared"](), tcfg, hidden=128, seed=0,
                 updates_per_launch=1)
    eng = tr.engine
    spu = eng.steps_per_update
    eng.run(2 * spu)                                    # warm-up
    sync()
    build.reset_launches()
    updates = 0
    t0 = time.perf_counter()
    hist, _ = eng.run(5 * spu)
    sync()
    wall = time.perf_counter() - t0
    updates += len(hist)
    torch.cuda.set_sync_debug_mode("error")             # no sync in a launch
    ring = eng.launch(1)
    torch.cuda.set_sync_debug_mode(0)
    updates += 1
    sync()
    launches = dict(build.LAUNCHES)
    want = {"gae": updates, "flash_attention": 0, "flash_decode": 0,
            "ssd": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"launch counts {launches}, expected {want}")
    # one more update through the engine's own two halves, for their times;
    # its result is dropped, so the engine's state stays as it was
    t1 = time.perf_counter()
    _, batch = eng.update.collect(eng.ts, eng.rc, eng.generator)
    sync()
    t2 = time.perf_counter()
    eng.update.learn(eng.ts, *batch, eng.generator)
    sync()
    t3 = time.perf_counter()
    if not (bool(torch.isfinite(ring).all()) and all(
            math.isfinite(h[k]) for h in hist for k in METRIC_KEYS)):
        raise AssertionError("non-finite metrics in the full-size run")
    update_ms = wall * 1e3 / len(hist)
    launch_ms = sum(h["launch_ms"] for h in hist) / len(hist)
    print(f"[6 train] (c) squared full size: {TRAIN_ENVS} envs x "
          f"{tcfg.unroll_length} steps = {spu} transitions/update, "
          f"{tcfg.update_epochs} epochs x {tcfg.num_minibatches} minibatches "
          f"of {spu // tcfg.num_minibatches}, hidden 128, K 1: "
          f"{len(hist) * spu / wall:.0f} sps, {update_ms:.2f} ms/update "
          f"(launch {launch_ms:.2f} ms); split update: rollout "
          f"{(t2 - t1) * 1e3:.2f} ms, learn {(t3 - t2) * 1e3:.2f} ms; a "
          f"launch ran under sync debug mode 'error'; score "
          f"{hist[-1]['score']:.3f}; launches {launches} over {updates} "
          f"updates", flush=True)
    profile_steps("6 train", "full-size update", lambda: eng.launch(1), 1,
                  update_ms)
    del tr, eng, batch
    torch.cuda.empty_cache()
    return launches


def kernel_rows(gen, launches, errs):
    """Times at the main paths' shapes: kernel, plain version, library call
    (SDPA for attention; none for GAE and SSD), and bound."""
    bf = torch.bfloat16
    H, K, hd = 16, 8, 128
    rows = []

    # prefill attention: 4 input sets of 33.6 MB
    fa_sets = [(randn(gen, (BATCH, PROMPT, H, hd), bf),
                randn(gen, (BATCH, PROMPT, K, hd), bf),
                randn(gen, (BATCH, PROMPT, K, hd), bf)) for _ in range(4)]
    flops = 2 * BATCH * H * hd * PROMPT * (PROMPT + 1)   # causal pairs only
    nbytes = 2 * (2 * BATCH * PROMPT * H * hd + 2 * BATCH * PROMPT * K * hd)
    rows.append(("flash_attention", flops, PEAK_FLOPS, nbytes,
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
    rows.append(("flash_decode", flops, PEAK_FLOPS, nbytes,
                 cuda_ms(flash_decode, fd_sets, 200),
                 cuda_ms(ref.flash_decode, fd_sets, 50),
                 cuda_ms(lambda q, k, v, n: F.scaled_dot_product_attention(
                     q[:, :, None], k[:, :L + 1].transpose(1, 2),
                     v[:, :L + 1].transpose(1, 2), enable_gqa=True),
                     fd_sets, 200)))
    del fd_sets

    # GAE at the full-size update: 24 input sets of 2.4 MB (57 MB). The
    # kernel's ms is its device time from the profiler: back-to-back event
    # timing of a ~us kernel would time the host's launch rate instead.
    B, T = TRAIN_ENVS, TRAIN_UNROLL
    gae_sets = [gae_inputs(gen, B, T, 0.1) for _ in range(24)]
    cycle = itertools.cycle(gae_sets)

    def gae_call():
        r, v, d, lv = next(cycle)
        return gae(r.T, v.T, d.T, lv, GAMMA, LAM)

    for _ in range(len(gae_sets)):
        gae_call()
    calls = 96
    by_name, _ = device_times(gae_call, calls)
    if by_name is None or "gae_kernel" not in by_name:
        raise AssertionError("the profiler saw no gae_kernel")
    gae_ms = by_name["gae_kernel"] / calls
    host_ms = cuda_ms(lambda r, v, d, lv: gae(r.T, v.T, d.T, lv, GAMMA, LAM),
                      gae_sets, 200)
    plain_ms = cuda_ms(lambda r, v, d, lv: ref.gae(r.T, v.T, d.T, lv, GAMMA,
                                                   LAM), gae_sets, 10)
    flops = 8 * B * T
    nbytes = (4 + 4 + 1 + 4) * B * T + 4 * B
    rows.append(("gae", flops, PEAK_F32_FLOPS, nbytes, gae_ms, plain_ms,
                 None))
    print(f"[6 train] gae: one call back to back with CUDA events (host "
          f"launch time included) {host_ms:.4f} ms; no single PyTorch call "
          f"computes GAE, so there is no library time", flush=True)
    del gae_sets

    # SSD at mamba2's serve shape, laid out as models/ssm.py gives it: 3
    # input sets of 36.7 MB (110 MB)
    ssd_sets = [ssd_inputs(gen, BATCH, PROMPT, SSD_H, SSD_P, SSD_N, SSD_G,
                           bf, True) for _ in range(3)]
    flops, nbytes = ssd_work(BATCH, PROMPT, SSD_H, SSD_P, SSD_N, SSD_G,
                             SSD_Q, 2)
    rows.append(("ssd", flops, PEAK_FLOPS, nbytes,
                 cuda_ms(lambda *a: ssd(*a, chunk=SSD_Q), ssd_sets, 20),
                 cuda_ms(ref.ssd, ssd_sets, 3), None))
    del ssd_sets

    out = []
    for name, flops, peak, nbytes, ms, plain_ms, lib_ms in rows:
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        src, replaces = KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib_ms})
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {max(t_ops, t_bytes):.4f} ms by "
              f"{out[-1]['bound_by']}: {flops:.4g} FLOP, {nbytes:.4g} B)",
              flush=True)
    return out


def ssd_work(B, T, H, P, N, G, Q, elem):
    """(FLOP, bytes) the SSD function needs: per (b, h) and chunk of q
    steps, C.B^T (2 q^2 N), the masked product with x (2 q^2 P), the
    carried state's term (2 q P N) and the state update (2 q P N); x read
    and y written in the input type, dt read and h_last written in f32, B_
    and C read once per group."""
    flops = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        flops += B * H * (2 * q * q * (N + P) + 4 * q * P * N)
    nbytes = (2 * B * T * H * P * elem + 4 * B * T * H
              + 2 * B * T * G * N * elem + 4 * B * H * P * N)
    return flops, nbytes


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = phase_device()
    phase_build()
    errs = phase_parity(gen)
    phase_full_width_f32(gen, ARCH)
    phase_full_width_f32(gen, SSM_ARCH)
    launches = phase_serve(gen, ARCH)
    launches["ssd"] = phase_serve(gen, SSM_ARCH)["ssd"]
    launches["gae"] = phase_train()["gae"]
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
