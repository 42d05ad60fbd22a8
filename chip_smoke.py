#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one Hopper card (H100) and nvcc. It builds the port's kernels from
``src/repro_torch/kernels/csrc`` and runs nine phases, each printing its
lines; any failure ends the run with a traceback and a non-zero exit:

  1. device      CUDA present, compute capability 9.x, nvidia-smi name/limit
  2. build       nvcc builds every kernel (one process per source, together)
  3. parity      each kernel against its plain PyTorch version on the card at
                 the serve and training shapes and edge shapes: attention
                 bf16 at 2e-2, f32 at 1e-4 with TF32 off; GAE f32 at 1e-5;
                 SSD (y and h_last) bf16 at the serve shape at 2e-2, f32 at
                 edge shapes (ragged T, T = 1, T < chunk, x a strided view,
                 stride-0 B_/C, two groups) at 1e-4
                 quant_matmul (int8 and int4 weights, x in bf16 at 2e-2
                 and f32 at 1e-4) at the seven serve shapes, M = 8 and
                 4096 (the tied unembed, 151936 x 1024 read as (N, K), at
                 M = 8), and edge shapes (M = 1, ragged N and K, a strided
                 x, a tiled scale, K below a tile); pack exactly
                 (``torch.equal``) at the host tier's act shape, the bytes
                 emulation of Spaces' obs at 4096 envs and edge shapes (one
                 leaf, 1-byte leaves, odd widths at unaligned offsets, B = 1,
                 a strided row view, more leaves than one launch holds)
  4. full width  qwen3-0.6b and mamba2-1.3b in f32 (TF32 off), then
                 qwen3-0.6b with int8 weights: the cuda and ref backends on
                 prefill last-token logits and 4 teacher-forced decode steps,
                 atol = rtol = 1e-3
  5. serve       qwen3-0.6b, then mamba2-1.3b, then qwen3-0.6b with int8 and
                 with int4 weights, in bf16, batch 8, prompt 512, 64 new
                 tokens through ``rl.actor.generate``; the launch counters
                 must read 28 (flash_attention), 28 x 63 (flash_decode), 0
                 (gae, ssd, quant_matmul, pack) for qwen3, 48 (ssd) and 0 (the
                 others) for mamba2, and 64 x (28 x 6 + 1) (quant_matmul) on
                 top of qwen3's for the quantised runs; prints prefill ms,
                 decode ms/token,
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
                 of one update
  7. emulation   ``Emulated(env, mode="bytes")`` for spaces and multiagent
                 steps 4096 envs on the card: one pack launch per step, the
                 obs equal to the ref path's byte for byte, and unemulate
                 then emulate gives them back
  8. pool        the pool tier through ``Trainer(backend="pool")``: (a)
                 bandit and squared solve at their presets; (b) full size:
                 squared on 2 buffers of 4096 envs x 64 steps, hidden 128: 2
                 warm-up and 5 timed updates, one more under sync debug mode
                 "error" up to its enqueue; the counters must read one gae
                 per update and 0 pack; prints sps, ms per update and a
                 profile of one run of one update
  9. host        the host tier through ``bridge.make_host_engine`` on
                 threads: bandit must solve at its preset (N 64, M 128,
                 unroll 64), squared runs its preset budget (its score is
                 printed, not required); the counters must read one pack per
                 act step and one gae per update; a profile of one update of
                 squared; then squared on the proc backend through the
                 launcher in a subprocess (N 8, M 16 spawned workers, 4
                 updates), whose printed counters must agree the same way

Kernel rows: each kernel's ms at its main path's shapes beside its plain
version's, its bound and a library call. pack's row is timed by CUDA-graph
replay at the host tier's act shape, with ``torch.cat`` as its library
call, and a line before it times it at a full-size trajectory's bytes
emulation, whose inputs exceed the L2. quant_matmul's row is the total
over one int8 ``generate`` of its device times at each serve shape (printed
on the lines before it, timed by CUDA-graph replay), beside the same totals
of the plain version, the bound and ``torch.matmul`` on the
already-dequantised bf16 weight.

Then one JSON line of the kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import ast
import itertools
import json
import math
import os
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

from repro_torch.bridge import make_host_engine  # noqa: E402
from repro_torch.configs import get_config, with_overrides  # noqa: E402
from repro_torch.configs.ocean import ocean_tcfg, preset  # noqa: E402
from repro_torch.core.emulation import (Emulated, emulate,  # noqa: E402
                                        unemulate)
from repro_torch.envs.ocean import OCEAN  # noqa: E402
from repro_torch.envs.ocean_host import OCEAN_HOST  # noqa: E402
from repro_torch.kernels import build, dispatch, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.gae import gae  # noqa: E402
from repro_torch.kernels.pack import MAX_LEAVES, pack  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.models.params import matmul  # noqa: E402
from repro_torch.models.policy import BackbonePolicy  # noqa: E402
from repro_torch.rl import actor  # noqa: E402
from repro_torch.rl.engine import (METRIC_KEYS,  # noqa: E402
                                   act_transfer_spec)
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
    "quant_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:43"),
    "pack": ("src/repro_torch/kernels/csrc/pack.cu",
             "src/repro/kernels/pack.py:29"),
}
# mamba2-1.3b's SSD at the serve shape: heads, head dim, state, groups, chunk
SSD_H, SSD_P, SSD_N, SSD_G, SSD_Q = 64, 64, 128, 1, 128
# qwen3-0.6b's quantised products (K, N) per layer: wq, wk, wv, wo, mlp wi,
# mlp wo; and the tied unembed, the (V, d) table read as (N, K)
QMM_LAYER = ((1024, 2048), (1024, 1024), (1024, 1024), (2048, 1024),
             (1024, 6144), (3072, 1024))
QMM_UNEMBED = (1024, 151936)
QMM_EDGES = (  # (M, K, N, transposed, scale length or None, x row pad)
    (1, 1024, 1024, False, None, 0), (5, 999, 1001, False, None, 24),
    (37, 1001, 999, True, None, 8), (300, 77, 130, False, None, 0),
    (8, 1024, 2048, False, 128, 0), (200, 1024, 2048, False, 128, 0),
    (17, 3, 5, False, None, 0), (8, 4096, 64, False, None, 0))
TRAIN_ENVS, TRAIN_UNROLL = 4096, 64     # the full-size training update
GAMMA, LAM = 0.95, 0.95                 # ocean_tcfg's gamma, TrainConfig's
HOST_N = 64                             # the host tier's preset batch (M 128)
PROC_N, PROC_UPDATES = 8, 4             # the proc-backend run: M 16 workers


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
    # quant_matmul: the serve shapes at decode and prefill M, the unembed at
    # decode M, then the edge shapes; int8 and int4, x in bf16 and f32
    errs["quant_matmul"] = 0.0
    serve = [(M, K, N, False, None, 0) for K, N in QMM_LAYER
             for M in (BATCH, BATCH * PROMPT)]
    serve.append((BATCH, *QMM_UNEMBED, True, None, 0))
    for qtype in ("int8", "int4"):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            for shape in serve + list(QMM_EDGES):
                M, K, N, trans, S, pad = shape
                x, w, s = qmm_inputs(gen, M, K, N, trans, S, pad, qtype,
                                     dtype)
                err = check_close(f"quant_matmul {shape} {qtype} {dtype}",
                                  quant_matmul(x, w, s, trans),
                                  ref.quant_matmul(x, w, s, trans), tol)
                if shape in serve and qtype == "int8" and \
                        dtype == torch.bfloat16:
                    errs["quant_matmul"] = max(errs["quant_matmul"], err)
                cases += 1
    # pack: exact, at the host tier's act shape, the bytes emulation of
    # Spaces' obs at 4096 envs and the edge shapes
    errs["pack"] = 0.0
    for what, leaves in pack_cases(gen).items():
        got, want = pack(leaves), ref.pack(leaves)
        if not (got.is_contiguous() and torch.equal(got, want)):
            raise AssertionError(f"pack {what}: differs from torch.cat")
        errs["pack"] = max(errs["pack"], max_err(got, want))
        cases += 1
    sync()
    print(f"[3 parity] {cases} cases pass; max abs err at the serve shapes "
          f"(bf16; quant_matmul int8), the training shape (gae, f32) and "
          f"the host tier's shapes (pack, exact): {errs}", flush=True)
    return errs


def u8(gen, B, n):
    return torch.randint(0, 256, (B, n), generator=gen, device="cuda",
                         dtype=torch.uint8)


def f32_bytes(gen, B, n):
    """(B, 4n) uint8: the bytes of (B, n) normal f32, as emulate makes."""
    return torch.randn((B, n), generator=gen, device="cuda").view(torch.uint8)


def pack_cases(gen):
    base = u8(gen, 300, 64)
    return {
        "host act (B 64: action 4, logp 4, value 4)":
            [u8(gen, HOST_N, 4), f32_bytes(gen, HOST_N, 1),
             f32_bytes(gen, HOST_N, 1)],
        "spaces obs (B 4096: flat 16, image 36)":
            [f32_bytes(gen, TRAIN_ENVS, 4), f32_bytes(gen, TRAIN_ENVS, 9)],
        "one leaf": [u8(gen, 257, 48)],
        "1-byte leaves": [u8(gen, 100, 1) for _ in range(5)],
        "odd widths at unaligned offsets":
            [u8(gen, 333, n) for n in (3, 17, 4, 33)],
        "B = 1": [u8(gen, 1, n) for n in (7, 16, 5)],
        "strided row view": [base[:, 5:21], base[:, 32:64], u8(gen, 300, 2)],
        f"more than {MAX_LEAVES} leaves":
            [u8(gen, 70, 1 + i % 5) for i in range(2 * MAX_LEAVES + 11)],
    }


def qmm_inputs(gen, M, K, N, transposed, S, pad, qtype, dtype):
    """quant_matmul inputs: x (M, K) normal (a view with row stride K + pad
    when pad), integer weights uniform in [-qmax, qmax] stored (K, N) or
    (N, K) (int4 packed), and a positive f32 scale of length S (tiled) or of
    the stored last axis, scaled so that outputs are of order 1."""
    qmax = 127 if qtype == "int8" else 7
    ints = torch.randint(-qmax, qmax + 1, (N, K) if transposed else (K, N),
                         generator=gen, device="cuda", dtype=torch.int8)
    w = ref.pack_int4(ints) if qtype == "int4" else ints
    S = S or (K if transposed else N)
    s = torch.rand(S, generator=gen, device="cuda") * 2 / (qmax * K ** 0.5)
    x = randn(gen, (M, K + pad), dtype)[:, pad // 2:pad // 2 + K]
    return x, w, s


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


def phase_full_width_f32(gen, arch, quantize=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = with_overrides(get_config(arch), dtype="float32",
                         param_dtype="float32")
    policy = BackbonePolicy(cfg, generator=gen, quantize=quantize)
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
    print(f"[4 full width] {cfg.name} f32 {cfg.num_layers}L d{cfg.d_model}"
          f"{f' {quantize} weights' if quantize else ''}: "
          f"cuda vs ref logits over prefill + {steps} decode steps, max abs "
          f"err {err} (|logit| max "
          f"{float(logits['ref'][..., :cfg.vocab_size].abs().max())})",
          flush=True)
    del policy, caches
    torch.cuda.empty_cache()


def serve_launches(cfg, quantize=None):
    """The kernel launches one ``generate`` of NEW tokens must make: one
    prefill kernel per attention or SSM layer, one decode kernel per
    attention layer and step (SSM layers decode without a kernel); with
    quantised weights one quant_matmul per matmul weight and forward (NEW
    forwards: the prefill and NEW - 1 decode steps), the unembed included."""
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    per_forward = (4 * attn + 2 * (cfg.num_layers - attn)
                   + 2 * cfg.num_layers * (cfg.d_ff > 0) + 1)
    return {"flash_attention": attn, "flash_decode": attn * (NEW - 1),
            "ssd": cfg.num_layers - attn, "gae": 0, "pack": 0,
            "quant_matmul": NEW * per_forward if quantize else 0}


def phase_serve(gen, arch, quantize=None):
    cfg = get_config(arch)
    policy = BackbonePolicy(cfg, generator=gen, quantize=quantize)
    name = f"{cfg.name}{f' {quantize}' if quantize else ''}"
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
    want = serve_launches(cfg, quantize)
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
    print(f"[5 serve] {name} bf16 B{BATCH} prompt {PROMPT} +{NEW} tokens: "
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

    profile_steps("5 serve", f"{name} prefill", run_prefill, 1,
                  prefill_ms)
    profile_steps("5 serve", f"{name} decode step", run_decode, 8,
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
            "ssd": 0, "quant_matmul": 0, "pack": 0}
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


def phase_emulation(gen):
    """Emulation's bytes mode on the card: ``Emulated(env, mode="bytes")``
    steps 4096 envs; its obs equal the ``ref`` path's (``torch.cat``) byte
    for byte, and ``unemulate`` then ``emulate`` gives them back."""
    for name in ("spaces", "multiagent"):
        em = Emulated(OCEAN[name](), mode="bytes")
        state, _ = em.reset(em.env.init(TRAIN_ENVS, gen), gen)
        A = em.num_agents
        lead = (TRAIN_ENVS, A) if A > 1 else (TRAIN_ENVS,)
        act = torch.randint(0, 2, lead + (em.act_spec.num_components,),
                            generator=gen, device="cuda", dtype=torch.int32)
        before = build.LAUNCHES["pack"]
        state, obs, _, _, _ = em.step(state, act, gen)
        if build.LAUNCHES["pack"] != before + 1:
            raise AssertionError("the bytes-mode step did not launch pack")
        with dispatch.using("ref"):
            want = emulate(em.obs_spec, em.env.obs(state))
        back = emulate(em.obs_spec, unemulate(em.obs_spec, obs))
        if not (obs.dtype == torch.uint8 and torch.equal(obs, want)
                and torch.equal(back, obs)):
            raise AssertionError(f"bytes emulation of {name} differs")
        print(f"[7 emulation] {name} bytes mode at {TRAIN_ENVS} envs: obs "
              f"{tuple(obs.shape)} uint8 equal to the ref path, round trip "
              f"exact", flush=True)


def check_launches(tag, want):
    launches = dict(build.LAUNCHES)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{tag}: launch counts {launches}, expected "
                             f"{want}")
    return launches


def tier_profile(tag, label, run_one):
    """Wall time of one ``run_one()`` (a run of a few updates; it ends in a
    synchronise), then the same under the profiler: device time and idle
    share over the run."""
    sync()
    t0 = time.perf_counter()
    run_one()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    profile_steps(tag, label, run_one, 1, wall_ms)


def phase_pool():
    """The pool tier through ``Trainer(backend="pool")``: bandit and squared
    solve at their presets, then the full-size squared update (2 buffers of
    4096 envs, unroll 64). Returns the launch counts of the full-size run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("bandit", "squared"):
        p = preset(name)
        tr = Trainer(OCEAN[name](), ocean_tcfg(name, engine_backend="pool"),
                     hidden=p.hidden, recurrent=p.recurrent, seed=0)
        t0 = time.perf_counter()
        m = tr.train(p.total_steps, target_score=p.target_score)
        wall = time.perf_counter() - t0
        if not m["score"] >= p.target_score:
            raise AssertionError(f"pool {name} unsolved in {p.total_steps} "
                                 f"steps: score {m['score']}")
        print(f"[8 pool] (a) {name} SOLVED score {m['score']:.3f} at "
              f"{m['env_steps']} env steps (budget {p.total_steps}) in "
              f"{wall:.2f} s wall", flush=True)

    tcfg = ocean_tcfg("squared", num_envs=TRAIN_ENVS, engine_backend="pool")
    tr = Trainer(OCEAN["squared"](), tcfg, hidden=128, seed=0)
    eng = tr.engine
    spu = eng.steps_per_update
    eng.run(2 * spu)                                    # warm-up
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    hist, _ = eng.run(5 * spu)
    sync()
    wall = time.perf_counter() - t0
    # one more update, its host work under sync debug mode "error" from the
    # first env step to the update's enqueue (the metrics drain after it)
    torch.cuda.set_sync_debug_mode("error")
    try:
        guarded, _ = eng.run(spu, on_launch=lambda u: (
            torch.cuda.set_sync_debug_mode(0)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    updates = len(hist) + len(guarded)
    launches = check_launches("pool tier", {
        "gae": updates, "pack": 0, "flash_attention": 0, "flash_decode": 0,
        "ssd": 0, "quant_matmul": 0})
    if not all(math.isfinite(h[k]) for h in hist + guarded
               for k in METRIC_KEYS):
        raise AssertionError("non-finite metrics in the pool-tier run")
    update_ms = wall * 1e3 / len(hist)
    print(f"[8 pool] (b) squared full size: {tcfg.pool_buffers} buffers x "
          f"{TRAIN_ENVS} envs x {tcfg.unroll_length} steps, {spu} "
          f"transitions/update, {tcfg.update_epochs} epochs x "
          f"{tcfg.num_minibatches} minibatches, hidden 128: "
          f"{len(hist) * spu / wall:.0f} sps, {update_ms:.2f} ms/update "
          f"(learn enqueue {sum(h['launch_ms'] for h in hist) / len(hist):.2f}"
          f" ms); an update ran under sync debug mode 'error'; score "
          f"{hist[-1]['score']:.3f}; act steps {eng.act_steps}; launches "
          f"{launches} over {updates} updates", flush=True)
    tier_profile("8 pool", "full size, one run of 5 updates",
                 lambda: eng.run(5 * spu))
    del tr, eng
    torch.cuda.empty_cache()
    return launches


def host_run(name, backend="thread"):
    """``--host-env name`` at its preset, in process (what the launcher
    does): returns (engine, final metrics, updates, wall s). The engine is
    left open for its profile; the caller closes it."""
    p = preset(name)
    tcfg = ocean_tcfg(name, engine_backend="host", host_backend=backend)
    eng = make_host_engine(OCEAN_HOST[name], tcfg, hidden=p.hidden,
                           recurrent=p.recurrent, seed=0)
    t0 = time.perf_counter()
    hist, solved = eng.run(p.total_steps, target_score=p.target_score)
    wall = time.perf_counter() - t0
    m = solved if solved is not None else hist[-1]
    if not all(math.isfinite(h[k]) for h in hist for k in METRIC_KEYS):
        raise AssertionError(f"non-finite metrics in host/{name}")
    status = "SOLVED" if m["score"] >= p.target_score else "unsolved"
    print(f"[9 host] host/{name} threads M {eng.hvec.num_envs} N "
          f"{eng.hvec.batch_envs}: {status} score {m['score']:.3f} at "
          f"{m['env_steps']} env steps (budget {p.total_steps}), "
          f"{len(hist)} updates, {eng.act_steps} act steps, "
          f"{m['env_steps'] / wall:.0f} sps over {wall:.2f} s wall",
          flush=True)
    return eng, m, len(hist), status


def phase_host():
    """The host tier: bandit on threads must solve at its preset; squared
    runs its preset budget (no run of the reference shows a host-tier
    squared solve); then squared on the proc backend through the launcher,
    in a subprocess (spawned workers re-import its torch-free module), N 8,
    M 16, 4 updates. Every act step packs its outputs with one pack launch;
    every update runs one gae. Returns the launch counts of the two thread
    runs."""
    build.reset_launches()
    act_steps = updates = 0
    for name in ("bandit", "squared"):
        eng, m, n, status = host_run(name)
        try:
            act_steps += eng.act_steps
            updates += n
            if name == "bandit" and status != "SOLVED":
                raise AssertionError(f"host/bandit unsolved: {m}")
        finally:
            eng.close()
    launches = check_launches("host tier", {
        "pack": act_steps, "gae": updates, "flash_attention": 0,
        "flash_decode": 0, "ssd": 0, "quant_matmul": 0})
    print(f"[9 host] launches {launches} over {updates} updates and "
          f"{act_steps} act steps ({act_steps / updates:.1f} pack launches "
          f"per update)", flush=True)

    # where the time goes: 3 updates of host/squared, wall and profiled;
    # then the act step alone (device act, pack, copy, numpy cut) against
    # the wall time of a batch
    p = preset("squared")
    eng = make_host_engine(OCEAN_HOST["squared"],
                           ocean_tcfg("squared", engine_backend="host"),
                           hidden=p.hidden, seed=0)
    try:
        eng.run(eng.steps_per_update)                   # warm-up
        eng.act_steps = 0
        t0 = time.perf_counter()
        eng.run(3 * eng.steps_per_update)
        batch_ms = (time.perf_counter() - t0) * 1e3 / eng.act_steps
        tier_profile("9 host", "host/squared, one run of 3 updates",
                     lambda: eng.run(3 * eng.steps_per_update))
        obs, _, done, _, ids = eng.hvec.recv(timeout=60.0)
        spec = act_transfer_spec(eng.hvec.act_spec)
        staging = torch.empty((eng.batch_size, spec.total),
                              dtype=torch.uint8, pin_memory=True)
        n = 200
        t0 = time.perf_counter()
        for _ in range(n):
            action = eng._act_to_host(spec, obs, None, done, staging)[0]
        act_ms = (time.perf_counter() - t0) * 1e3 / n
        eng.hvec.send(action, ids)
        print(f"[9 host] host/squared act step (obs to the card, act, one "
              f"pack, one {spec.total * eng.batch_size}-byte copy, numpy "
              f"cut): {act_ms:.3f} ms of {batch_ms:.3f} ms wall per batch of "
              f"{eng.hvec.batch_envs} envs ({100 * act_ms / batch_ms:.1f}%)",
              flush=True)
    finally:
        eng.close()

    steps = PROC_UPDATES * TRAIN_UNROLL * PROC_N
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--host-env",
           "squared", "--host-backend", "proc", "--num-envs", str(PROC_N),
           "--total-env-steps", str(steps), "--full-budget"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"proc-backend launcher exit {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    line = next(ln for ln in r.stdout.splitlines() if "act_steps=" in ln)
    got = re.search(r"updates=(\d+) act_steps=(\d+) launches=(\{.*\})",
                    line)
    n_upd, n_act = int(got.group(1)), int(got.group(2))
    proc_launches = ast.literal_eval(got.group(3))
    if n_upd != PROC_UPDATES or proc_launches["pack"] != n_act or \
            proc_launches["gae"] != n_upd:
        raise AssertionError(f"proc run: {line}")
    print(f"[9 host] host/squared proc backend through the launcher (M "
          f"{2 * PROC_N} spawned workers, N {PROC_N}, {PROC_UPDATES} "
          f"updates) in {wall:.1f} s wall, interpreter start and spawn "
          f"included:{line.split('->')[1]}", flush=True)
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

    rows.append(pack_row(gen))

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
    out.append(qmm_row(gen, launches, errs))
    return out


def pack_row(gen):
    """pack at the host tier's act shape (B 64 rows of action, logp and
    value: 12 bytes), then at the bytes emulation of a full-size trajectory
    of Spaces' obs (262,144 rows of 16 + 36 bytes; four input sets of 13.6
    MB, so they come from HBM): device ms per call by CUDA-graph replay of
    the kernel, its plain version and ``torch.cat`` (the same function; the
    yardstick the port never calls on the card)."""
    def times(sets, calls):
        return (graph_ms(lambda *l: pack(l), sets, calls),
                graph_ms(lambda *l: ref.pack(l), sets, calls),
                graph_ms(lambda *l: torch.cat(l, dim=-1), sets, calls))

    act_sets = [(u8(gen, HOST_N, 4), f32_bytes(gen, HOST_N, 1),
                 f32_bytes(gen, HOST_N, 1)) for _ in range(16)]
    nbytes = 2 * HOST_N * 12
    ms, plain_ms, lib_ms = times(act_sets, 64)
    big = [(f32_bytes(gen, TRAIN_ENVS * TRAIN_UNROLL, 4),
            f32_bytes(gen, TRAIN_ENVS * TRAIN_UNROLL, 9)) for _ in range(4)]
    big_bytes = 2 * TRAIN_ENVS * TRAIN_UNROLL * 52
    big_ms, big_plain, big_lib = times(big, 8)
    print(f"[kernel] pack (B {TRAIN_ENVS * TRAIN_UNROLL}, leaves of 16 and "
          f"36 bytes, inputs from HBM): {big_ms:.4f} ms (plain "
          f"{big_plain:.4f} ms, torch.cat {big_lib:.4f} ms, bound "
          f"{big_bytes / PEAK_BYTES * 1e3:.4f} ms by bytes: {big_bytes} B, "
          f"{big_bytes / big_ms / 1e6:.1f} GB/s)", flush=True)
    del big
    return ("pack", 0, PEAK_FLOPS, nbytes, ms, plain_ms, lib_ms)


def graph_ms(fn, arg_sets, calls, replays=5):
    """Device ms per call of ``fn``: ``calls`` calls cycling through
    ``arg_sets``, captured once in a CUDA graph and replayed, between CUDA
    events. At a few microseconds a call, events around back-to-back eager
    calls would time the host's launch rate instead; and in this long
    process the profiler has been seen to drop kernel events of some of its
    sessions."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up outside the capture
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    sync()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def qmm_row(gen, launches, errs):
    """quant_matmul at qwen3-0.6b's serve shapes, int8 and int4: device ms
    per call (``graph_ms``) of the kernel, its plain version and
    ``torch.matmul`` on the dequantised bf16 weight (the product the kernel
    replaces), with ``torch._weight_int8pack_mm`` where this torch runs it
    on CUDA (given x already scaled for the unembed, whose scale lies on
    K); inputs cycled through > 64 MB. The row is the total over one int8
    generate: each shape's time times its calls per generate."""
    bf = torch.bfloat16
    L = get_config(ARCH).num_layers
    shapes = [(BATCH * PROMPT, K, N, False, L) for K, N in QMM_LAYER]
    shapes += [(BATCH, K, N, False, L * (NEW - 1)) for K, N in QMM_LAYER]
    shapes.append((BATCH, *QMM_UNEMBED, True, NEW))
    total = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "ops": 0.0, "bytes": 0.0,
             "int8pack": 0.0}
    int8pack_missing = set()
    for M, K, N, trans, calls in shapes:
        flops = 2 * M * K * N
        line = []
        for qtype in ("int8", "int4"):
            wbytes = K * N // (2 if qtype == "int4" else 1)
            nbytes = 2 * M * K + wbytes + 4 * (K if trans else N) + 2 * M * N
            nsets = max(2, min(64, math.ceil(64e6 / nbytes)))
            sets = [qmm_inputs(gen, M, K, N, trans, None, 0, qtype, bf)
                    for _ in range(nsets)]
            n = 64 if M == BATCH else 8
            ms = graph_ms(lambda x, w, s: quant_matmul(x, w, s, trans),
                          sets, n)
            t_ops = flops / PEAK_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            by = "bytes" if t_bytes >= t_ops else "operations"
            line.append(f"{qtype} {ms:.4f} ms (bound "
                        f"{max(t_ops, t_bytes):.4f} by {by})")
            if qtype == "int8":
                plain = graph_ms(lambda x, w, s: ref.quant_matmul(
                    x, w, s, trans), sets[:2], 4)
                deq = [(x, (w.float() * s).to(bf)) for x, w, s in sets]
                lib = graph_ms(lambda x, d: x @ (d.t() if trans else d),
                               deq, n)
                total["ms"] += calls * ms
                total["plain"] += calls * plain
                total["lib"] += calls * lib
                if t_ops >= t_bytes:
                    total["ops"] += calls * t_ops
                else:
                    total["bytes"] += calls * t_bytes
                line.append(f"plain {plain:.4f} ms, torch.matmul on the "
                            f"dequantised bf16 weight {lib:.4f} ms")
                del deq
                # a yardstick only: the port never calls it
                packed = [((x * s).to(bf), w, torch.ones(
                    N, dtype=bf, device="cuda")) if trans else
                          (x, w.t().contiguous(), s.to(bf))
                          for x, w, s in sets]
                try:
                    pack_ms = graph_ms(torch._weight_int8pack_mm, packed, n)
                    total["int8pack"] += calls * pack_ms
                    line.append(f"torch._weight_int8pack_mm {pack_ms:.4f} "
                                f"ms")
                except (RuntimeError, NotImplementedError, TypeError,
                        AttributeError) as e:
                    int8pack_missing.add(type(e).__name__)
                    line.append("torch._weight_int8pack_mm does not run "
                                f"here ({type(e).__name__}: "
                                f"{str(e).splitlines()[0][:80]})")
                del packed
            del sets
        print(f"[kernel] quant_matmul M {M} K {K} N {N}"
              f"{' (N, K) layout' if trans else ''}, {calls} per generate: "
              + "; ".join(line), flush=True)
    bound = total["ops"] + total["bytes"]
    int8pack = (f"{total['int8pack']:.4f} ms" if not int8pack_missing else
                f"not run at every shape ({', '.join(int8pack_missing)})")
    row = {"name": "quant_matmul", "route": "cuda",
           "source": KERNELS["quant_matmul"][0],
           "replaces": KERNELS["quant_matmul"][1],
           "launches": launches["quant_matmul"],
           "max_abs_err": errs["quant_matmul"], "ms": total["ms"],
           "plain_ms": total["plain"], "bound_ms": bound,
           "bound_by": "operations" if total["ops"] >= total["bytes"]
           else "bytes", "library_ms": total["lib"]}
    print(f"[kernel] quant_matmul over one int8 generate: {row['ms']:.4f} ms "
          f"(plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
          f"ms, bound {bound:.4f} ms: {total['ops']:.4f} ms of it by "
          f"operations, {total['bytes']:.4f} ms by bytes); "
          f"torch._weight_int8pack_mm: {int8pack}", flush=True)
    qmm_host_time(gen)
    torch.cuda.empty_cache()
    return row


def host_us(fn, calls=3000):
    """Host microseconds per call of ``fn`` over back-to-back calls (the
    device work of each is a few microseconds and overlaps)."""
    for _ in range(200):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def qmm_host_time(gen):
    """What a decode-step matmul costs the host, at K = N = 1024, B 8:
    ``params.matmul`` on a quantised weight (dispatch, checks, the ctypes
    launch) against the same call on a bf16 weight (``x @ w``)."""
    bf = torch.bfloat16
    x, w, s = qmm_inputs(gen, BATCH, 1024, 1024, False, None, 0, "int8", bf)
    quant = {"w": w, "w_scale": s}
    plain = {"w": (w.float() * s).to(bf)}
    x = x[:, None]
    q_us = host_us(lambda: matmul(quant, "w", x, bf))
    b_us = host_us(lambda: matmul(plain, "w", x, bf))
    calls = 6 * get_config(ARCH).num_layers + 1
    print(f"[kernel] quant_matmul host time per decode-step call (B {BATCH}, "
          f"K = N = 1024, params.matmul): {q_us:.2f} us quantised, "
          f"{b_us:.2f} us on the bf16 weight; {calls} calls per decode step",
          flush=True)


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
    phase_full_width_f32(gen, ARCH, quantize="int8")
    launches = phase_serve(gen, ARCH)
    launches["ssd"] = phase_serve(gen, SSM_ARCH)["ssd"]
    launches["quant_matmul"] = phase_serve(gen, ARCH, "int8")["quant_matmul"]
    phase_serve(gen, ARCH, "int4")
    launches["gae"] = phase_train()["gae"]
    phase_emulation(gen)
    phase_pool()
    launches["pack"] = phase_host()["pack"]
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
