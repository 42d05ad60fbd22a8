#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one Hopper card (H100) and nvcc. It builds the port's kernels from
``src/repro_torch/kernels/csrc`` and runs seventeen phases, each printing its
lines (and a ``[time]`` line after each, the script's seconds so far); any
failure ends the run with a traceback and a non-zero exit:

  1. device      CUDA present, compute capability 9.x, nvidia-smi name/limit
  2. build       nvcc builds every kernel (one process per source, together);
                 beside it a second compile of ssd.cu, flash_decode.cu,
                 flash_attention.cu, quant_matmul.cu, flash_attention_bwd.cu
                 and ssd_bwd.cu with ``-Xptxas -v`` prints each kernel's
                 registers and spills
                 (none allowed in the serve-path instances, the bf16
                 forward and decode at hd 160 and 256 among them, nor in
                 flash_attention_bwd's wgmma kernels at hd 128 nor in
                 ssd_bwd's tensor-core kernel, ``NO_SPILLS``), and
                 ``cuobjdump -sass`` of the
                 built libraries counts tensor-core (HMMA, HGMMA) and
                 asynchronous-copy (LDGSTS, UTMALDG) instructions
                 by instance (``SASS_NEEDS`` says which each must have)
  3. parity      each kernel against its plain PyTorch version on the card at
                 the serve and training shapes and edge shapes: attention
                 (``FA_CASES``: the serve shape, ragged T, T = 1, T = 65,
                 S > T, S < T, non-causal, MQA, MHA, an odd group, every
                 head dim) bf16 at 2e-2, f32 at 1e-4 with TF32 off;
                 decode attention (``fd_cases``: the serve shape and two
                 small ones at three fills, the lengths 0, split - 1,
                 split, split + 1 and S - 1 of ``flash_decode.plan`` at S
                 576, 100, 577, 1000 and at B 64, 1 to 20 query heads a KV
                 head at every head dim, strided cache and q views whose
                 two calls must agree bit for bit) at the same tolerances;
                 GAE f32 at 1e-5 (``GAE_CASES``: B 1 to 10,000, T 1 to
                 1000, two calls bit for bit);
                 SSD (y and h_last) bf16 at the serve shape at 2e-2 (two
                 calls bit for bit), f32 at edge shapes (ragged T, T = 1,
                 T < chunk, x a strided view, stride-0 B_/C, two groups)
                 at 1e-4, bf16 on the tensor cores (``SSD_TC_CASES``: T 1
                 to 2048, one and two groups, x a view or dense; head dim
                 48, state 32 and chunk 100 at T 300) at 2e-2,
                 each call on the route ``ssd.route`` names, as the
                 launcher counted it; at jamba-v0.1-52b's SSM widths (H
                 128, P 64, state 16) the forward at its serve shape in
                 bf16 and at T 300 in f32, and the backward at T 256 and
                 129 in bf16 and 130 in f32
                 quant_matmul (int8 and int4 weights, x in bf16 at 2e-2
                 and f32 at 1e-4) at the seven serve shapes, M = 8 and
                 4096 (the tied unembed, 151936 x 1024 read as (N, K), at
                 M = 8), and edge shapes (M = 1, ragged N and K, a strided
                 x, a tiled scale, K below a tile, M 13 and 16 at decode,
                 M 17, 65 and 129 at prefill, K 1000, odd N, a strided x
                 with and without 16-byte alignment, the unembed at M 13,
                 decode shapes that reuse the kernels' rings), each call
                 on the route the wrapper's ``route`` names, as the
                 launcher counted it;
                 pack exactly
                 (``torch.equal``) at the host tier's act shape, the bytes
                 emulation of Spaces' obs at 4096 envs and edge shapes (one
                 leaf, 1-byte leaves, odd widths at unaligned offsets, B = 1,
                 a strided row view, more leaves than one launch holds, 1 to
                 75 leaves with a 0-width one, mixed 16-, 4- and 1-byte
                 access widths, B 1, 31, 33, 64 and 262,144)
  4. full width  qwen3-0.6b and mamba2-1.3b in f32 (TF32 off), then
                 qwen3-0.6b with int8 weights: the cuda and ref backends on
                 prefill last-token logits and 4 teacher-forced decode steps,
                 atol = rtol = 1e-3
  5. serve       qwen3-0.6b, then mamba2-1.3b, then qwen3-0.6b with int8 and
                 with int4 weights (int4 cut to ``INT4_DEPTH`` 7 of its 28
                 layers, for time), in bf16, batch 8, prompt 512, 64 new
                 tokens through ``rl.actor.generate``; the launch counters
                 must read 28 (flash_attention), 28 x 63 (flash_decode), 0
                 (gae, ssd, quant_matmul, pack) for qwen3, 48 (ssd) and 0 (the
                 others) for mamba2, and 64 x (28 x 6 + 1) (quant_matmul) on
                 top of qwen3's for the int8 run (int4: 7 for 28), whose
                 quant_matmul routes (as its launcher counted them) must
                 read 63 x 168 + 64 decode-kernel launches (every call at M
                 = 8) and 168 wgmma prefill ones, and mamba2's 48 ssd launches must all
                 take the tensor cores; every run's greedy tokens (a
                 prefill and 16 greedy steps) must repeat exactly in a
                 second run; prints prefill ms, decode ms/token, tok/s,
                 max_memory_allocated,
                 a profile of one prefill and 8 decode steps (device
                 time, idle share, top kernels; for mamba2 the ssd
                 kernel's ms of the prefill's), and each kernel's ms beside
                 its plain version's, its bound and, for attention,
                 ``scaled_dot_product_attention`` (a yardstick the port never
                 calls)
  6. train       Ocean PPO through ``rl.trainer.Trainer`` on the card, f32:
                 (a) bandit and squared solve (score >= 0.9) at their presets
                 (64 envs x 64 steps, hidden 64, seed 0) within 150k / 300k
                 steps; (b) each of the 13 envs of ``OCEAN`` runs 2 updates
                 at 4096 envs x 64 steps with finite metrics; (c) full size: squared
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
 10. checkpoint  path A, the jit tier at the squared preset: two
                 uninterrupted runs of 10 updates must be bitwise equal;
                 then 5 updates, a save, a new engine from another seed, a
                 restore and 5 more must leave the generator, params, AdamW
                 state and rollout carry ``torch.equal`` to the
                 uninterrupted run's, with one gae launch per update after
                 the restore; an async save of a live engine must hold the
                 values at its call; prints save and restore ms and bytes
 11. async       path B, the async actor–learner tier through the launcher,
                 each run a subprocess in its own session (its 2 actors are
                 spawned processes acting on the card, each with its own
                 CUDA context): (a) bandit must print SOLVED with one gae
                 launch per learner update, and the actors' device must be
                 the card; (b) a 40-update full-budget run in which actor 1
                 is killed (SIGKILL) after the first update must reshard
                 and finish all 40; (c) a 40-update run stopped by SIGINT
                 after update 11 and rerun with ``--ckpt-dir --resume``
                 must end at update 40; prints sps, the learner's idle
                 share, fragment ages, dropped fragments, each actor's
                 device and steps/s, and ``torch.cuda.mem_get_info``
 12. ocean2      path C, Ocean II through the Trainer on the card: pong,
                 drone, tagteam and maze each train at their unchanged
                 ``configs/ocean.py`` preset (64 envs x 64 steps, hidden 64)
                 to their target score on seed 0, with one gae launch per
                 update; an env that stalls is re-run over seeds 0-5 and
                 passes only if 5 of 6 solve; pong's line counts the calls
                 of the conv frontend, maze's the distinct wall layouts of
                 env 0's first 64 episodes (random actions), which must be
                 more than 1; prints env steps, wall time and sps
 13. selfplay    path D, league self-play on the jit tier: (a) the launcher
                 with ``--ocean duel --selfplay --league-dir`` in a
                 subprocess at the duel preset (300k steps) must reach a
                 winrate of >= 0.9 against the random policy, with one gae
                 launch per update; prints the store's versions and the
                 leaderboard; (b) a full-size self-play update, duel at
                 4096 envs x 64 steps (8,192 agent rows, 4,096 learner
                 rows): 2 warm-up and 5 timed updates, one launch under sync
                 debug mode "error" (the opponent is loaded and copied
                 before it), gae == updates, and a profile of one update;
                 (c) ``Arena.vs_pool`` over 4 stored versions (1024 envs a
                 match) must give the same outcomes as
                 ``vs_pool_sequential``; prints both times
 14. lm train    path E, LM-backbone PPO: (a) flash_attention_bwd
                 (``FA_BWD_CASES``: qwen3's training shape B 8, T 256, H 16,
                 K 8, hd 128, every head dim, MQA, an odd group, S != T,
                 non-causal, ragged T, T = 1, T and S off the wgmma route's
                 64- and 128-row tiles; ``FA_BWD_VIEWS``: q, k, v views of a
                 fused projection and a transposed do, bit for bit against
                 contiguous copies; each call on the route ``bwd_route``
                 names, as the launcher counted it) and ssd_bwd
                 (``SSD_BWD_CASES``: mamba2's training shape B 8, T 256,
                 H 64, P 64, N 128, ragged T, T = 1, stride-0 B_/C, x a
                 view, two and three groups, dh_last given, T 63 to 129
                 about the tensor cores' 64-step chunks, head dims 16 to
                 64 and states 16 to 128; ``SSD_BWD_LAYOUTS``: x one
                 element off 16 bytes, and a transposed dy bit for bit
                 against a contiguous copy; each call on the route
                 ``ssd.bwd_route`` names, as the launcher counted it) in
                 bf16 at 2e-2
                 and f32 at 1e-4 (TF32 off) of the largest gradient, against
                 their plain versions (autograd of the plain forwards) in f32
                 on the same inputs, two calls bit for bit, and the
                 forward's LSE against the plain one at 1e-4; (b) one
                 ``make_lm_train_step`` of qwen3-0.6b and of mamba2-1.3b at
                 full width in f32, B 2 x T 64, from ``LM_GATE_SEED``: the
                 cuda ops against ``dispatch.using("ref")`` from the same
                 params and batch, loss and grad_norm within 1e-3
                 relative, each leaf's gradient within 1e-3 of its largest,
                 the updated params within 1e-3; for mamba2 also each
                 leaf within 1e-4 of a plain run that takes the SSD
                 forward kernel's output (the backward kernel alone: see
                 ``lm_gate``); (c) both archs through the launcher in
                 bf16, ``--batch 8 --seq 256 --steps 10``: finite loss,
                 grad_norm > 0, params moved, and a step's launches 56
                 flash_attention, 28 flash_attention_bwd (qwen3; all on the
                 wgmma route, ``build.routes``) or 96 ssd, 48 ssd_bwd
                 (mamba2; all on the tensor cores), and 1 gae; prints ms
                 per step, tokens
                 per second, max_memory_allocated and a profile of one step
 15. moe+front   path F, MoE and the modality frontends: (a)
                 jamba-v0.1-52b with int8 weights at full width (32 layers,
                 d_model 4096, 16 experts top-2; built leaf by leaf, ~52 GB)
                 in f32 as phase 4 runs it, the router's choices of both
                 backends recorded (``RoutingLog``): logits within 1e-3,
                 and every token whose experts differ between the two runs
                 printed with its router-probability gap, which must be a
                 near-tie (``NEAR_TIE``); (b) jamba int8 served as phase 5
                 serves (B 8, prompt 512, 64 new tokens): 2 x 16
                 quant_matmul launches a MoE layer and forward, one per
                 expert and weight (``serve_launches``), the experts' rows
                 (B x capacity) on the wgmma kernel (``serve_routes``), all
                 28 ssd calls on the tensor cores; (c) musicgen-medium's
                 f32 train gate as phase 14(b)'s at B 2 x T 320 (its
                 256-frame audio prefix and 64 tokens), then 10 bf16 steps
                 through the launcher at ``--seq 512`` (B 8), with 96
                 flash_attention, 48 flash_attention_bwd (hd 64, all on
                 the wgmma route) and 1 gae launch a step; (d) each of the
                 slice's six archs (internlm2-20b, internvl2-26b,
                 musicgen-medium, jamba, dbrx-132b, llama4-maverick) at its
                 smoke config in bf16: a generate with its launch counts
                 and two train steps through the launcher (the MoE
                 backward through autograd, the prefix for the frontend
                 archs); gemma-7b and stablelm-12b the same
 16. head dims   path G, gemma-7b (hd 256, 16 heads, 16 KV heads, GeGLU,
                 tied embeddings) and stablelm-12b (hd 160, 32 heads, 8 KV
                 heads), after freeing phase 15's memory: (a) the three
                 attention kernels at hd 160 and 256 against their plain
                 versions, bf16 at 2e-2 and f32 at 1e-4 (TF32 off): the
                 forward (``FA_CASES`` at those head dims: both archs' serve
                 shapes, T and S off the tiles, T = 1, S != T, non-causal,
                 G 1, 4 and an odd group) on the route ``fwd_route`` names
                 as the launcher counted it, decode (``hd_decode_cases``:
                 both archs' caches at lengths 0, mid and S - 1, a whole
                 cluster, G 8) and the backward (``FA_BWD_CASES`` at those
                 head dims: both archs' training shapes, ragged T, T = 1,
                 S != T, non-causal, an odd group; on the CUDA cores, bit
                 for bit across two calls), and decode's shared memory as
                 ``flash_decode.plan`` reads it equal to the launcher's at
                 every instance; (b) both archs' f32 serve gates as phase 4
                 runs them at full width and depth (34 and 48.6 GB of
                 params), within 1e-3; (c) both served as phase 5 serves, in
                 bf16 at full width and depth: 28 flash_attention a prefill
                 (all on wgmma) and 1,764 flash_decode a generate for gemma,
                 40 and 2,520 for stablelm; (d) each arch's f32 train gate
                 as phase 14(b)'s at depth ``HD_GATE_DEPTH`` 4, then 10 bf16
                 steps through the launcher at depth ``HD_TRAIN_DEPTH`` 8
                 (full width, B 8 x T 256; ``at_depth``), with 2L
                 flash_attention, L flash_attention_bwd (all on the CUDA
                 cores) and 1 gae launch a step and a peak memory below
                 ``HD_PEAK_GIB`` 70 GiB
 17. shard       path H, the data-parallel ``shard_map`` tier at world size
                 1 over NCCL: (a) squared's preset and duel self-play (a
                 fixed opponent) for ``SHARD_UPDATES`` 3 updates on the jit
                 tier and on the shard_map tier: params, AdamW moments,
                 generator, rollout carry and every metric bit for bit;
                 one gae launch an update on both, and E x M + 1 = 17
                 all-reduces an update on the shard_map tier (one a
                 minibatch for the gradients, loss and stats, one for the
                 episode sums); then each tier's ms per update from rounds
                 of ``SHARD_TIME_UPDATES`` 4 in turns (jit, shard_map,
                 shard_map, jit); (b) the
                 launcher in a subprocess: ``--ocean squared
                 --engine-backend shard_map --full-budget
                 --total-env-steps`` (``SHARD_LAUNCHER_UPDATES`` 30
                 updates) ``--metrics-port 0 --run-dir D --profile P
                 --profile-launches 3 --ckpt-dir C --save-every 10``;
                 while it trains, GET /metrics (the engine's counters),
                 /healthz (200, ok) and /spans; afterwards gae == updates,
                 17 all-reduces an update, the newest checkpoint (gathered
                 and written by rank 0) at the last update, a
                 torch.profiler trace in P
                 whose CUDA kernel events name ``gae_kernel``, and
                 ``python -m repro_torch.telemetry summarize D`` and
                 ``export-trace D`` exiting 0

Kernel rows: each kernel's ms at its main path's shapes beside its plain
version's, its bound and a library call. First, a line for each new head
dim: flash_attention and flash_decode at gemma-7b's and stablelm-12b's
serve shapes in turns with SDPA, and (before the backward rows)
flash_attention_bwd at their training shapes against SDPA's backward by the
profiler, each with its launches on phase 16's paths. flash_attention and
SDPA are timed
in turns over 9 rounds by CUDA-graph replay, and the row gives each one's
median; a line before it does the same at T 2048, where operations bound
it. flash_decode's row is timed the same way against SDPA over the filled
prefix at the last serve step, and a line before it at S 8192, whose
caches exceed the L2. ssd's row is the median of 7 CUDA-graph
replays at mamba2's serve shape, and a line before it times T 2048, a walk
of 16 chunks; a line after it times jamba's prefill shape (state 16). pack's row is timed by CUDA-graph
replay at the host tier's act shape, with ``torch.cat`` as its library
call, and a line before it times it at a full-size trajectory's bytes
emulation, whose inputs exceed the L2. flash_decode and pack also print
their wrappers' host microseconds a call beside SDPA's and
``torch.cat``'s. quant_matmul's row is the total
over one int8 ``generate`` of its device times at each serve shape (printed
on the lines before it, timed by CUDA-graph replay), beside the same totals
of the plain version, the bound and ``torch.matmul`` on the
already-dequantised bf16 weight, and a line splits it into prefill, decode
projections and unembed. The backward kernels' rows are at the training
shapes (B 8, T 256), the median of 5 CUDA-graph replays, beside their plain
versions and, for attention, the device time of
``scaled_dot_product_attention``'s backward by the profiler (a line before
the rows also gives the kernel's own by the profiler and both ratios); the
ssd_bwd line before its row times the f64 CUDA-core route in turns with
the tensor cores at the same shape, for the record; their launches are a
train step's.

Then one JSON line of the kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import ast
import ctypes
import gc
import itertools
import json
import math
import os
import re
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.bridge import make_host_engine  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import (get_config,  # noqa: E402
                                 get_smoke_config, with_overrides)
from repro_torch.configs.ocean import ocean_tcfg, preset  # noqa: E402
from repro_torch.core.emulation import (Emulated, emulate,  # noqa: E402
                                        unemulate)
from repro_torch.envs.ocean import OCEAN  # noqa: E402
from repro_torch.envs.ocean_host import OCEAN_HOST  # noqa: E402
from repro_torch.kernels import build, dispatch, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD, bwd_route, flash_attention, flash_attention_bwd, flash_attention_fwd,
    fwd_route)
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    SMS, max_clusters as fd_max_clusters, plan as fd_plan,
    smem_bytes as fd_smem)
from repro_torch.kernels.gae import gae  # noqa: E402
from repro_torch.kernels.pack import MAX_LEAVES, pack  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    alignment as qmm_alignment, quant_matmul, route as qmm_route)
from repro_torch.kernels.ssd import (  # noqa: E402
    BWD as SSD_BWD, BWD_CHUNK as SSD_BWD_CHUNK, alignment as ssd_alignment,
    bwd_route as ssd_bwd_route, route as ssd_route, ssd, ssd_bwd,
    ssd_bwd_cuda_core, ssd_fwd)
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.buffer import random_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.rl.learner import (  # noqa: E402
    init_train_state, make_lm_train_step)
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.league import Arena, SelfPlay, build_league  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.params import matmul  # noqa: E402
from repro_torch.models.policy import BackbonePolicy  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402
from repro_torch.rl import actor  # noqa: E402
from repro_torch.rl.engine import (METRIC_KEYS,  # noqa: E402
                                   TrainEngine, act_transfer_spec)
from repro_torch.rl.trainer import Trainer, ocean_policy_stack  # noqa: E402

ARCH, SSM_ARCH = "qwen3-0.6b", "mamba2-1.3b"
# path F, MoE and the frontends: jamba served int8 and musicgen trained at
# full width, and every arch of the slice at smoke size
MOE_ARCH, AUDIO_ARCH = "jamba-v0.1-52b", "musicgen-medium"
SLICE_ARCHS = ("internlm2-20b", "internvl2-26b", AUDIO_ARCH, MOE_ARCH,
               "dbrx-132b", "llama4-maverick-400b-a17b", "gemma-7b",
               "stablelm-12b")
# path G, the head-dim slice: gemma-7b (hd 256, H 16, K 16) and
# stablelm-12b (hd 160, H 32, K 8) served at full width and depth, trained
# at full width and depth HD_GATE_DEPTH (f32 gate) and HD_TRAIN_DEPTH (bf16)
HD_ARCHS = ("gemma-7b", "stablelm-12b")
NEW_HEAD_DIMS = (160, 256)
HD_GATE_DEPTH, HD_TRAIN_DEPTH = 4, 8
HD_PEAK_GIB = 70        # the depth-8 bf16 run's peak memory must stay below
AUDIO_GATE_T = 320      # the f32 gate's T: the 256-frame prefix + 64 tokens
AUDIO_SEQ = 512         # the launcher's --seq: 256 frames + 256 tokens
NEAR_TIE = 1e-4         # a routing flip's largest router-probability gap
BATCH, PROMPT, NEW = 8, 512, 64
INT4_DEPTH = 7            # int4 qwen3's layers in phase 5 (of 28): time
GREEDY_STEPS = 16         # greedy decode steps run twice for determinism
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
    # the backward kernels replace no Pallas kernel: JAX differentiates the
    # jnp program around each forward-only kernel; they stand for the
    # gradients of these
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:74"),
    "ssd_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd.cu",
                "src/repro/kernels/ssd.py:69"),
}
# attention parity cases (B, T, S, H, K, hd, causal): the serve shape, ragged
# tails, one row, one row past a tile, S > T and S < T, non-causal, MQA, MHA
# and an odd group (one head per block on the wgmma path), and every head
# dim; those at hd 160 and 256 (gemma's and stablelm's serve shapes, T and
# S off the 64-row tiles, T = 1, S != T, non-causal, G 1, 4 and an odd 3)
# run in phase 16, the rest in phase 3
FA_CASES = (
    (BATCH, PROMPT, PROMPT, 16, 8, 128, True), (2, 200, 200, 16, 8, 128, True),
    (3, 77, 77, 8, 2, 64, True), (2, 130, 130, 4, 2, 32, True),
    (2, 1, 1, 16, 8, 128, True), (2, 65, 65, 16, 8, 128, True),
    (2, 100, 300, 8, 2, 128, True), (2, 130, 200, 8, 4, 64, False),
    (2, 200, 70, 4, 4, 32, False), (2, 96, 96, 4, 1, 16, True),
    (1, 64, 64, 4, 1, 128, False), (2, 200, 200, 4, 4, 128, True),
    (2, 300, 150, 6, 2, 64, True),
    (BATCH, PROMPT, PROMPT, 16, 16, 256, True),
    (BATCH, PROMPT, PROMPT, 32, 8, 160, True),
    (2, 200, 200, 16, 16, 256, True), (2, 130, 130, 32, 8, 160, True),
    (2, 1, 1, 16, 16, 256, True), (2, 1, 1, 32, 8, 160, True),
    (2, 65, 65, 4, 1, 256, True), (2, 100, 300, 8, 2, 160, True),
    (2, 300, 100, 4, 4, 256, True), (2, 130, 200, 8, 4, 160, False),
    (2, 200, 70, 4, 4, 256, False), (2, 96, 96, 6, 2, 160, True),
    (2, 150, 150, 6, 2, 256, True))
FA_LONG = 2048      # a prompt length where operations bound flash_attention
FD_LONG = 8192      # a cache length whose K/V (268 MB) exceeds the L2
# mamba2-1.3b's SSD at the serve shape: heads, head dim, state, groups, chunk
SSD_H, SSD_P, SSD_N, SSD_G, SSD_Q = 64, 64, 128, 1, 128
# jamba-v0.1-52b's: 128 heads of 64, state 16 (groups 1, chunk 128)
JAMBA_H, JAMBA_P, JAMBA_N = 128, 64, 16
SSD_LONG = 2048     # a prompt length whose chunk walk is 16 chunks
SSD_PATHS = build.ROUTES["ssd"][1]      # the launcher's routes
# the tensor-core route's parity cases (T, G, x a view, P, N, chunk): at
# mamba2's widths T below a tile, about a chunk, ragged, 16 chunks; one and
# two groups; x a view of the conv output or dense; then head dim 48, state
# 32 and a chunk of 100, which is not a multiple of the 16-row tiles
SSD_TC_CASES = tuple(
    (T, G, view, SSD_P, SSD_N, SSD_Q) for T, G, view in itertools.product(
        (1, 15, 127, 128, 129, 300, 2048), (1, 2), (True, False))) + (
    (300, 1, False, 48, 32, 100),)
# GAE's parity cases: envs about a warp and past the card's blocks, T of
# one step, ragged segments, one chunk a segment (64) and streamed (1000)
GAE_CASES = tuple(itertools.product((1, 31, 33, 4096, 10000),
                                    (1, 37, 64, 1000), (0.0, 0.1, 0.5)))
# qwen3-0.6b's quantised products (K, N) per layer: wq, wk, wv, wo, mlp wi,
# mlp wo; and the tied unembed, the (V, d) table read as (N, K)
QMM_LAYER = ((1024, 2048), (1024, 1024), (1024, 1024), (2048, 1024),
             (1024, 6144), (3072, 1024))
QMM_UNEMBED = (1024, 151936)
QMM_EDGES = (  # (M, K, N, transposed, scale length or None, x row pad)
    (1, 1024, 1024, False, None, 0), (5, 999, 1001, False, None, 24),
    (37, 1001, 999, True, None, 8), (300, 77, 130, False, None, 0),
    (8, 1024, 2048, False, 128, 0), (200, 1024, 2048, False, 128, 0),
    (17, 3, 5, False, None, 0), (8, 4096, 64, False, None, 0),
    # the decode fragments: M 16 full, M 13 ragged (with K 1000, not a
    # multiple of a k-step, and a strided x); odd N (int4's last nibble)
    (16, 1024, 1024, False, None, 0), (13, 1000, 2048, False, None, 8),
    (8, 1024, 777, False, None, 0), (16, 1000, 999, True, None, 8),
    (13, *QMM_UNEMBED, True, None, 0),
    # the prefill tile's edges (M 17, 65, 129), odd N; a strided x whose
    # base and rows are 16-byte aligned (pad 16), and one whose are not
    (17, 1024, 1024, False, None, 0), (65, 1000, 1024, False, None, 0),
    (129, 1024, 1001, False, None, 0), (200, 1024, 2048, False, None, 16),
    (200, 1024, 2048, False, None, 6),
    # the decode rings reused: more k-steps a warp than the (K, N) ring's
    # slots (split 1 at N 16384, split 8 at K 8192); K past the (N, K)
    # kernel's staged x * s (2048 / MT values), which restages it
    (8, 1024, 16384, False, None, 0), (8, 8192, 1024, False, None, 0),
    (8, 4096, 300, True, None, 0), (16, 2500, 300, True, None, 0))
QMM_PATHS = build.ROUTES["quant_matmul"][1]     # the launcher's routes
TRAIN_ENVS, TRAIN_UNROLL = 4096, 64     # the full-size training update
GAMMA, LAM = 0.95, 0.95                 # ocean_tcfg's gamma, TrainConfig's
HOST_N = 64                             # the host tier's preset batch (M 128)
PACK_LEAVES = (1, 3, 8, 32, 33, 75)     # pack's leaf counts about its tables
PACK_ROWS = (1, 31, 33, 64)             # pack's B about a warp
PROC_N, PROC_UPDATES = 8, 4             # the proc-backend run: M 16 workers
CKPT_U = 5                              # path A: updates before the stop
OCEAN2 = ("pong", "drone", "tagteam", "maze")   # path C, at their presets
POOL_K, POOL_ENVS = 4, 1024             # path D: the arena's pool
ASYNC_UPDATES = 40                      # path B: full-budget runs' updates
SHARD_UPDATES = 3                       # path H: updates a tier runs in 17(a)
SHARD_LAUNCHER_UPDATES = 30             # path H: the launcher's run in 17(b)
SHARD_TIME_UPDATES = 4                  # path H: a timed round in 17(a)
# path E, LM-backbone PPO: the launcher's defaults, B 8 x T 256, 10 steps
LM_BATCH, LM_SEQ, LM_STEPS = 8, 256, 10
LM_GATE_B, LM_GATE_T = 2, 64            # the full-width f32 gate
LM_GATE_SEED = 0           # the gate's own generator (tools/ reruns it)
# qwen3's attention at the training shape (B, T, H, K, hd), and the
# backward's edge cases (B, T, S, H, K, hd, causal): every head dim, MQA,
# an odd group, S != T, non-causal, ragged T, T = 1; for the wgmma route's
# tiling T and S off the 64- and 128-row tiles in both directions, MQA at
# hd 64, an odd group at hd 128, non-causal at both head dims; at hd 160
# and 256 (phase 16; phase 14 runs the rest) gemma's and stablelm's
# training shapes, ragged T off the 32- and 64-row tiles, T = 1, S != T,
# non-causal, an odd group
FA_TRAIN = (LM_BATCH, LM_SEQ, 16, 8, 128)
FA_BWD_CASES = (
    (LM_BATCH, LM_SEQ, LM_SEQ, 16, 8, 128, True),
    (2, 200, 200, 4, 2, 32, True), (1, 130, 130, 8, 2, 64, True),
    (2, 64, 64, 4, 1, 16, True), (2, 1, 1, 16, 8, 128, True),
    (2, 65, 65, 16, 8, 128, True), (2, 100, 300, 8, 2, 128, True),
    (2, 130, 200, 8, 4, 64, False), (2, 200, 70, 4, 4, 32, False),
    (2, 96, 96, 4, 1, 128, True), (2, 300, 150, 6, 2, 64, True),
    (1, 129, 129, 8, 2, 128, True), (2, 190, 77, 8, 4, 128, True),
    (2, 77, 190, 4, 2, 64, True), (2, 150, 150, 8, 1, 64, True),
    (2, 100, 100, 6, 2, 128, True), (2, 200, 90, 4, 2, 128, False),
    (1, 70, 250, 4, 4, 64, False),
    (LM_BATCH, LM_SEQ, LM_SEQ, 16, 16, 256, True),
    (LM_BATCH, LM_SEQ, LM_SEQ, 32, 8, 160, True),
    (2, 200, 200, 16, 16, 256, True), (2, 130, 130, 32, 8, 160, True),
    (2, 1, 1, 16, 16, 256, True), (2, 100, 300, 8, 2, 160, True),
    (2, 190, 77, 4, 4, 256, True), (2, 130, 200, 8, 4, 160, False),
    (2, 96, 96, 6, 2, 256, True))
# the same with q, k, v views of one fused projection and a transposed,
# non-contiguous do (TMA reads both as they lie)
FA_BWD_VIEWS = ((2, 150, 150, 16, 8, 128, True),
                (2, 150, 150, 16, 2, 64, True))
# mamba2's SSD at the training shape (B, T) and the backward's edge cases
# (B, T, H, P, N, G, x a view, dh_last given): ragged T, T = 1, stride-0
# B_/C, x a view, two and three groups, head dim and state 128; for the
# tensor-core route's 64-step chunks T 63, 64, 65 and 129, and head dims
# 16 to 64 beside states 16, 32 and 128
SSD_BWD_CASES = (
    (LM_BATCH, LM_SEQ, SSD_H, SSD_P, SSD_N, SSD_G, True, False),
    (2, 300, 4, 64, 128, 1, True, False), (2, 1, 4, 64, 128, 1, True, True),
    (3, 50, 4, 16, 16, 1, False, True), (2, 96, 4, 16, 16, 2, True, False),
    (2, 64, 3, 16, 32, 3, False, False), (1, 70, 2, 128, 128, 1, False, True),
    (2, 129, 4, 48, 32, 2, True, False), (2, 63, 4, 64, 128, 1, True, True),
    (2, 64, 4, 32, 128, 2, True, False), (2, 65, 4, 16, 32, 1, False, True),
    (1, 129, 4, 64, 16, 1, True, True))
# x a view one element off 16 bytes (the CUDA cores), and dy transposed
# ((B, H, T, P) seen as (B, T, H, P): the tensor cores read it as it lies)
SSD_BWD_LAYOUTS = ((2, 130, 4, 64, 128, 1, "x_unaligned"),
                   (2, 130, 4, 64, 128, 1, "dy_transposed"))


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


def alternate_ms(fns, arg_sets, calls, rounds=9):
    """Median device ms per call of each of ``fns``, timed in turns: each
    round times every function once by CUDA-graph replay of ``calls`` calls
    (``graph_ms``; host launch time is not counted), so a drift of the card
    between rounds falls on all of them alike; also returns each one's
    rounds."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, ts in zip(fns, times):
            ts.append(graph_ms(fn, arg_sets, calls))
    return [statistics.median(ts) for ts in times], times


def sdpa(q, k, v):
    """``scaled_dot_product_attention`` on the (B, T, H, hd) layout, causal
    with GQA: the yardstick of flash_attention, never called by the port."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)


def attention_work(B, T, H, K, hd):
    """(FLOP, bytes) of causal attention: the causal pairs' two products,
    and q, k, v and o moved once in bf16."""
    flops = 2 * B * H * hd * T * (T + 1)
    nbytes = 2 * (2 * B * T * H * hd + 2 * B * T * K * hd)
    return flops, nbytes


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
    ptxas = {name: start_ptxas_report(name) for name in INSTANCES}
    paths = build.build_all()
    for name in paths:
        build.load(name)
    print(f"[2 build] built and loaded {sorted(paths)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, proc in ptxas.items():
        finish_ptxas_report(name, proc)
        sass_report(name, paths[name])


# Kernel instances by their mangled names, for the ptxas and SASS reports:
# ssd's bf16 tensor-core kernel (every head dim <= 64) and its CUDA-core
# kernels by dtype and head dim; flash_decode's bf16 (mma.sync) and f32
# (CUDA cores) kernels by head dim;
# flash_attention's bf16 kernels on wgmma (head dims 64, 128) or mma.sync
# (16, 32) and its f32 kernels; quant_matmul's bf16 decode kernels by
# layout, weight and m-tiles (MT 1 serves M <= 8), its wgmma prefill
# kernel and its CUDA-core tiles; flash_attention_bwd's dq and dk/dv
# kernels on wgmma (bf16 at head dims 64, 128) or the CUDA cores.
FA_ROUTE = {"wg": "bf16 wgmma", "tc": "bf16 mma.sync", None: "f32 CUDA cores"}
QMM_TYPE = {"0": "int8", "1": "int4"}


def _fa(m):
    return f"{FA_ROUTE[m.group(1)]} hd {m.group(3)}"


def _qmm_dec(m):
    layout = "(K, N)" if m.group(1) == "kn" else "(N, K)"
    return f"bf16 decode {layout} {QMM_TYPE[m.group(2)]} MT {m.group(3)}"


def _qmm_fma(m):
    dtype = "f32" if m.group(1) == "f" else "bf16"
    layout = "(N, K)" if m.group(3) == "1" else "(K, N)"
    return (f"{dtype} CUDA cores {layout} {QMM_TYPE[m.group(2)]} BM "
            f"{m.group(4)}")


def _ssd_cc(m):
    return (f"{'f32' if m.group(1) == 'f' else 'bf16'} CUDA cores head dim "
            f"<= {32 * int(m.group(2))}")


INSTANCES = {
    "ssd": [
        (re.compile(r"ssd_tc_kernel"), lambda m: "bf16 tensor cores"),
        (re.compile(r"ssd_kernelI(f|13__nv_bfloat16)Li(\d)E"), _ssd_cc)],
    "flash_decode": [
        (re.compile(r"fd_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
         lambda m: f"{'f32' if m.group(1) == 'f' else 'bf16'} hd "
                   f"{m.group(2)}")],
    "flash_attention": [
        (re.compile(r"flash_attention_(wg|tc)?_?kernelI(f)?Li(\d+)E"), _fa)],
    "flash_attention_bwd": [
        (re.compile(r"fa_bwd_wg_(dq|dkdv)_kernelILi(\d+)E"),
         lambda m: f"bf16 wgmma {m.group(1)} hd {m.group(2)}"),
        (re.compile(r"fa_bwd_(dq|dkdv)_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
         lambda m: f"{'f32' if m.group(2) == 'f' else 'bf16'} CUDA cores "
                   f"{m.group(1)} hd {m.group(3)}")],
    "ssd_bwd": [
        (re.compile(r"ssd_bwd_tc_kernel"), lambda m: "bf16 tensor cores"),
        (re.compile(r"ssd_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E"),
         lambda m: f"{'f32' if m.group(1) == 'f' else 'bf16'} rows "
                   f"{m.group(2)} a warp, columns {32 * int(m.group(3))}")],
    "quant_matmul": [
        (re.compile(r"dec_(kn|nk)_kernelILb([01])ELi(\d)E"), _qmm_dec),
        (re.compile(r"qmm_wg_kernelILb([01])E"),
         lambda m: f"bf16 wgmma prefill {QMM_TYPE[m.group(1)]}"),
        (re.compile(r"qmm_kernelI(f|13__nv_bfloat16)Lb([01])ELb([01])E"
                    r"NS_4TileILi(\d+)E"), _qmm_fma)],
}
# SASS each instance must hold, by label prefix: (count of instances,
# groups of instructions of which each group needs one)
SASS_NEEDS = {
    "ssd": {"bf16 tensor cores": (1, (("HMMA", "HGMMA"),
                                      ("LDGSTS", "UTMALDG")))},
    "flash_decode": {"bf16": (6, (("HMMA",), ("LDGSTS",)))},
    "flash_attention": {"bf16": (6, (("HMMA", "HGMMA"),
                                     ("LDGSTS", "UTMALDG"))),
                        "bf16 wgmma": (4, (("HGMMA",), ("UTMALDG",)))},
    "quant_matmul": {"bf16 decode": (8, (("HMMA",), ("LDGSTS",))),
                     "bf16 wgmma": (2, (("HGMMA",), ("UTMALDG",)))},
    # flash_attention_bwd's wgmma route (dq and dk/dv at hd 64 and 128);
    # ssd_bwd's tensor-core route (mma.sync fed by cp.async)
    "flash_attention_bwd": {"bf16 wgmma": (4, (("HGMMA",), ("UTMALDG",)))},
    "ssd_bwd": {"bf16 tensor cores": (1, (("HMMA", "HGMMA"),
                                          ("LDGSTS", "UTMALDG")))},
}
# instances on the serve and training paths, where ptxas must report no
# spills
NO_SPILLS = {"ssd": ("bf16 tensor cores",),     # mamba2's P 64 among them
             "flash_decode": ("bf16 hd 128", "bf16 hd 160", "bf16 hd 256"),
             "flash_attention": ("bf16 wgmma hd 128", "bf16 wgmma hd 160",
                                 "bf16 wgmma hd 256"),
             "quant_matmul": ("bf16 decode (K, N) int8 MT 1",
                              "bf16 decode (K, N) int4 MT 1",
                              "bf16 decode (N, K) int8 MT 1",
                              "bf16 decode (N, K) int4 MT 1",
                              "bf16 wgmma prefill int8",
                              "bf16 wgmma prefill int4"),
             "flash_attention_bwd": ("bf16 wgmma dq hd 128",
                                     "bf16 wgmma dkdv hd 128"),
             "ssd_bwd": ("bf16 tensor cores",)}     # mamba2's training call


def instance(name, mangled):
    """The label of kernel ``name``'s instance ``mangled``, or None."""
    for pattern, label in INSTANCES[name]:
        m = pattern.search(mangled)
        if m:
            return label(m)
    return None


def start_ptxas_report(name):
    """A second compile of ``csrc/<name>.cu`` to a cubin with ``-Xptxas -v``
    (registers, spills and shared memory of each kernel), started beside the
    build."""
    out = build.BUILD_DIR / f"{name}-ptxas.cubin"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v",
           "-o", str(out), str(build.CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_ptxas_report(name, proc):
    log, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {name}:\n{log}")
    entry, rows = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w]+)", line)
        if m:
            entry = instance(name, m.group(1))
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows.setdefault(entry, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(entry, {})["registers"] = int(m.group(1))
    if not rows:
        raise AssertionError(f"no ptxas report for {name}:\n{log}")
    for line in log.splitlines():       # e.g. wgmma serialised by ptxas
        if "warning" in line.lower() or "Performance" in line:
            print(f"[2 build] {name} ptxas: {line.strip()}", flush=True)
    print(f"[2 build] {name} ptxas -v (sm_90a): " + "; ".join(
        f"{k}: {v.get('registers')} registers, spill stores "
        f"{v.get('spill_stores')} B, loads {v.get('spill_loads')} B"
        for k, v in sorted(rows.items())), flush=True)
    spills = {k: rows.get(k) for k in NO_SPILLS[name]
              if k not in rows or rows[k].get("spill_stores", 0)
              or rows[k].get("spill_loads", 0)}
    if spills:
        raise AssertionError(f"{name}: serve-path instances missing or "
                             f"spilling: {spills}")


SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "LDSM", "MUFU.EX2")


def sass_report(name, lib):
    """Count the tensor-core and asynchronous-copy instructions in the
    built library's SASS (``cuobjdump -sass``), by kernel instance; each
    instance of a ``SASS_NEEDS`` prefix must hold one of each group."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = instance(name, m.group(1))
            if entry is not None:
                counts[entry] = dict.fromkeys(SASS_OPS, 0)
            continue
        if entry is None:
            continue
        ops = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if ops:
            for op in SASS_OPS:
                if ops.group(1) == op or ops.group(1).startswith(op + "."):
                    counts[entry][op] += 1
    print(f"[2 build] {name} SASS instruction counts: " + "; ".join(
        f"{k}: " + ", ".join(f"{op} {n}" for op, n in v.items())
        for k, v in sorted(counts.items())), flush=True)
    for prefix, (want, groups) in SASS_NEEDS[name].items():
        got = [v for k, v in counts.items() if k.startswith(prefix)]
        if len(got) != want or not all(
                any(v[op] for op in group) for v in got for group in groups):
            raise AssertionError(f"{name}: {prefix} instances ({len(got)} "
                                 f"of {want}) lack one of {groups}: {counts}")


def phase_parity(gen):
    """Each kernel against its plain version; returns the max abs error of
    each kernel at the serve shapes in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {"flash_attention": 0.0, "flash_decode": 0.0, "gae": 0.0,
            "ssd": 0.0}
    cases = 0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for shape in FA_CASES:
            if shape[5] in NEW_HEAD_DIMS:
                continue                    # phase 16
            err = fa_case(gen, shape, dtype, tol)
            if shape == FA_CASES[0] and dtype == torch.bfloat16:
                errs["flash_attention"] = err
            cases += 1
        # (B, S, H, K, hd) x cache fill, then the lengths about the split
        # (0, split - 1, split, split + 1, S - 1) at S on and off 16, query
        # heads a KV head from 1 to 20 at every head dim, and strided views
        for shape, lengths in fd_cases():
            err = fd_case(gen, shape, lengths, dtype, tol)
            if shape == (BATCH, PROMPT + NEW, 16, 8, 128) and \
                    dtype == torch.bfloat16:
                errs["flash_decode"] = max(errs["flash_decode"], err)
            cases += len(lengths)
        cases += fd_view_case(gen, dtype, tol)
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
    # GAE over envs and lengths about its segments; two calls give the
    # same bits
    for B, T, done_p in GAE_CASES:
        r, v, d, lv = gae_inputs(gen, B, T, done_p)
        got = gae(r.T, v.T, d.T, lv, GAMMA, LAM)
        check_close(f"gae ({B}, {T}) done_p {done_p}", got,
                    ref.gae(r.T, v.T, d.T, lv, GAMMA, LAM), 1e-5)
        if not torch.equal(got, gae(r.T, v.T, d.T, lv, GAMMA, LAM)):
            raise AssertionError(f"gae ({B}, {T}): two calls differ")
        cases += 1
    # SSD: the serve shape in bf16 as models/ssm.py hands it over, then
    # edge shapes in f32 (B, T, H, P, N, G, chunk, x a view of the conv
    # output), each on the route the wrapper's ``route`` names, as the
    # launcher counted it
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
        cases += ssd_case(f"{shape} {dtype}", args, Q, tol, errs,
                          B == BATCH)
    # the tensor-core route at mamba2's widths over lengths, groups and
    # layouts; the serve shape's two calls give the same bits
    for T, G, view, P, N, Q in SSD_TC_CASES:
        args = ssd_inputs(gen, 2, T, 4, P, N, G, torch.bfloat16, view)
        cases += ssd_case(f"(2, {T}, 4, {P}, {N}, {G}, {Q}, {view}) bf16",
                          args, Q, 2e-2, errs, False)
    args = ssd_inputs(gen, BATCH, PROMPT, SSD_H, SSD_P, SSD_N, SSD_G,
                      torch.bfloat16, True)
    (y1, h1), (y2, h2) = (ssd(*args, chunk=SSD_Q) for _ in range(2))
    if not (torch.equal(y1, y2) and torch.equal(h1, h2)):
        raise AssertionError("ssd at the serve shape: two calls differ")
    del args, y1, h1, y2, h2
    # jamba's SSM layers (state 16): the forward at its serve shape in bf16
    # (the tensor cores) and a ragged T in f32, the backward at two bf16
    # shapes (the tensor cores) and in f32, dh_last given in one
    jamba = {}
    for shape, dtype, tol in (
            ((BATCH, PROMPT, JAMBA_H, JAMBA_P, JAMBA_N, 1, SSD_Q, True),
             torch.bfloat16, 2e-2),
            ((2, 300, JAMBA_H, JAMBA_P, JAMBA_N, 1, SSD_Q, True),
             torch.float32, 1e-4)):
        B, T, H, P, N, G, Q, view = shape
        args = ssd_inputs(gen, B, T, H, P, N, G, dtype, view)
        e = {}
        cases += ssd_case(f"jamba {shape} {dtype}", args, Q, tol, e, True)
        jamba[f"fwd {dtype}"] = e["ssd"]
    for shape, dtype, tol in (
            ((2, 256, JAMBA_H, JAMBA_P, JAMBA_N, 1, True, False),
             torch.bfloat16, 2e-2),
            ((2, 129, JAMBA_H, JAMBA_P, JAMBA_N, 1, True, True),
             torch.bfloat16, 2e-2),
            ((2, 130, JAMBA_H, JAMBA_P, JAMBA_N, 1, True, True),
             torch.float32, 1e-4)):
        jamba[f"bwd {shape[1]} {dtype}"] = ssd_bwd_case(gen, shape, dtype,
                                                        tol)
        cases += 1
    print(f"[3 parity] ssd at jamba-v0.1-52b's SSM widths (H {JAMBA_H}, P "
          f"{JAMBA_P}, N {JAMBA_N}): forward and backward pass, max abs "
          f"err {jamba}", flush=True)
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
                build.routes("quant_matmul", reset=True)
                err = check_close(f"quant_matmul {shape} {qtype} {dtype}",
                                  quant_matmul(x, w, s, trans),
                                  ref.quant_matmul(x, w, s, trans), tol)
                want = qmm_route(M, dtype, trans, *qmm_alignment(x, w))
                taken = build.routes("quant_matmul")
                if taken != {p: int(p == want) for p in QMM_PATHS}:
                    raise AssertionError(f"quant_matmul {shape} {qtype} "
                                         f"{dtype}: the launcher took "
                                         f"{taken}, the route rule names "
                                         f"{want}")
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


def fa_case(gen, shape, dtype, tol):
    """One flash_attention parity case (B, T, S, H, K, hd, causal) against
    the plain version, on the route ``fwd_route`` names as the launcher
    counted it; returns the max abs error."""
    B, T, S, H, K, hd, causal = shape
    q = randn(gen, (B, T, H, hd), dtype)
    k, v = (randn(gen, (B, S, K, hd), dtype) for _ in range(2))
    build.routes("flash_attention", reset=True)
    err = check_close(f"flash_attention {shape} {dtype}",
                      flash_attention(q, k, v, causal=causal),
                      ref.flash_attention(q, k, v, causal=causal), tol)
    want = fwd_route(dtype, hd)
    taken = build.routes("flash_attention")
    if taken != {r: int(r == want) for r in taken}:
        raise AssertionError(f"flash_attention {shape} {dtype}: routes "
                             f"{taken}, expected {want}")
    return err


def fd_case(gen, shape, lengths, dtype, tol):
    """flash_decode at one cache shape (B, S, H, K, hd) and each of
    ``lengths`` against the plain version; returns the max abs error."""
    B, S, H, K, hd = shape
    q = randn(gen, (B, H, hd), dtype)
    k, v = (randn(gen, (B, S, K, hd), dtype) for _ in range(2))
    err = 0.0
    for L in lengths:
        length = torch.tensor(L, dtype=torch.int32, device="cuda")
        err = max(err, check_close(f"flash_decode {shape} length {L} "
                                   f"{dtype}", flash_decode(q, k, v, length),
                                   ref.flash_decode(q, k, v, length), tol))
    return err


def ssd_case(what, args, chunk, tol, errs, serve):
    """One SSD parity case: y and h_last against the plain version, and the
    route the launcher counted against the wrapper's rule; 1."""
    x, _, _, B_, C = args
    want = ssd_route(x.dtype, x.shape[-1], B_.shape[-1], chunk,
                     ssd_alignment(x, B_, C))
    build.routes("ssd", reset=True)
    (y, h), (ry, rh) = ssd(*args, chunk=chunk), ref.ssd(*args)
    taken = build.routes("ssd")
    if taken != {p: int(p == want) for p in SSD_PATHS}:
        raise AssertionError(f"ssd {what}: the launcher took {taken}, the "
                             f"route rule names {want}")
    err = max(check_close(f"ssd y {what}", y, ry, tol),
              check_close(f"ssd h_last {what}", h, rh, tol))
    if serve:
        errs["ssd"] = err
    return 1


def fd_cases():
    """flash_decode's parity cases: ((B, S, H, K, hd), lengths)."""
    S = PROMPT + NEW
    cases = [((BATCH, S, 16, 8, 128), [int(f * (S - 1)) for f in
                                       (0.0, 0.6, 1.0)]),
             ((3, 100, 8, 2, 64), [0, 59, 99]), ((2, 64, 4, 1, 32),
                                                 [0, 37, 63])]
    for B, S_, K in ((BATCH, S, 8), (2, 100, 2), (1, 577, 1), (3, 1000, 4),
                     (64, 300, 8)):
        split, _ = fd_plan(B, K, S_)
        cases.append(((B, S_, 2 * K, K, 128), sorted(
            {L for L in (0, split - 1, split, split + 1, S_ - 1)
             if L < S_})))
    for G in (1, 2, 4, 8, 20):
        for hd in (16, 32, 64, 128):
            cases.append(((2, 200, 2 * G, 2, hd), [150]))
    return cases


def fd_view_case(gen, dtype, tol):
    """flash_decode on caches laid out (B, K, S, hd) and viewed as (B, S, K,
    hd), q a view of a wider row; two calls must give the same bits."""
    B, S, H, K, hd = BATCH, PROMPT + NEW, 16, 8, 128
    k, v = (randn(gen, (B, K, S, hd), dtype).transpose(1, 2)
            for _ in range(2))
    q = randn(gen, (B, H, hd + 64), dtype)[..., 32:32 + hd]
    length = torch.tensor(S - 7, dtype=torch.int32, device="cuda")
    got = flash_decode(q, k, v, length)
    check_close(f"flash_decode strided views {dtype}", got,
                ref.flash_decode(q, k, v, length), tol)
    if not torch.equal(got, flash_decode(q, k, v, length)):
        raise AssertionError(f"flash_decode {dtype}: two calls differ")
    return 1


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
        **{f"{n} leaves (a 0-width one among them past one)":
           [u8(gen, 70, (3 * i + 1) % 7) for i in range(n)]
           for n in PACK_LEAVES},
        "mixed access widths (16, 4 and 1 bytes)":
            [u8(gen, 100, n) for n in (16, 32, 4, 12, 1, 3, 12)],
        **{f"B {B} (three 4-byte leaves)": [u8(gen, B, 4) for _ in range(3)]
           for B in PACK_ROWS},
        f"B {TRAIN_ENVS * TRAIN_UNROLL} (leaves of 16 and 36 bytes)":
            [u8(gen, TRAIN_ENVS * TRAIN_UNROLL, n) for n in (16, 36)],
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


class RoutingLog:
    """Records every call of ``models.moe.route`` while it is entered: the
    router's probabilities and the chosen experts of each call, in order.
    ``moe_apply`` looks ``route`` up in its module at each call, so the
    package needs no hook for it."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        real = self.real = moe_mod.route

        def recorded(params, x, cfg):
            probs, gate, eidx = real(params, x, cfg)
            self.calls.append((probs.detach().clone(), eidx.clone()))
            return probs, gate, eidx

        moe_mod.route = recorded
        return self

    def __exit__(self, *exc):
        moe_mod.route = self.real


def routing_flips(got, want):
    """Compare two runs' routing call by call: (decisions, max |probs
    apart|, flips), a flip (call, group, token, gap) where a token's ordered
    top-k differs, its gap the ``want`` run's probability difference
    between the two experts at the first differing choice."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routing calls against "
                             f"{len(want)}")
    decisions, p_err, flips = 0, 0.0, []
    for c, ((pg, eg), (pw, ew)) in enumerate(zip(got, want)):
        decisions += ew[..., 0].numel()
        p_err = max(p_err, max_err(pg, pw))
        for g, t in (eg != ew).any(-1).nonzero().tolist():
            j = int((eg[g, t] != ew[g, t]).nonzero()[0])
            a, b = int(eg[g, t, j]), int(ew[g, t, j])
            flips.append((c, g, t, abs(float(pw[g, t, a] - pw[g, t, b]))))
    return decisions, p_err, flips


def phase_full_width_f32(gen, arch, quantize=None, tag="4 full width"):
    """The cuda and ref backends on the same f32 params and tokens:
    last-token logits of a prefill and 4 teacher-forced decode steps
    within 1e-3. On an MoE arch the two runs' routing is compared too:
    every flip of a token's experts must be a near-tie (its router
    probabilities within ``NEAR_TIE``), and each one is printed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = with_overrides(get_config(arch), dtype="float32",
                         param_dtype="float32")
    policy = BackbonePolicy(cfg, generator=gen, quantize=quantize)
    B, T, steps = 2, 256, 4
    toks = torch.randint(0, cfg.vocab_size, (B, T + steps), generator=gen,
                         device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    logits, routing = {}, {}
    for mode in ("cuda", "ref"):
        with dispatch.using(mode), RoutingLog() as log:
            lg, _, caches = policy.prefill(toks[:, :T], T + steps)
            out = [lg]
            for t in range(T, T + steps):
                lg, _, caches = policy.decode(toks[:, t:t + 1], caches)
                out.append(lg)
        logits[mode], routing[mode] = torch.stack(out), log.calls
    routed = ""
    if cfg.num_experts:
        decisions, p_err, flips = routing_flips(routing["cuda"],
                                                routing["ref"])
        for c, g, t, gap in flips:
            print(f"[{tag}] {cfg.name} routing flip: call {c}, sequence "
                  f"{g}, token {t}: router probabilities {gap:.3g} apart",
                  flush=True)
        far = [f for f in flips if not f[3] <= NEAR_TIE]
        if far:
            raise AssertionError(f"{cfg.name}: routing flips that are no "
                                 f"near-tie (gap > {NEAR_TIE}): {far}")
        routed = (f"; routing: {len(routing['ref'])} calls, {decisions} "
                  f"token decisions, {len(flips)} flips (each a near-tie "
                  f"within {NEAR_TIE}), router probabilities max abs err "
                  f"{p_err:.3g}")
    err = check_close("full-width f32 cuda vs ref", logits["cuda"],
                      logits["ref"], 1e-3)
    print(f"[{tag}] {cfg.name} f32 {cfg.num_layers}L d{cfg.d_model}"
          f"{f' {quantize} weights' if quantize else ''}: "
          f"cuda vs ref logits over prefill + {steps} decode steps, max abs "
          f"err {err} (|logit| max "
          f"{float(logits['ref'][..., :cfg.vocab_size].abs().max())})"
          f"{routed}; params built in {init_s:.1f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del policy, caches, routing
    torch.cuda.empty_cache()


def forward_matmuls(cfg):
    """(dense, expert) quantised products of one forward, the unembed
    aside: 4 a attention layer, 2 an SSM layer, 2 a gated MLP; 2 per
    expert (wi, wo) an MoE layer, each over its own rows."""
    kinds = [layer_kinds(cfg, i) for i in range(cfg.num_layers)]
    dense = sum((4 if mixer == "attn" else 2) + 2 * (ffn == "mlp")
                for mixer, ffn in kinds)
    return dense, 2 * cfg.num_experts * sum(ffn == "moe" for _, ffn in kinds)


def serve_launches(cfg, quantize=None, new=None):
    """The kernel launches one ``generate`` of ``new`` tokens must make: one
    prefill kernel per attention or SSM layer, one decode kernel per
    attention layer and step (SSM layers decode without a kernel); with
    quantised weights one quant_matmul per matmul weight and forward (``new``
    forwards: the prefill and ``new`` - 1 decode steps), the unembed
    included, an MoE layer's 2 x E among them (one per expert and weight)."""
    new = new or NEW
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    per_forward = sum(forward_matmuls(cfg)) + 1
    return {"flash_attention": attn, "flash_decode": attn * (new - 1),
            "ssd": cfg.num_layers - attn, "gae": 0, "pack": 0,
            "quant_matmul": new * per_forward if quantize else 0,
            "flash_attention_bwd": 0, "ssd_bwd": 0}


def serve_routes(cfg, quantize=None):
    """The quant_matmul route of each launch of one ``generate``, by the
    rows M of each call as ``qmm_route`` (the launcher's rule) names it for
    bf16 x: the dense matmuls at M = BATCH x PROMPT in the prefill and
    BATCH in a decode step, the experts' at BATCH x C (C the capacity of
    the prefill's or a decode step's length), and every forward's unembed
    at M = BATCH (it reads the last position only)."""
    counts = dict.fromkeys(QMM_PATHS, 0)
    if not quantize:
        return counts
    dense, experts = forward_matmuls(cfg)
    for T, forwards in ((PROMPT, 1), (1, NEW - 1)):
        calls = [(BATCH * T, dense), (BATCH, 1)]
        if experts:
            calls.append((BATCH * moe_mod.capacity(cfg, T), experts))
        for M, n in calls:
            counts[qmm_route(M, torch.bfloat16, False, True, True)] += \
                forwards * n
    return counts


def greedy_tokens(policy, prompt, max_len):
    """A sampled first token from a generator seeded 1, then GREEDY_STEPS
    greedy decode steps: (B, 1 + GREEDY_STEPS) int32."""
    prefill = actor.make_prefill_step(policy, max_len)
    serve = actor.make_serve_step(policy, greedy=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok, _, caches = prefill(prompt, gen)
    out = [tok]
    for _ in range(GREEDY_STEPS):
        tok, _, caches = serve(tok, caches, gen)
        out.append(tok)
    return torch.cat(out, dim=1)


def phase_serve(gen, arch, quantize=None, tag="5 serve", depth=None):
    """``generate`` at the serve shape with its launch counts and routes,
    its times, greedy tokens twice and a profile; ``depth`` cuts the
    number of layers (the widths stay the arch's)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if depth:
        cfg = with_overrides(cfg, num_layers=depth)
    policy = BackbonePolicy(cfg, generator=gen, quantize=quantize)
    sync()
    init_s = time.perf_counter() - t0
    name = (f"{cfg.name}{f' {quantize}' if quantize else ''}"
            f"{f' at depth {depth}' if depth else ''}")
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
    routes = build.routes("quant_matmul")
    want = serve_launches(cfg, quantize)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"launch counts {launches}, expected {want}")
    want_routes = serve_routes(cfg, quantize)
    if routes != want_routes:
        raise AssertionError(f"quant_matmul routes {routes}, expected "
                             f"{want_routes}")
    ssd_routes = build.routes("ssd")      # every SSM prefill on the tensor
    if ssd_routes != {"tensor_core": want["ssd"], "cuda_core": 0}:  # cores
        raise AssertionError(f"ssd routes {ssd_routes}, expected "
                             f"{want['ssd']} tensor_core")
    fa_routes = build.routes("flash_attention")     # every bf16 prefill's
    if fa_routes != {"wgmma": want["flash_attention"], "mma_sync": 0,
                     "cuda_core": 0}:               # attention on wgmma
        raise AssertionError(f"flash_attention routes {fa_routes}, expected "
                             f"{want['flash_attention']} wgmma")
    fa_note = (f"; flash_attention routes {fa_routes}"
               if want["flash_attention"] else "")
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
    print(f"[{tag}] {name} bf16 B{BATCH} prompt {PROMPT} +{NEW} tokens: "
          f"generate {total_s * 1e3:.1f} ms, {tok_s:.1f} tok/s; prefill "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms/token; launches "
          f"{launches}{f'; quant_matmul routes {routes}' if quantize else ''}"
          f"{f'; ssd routes {ssd_routes}' if want['ssd'] else ''}"
          f"{fa_note}; params "
          f"built in {init_s:.1f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    first, again = (greedy_tokens(policy, prompt, max_len)
                    for _ in range(2))
    if not torch.equal(first, again):
        raise AssertionError(f"{name}: greedy tokens differ between two "
                             f"runs")
    print(f"[{tag}] {name}: greedy tokens of two runs (prefill + "
          f"{GREEDY_STEPS} steps) are identical", flush=True)

    # where the time goes: one profiled prefill, then 8 profiled decode steps
    state = {}

    def run_prefill():
        state["tok"], _, state["caches"] = prefill(prompt, gen)

    def run_decode():
        state["tok"], _, state["caches"] = serve(state["tok"], state["caches"],
                                                 gen)

    kernels = (("ssd_tc_kernel",) if want["ssd"] else ()) + (
        ("qmm_wg_kernel", "dec_kn_kernel") if quantize else ())
    profile_steps(tag, f"{name} prefill", run_prefill, 1, prefill_ms,
                  kernels)
    profile_steps(tag, f"{name} decode step", run_decode, 8, decode_ms,
                  kernels)
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


def profile_steps(tag, label, fn, steps, wall_ms, kernels=()):
    """Profile ``steps`` calls of ``fn``; print the device time per step
    against ``wall_ms`` (the same step timed without the profiler), the
    device's idle share, the kernels run per step and the top kernels, and
    the device ms per step of each of ``kernels`` beside the step's."""
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
    for k in kernels:
        ms = by_name.get(k, 0.0) / steps
        print(f"[{tag}] {label}: {k} {ms:.3f} ms of the step's {busy:.3f} ms "
              f"device time ({100 * ms / busy:.1f}%)", flush=True)


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


def engine_state(eng):
    """Every tensor of an engine's resumable state, in a fixed order: the
    generator's state, the TrainState (params, AdamW moments and steps)
    and the rollout carry."""
    return ([eng.generator.get_state()]
            + [leaf for _, leaf in ckpt._flatten_with_names(eng.ts)]
            + [leaf for _, leaf in ckpt._flatten_with_names(eng.rc)])


def equal_states(a, b):
    sa, sb = engine_state(a), engine_state(b)
    return len(sa) == len(sb) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for x, y in zip(sa, sb))


def phase_checkpoint():
    """Path A: a jit-tier run at the squared preset that is stopped, saved,
    restored into a new engine and resumed ends bitwise equal to an
    uninterrupted run (generator, params, AdamW state, rollout carry), and
    two uninterrupted runs are bitwise equal first; an async save of a live
    engine holds the values at its call. Returns the gae launches of the
    resumed half, one per update."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = preset("squared")
    tcfg = ocean_tcfg("squared", checkpoint_every=CKPT_U)

    def engine(seed=0):
        return Trainer(OCEAN["squared"](), tcfg, hidden=p.hidden,
                       seed=seed).engine

    a, a2 = engine(), engine()
    spu = a.steps_per_update
    a.run(2 * CKPT_U * spu)
    a2.run(2 * CKPT_U * spu)
    sync()
    if not equal_states(a, a2):
        raise AssertionError("two uninterrupted jit-tier runs differ")
    with tempfile.TemporaryDirectory() as d:
        b = engine()
        b.checkpoint_dir = d
        b.run(CKPT_U * spu)            # saves at update CKPT_U, async
        sync()
        t0 = time.perf_counter()
        path = b.save_checkpoint(CKPT_U, async_=False)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        c = engine(seed=7)
        t0 = time.perf_counter()
        got = c.restore(d)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if got != CKPT_U:
            raise AssertionError(f"restored update {got}, saved {CKPT_U}")
        build.reset_launches()
        hist, _ = c.run(2 * CKPT_U * spu)
        sync()
        launches = check_launches("checkpoint resume", {
            "gae": len(hist), "pack": 0, "flash_attention": 0,
            "flash_decode": 0, "ssd": 0, "quant_matmul": 0})
        if len(hist) != CKPT_U or not equal_states(a, c):
            raise AssertionError(f"stopped-and-resumed run ({len(hist)} "
                                 f"updates after the restore) is not "
                                 f"bitwise equal to the uninterrupted one")
        print(f"[10 checkpoint] squared preset ({tcfg.num_envs} envs x "
              f"{tcfg.unroll_length} steps, hidden {p.hidden}): two "
              f"uninterrupted runs of {2 * CKPT_U} updates bitwise equal; "
              f"{CKPT_U} updates, save, new engine, restore, {CKPT_U} more: "
              f"generator, params, AdamW state and rollout carry bitwise "
              f"equal to the uninterrupted run ({len(engine_state(a))} "
              f"tensors); save {save_ms:.2f} ms (synchronous), restore "
              f"{restore_ms:.2f} ms, {nbytes} bytes in "
              f"{len(list(Path(path).iterdir()))} files; launches after the "
              f"restore {launches}", flush=True)

    with tempfile.TemporaryDirectory() as d:
        e = engine()
        e.checkpoint_dir = d
        e.run(CKPT_U * spu)
        sync()
        want = [x.clone() for x in engine_state(e)]
        t0 = time.perf_counter()
        handle = e.save_checkpoint(CKPT_U, async_=True)
        call_ms = (time.perf_counter() - t0) * 1e3
        e.run(CKPT_U * spu)            # the live engine moves on
        handle.join()
        sync()
        r = engine(seed=3)
        r.restore(d)
        got = engine_state(r)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError("the async save wrote other values than "
                                 "the engine's at its call")
        if all(torch.equal(x, y) for x, y in zip(engine_state(e), want)):
            raise AssertionError("the live engine did not move on")
        print(f"[10 checkpoint] async save of a live engine: the call took "
              f"{call_ms:.2f} ms (device-to-host copy), {CKPT_U} more "
              f"updates ran while it wrote, and the checkpoint holds the "
              f"values at the call", flush=True)
    del a, a2, b, c, e, r
    torch.cuda.empty_cache()
    return launches


def run_launcher(tag, args, timeout, on_line=None):
    """``python -m repro_torch.launch.train`` with ``args`` in a subprocess
    of its own session, its lines read as they come; ``on_line(line,
    proc)`` may act on each. Every process of the session is stopped at
    the end. Returns (exit code, stdout lines)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args]
    proc = subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "PYTHONUNBUFFERED": "1"})
    lines = queue.Queue()

    def read():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    out, deadline = [], time.monotonic() + timeout
    try:
        while True:
            try:
                ln = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"[{tag}] launcher still running after "
                                     f"{timeout} s:\n" + "".join(out[-40:]))
            if ln is None:
                break
            out.append(ln)
            if on_line is not None:
                on_line(ln, proc)
        rc = proc.wait(timeout=60)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)     # any process left over
        except ProcessLookupError:
            pass
        proc.wait(timeout=60)
    return rc, out


def async_summary(tag, out):
    """The numbers of one async launcher run: (updates this run, last
    update, launches, the async line, the actor lines)."""
    line = next((ln for ln in out if "last_update=" in ln), None)
    if line is None:
        raise AssertionError(f"[{tag}] no result line:\n" + "".join(out[-40:]))
    got = re.search(r"updates=(\d+) last_update=(\d+) launches=(\{.*\})",
                    line)
    stats = next(ln for ln in out if ln.startswith("  async:"))
    actors = [ln.strip() for ln in out if ln.startswith("  actor ")]
    mem = [ln.strip() for ln in out if "mem_get_info" in ln]
    return (int(got.group(1)), int(got.group(2)),
            ast.literal_eval(got.group(3)), line.strip(), stats.strip(),
            actors, mem)


def async_evidence(run_dir, out):
    """One line: the score of every update of an async launcher run (from
    its metrics log in ``run_dir``), the fragments dropped so far and the
    fragments' mean and largest age at each update, and the run's async
    line when it printed one."""
    recs = []
    for path in sorted(Path(run_dir).glob("*.jsonl")):
        if not path.name.startswith("spans"):
            recs += [json.loads(ln) for ln in path.read_text().splitlines()
                     if ln.strip()]
    recs = [r for r in recs if "score" in r]
    stats = next((ln.strip() for ln in out if ln.startswith("  async:")),
                 "no async line")
    return (f"[11 async] (a) evidence: {len(recs)} updates; score "
            f"{[round(r['score'], 3) for r in recs]}; dropped "
            f"{[int(r.get('dropped_fragments', 0)) for r in recs]}; age "
            f"mean {[round(r.get('frag_age_mean', 0.0), 2) for r in recs]}; "
            f"age max {[int(r.get('frag_age_max', 0)) for r in recs]}; "
            f"{stats}")


def phase_async():
    """Path B: the async actor–learner tier through the launcher, each run
    in a subprocess (its actors are spawned processes, each with its own
    CUDA context). (a) bandit with 2 actors solves, one gae launch per
    update on the learner; (b) a full-budget run in which one actor is
    killed (SIGKILL) after the first update reshards and finishes every
    update; (c) a learner stopped (SIGINT) after update 11 and resumed
    with --ckpt-dir --resume ends at the same update count as (b)'s
    uninterrupted learner. Returns the gae launches of (a)."""
    base = ["--ocean", "bandit", "--engine-backend", "async", "--num-actors",
            "2"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rc, out = run_launcher("11 async", base + [
            "--run-dir", d, "--ckpt-dir", os.path.join(d, "ck")],
            timeout=600)
        wall = time.perf_counter() - t0
        # the evidence for the verdict below, whatever the verdict
        print(async_evidence(d, out), flush=True)
    if rc != 0 or not any("-> SOLVED" in ln for ln in out):
        raise AssertionError(f"async bandit did not solve (exit {rc}):\n"
                             + "".join(out[-40:]))
    n, last, launches, line, stats, actors, mem = async_summary("11 async",
                                                                out)
    if launches["gae"] != n or n != last or any(
            launches[k] for k in launches if k != "gae"):
        raise AssertionError(f"async launches {launches} over {n} updates")
    if len(actors) != 2 or not all("device=cuda" in a for a in actors):
        raise AssertionError(f"actor devices: {actors}")
    print(f"[11 async] (a) bandit, 2 actors, through the launcher in "
          f"{wall:.1f} s wall (interpreter, spawn and CUDA contexts "
          f"included):{line.split('->')[1]}", flush=True)
    print(f"[11 async] (a) {stats}", flush=True)
    for a in actors + mem:
        print(f"[11 async] (a) {a}", flush=True)

    steps = ASYNC_UPDATES * 64 * 64
    full = base + ["--full-budget", "--total-env-steps", str(steps)]
    killed = {}

    def kill_actor(ln, proc):
        if "pids=[" in ln:
            killed["pids"] = ast.literal_eval(ln.split("pids=")[1]
                                              .split("]")[0] + "]")
        if ln.startswith("  upd") and "done" not in killed:
            os.kill(killed["pids"][1], signal.SIGKILL)
            killed["done"] = ln.split()[1]

    with tempfile.TemporaryDirectory() as d:
        rc, out = run_launcher("11 async", full + ["--ckpt-dir", d],
                               timeout=600, on_line=kill_actor)
    n, last, launches, line, stats, actors, _ = async_summary("11 async", out)
    if rc != 0 or n != ASYNC_UPDATES or "reshards=1" not in stats or \
            "dead=[1]" not in stats or launches["gae"] != n:
        raise AssertionError(f"actor-kill run (exit {rc}): {line} {stats}")
    print(f"[11 async] (b) actor 1 killed after update "
          f"{killed['done']}: resharded and finished {n} of {ASYNC_UPDATES}"
          f" updates; {stats}", flush=True)

    with tempfile.TemporaryDirectory() as d:
        ck = full + ["--ckpt-dir", d, "--save-every", "5"]
        stop = {}

        def interrupt(ln, proc):
            if ln.startswith("  upd   10") and "sent" not in stop:
                proc.send_signal(signal.SIGINT)
                stop["sent"] = True

        rc1, out1 = run_launcher("11 async", ck, timeout=600,
                                 on_line=interrupt)
        if rc1 == 0 or "sent" not in stop:
            raise AssertionError(f"the learner was not stopped (exit {rc1})")
        saved = ckpt.step_of(ckpt.latest(os.path.join(d, "bandit")))
        rc2, out2 = run_launcher("11 async", ck + ["--resume"], timeout=600)
        n2, last2, launches2, line2, _, _, _ = async_summary("11 async",
                                                             out2)
        resumed = [ln.strip() for ln in out2 if "resumed at update" in ln]
        if rc2 != 0 or last2 != last or n2 != last2 - saved or \
                launches2["gae"] != n2:
            raise AssertionError(f"kill-then-resume ended at update {last2} "
                                 f"({n2} after {resumed}), uninterrupted "
                                 f"{last}")
        print(f"[11 async] (c) learner stopped by SIGINT after update 11 "
              f"(exit {rc1}), newest checkpoint at update {saved}; "
              f"{resumed[0]}, {n2} more updates, ends at update {last2} as "
              f"the uninterrupted learner did; gae {launches2['gae']}",
              flush=True)
    return launches


def ocean2_solve(name, seed):
    """One Ocean II env at its preset through the Trainer on the card:
    returns (trainer, final metrics, wall s, gae launches, conv frontend
    calls)."""
    p = preset(name)
    tr = Trainer(OCEAN[name](), ocean_tcfg(name), hidden=p.hidden,
                 recurrent=p.recurrent, conv=p.conv, seed=seed)
    conv_calls = [0]
    if tr.policy.conv_shape:
        frontend = tr.policy._conv_frontend

        def counted(params, obs):
            conv_calls[0] += 1
            return frontend(params, obs)
        tr.policy._conv_frontend = counted
    build.reset_launches()
    t0 = time.perf_counter()
    m = tr.train(p.total_steps, target_score=p.target_score)
    sync()
    wall = time.perf_counter() - t0
    launches = check_launches(f"12 ocean2 {name}", {
        "gae": len(tr.history), "pack": 0, "flash_attention": 0,
        "flash_decode": 0, "ssd": 0, "quant_matmul": 0})
    return tr, m, wall, launches["gae"], conv_calls[0]


def maze_layouts(eng, episodes=64):
    """Distinct wall layouts over the first ``episodes`` episodes of env 0
    of the engine's VecEnv (random actions, on the card): the walls and
    done flags of every step stay on the device until the end."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    vec = eng.vec
    state, _ = vec.init(gen)
    walls, dones = [state["walls"][0].clone()], []
    steps = episodes * vec.env.env.horizon
    for _ in range(steps):
        act = torch.randint(0, 5, (vec.batch_size, 1), generator=gen,
                            device="cuda", dtype=torch.int32)
        state, _, _, done, _ = vec.step(state, act, gen)
        walls.append(state["walls"][0].clone())
        dones.append(done[0])
    walls = torch.stack(walls).cpu().numpy()
    ends = torch.stack(dones).cpu().numpy().nonzero()[0]
    if len(ends) < episodes - 1:
        raise AssertionError(f"env 0 ended {len(ends)} episodes in {steps} "
                             f"steps")
    # episode e + 1 starts at the state after the step that ended e
    firsts = [walls[0]] + [walls[i + 1] for i in ends[:episodes - 1]]
    return len({w.tobytes() for w in firsts}), len(firsts)


def phase_ocean2():
    """Path C, Ocean II: pong, drone, tagteam and maze at their
    ``configs/ocean.py`` presets through the Trainer on the card, each to
    its target score on seed 0 (a stall re-runs the preset over seeds 0-5
    and passes only if 5 of 6 solve), one gae launch per update; pong must
    run the conv frontend, and maze must draw a new layout per episode.
    Returns {env: (updates, gae launches)}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in OCEAN2:
        p = preset(name)
        tr, m, wall, gae_n, conv_calls = ocean2_solve(name, 0)
        n = len(tr.history)
        status = "SOLVED" if m["score"] >= p.target_score else "stalled"
        extra = ""
        if name == "pong":
            if tr.policy.conv_shape != (6, 6) or not conv_calls:
                raise AssertionError(f"pong did not run the conv frontend "
                                     f"({conv_calls} calls)")
            extra = (f"; conv frontend {tr.policy.conv_shape} with "
                     f"{tr.policy.CONV_FILTERS} filters ran {conv_calls} "
                     f"times ({conv_calls / n:.0f} per update)")
        if name == "maze":
            distinct, eps = maze_layouts(tr.engine)
            if distinct <= 1:
                raise AssertionError(f"maze replayed one layout over {eps} "
                                     f"episodes")
            extra = (f"; env 0's first {eps} episodes drew {distinct} "
                     f"distinct wall layouts")
        print(f"[12 ocean2] {name} {status} score {m['score']:.3f} at "
              f"{m['env_steps']} env steps (budget {p.total_steps}, seed 0) "
              f"in {wall:.2f} s wall, {n} updates "
              f"({m['env_steps'] / wall:.0f} sps), gae launches {gae_n} == "
              f"updates{extra}", flush=True)
        if status != "SOLVED":
            solved = 0
            for seed in range(6):
                trs, ms, walls, _, _ = (tr, m, wall, gae_n, 0) if seed == 0 \
                    else ocean2_solve(name, seed)
                ok = ms["score"] >= p.target_score
                solved += ok
                print(f"[12 ocean2] {name} seed {seed}: "
                      f"{'SOLVED' if ok else 'stalled'} score "
                      f"{ms['score']:.3f} at {ms['env_steps']} env steps in "
                      f"{walls:.2f} s", flush=True)
                del trs
            if solved < 5:
                raise AssertionError(f"{name} solved on {solved} of 6 seeds")
        out[name] = (n, gae_n)
        del tr
    torch.cuda.empty_cache()
    return out


def phase_selfplay():
    """Path D, league self-play: (a) the launcher with --selfplay on duel at
    its preset in a subprocess, winrate against random >= 0.9, one gae a
    learner update; (b) a full-size self-play update (duel, 4096 envs x 64
    steps), one launch under sync debug mode "error"; (c) the arena's
    batched pool against its one-pass-per-opponent form. Returns the gae
    launches of (b)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = preset("duel")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rc, out = run_launcher("13 selfplay", [
            "--ocean", "duel", "--selfplay", "--league-dir", d], timeout=600)
        wall = time.perf_counter() - t0
        line = next((ln for ln in out if "winrate_vs_random=" in ln), None)
        if rc != 0 or line is None:
            raise AssertionError(f"selfplay launcher exit {rc}:\n"
                                 + "".join(out[-40:]))
        got = re.search(r"winrate_vs_random=([0-9.]+) versions=(\[.*\]) "
                        r"updates=(\d+) steps=(\d+) launches=(\{.*\})", line)
        wr, versions = float(got.group(1)), ast.literal_eval(got.group(2))
        n, steps = int(got.group(3)), int(got.group(4))
        launches = ast.literal_eval(got.group(5))
        if wr < p.target_score or launches["gae"] != n or any(
                launches[k] for k in launches if k != "gae"):
            raise AssertionError(f"selfplay: {line}")
        board = out[out.index(line) + 1:]
        print(f"[13 selfplay] (a) duel through the launcher (preset "
              f"{p.total_steps} steps, K 1, snapshots every 10 updates) in "
              f"{wall:.1f} s wall, interpreter start included: winrate vs "
              f"random {wr:.3f} (>= {p.target_score}), {n} updates, {steps} "
              f"env steps, gae launches {launches['gae']} == updates, store "
              f"versions {versions}; leaderboard: "
              + " | ".join(" ".join(b.split()) for b in board[1:]),
              flush=True)

    with tempfile.TemporaryDirectory() as d:
        tcfg = ocean_tcfg("duel", num_envs=TRAIN_ENVS)
        eng, store, _, sampler, arena = build_league(
            OCEAN["duel"](), tcfg, league_dir=d, hidden=p.hidden, seed=0)
        spu = eng.steps_per_update
        eng.run(2 * spu)                                # warm-up
        sync()
        build.reset_launches()
        t0 = time.perf_counter()
        hist, _ = eng.run(5 * spu)
        sync()
        wall = time.perf_counter() - t0
        opp = sampler.next_params()       # store load and copy: outside
        sync()
        torch.cuda.set_sync_debug_mode("error")         # no sync in a launch
        try:
            ring = eng.launch(1, opp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync()
        updates = len(hist) + 1
        sp_launches = check_launches("13 selfplay (b)", {
            "gae": updates, "pack": 0, "flash_attention": 0,
            "flash_decode": 0, "ssd": 0, "quant_matmul": 0})
        if not (bool(torch.isfinite(ring).all()) and all(
                math.isfinite(h[k]) for h in hist for k in METRIC_KEYS)):
            raise AssertionError("non-finite metrics in the self-play run")
        update_ms = wall * 1e3 / len(hist)
        A, L = eng.vec.num_agents, eng._sp_agents
        print(f"[13 selfplay] (b) duel full size: {TRAIN_ENVS} envs x "
              f"{tcfg.unroll_length} steps, {TRAIN_ENVS * A} agent rows "
              f"({TRAIN_ENVS * L} learner rows), hidden {p.hidden}, "
              f"{tcfg.update_epochs} epochs x {tcfg.num_minibatches} "
              f"minibatches, K 1: {len(hist) * spu / wall:.0f} sps (all "
              f"rows), {update_ms:.2f} ms/update (launch "
              f"{sum(h['launch_ms'] for h in hist) / len(hist):.2f} ms); a "
              f"launch ran under sync debug mode 'error'; launches "
              f"{sp_launches} over {updates} updates", flush=True)
        profile_steps("13 selfplay", "(b) full-size self-play update",
                      lambda: eng.launch(1, opp), 1, update_ms)

        # (c) K opponents from the store: the batched pass against one
        # pass per opponent, in turns (pooled, sequential, sequential,
        # pooled), each from the same generator seed
        for _ in range(POOL_K - 1):
            eng.launch(1, opp)
            store.add(eng.ts.params)
        versions = store.versions()[-POOL_K:]
        stacked = store.load_stacked(versions, sampler.like)
        pa = eng.ts.params
        pool_arena = Arena(arena.em, arena.policy, arena.dist,
                           num_envs=POOL_ENVS)
        times, results = {"pooled": [], "sequential": []}, {}
        for kind in ("pooled", "sequential", "sequential", "pooled"):
            fn = (pool_arena.vs_pool if kind == "pooled"
                  else pool_arena.vs_pool_sequential)
            g = torch.Generator(device="cuda").manual_seed(5)
            sync()
            t0 = time.perf_counter()
            res = fn(pa, stacked, g)
            times[kind].append((time.perf_counter() - t0) * 1e3)
            if results.setdefault(kind, res) != res:
                raise AssertionError(f"arena {kind} is not repeatable")
        if results["pooled"] != results["sequential"]:
            raise AssertionError(f"vs_pool {results['pooled']} != "
                                 f"vs_pool_sequential "
                                 f"{results['sequential']}")
        print(f"[13 selfplay] (c) arena vs_pool over {POOL_K} stored "
              f"versions {versions}, {POOL_ENVS} envs a match x "
              f"{pool_arena.steps} steps: outcomes equal to "
              f"vs_pool_sequential "
              f"{[round(r['outcome'], 4) for r in results['pooled']]} "
              f"({sum(r['episodes'] for r in results['pooled']):.0f} "
              f"episodes); pooled {min(times['pooled']):.1f} ms, sequential "
              f"{min(times['sequential']):.1f} ms (best of 2 in turns, "
              f"host wall with the final copy)", flush=True)
        del eng, store, sampler, arena, pool_arena, stacked
    torch.cuda.empty_cache()
    return sp_launches


def http_get(url, timeout=10.0):
    """(status, body text) of a GET; an HTTP error status is returned."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def shard_engine(name, backend, opp_seed=None):
    """A TrainEngine at ``name``'s preset on ``backend``; with
    ``opp_seed``, self-play against one opponent drawn from that seed."""
    p = preset(name)
    em, dist, pol = ocean_policy_stack(OCEAN[name](), hidden=p.hidden,
                                       recurrent=p.recurrent, conv=p.conv)
    sp = None
    if opp_seed is not None:
        opp = pol.init(torch.Generator(device="cuda").manual_seed(opp_seed))
        sp = SelfPlay(lambda: opp)
    return TrainEngine(em, pol, ocean_tcfg(name), dist, seed=0,
                       backend=backend, selfplay=sp)


def phase_shard():
    """Path H, the data-parallel ``shard_map`` tier at world size 1 over
    NCCL: (a) bit for bit against the jit tier on squared and duel
    self-play, with its gae launches and all-reduces; (b) the launcher with
    monitoring and profiling in a subprocess. Returns the gae launches of
    (b)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, opp_seed in (("squared", None), ("duel", 7)):
        tcfg = ocean_tcfg(name)
        per_update = tcfg.update_epochs * tcfg.num_minibatches + 1
        engines = {b: shard_engine(name, b, opp_seed)
                   for b in ("jit", "shard_map")}
        try:
            got = torch.distributed.get_backend()
            if got != "nccl" or engines["shard_map"].num_shards != 1:
                raise AssertionError(f"shard_map tier on {got}, world size "
                                     f"{engines['shard_map'].num_shards}")
            runs = {}
            for backend, eng in engines.items():
                build.reset_launches()
                shd.reset_collectives()
                hist, _ = eng.run(SHARD_UPDATES * eng.steps_per_update)
                sync()
                runs[backend] = (hist, [x.clone() for x in engine_state(eng)],
                                 dict(build.LAUNCHES), dict(shd.COLLECTIVES))
            # then each tier's ms an update, in turns, both warm
            rounds = {b: [] for b in engines}
            for b in ("jit", "shard_map", "shard_map", "jit"):
                sync()
                t0 = time.perf_counter()
                engines[b].run(SHARD_TIME_UPDATES * engines[b].steps_per_update)
                sync()
                rounds[b].append((time.perf_counter() - t0) * 1e3
                                 / SHARD_TIME_UPDATES)
        finally:
            for eng in engines.values():
                eng.close()
        ms_a, ms_b = (statistics.mean(rounds[b]) for b in engines)
        (ha, sa, la, _), (hb, sb, lb, cb) = runs["jit"], runs["shard_map"]
        same = len(sa) == len(sb) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(sa, sb))
        metrics_same = len(ha) == len(hb) == SHARD_UPDATES and all(
            x[k] == y[k] for x, y in zip(ha, hb) for k in METRIC_KEYS)
        if not (same and metrics_same):
            raise AssertionError(f"[17 shard] (a) {name}: shard_map at world "
                                 f"size 1 differs from the jit tier (state "
                                 f"equal {same}, metrics equal "
                                 f"{metrics_same})")
        want = {"gae": SHARD_UPDATES, "flash_attention": 0,
                "flash_decode": 0, "ssd": 0, "quant_matmul": 0, "pack": 0}
        for tier, got in (("jit", la), ("shard_map", lb)):
            if any(got[k] != v for k, v in want.items()):
                raise AssertionError(f"[17 shard] (a) {name} {tier}: launch "
                                     f"counts {got}, expected {want}")
        if cb["all_reduce"] != SHARD_UPDATES * per_update:
            raise AssertionError(f"[17 shard] (a) {name}: {cb} over "
                                 f"{SHARD_UPDATES} updates, expected "
                                 f"{per_update} all-reduces an update")
        print(f"[17 shard] (a) {name}{' self-play' if opp_seed else ''} "
              f"preset ({tcfg.num_envs} envs x {tcfg.unroll_length} steps, "
              f"{tcfg.update_epochs} epochs x {tcfg.num_minibatches} "
              f"minibatches): shard_map (NCCL, world size 1) == jit bit for "
              f"bit over {SHARD_UPDATES} updates ({len(sa)} state tensors, "
              f"{len(METRIC_KEYS)} metrics an update); ms/update jit "
              f"{ms_a:.2f}, shard_map {ms_b:.2f} (rounds of "
              f"{SHARD_TIME_UPDATES} in turns, jit "
              f"{', '.join(f'{x:.2f}' for x in rounds['jit'])}, shard_map "
              f"{', '.join(f'{x:.2f}' for x in rounds['shard_map'])}); "
              f"gae {lb['gae']} ({lb['gae'] // SHARD_UPDATES} an "
              f"update); collectives {cb}: "
              f"{cb['all_reduce'] // SHARD_UPDATES} all-reduces an update "
              f"(E x M = {per_update - 1} + 1), "
              f"{cb['all_gather'] // SHARD_UPDATES} all-gathers (the "
              f"advantage statistics)", flush=True)

    # (b) the launcher, watched while it trains, then its records read
    with tempfile.TemporaryDirectory() as d:
        run_dir, prof_dir = os.path.join(d, "run"), os.path.join(d, "prof")
        seen = {}

        def probe(ln, proc):
            if ln.startswith("monitoring:"):
                seen["url"] = ln.split()[1].rsplit("/metrics", 1)[0]
            if ln.startswith("  upd") and "url" in seen and \
                    "metrics" not in seen:
                for ep in ("metrics", "healthz", "spans"):
                    seen[ep] = http_get(f"{seen['url']}/{ep}")

        ck = os.path.join(d, "ck")
        t0 = time.perf_counter()
        rc, out = run_launcher("17 shard", [
            "--ocean", "squared", "--engine-backend", "shard_map",
            "--full-budget", "--total-env-steps",
            str(SHARD_LAUNCHER_UPDATES * ocean_tcfg("squared").num_envs
                * ocean_tcfg("squared").unroll_length),
            "--metrics-port", "0", "--run-dir", run_dir, "--profile",
            prof_dir, "--profile-launches", "3", "--ckpt-dir", ck,
            "--save-every", "10"], timeout=300, on_line=probe)
        wall = time.perf_counter() - t0
        line = next((ln for ln in out if "collectives=" in ln), None)
        if rc != 0 or line is None or "metrics" not in seen:
            raise AssertionError(f"[17 shard] (b) launcher exit {rc}, "
                                 f"endpoints read: {sorted(seen)}:\n"
                                 + "".join(out[-40:]))
        got = re.search(r"updates=(\d+) world_size=(\d+) launches=(\{.*?\})"
                        r" collectives=(\{.*?\})", line)
        n, world = int(got.group(1)), int(got.group(2))
        launches = ast.literal_eval(got.group(3))
        coll = ast.literal_eval(got.group(4))
        per_update = (ocean_tcfg("squared").update_epochs
                      * ocean_tcfg("squared").num_minibatches + 1)
        saved = ckpt.latest(os.path.join(ck, "squared"))
        if world != 1 or n != SHARD_LAUNCHER_UPDATES or \
                launches["gae"] != n or any(
                    launches[k] for k in launches if k != "gae") or \
                coll["all_reduce"] != n * per_update or saved is None or \
                ckpt.step_of(saved) != n:
            raise AssertionError(f"[17 shard] (b) {line} (newest checkpoint "
                                 f"{saved})")
        code_m, metrics = seen["metrics"]
        code_h, health = seen["healthz"]
        code_s, spans = seen["spans"]
        want = ('repro_stat_world_size{source="engine"} 1',
                'repro_stat_all_reduces{source="engine"}')
        if code_m != 200 or not all(w in metrics for w in want):
            raise AssertionError(f"[17 shard] (b) /metrics {code_m}:\n"
                                 f"{metrics[-2000:]}")
        if code_h != 200 or json.loads(health)["ok"] is not True:
            raise AssertionError(f"[17 shard] (b) /healthz {code_h}: "
                                 f"{health}")
        if code_s != 200:
            raise AssertionError(f"[17 shard] (b) /spans {code_s}: {spans}")
        json.loads(spans)
        traces = sorted(Path(prof_dir).glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"[17 shard] (b) traces in {prof_dir}: "
                                 f"{traces}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        gae_events = [e for e in kernels if "gae_kernel" in e.get("name", "")]
        if not gae_events:
            raise AssertionError(f"[17 shard] (b) the trace's {len(kernels)} "
                                 f"kernel events name no gae_kernel")
        cli = {}
        for cmd in ("summarize", "export-trace"):
            r = subprocess.run([sys.executable, "-m", "repro_torch.telemetry",
                                cmd, run_dir], cwd=ROOT, capture_output=True,
                               text=True, timeout=120,
                               env={**os.environ,
                                    "PYTHONPATH": str(ROOT / "src")})
            if r.returncode != 0:
                raise AssertionError(f"[17 shard] (b) telemetry {cmd} exit "
                                     f"{r.returncode}:\n{r.stdout[-2000:]}"
                                     f"\n{r.stderr[-2000:]}")
            cli[cmd] = next((ln for ln in r.stdout.splitlines()
                             if ln.startswith(("# sps", "wrote"))), "")
    metric_lines = [ln for ln in metrics.splitlines()
                    if 'source="engine"' in ln or ln.startswith("engine_")]
    print(f"[17 shard] (b) launcher, squared on the shard_map tier, "
          f"{n} updates (checkpoints every 10, gathered and written by "
          f"rank 0, newest at update {ckpt.step_of(saved)}) in {wall:.1f} s "
          f"wall (start-up included): {line.split('->')[1].strip()}",
          flush=True)
    print(f"[17 shard] (b) while it trained: /metrics {code_m} "
          f"({len(metrics.splitlines())} lines; {'; '.join(metric_lines)}), "
          f"/healthz {code_h} {json.loads(health)['ok']}, /spans {code_s} "
          f"({len(json.loads(spans))} span names)", flush=True)
    print(f"[17 shard] (b) profile of the first 3 launches: {traces[0].name}"
          f", {len(kernels)} kernel events, {len(gae_events)} gae_kernel "
          f"({gae_events[0]['name'][:60]}, "
          f"{sum(e.get('dur', 0) for e in gae_events) / len(gae_events):.1f}"
          f" us each); telemetry summarize: {cli['summarize']}; "
          f"export-trace: {cli['export-trace']}", flush=True)
    return launches


def grad_err(name, got, want, tol, scale=None):
    """max |got - want| within ``tol`` of ``scale`` (default the largest
    |want|); returns the max abs error."""
    err = max_err(got, want)
    scale = scale or max(float(want.float().abs().max()), 1e-6)
    if not (err <= tol * scale and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"{name}: max abs err {err} beyond {tol} of "
                             f"{scale}")
    return err


def fa_bwd_case(gen, shape, dtype, tol, view=False):
    """flash_attention_bwd at one shape against the plain version in f32 on
    the same inputs, the forward's LSE against the plain one, two calls bit
    for bit, each on the route ``bwd_route`` names as the launcher counted
    it; with ``view``, q, k, v views of one fused projection and a
    transposed do, also bit for bit against contiguous copies. Returns the
    max abs error of dq, dk, dv."""
    B, T, S, H, K, hd, causal = shape
    if view:
        qkv = randn(gen, (B, T, (H + 2 * K) * hd), dtype)
        q = qkv[..., :H * hd].unflatten(-1, (H, hd))
        k = qkv[..., H * hd:(H + K) * hd].unflatten(-1, (K, hd))
        v = qkv[..., (H + K) * hd:].unflatten(-1, (K, hd))
        do = randn(gen, (B, H, T, hd), dtype).transpose(1, 2)
    else:
        q = randn(gen, (B, T, H, hd), dtype)
        k, v = (randn(gen, (B, S, K, hd), dtype) for _ in range(2))
        do = randn(gen, (B, T, H, hd), dtype)
    o, lse = flash_attention_fwd(q, k, v, causal, with_lse=True)
    build.routes(BWD, reset=True)
    check_close(f"flash_attention lse {shape} {dtype}", lse,
                ref.flash_attention_lse(q, k, causal), 1e-4)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   do.float(), causal=causal)
    scale = max(float(w.abs().max()) for w in want)   # dq is 0 at T = 1
    err = max(grad_err(f"flash_attention_bwd {n} {shape} {dtype}", g, w,
                       tol, scale) for n, g, w in zip("qkv", got, want))
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {shape} {dtype}: two "
                             f"calls differ")
    calls = 2
    if view:
        dense = flash_attention_bwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o, lse, do.contiguous(),
                                    causal)
        calls += 1
        if not all(torch.equal(a, b) for a, b in zip(got, dense)):
            raise AssertionError(f"flash_attention_bwd {shape} {dtype}: "
                                 f"views and contiguous copies differ")
    want_route = bwd_route(dtype, hd)
    taken = build.routes(BWD)
    if taken != {r: calls * (r == want_route) for r in taken}:
        raise AssertionError(f"flash_attention_bwd {shape} {dtype}: routes "
                             f"{taken}, expected {calls} on {want_route}")
    return err


def ssd_bwd_case(gen, shape, dtype, tol, layout=None):
    """ssd_bwd at one shape (inputs laid out as models/ssm.py gives them, or
    with ``layout`` x one element off 16 bytes or dy transposed) against
    the plain version in f32 on the same inputs, two calls bit for bit, each
    on the route ``bwd_route`` names as the launcher counted it (a
    transposed dy also bit for bit against a contiguous copy); returns the
    max abs error over its five gradients."""
    B, T, H, P, N, G = shape[:6]
    x, dt, A, B_, C = ssd_inputs(gen, B, T, H, P, N, G, dtype,
                                 shape[6] is True)
    if layout == "x_unaligned":
        x = randn(gen, (B, T, H * P + 1), dtype)[..., 1:].unflatten(
            -1, (H, P))
    dy = randn(gen, (B, T, H, P), dtype)
    if layout == "dy_transposed":
        dy = randn(gen, (B, H, T, P), dtype).transpose(1, 2)
    dh_last = (randn(gen, (B, H, P, N), torch.float32)
               if shape[7:] == (True,) else None)
    build.routes(SSD_BWD, reset=True)
    got = ssd_bwd(x, dt, A, B_, C, dy, dh_last)
    want = ref.ssd_bwd(x.float(), dt, A, B_.float(), C.float(), dy.float(),
                       dh_last)
    err = max(grad_err(f"ssd_bwd {n} {shape} {dtype} {layout}", g, w, tol)
              for n, g, w in zip(("dx", "ddt", "dA", "dB_", "dC"), got,
                                 want))
    again = ssd_bwd(x, dt, A, B_, C, dy, dh_last)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"ssd_bwd {shape} {dtype}: two calls differ")
    calls = 2
    if layout == "dy_transposed":
        dense = ssd_bwd(x, dt, A, B_, C, dy.contiguous(), dh_last)
        calls += 1
        if not all(torch.equal(a, b) for a, b in zip(got, dense)):
            raise AssertionError(f"ssd_bwd {shape} {dtype}: a transposed dy "
                                 f"and its contiguous copy differ")
    want_route = ssd_bwd_route(dtype, P, N, ssd_alignment(x, B_, C))
    taken = build.routes(SSD_BWD)
    if taken != {r: calls * (r == want_route) for r in taken}:
        raise AssertionError(f"ssd_bwd {shape} {dtype} {layout}: routes "
                             f"{taken}, expected {calls} on {want_route}")
    return err


class SSDHeldForward(torch.autograd.Function):
    """An SSD op with the forward kernel's output and the plain version's
    backward: a run of the plain path whose forward rounds as the cuda
    run's does."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, chunk):
        ctx.save_for_backward(x, dt, A, B_, C)
        return ssd_fwd(x, dt, A, B_, C, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        return (*ref.ssd_bwd(*ctx.saved_tensors, dy, dh), None)


def held_ssd(x, dt, A, B_, C, chunk=128):
    return SSDHeldForward.apply(x, dt, A, B_, C, chunk)


def lm_gate_inputs(arch, seed=LM_GATE_SEED, T=LM_GATE_T, depth=None):
    """(cfg, tcfg, step, state, batch) of the f32 gate: full width in f32
    (TF32 off), ``depth`` layers if given, B 2 x T (a frontend arch's prefix
    among the T), params and batch drawn from a generator of their own, so
    that ``tools/lm_gate_spread.py`` takes the same input."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = with_overrides(get_config(arch), dtype="float32",
                         param_dtype="float32",
                         **({"num_layers": depth} if depth else {}))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = BackbonePolicy(cfg, generator=gen)
    tcfg = TrainConfig(warmup_steps=0)      # the first step at the peak rate
    step = make_lm_train_step(policy, tcfg, loss_chunk=LM_GATE_T)
    state = init_train_state(policy.params())
    batch = random_batch(cfg, LM_GATE_B, T, gen)
    return cfg, tcfg, step, state, batch


def step_grads(step, state, batch, tcfg):
    """(metrics as floats, updated params, {leaf name: gradient}) of one
    step; the gradients are those before clipping, read back from the
    first moments (m = (1 - b1) · clip · g after one step)."""
    out, m = step(state, batch)
    clip = 1.0
    if tcfg.max_grad_norm:
        clip = (tcfg.max_grad_norm / m["grad_norm"].clamp(min=1e-12)
                ).clamp(max=1.0)
    grads = {n: g / ((1 - tcfg.adam_b1) * clip)
             for n, g in named_leaves(out.opt.m)}
    sync()
    return {k: float(v) for k, v in m.items()}, out.params, grads


def leaf_rel(got, want):
    """{leaf: max |got - want| / max |want|}."""
    return {n: max_err(got[n], want[n]) / max(float(want[n].abs().max()),
                                              1e-30) for n in want}


def lm_gate(arch, T=LM_GATE_T, tag="14 lm train (b)", depth=None):
    """One make_lm_train_step at full width in f32 (TF32 off), B 2 x T
    (``depth`` layers if given, else the arch's),
    through the cuda ops and through ``dispatch.using("ref")`` (every op
    plain, its SSD stepped in f64) from the same params and batch: loss and
    grad_norm within 1e-3 relative, every leaf's gradient within 1e-3 of
    its largest, and the updated params within 1e-3.

    On an arch with SSM layers that margin is thin: mamba2's f32 gradient
    moves up to ~1e4 times as far as the SSD forward's output (at this input
    a 1e-6 relative change of the plain SSD's output moves leaves of every
    SSM kind by up to 9e-3 of their largest, ``tools/lm_gate_spread.py``).
    So the cuda run is also held, every leaf's gradient within 1e-4 of its
    largest, against a plain run whose SSD forward is the kernel's output
    (``held_ssd``): the backward kernel against the plain backward from one
    forward."""
    cfg, tcfg, step, state, batch = lm_gate_inputs(arch, T=T, depth=depth)
    build.reset_launches()
    gm, got, gg = step_grads(step, state, batch, tcfg)
    launches = dict(build.LAUNCHES)
    with dispatch.using("ref"):
        wm, want, wg = step_grads(step, state, batch, tcfg)
    p_err = max(max_err(a, b) for a, b in zip(tree_leaves(got),
                                              tree_leaves(want)))
    del got, want
    rel = leaf_rel(gg, wg)
    del wg
    worst = max(rel, key=rel.get)
    fails = [f"{n} gradient {rel[n]}" for n in rel if not rel[n] <= 1e-3]
    for k in ("loss", "grad_norm"):
        if not (math.isfinite(gm[k]) and abs(gm[k] - wm[k]) <= 1e-3 * abs(
                wm[k])):
            fails.append(f"{k} cuda {gm[k]} ref {wm[k]}")
    if not p_err <= 1e-3:
        fails.append(f"params max abs err {p_err}")
    held = ""
    ssm = not all(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    if ssm:
        torch.cuda.empty_cache()
        with dispatch.replaced("ssd", "ref", held_ssd), \
                dispatch.using("ref"):
            hm, _, hg = step_grads(step, state, batch, tcfg)
        h_rel = leaf_rel(gg, hg)
        del hg
        h_worst = max(h_rel, key=h_rel.get)
        fails += [f"{n} gradient against the held forward {h_rel[n]}"
                  for n in h_rel if not h_rel[n] <= 1e-4]
        if not abs(gm["grad_norm"] - hm["grad_norm"]) <= 1e-4 * hm[
                "grad_norm"]:
            fails.append(f"grad_norm cuda {gm['grad_norm']} held forward "
                         f"{hm['grad_norm']}")
        held = (f"; against the plain run with the held SSD forward: "
                f"grad_norm {hm['grad_norm']:.6f}, gradients apart by "
                f"{h_rel[h_worst]:.3g} of their leaf's largest at worst "
                f"({h_worst})")
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    want_l = {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
              "ssd": 2 * (cfg.num_layers - attn),
              "ssd_bwd": cfg.num_layers - attn, "gae": 1}
    if any(launches[k] != n for k, n in want_l.items()):
        fails.append(f"launches {launches}, expected {want_l}")
    by_layer = [max(v for n, v in rel.items()
                    if n.startswith(f"backbone.layers.{i}."))
                for i in (0, cfg.num_layers - 1)]
    prefix = (f" (a prefix of {batch['prefix'].shape[1]} frames)"
              if "prefix" in batch else "")
    line = (f"{cfg.name} f32 {cfg.num_layers}L d{cfg.d_model} B {LM_GATE_B} "
            f"T {T}{prefix} (seed {LM_GATE_SEED}), one train step cuda vs "
            f"all-plain: loss {gm['loss']:.6f} / {wm['loss']:.6f}, "
            f"grad_norm {gm['grad_norm']:.6f} / {wm['grad_norm']:.6f}, "
            f"gradients apart by {rel[worst]:.3g} of their leaf's largest at "
            f"worst ({worst}), {by_layer[0]:.3g} in layer 0 and "
            f"{by_layer[1]:.3g} in layer {cfg.num_layers - 1}, params max "
            f"abs err {p_err:.3g}{held}; launches "
            f"{ {k: launches[k] for k in want_l} }")
    if fails:
        raise AssertionError(f"{arch} f32 gate: {fails}; {line}")
    print(f"[{tag}] {line}", flush=True)
    del state, gg, batch, step
    torch.cuda.empty_cache()


def named_leaves(tree, prefix=""):
    """(dotted name, tensor) of each leaf of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def moved_leaves(run, cfg):
    """Leaves of a launcher run's params that differ from its initial draw,
    redrawn from the launcher's seed (0): the run's policy holds the trained
    params (``launch/train.py`` binds each step's)."""
    init = BackbonePolicy(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0)).params()
    moved = sum(not torch.equal(a, b) for a, b in zip(
        tree_leaves(run.state.params), tree_leaves(init)))
    del init
    return moved


class at_depth:
    """Within it, ``repro_torch.configs.get_config`` (which the launcher
    reads) gives ``depth`` layers of each arch at its full width: the
    launcher has no depth flag, nor has the reference's."""

    def __init__(self, depth):
        self.depth = depth

    def __enter__(self):
        import repro_torch.configs as configs
        self.configs, self.orig = configs, configs.get_config
        if self.depth:
            configs.get_config = lambda arch: with_overrides(
                self.orig(arch), num_layers=self.depth)
        return self

    def __exit__(self, *exc):
        self.configs.get_config = self.orig


def lm_launcher_run(arch, seq=LM_SEQ, tag="14 lm train (c)", depth=None):
    """LM PPO through the launcher at full width in bf16, B 8 x ``seq``
    (a frontend arch's prefix among them), ``depth`` layers if given (then
    the peak memory must stay below ``HD_PEAK_GIB``), 10 steps; then one
    more step profiled. Returns the launches per step."""
    cfg = get_config(arch)
    if depth:
        cfg = with_overrides(cfg, num_layers=depth)
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    per_step = {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
                "ssd": 2 * (cfg.num_layers - attn),
                "ssd_bwd": cfg.num_layers - attn, "gae": 1,
                "flash_decode": 0, "quant_matmul": 0, "pack": 0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    with at_depth(depth):
        run = launch_train.main(["--arch", arch, "--batch", str(LM_BATCH),
                                 "--seq", str(seq), "--steps", str(LM_STEPS)])
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    bwd_routes = build.routes(BWD)
    ssd_routes = build.routes(SSD_BWD)
    peak = torch.cuda.max_memory_allocated()
    if any(launches[k] != n * LM_STEPS for k, n in per_step.items()):
        raise AssertionError(f"{arch}: launches {launches} over {LM_STEPS} "
                             f"steps, expected {per_step} a step")
    # every attention backward of a bf16 train step on the route its head
    # dim takes: wgmma at 64 and 128, the CUDA cores at 160 and 256
    route = bwd_route(torch.bfloat16, cfg.head_dim)
    want_routes = {r: attn * LM_STEPS * (r == route)
                   for r in ("wgmma", "cuda_core")}
    if bwd_routes != want_routes:
        raise AssertionError(f"{arch}: flash_attention_bwd routes "
                             f"{bwd_routes} over {LM_STEPS} steps, expected "
                             f"{want_routes}")
    # and every SSD backward on the tensor cores
    want_ssd = {"tensor_core": (cfg.num_layers - attn) * LM_STEPS,
                "cuda_core": 0}
    if ssd_routes != want_ssd:
        raise AssertionError(f"{arch}: ssd_bwd routes {ssd_routes} over "
                             f"{LM_STEPS} steps, expected {want_ssd}")
    m = run.metrics
    if not (math.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0):
        raise AssertionError(f"{arch}: loss {float(m['loss'])}, grad_norm "
                             f"{float(m['grad_norm'])}")
    moved = moved_leaves(run, cfg)
    if not moved:
        raise AssertionError(f"{arch}: no parameter moved in {LM_STEPS} "
                             f"steps")
    if depth and not peak < HD_PEAK_GIB * 2**30:
        raise AssertionError(f"{arch} at depth {depth}: max_memory_allocated"
                             f" {peak / 2**30:.2f} GiB, not below "
                             f"{HD_PEAK_GIB} GiB")
    step_ms = run.loop.monitor.median * 1e3
    P = cfg.frontend_prefix if cfg.frontend else 0
    print(f"[{tag}] {cfg.name} bf16 {cfg.num_layers}L d{cfg.d_model} B "
          f"{LM_BATCH} T {seq}"
          f"{f' ({P} prefix frames, {seq - P} tokens)' if P else ''} "
          f"through the launcher: "
          f"{LM_STEPS} steps in {wall:.1f} s (build of the policy and state "
          f"included), median step {step_ms:.2f} ms, "
          f"{LM_BATCH * seq / step_ms * 1e3:.0f} tokens/s; last loss "
          f"{float(m['loss']):+.4f} grad_norm {float(m['grad_norm']):.3f}; "
          f"{moved} of {len(tree_leaves(run.state.params))} param leaves "
          f"moved; max_memory_allocated {peak / 2**30:.2f} GiB; launches a "
          f"step {per_step}; flash_attention_bwd routes over the {LM_STEPS} "
          f"steps {bwd_routes}, ssd_bwd routes {ssd_routes}", flush=True)
    batch = next(run.batches(0))
    state = {"ts": run.state}

    def one():
        state["ts"], _ = run.step(state["ts"], batch)

    bwd = ("fa_bwd_wg_dq_kernel", "fa_bwd_wg_dkdv_kernel") \
        if route == "wgmma" else ("fa_bwd_dq_kernel", "fa_bwd_dkdv_kernel")
    profile_steps(tag, f"{cfg.name} train step", one, 1, step_ms,
                  bwd + ("flash_attention_wg_kernel", "ssd_bwd_tc_kernel",
                         "ssd_bwd_da_kernel", "ssd_tc_kernel", "gae_kernel"))
    del run, state, batch
    torch.cuda.empty_cache()
    return per_step


def phase_lm_train(gen):
    """Path E, LM-backbone PPO: (a) the backward kernels against their plain
    versions, (b) the full-width f32 gate, (c) the bf16 launcher runs.
    Returns (launches a train step, max abs errors at the training
    shapes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    errs, cases = {}, 0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for shape in FA_BWD_CASES:
            if shape[5] in NEW_HEAD_DIMS:
                continue                    # phase 16
            err = fa_bwd_case(gen, shape, dtype, tol)
            if shape == FA_BWD_CASES[0] and dtype == torch.bfloat16:
                errs["flash_attention_bwd"] = err
            cases += 1
        for shape in FA_BWD_VIEWS:
            fa_bwd_case(gen, shape, dtype, tol, view=True)
            cases += 1
        for shape in SSD_BWD_CASES:
            err = ssd_bwd_case(gen, shape, dtype, tol)
            if shape == SSD_BWD_CASES[0] and dtype == torch.bfloat16:
                errs["ssd_bwd"] = err
            cases += 1
        for shape in SSD_BWD_LAYOUTS:
            ssd_bwd_case(gen, shape, dtype, tol, layout=shape[6])
            cases += 1
    sync()
    print(f"[14 lm train (a)] {cases} backward cases pass (bf16 at 2e-2 and "
          f"f32 at 1e-4 of the largest gradient, against the plain versions "
          f"in f32; the forward's LSE at 1e-4; two calls bit for bit) in "
          f"{time.perf_counter() - t0:.1f} s; max abs err at the training "
          f"shapes (bf16): {errs}", flush=True)
    for arch in (ARCH, SSM_ARCH):
        lm_gate(arch)
    launches = {}
    for arch in (ARCH, SSM_ARCH):
        per_step = lm_launcher_run(arch)
        for k in ("flash_attention_bwd", "ssd_bwd"):
            launches[k] = launches.get(k) or per_step[k]
    return launches, errs


def phase_moe_frontends(gen):
    """Path F, MoE and the modality frontends: (a) jamba-v0.1-52b int8 at
    full width, the f32 gate of cuda against ref with its routing compared;
    (b) jamba served int8 in bf16 at B 8, prompt 512, 64 new tokens; (c)
    musicgen-medium's f32 train gate with its 256-frame prefix, then 10
    bf16 steps through the launcher at --seq 512; (d) each arch of the
    slice at smoke size: one generate and two train steps. Returns jamba's
    serve launches."""
    t0 = time.perf_counter()
    phase_full_width_f32(gen, MOE_ARCH, quantize="int8",
                         tag="15 moe+frontends (a)")
    launches = phase_serve(gen, MOE_ARCH, "int8", tag="15 moe+frontends (b)")
    lm_gate(AUDIO_ARCH, T=AUDIO_GATE_T, tag="15 moe+frontends (c)")
    lm_launcher_run(AUDIO_ARCH, seq=AUDIO_SEQ, tag="15 moe+frontends (c)")
    for arch in SLICE_ARCHS:
        smoke_arch(gen, arch)
    print(f"[15 moe+frontends] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def smoke_arch(gen, arch):
    """One arch at its smoke config in bf16 on the card: a generate of 8
    tokens from a 32-token prompt with its launch counts, then two train
    steps through the launcher (B 2 x T 64, a frontend's prefix of 8 among
    the 64) with a step's launches: each attention and SSM layer's forward
    twice (the recompute of remat "full") and backward once, one gae."""
    cfg = get_smoke_config(arch)
    policy = BackbonePolicy(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                           device="cuda")
    build.reset_launches()
    out = actor.generate(policy, prompt, 8, gen)
    sync()
    got, want = dict(build.LAUNCHES), serve_launches(cfg, new=8)
    if any(got[k] != n for k, n in want.items()) or out.shape != (2, 8) \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch} smoke generate: tokens {out.tolist()}"
                             f", launches {got}, expected {want}")
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    ssm = cfg.num_layers - attn
    per_step = {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
                "ssd": 2 * ssm, "ssd_bwd": ssm, "gae": 1}
    build.reset_launches()
    run = launch_train.main(["--arch", arch, "--smoke", "--batch", "2",
                             "--seq", "64", "--steps", "2"])
    sync()
    steps = dict(build.LAUNCHES)
    m = run.metrics
    moved = moved_leaves(run, cfg)
    if any(steps[k] != 2 * n for k, n in per_step.items()) or not (
            math.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
            and moved):
        raise AssertionError(f"{arch} smoke train: launches {steps} over 2 "
                             f"steps, expected {per_step} a step; loss "
                             f"{float(m['loss'])}, grad_norm "
                             f"{float(m['grad_norm'])}, {moved} leaves "
                             f"moved")
    kind = (f", {cfg.num_experts} experts top-{cfg.top_k}"
            if cfg.num_experts else "") + (
        f", prefix {cfg.frontend_prefix}" if cfg.frontend else "")
    print(f"[15 moe+frontends (d)] {arch} smoke ({cfg.num_layers}L d"
          f"{cfg.d_model}{kind}): "
          f"generate launches { {k: v for k, v in got.items() if v} }; two "
          f"train steps, loss {float(m['loss']):+.4f}, moe_aux "
          f"{float(m['moe_aux']):.4f}, grad_norm {float(m['grad_norm']):.3f},"
          f" {moved} of {len(tree_leaves(run.state.params))} leaves moved, "
          f"launches a step { {k: v // 2 for k, v in steps.items() if v} }",
          flush=True)
    del policy, run
    torch.cuda.empty_cache()


def hd_decode_cases():
    """flash_decode's phase-16 cases ((B, S, H, K, hd), lengths): both
    archs' caches at the serve shape (gemma's G 1, stablelm's G 4), one
    pair split over a whole cluster (f32 at hd 256 held to 5 blocks by
    ``plan``) and G 8, at lengths 0, mid and S - 1."""
    S = PROMPT + NEW
    return [((BATCH, S, 16, 16, 256), [0, S // 2, S - 1]),
            ((BATCH, S, 32, 8, 160), [0, S // 2, S - 1]),
            ((1, 577, 8, 1, 256), [0, 288, 576]),
            ((2, 300, 16, 2, 160), [0, 150, 299])]


def phase_headdims(gen):
    """Path G, head dims 160 and 256: (a) the three attention kernels at
    both against their plain versions (forward and backward on the route
    each names, the backward bit for bit across two calls; decode's shared
    memory as ``plan`` reads it against the launcher's); (b) gemma-7b's and
    stablelm-12b's f32 serve gates at full width and depth; (c) both served
    in bf16 at full width and depth; (d) both archs' f32 train gates at
    depth ``HD_GATE_DEPTH``, then 10 bf16 steps through the launcher at
    depth ``HD_TRAIN_DEPTH``, full width. Returns each arch's launches: a
    prefill's and a generate's attention, a train step's backward."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[16 head dims] memory_allocated at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    hd_parity(gen)
    for arch in HD_ARCHS:
        phase_full_width_f32(gen, arch, tag="16 head dims (b)")
    launches = {}
    for arch in HD_ARCHS:
        got = phase_serve(gen, arch, tag="16 head dims (c)")
        launches[arch] = {k: got[k] for k in ("flash_attention",
                                              "flash_decode")}
    for arch in HD_ARCHS:
        lm_gate(arch, tag="16 head dims (d)", depth=HD_GATE_DEPTH)
        per_step = lm_launcher_run(arch, tag="16 head dims (d)",
                                   depth=HD_TRAIN_DEPTH)
        launches[arch]["flash_attention_bwd"] = per_step[
            "flash_attention_bwd"]
    print(f"[16 head dims] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def hd_parity(gen):
    """Phase 16(a): the attention kernels at hd 160 and 256 against their
    plain versions, and decode's shared memory against plan's mirror."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    errs, cases = {}, 0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for shape in FA_CASES:
            if shape[5] not in NEW_HEAD_DIMS:
                continue
            err = fa_case(gen, shape, dtype, tol)
            if shape[0] == BATCH:
                errs[f"flash_attention hd {shape[5]} {dtype}"] = err
            cases += 1
        for shape, lengths in hd_decode_cases():
            err = fd_case(gen, shape, lengths, dtype, tol)
            if shape[0] == BATCH:
                errs[f"flash_decode hd {shape[4]} {dtype}"] = err
            cases += len(lengths)
        for shape in FA_BWD_CASES:
            if shape[5] not in NEW_HEAD_DIMS:
                continue
            err = fa_bwd_case(gen, shape, dtype, tol)
            if shape[0] == LM_BATCH:
                errs[f"flash_attention_bwd hd {shape[5]} {dtype}"] = err
            cases += 1
    # the decode split's shared memory: plan's mirror against the launcher's
    smem = build.load("flash_decode").flash_decode_smem
    smem.argtypes = [ctypes.c_int] * 4
    for hd, elem, n, G in itertools.product((16, 32, 64, 128, 160, 256),
                                            (2, 4), range(1, 9),
                                            (1, 4, 8, 20)):
        if smem(hd, int(elem == 2), n, G) != fd_smem(n, hd, elem, G):
            raise AssertionError(f"flash_decode smem at hd {hd}, {elem}-byte"
                                 f", {n} blocks, G {G}: csrc "
                                 f"{smem(hd, int(elem == 2), n, G)}, plan's "
                                 f"{fd_smem(n, hd, elem, G)}")
    sync()
    print(f"[16 head dims (a)] {cases} cases at hd 160 and 256 pass "
          f"(flash_attention on the route fwd_route names, flash_decode, "
          f"flash_attention_bwd on the CUDA cores bit for bit across two "
          f"calls; bf16 at 2e-2, f32 at 1e-4 with TF32 off), decode's shared "
          f"memory as plan reads it equals the launcher's, in "
          f"{time.perf_counter() - t0:.1f} s; max abs err at the serve and "
          f"training shapes: { {k: f'{v:.3g}' for k, v in errs.items()} }",
          flush=True)


def fa_line(gen, B, T, H, K, hd, calls, note="", plain=False):
    """flash_attention at (B, T, H, K, hd), causal bf16, timed in turns with
    SDPA by graph replay over 4 input sets (past the L2 at every shape
    timed), with ``plain`` also the plain version's ms; prints the line.
    Returns (ms, SDPA ms, FLOP, bytes, the sets)."""
    bf = torch.bfloat16
    fa_sets = [(randn(gen, (B, T, H, hd), bf), randn(gen, (B, T, K, hd), bf),
                randn(gen, (B, T, K, hd), bf)) for _ in range(4)]
    flops, nbytes = attention_work(B, T, H, K, hd)
    (ms, lib_ms), rounds = alternate_ms((flash_attention, sdpa), fa_sets,
                                        calls)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    by = "operations" if t_ops > t_bytes else "bytes"
    if plain:
        note = (f"; plain {cuda_ms(ref.flash_attention, fa_sets, 10):.4f} "
                f"ms{note}")
    print(f"[kernel] flash_attention B {B} T {T} H {H} K {K} hd {hd}"
          f" causal bf16, {len(rounds[0])} rounds in turns: kernel "
          f"median {ms:.4f} ms (rounds {min(rounds[0]):.4f}-"
          f"{max(rounds[0]):.4f}), SDPA median {lib_ms:.4f} ms (rounds "
          f"{min(rounds[1]):.4f}-{max(rounds[1]):.4f}), kernel / SDPA "
          f"{ms / lib_ms:.3f}, bound {max(t_ops, t_bytes):.4f} ms by "
          f"{by} ({flops:.4g} FLOP, {nbytes:.4g} B; "
          f"{flops / ms / 1e9:.1f} TFLOP/s){note}", flush=True)
    return ms, lib_ms, flops, nbytes, fa_sets


def fd_line(gen, S, H, K, hd, n_sets, calls, note="", plain=False):
    """flash_decode at the last step of a cache of S positions (B 8, the
    newest valid index S - 2), bf16, timed in turns with SDPA over the
    filled prefix by graph replay over ``n_sets`` cache sets, with
    ``plain`` also the plain version's ms; prints the line. Returns (ms,
    SDPA ms, FLOP, bytes, the sets, SDPA's function)."""
    bf = torch.bfloat16
    L = S - 2                                        # newest valid index
    length = torch.tensor(L, dtype=torch.int32, device="cuda")
    fd_sets = [(randn(gen, (BATCH, H, hd), bf),
                randn(gen, (BATCH, S, K, hd), bf),
                randn(gen, (BATCH, S, K, hd), bf), length)
               for _ in range(n_sets)]
    flops = 4 * BATCH * H * hd * (L + 1)
    nbytes = 2 * (2 * BATCH * (L + 1) * K * hd + 2 * BATCH * H * hd)

    def fd_sdpa(q, k, v, n, L=L):
        return F.scaled_dot_product_attention(
            q[:, :, None], k[:, :L + 1].transpose(1, 2),
            v[:, :L + 1].transpose(1, 2), enable_gqa=True)

    (ms, lib_ms), rounds = alternate_ms((flash_decode, fd_sdpa), fd_sets,
                                        calls)
    bound = nbytes / PEAK_BYTES * 1e3
    if plain:
        note = (f"; plain {cuda_ms(ref.flash_decode, fd_sets, 50):.4f} "
                f"ms{note}")
    print(f"[kernel] flash_decode B {BATCH} S {S} L {L} H {H} K {K} hd "
          f"{hd} bf16, {len(rounds[0])} rounds in turns: kernel median "
          f"{ms:.4f} ms (rounds {min(rounds[0]):.4f}-"
          f"{max(rounds[0]):.4f}), SDPA median {lib_ms:.4f} ms (rounds "
          f"{min(rounds[1]):.4f}-{max(rounds[1]):.4f}), kernel / SDPA "
          f"{ms / lib_ms:.3f}, bound {bound:.4f} ms by bytes ({nbytes:.4g}"
          f" B; {nbytes / ms / 1e9:.2f} TB/s, {100 * bound / ms:.1f}% of "
          f"the bound){note}", flush=True)
    return ms, lib_ms, flops, nbytes, fd_sets, fd_sdpa


def kernel_rows(gen, launches, errs, hd_launches):
    """Times at the main paths' shapes: kernel, plain version, library call
    (SDPA for attention; none for GAE and SSD), and bound. First a line for
    each new head dim's forward and decode at its arch's serve shape, with
    the launches of phase 16's paths (``hd_launches``)."""
    bf = torch.bfloat16
    H, K, hd = 16, 8, 128
    rows = []

    for arch in HD_ARCHS:
        cfg = get_config(arch)
        n = hd_launches[arch]
        *_, sets = fa_line(gen, BATCH, PROMPT, cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, 32,
                           f"; {n['flash_attention']} launches a {arch} "
                           f"prefill", plain=True)
        del sets
        G = cfg.num_heads // cfg.num_kv_heads
        split, n_split = fd_plan(BATCH, cfg.num_kv_heads, PROMPT + NEW, SMS,
                                 cfg.head_dim, 2, G)
        *_, sets, _ = fd_line(
            gen, PROMPT + NEW, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            6, 64, f"; {n['flash_decode']} launches a {arch} generate; plan "
            f"{n_split} blocks of {split} positions a (batch, KV head), the "
            f"card holding {fd_max_clusters(n_split, G, cfg.head_dim)} such "
            f"clusters at once", plain=True)
        del sets

    # prefill attention, timed in turns with SDPA: 4 input sets of 33.6 MB
    # at the serve shape; then a line at T 2048 (4 sets of 134 MB), where
    # operations bound it
    for T in (FA_LONG, PROMPT):
        ms, lib_ms, flops, nbytes, fa_sets = fa_line(
            gen, BATCH, T, H, K, hd, 32 if T == PROMPT else 8)
    q, k, v = fa_sets[0]
    print(f"[kernel] flash_attention host time per call at the serve shape "
          f"(checks, three tensor maps, the ctypes launch): "
          f"{host_us(lambda: flash_attention(q, k, v), 300):.2f} us; SDPA "
          f"{host_us(lambda: sdpa(q, k, v), 300):.2f} us (back-to-back "
          f"calls, each bounded below by its device time)", flush=True)
    rows.append(("flash_attention", flops, PEAK_FLOPS, nbytes, ms,
                 cuda_ms(ref.flash_attention, fa_sets, 10), lib_ms))
    del fa_sets, q, k, v

    # decode attention at the last serve step, timed in turns with SDPA by
    # graph replay: 6 cache sets of 18.9 MB; first a line at S 8192 (2 sets
    # of 268 MB), past the L2
    for S in (FD_LONG, PROMPT + NEW):
        ms, lib_ms, flops, nbytes, fd_sets, fd_sdpa = fd_line(
            gen, S, H, K, hd, 2 if S == FD_LONG else 6,
            8 if S == FD_LONG else 64)
    split, n_split = fd_plan(BATCH, K, S)
    print(f"[kernel] flash_decode plan at the serve shape: {n_split} blocks "
          f"of {split} positions a (batch, KV head), {BATCH * K} clusters "
          f"({BATCH * K * n_split} blocks); the card holds "
          f"{fd_max_clusters(n_split, H // K)} such clusters at once",
          flush=True)
    q, k, v, n = fd_sets[0]
    print(f"[kernel] flash_decode host time per call at the serve shape "
          f"(checks, plan, the ctypes launch): "
          f"{host_us(lambda: flash_decode(q, k, v, n), 300):.2f} us; SDPA "
          f"{host_us(lambda: fd_sdpa(q, k, v, n), 300):.2f} us (back-to-back "
          f"calls, each bounded below by its device time)", flush=True)
    rows.append(("flash_decode", flops, PEAK_FLOPS, nbytes, ms,
                 cuda_ms(ref.flash_decode, fd_sets, 50), lib_ms))
    del fd_sets, q, k, v

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

    # SSD laid out as models/ssm.py gives it, by graph replay (median of 7):
    # first a line at T 2048 (one input set of 147 MB), a walk of 16 chunks;
    # then mamba2's serve shape, 3 input sets of 36.7 MB (110 MB)
    for T in (SSD_LONG, PROMPT):
        ssd_sets = [ssd_inputs(gen, BATCH, T, SSD_H, SSD_P, SSD_N, SSD_G, bf,
                               True) for _ in range(1 if T == SSD_LONG else 3)]
        flops, nbytes = ssd_work(BATCH, T, SSD_H, SSD_P, SSD_N, SSD_G, SSD_Q,
                                 2)
        reps = [graph_ms(lambda *a: ssd(*a, chunk=SSD_Q), ssd_sets,
                         4 if T == SSD_LONG else 12) for _ in range(7)]
        ms = statistics.median(reps)
        bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
        print(f"[kernel] ssd B {BATCH} T {T} H {SSD_H} P {SSD_P} N {SSD_N} "
              f"G {SSD_G} chunk {SSD_Q} bf16, x a view, by graph replay: "
              f"median {ms:.4f} ms (readings {min(reps):.4f}-"
              f"{max(reps):.4f}), bound {bound:.4f} ms ({flops:.4g} FLOP, "
              f"{nbytes:.4g} B; {100 * bound / ms:.1f}% of the bound, "
              f"{flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
        if T == PROMPT:
            rows.append(("ssd", flops, PEAK_FLOPS, nbytes, ms,
                         cuda_ms(ref.ssd, ssd_sets, 3), None))
        del ssd_sets
    # and at jamba-v0.1-52b's prefill shape (state 16), 3 input sets of
    # 69.5 MB, where bytes bound it
    ssd_sets = [ssd_inputs(gen, BATCH, PROMPT, JAMBA_H, JAMBA_P, JAMBA_N, 1,
                           bf, True) for _ in range(3)]
    flops, nbytes = ssd_work(BATCH, PROMPT, JAMBA_H, JAMBA_P, JAMBA_N, 1,
                             SSD_Q, 2)
    reps = [graph_ms(lambda *a: ssd(*a, chunk=SSD_Q), ssd_sets, 12)
            for _ in range(7)]
    ms = statistics.median(reps)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"[kernel] ssd at jamba-v0.1-52b's prefill shape B {BATCH} T "
          f"{PROMPT} H {JAMBA_H} P {JAMBA_P} N {JAMBA_N} G 1 chunk {SSD_Q} "
          f"bf16, x a view, by graph replay: median {ms:.4f} ms (readings "
          f"{min(reps):.4f}-{max(reps):.4f}), plain "
          f"{cuda_ms(ref.ssd, ssd_sets, 3):.4f} ms, bound "
          f"{max(t_ops, t_bytes):.4f} ms by "
          f"{'operations' if t_ops > t_bytes else 'bytes'} ({flops:.4g} "
          f"FLOP, {nbytes:.4g} B; {100 * max(t_ops, t_bytes) / ms:.1f}% of "
          f"the bound, {nbytes / ms / 1e9:.2f} TB/s); 28 calls a jamba "
          f"prefill", flush=True)
    del ssd_sets

    rows.append(pack_row(gen))

    out = [kernel_row(r, launches, errs) for r in rows]
    out.append(qmm_row(gen, launches, errs))
    return out


def fa_bwd_line(gen, B, T, H, K, hd, note=""):
    """flash_attention_bwd at (B, T, H, K, hd), causal bf16: device ms per
    call by CUDA-graph replay (median of 5) over 4 input sets (past the
    L2), the plain version's ms, and the backward of
    ``scaled_dot_product_attention`` (a yardstick the port never calls) by
    the profiler's device time over 20 calls, beside the kernel's own by
    the same; prints the line. Returns (ms, plain ms, SDPA's ms, FLOP,
    bytes)."""
    bf = torch.bfloat16
    fa_sets = []
    for _ in range(4):
        q = randn(gen, (B, T, H, hd), bf)
        k, v = (randn(gen, (B, T, K, hd), bf) for _ in range(2))
        do = randn(gen, (B, T, H, hd), bf)
        o, lse = flash_attention_fwd(q, k, v, True, with_lse=True)
        fa_sets.append((q, k, v, o, lse, do))
    reps = [graph_ms(flash_attention_bwd, fa_sets, 8) for _ in range(5)]
    ms = statistics.median(reps)
    plain_ms = cuda_ms(lambda q, k, v, o, lse, do: ref.flash_attention_bwd(
        q, k, v, do), fa_sets, 4)
    # SDPA's backward (autograd.grad on one retained forward) and the
    # kernel on the same inputs, by the profiler's device time over 20
    # calls of each in one session (host-bound back to back): the kernel's
    # events by name, SDPA's all the others. A session of this long
    # process has been seen to miss the ctypes-launched kernels' events:
    # up to 3 sessions are taken until one holds both; if none does, the
    # kernel's profiler time is printed as not measured.
    q, k, v, o, lse, do = fa_sets[0]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qg, kg, vg)                    # (B, H, T, hd)
    do_t = do.transpose(1, 2)

    def both():
        torch.autograd.grad(out, (qg, kg, vg), do_t, retain_graph=True)
        flash_attention_bwd(q, k, v, o, lse, do)

    for _ in range(3):
        both()
    lib_ms = prof_ms = None
    for _ in range(3):
        by_name, _ = device_times(both, 20)
        kern_names = {n: t for n, t in (by_name or {}).items()
                      if n.startswith("fa_bwd_")}
        if by_name and len(by_name) > len(kern_names):
            lib_ms = sum(t for n, t in by_name.items()
                         if n not in kern_names) / 20
        if lib_ms is not None and len(kern_names) == 2:
            prof_ms = sum(kern_names.values()) / 20
            break
    if lib_ms is None:
        raise AssertionError("the profiler saw no device time of SDPA's "
                             "backward")
    # the four products the gradient needs over the causal pairs (dV = P^T
    # dO, dP = dO V^T, dQ = dS K, dK = dS^T Q), and q, k, v, o, do, lse read
    # and dq, dk, dv written once
    flops = 4 * B * H * hd * T * (T + 1)
    nbytes = 2 * (4 * B * T * H * hd + 4 * B * T * K * hd) + 4 * B * H * T
    bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    print(f"[kernel] flash_attention_bwd B {B} T {T} H {H} K {K} hd {hd} "
          f"causal bf16 ({bwd_route(bf, hd)}) by graph replay: median "
          f"{ms:.4f} ms (readings "
          f"{min(reps):.4f}-{max(reps):.4f}); by the profiler's device time "
          f"over 20 calls " + (
              f"{prof_ms:.4f} ms (" + ", ".join(
                  f"{n} {t / 20:.4f}" for n, t in sorted(kern_names.items()))
              + ")" if prof_ms is not None else "not measured (no session "
              "of 3 saw its events)") +
          f"; SDPA's backward by the same {lib_ms:.4f} ms; kernel / SDPA: "
          f"profiler / profiler " + (
              f"{prof_ms / lib_ms:.3f}" if prof_ms is not None
              else "not measured") +
          f", graph replay / profiler {ms / lib_ms:.3f}; plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms; "
          f"{flops / ms / 1e9:.1f} TFLOP/s{note}", flush=True)
    del fa_sets, out, qg, kg, vg, do_t, by_name, kern_names
    return ms, plain_ms, lib_ms, flops, nbytes


def bwd_rows(gen, launches, errs, hd_launches):
    """The backward kernels at the training shapes, bf16: device ms per call
    by CUDA-graph replay (median of 5), the plain version's ms, the bound
    and, for attention, the backward of ``scaled_dot_product_attention`` by
    the profiler (``fa_bwd_line``); first a line for each new head dim's
    attention backward at its arch's training shape, with its launches a
    step of phase 16's depth-``HD_TRAIN_DEPTH`` run (``hd_launches``)."""
    bf = torch.bfloat16
    rows = []
    for arch in HD_ARCHS:
        cfg = get_config(arch)
        fa_bwd_line(gen, LM_BATCH, LM_SEQ, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim,
                    f"; {hd_launches[arch]['flash_attention_bwd']} launches "
                    f"a {arch} train step at depth {HD_TRAIN_DEPTH} (one a "
                    f"layer)")
    ms, plain_ms, lib_ms, flops, nbytes = fa_bwd_line(gen, *FA_TRAIN)
    rows.append(("flash_attention_bwd", flops, PEAK_FLOPS, nbytes, ms,
                 plain_ms, lib_ms))

    ssd_sets = []
    for _ in range(2):                    # 2 sets of 60 MB: past the L2
        args = ssd_inputs(gen, LM_BATCH, LM_SEQ, SSD_H, SSD_P, SSD_N, SSD_G,
                          bf, True)
        ssd_sets.append(args + (randn(gen, (LM_BATCH, LM_SEQ, SSD_H,
                                            SSD_P), bf),))
    # the tensor-core route (every call of the row's), in turns with the
    # f64 CUDA-core walks at the same shape, for the record
    reps, old = [], []
    for _ in range(5):
        reps.append(graph_ms(ssd_bwd, ssd_sets, 4))
        old.append(graph_ms(ssd_bwd_cuda_core, ssd_sets, 2))
    ms = statistics.median(reps)
    plain_ms = cuda_ms(ref.ssd_bwd, ssd_sets, 2)
    Bn, Tn, Hn = LM_BATCH, LM_SEQ, SSD_H
    flops, nbytes = ssd_bwd_work(Bn, Tn, Hn, SSD_P, SSD_N, SSD_G,
                                 SSD_BWD_CHUNK, 2)
    print(f"[kernel] ssd_bwd B {Bn} T {Tn} H {Hn} P {SSD_P} N {SSD_N} G "
          f"{SSD_G} bf16, x a view, by graph replay, tensor cores: median "
          f"{ms:.4f} ms (readings {min(reps):.4f}-{max(reps):.4f}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s; "
          f"the f64 CUDA-core walks in turns with it: median "
          f"{statistics.median(old):.4f} ms (readings {min(old):.4f}-"
          f"{max(old):.4f}); plain {plain_ms:.4f} ms; no single PyTorch call "
          f"computes it", flush=True)
    rows.append(("ssd_bwd", flops, PEAK_FLOPS, nbytes, ms, plain_ms, None))
    del ssd_sets
    return [kernel_row(r, launches, errs) for r in rows]


def kernel_row(row, launches, errs):
    """One entry of the kernels JSON line, printed beside it."""
    name, flops, peak, nbytes, ms, plain_ms, lib_ms = row
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    src, replaces = KERNELS[name]
    out = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches[name],
           "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms}
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
          f"{lib}, bound {max(t_ops, t_bytes):.4f} ms by {out['bound_by']}: "
          f"{flops:.4g} FLOP, {nbytes:.4g} B)", flush=True)
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
    leaves = act_sets[0]
    us = {"pack": [], "torch.cat": []}
    for _ in range(3):
        us["pack"].append(host_us(lambda: pack(leaves)))
        us["torch.cat"].append(host_us(lambda: torch.cat(leaves, dim=-1)))
    print(f"[kernel] pack host time per call at the act shape, median of 3 "
          f"turns: the wrapper {statistics.median(us['pack']):.2f} us, "
          f"torch.cat {statistics.median(us['torch.cat']):.2f} us",
          flush=True)
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
    split = {}          # (part, "ms" or "lib") -> ms over one int8 generate
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
                part = ("unembed" if trans else
                        "decode" if M == BATCH else "prefill")
                for key, t in (("ms", ms), ("lib", lib)):
                    split[part, key] = split.get((part, key), 0.0) + \
                        calls * t
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
    print("[kernel] quant_matmul over one int8 generate by part (kernel / "
          "torch.matmul on the dequantised weight): " + ", ".join(
              f"{part} {split[part, 'ms']:.4f} / {split[part, 'lib']:.4f} ms"
              for part in ("prefill", "decode", "unembed")), flush=True)
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
    launch) against the same call on a bf16 weight (``x @ w``); then the
    wrapper alone and its C launcher alone (``quant_matmul_fwd`` through
    ctypes: the launch with the SM count read once a device), in turns."""
    bf = torch.bfloat16
    x, w, s = qmm_inputs(gen, BATCH, 1024, 1024, False, None, 0, "int8", bf)
    quant = {"w": w, "w_scale": s}
    plain = {"w": (w.float() * s).to(bf)}
    x3 = x[:, None]
    out = torch.empty((BATCH, 1024), dtype=bf, device="cuda")
    fwd = build.load("quant_matmul").quant_matmul_fwd
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), BATCH,
            1024, 1024, x.stride(0), 1, w.stride(0), 1024, 1, 0, 0, 1, 1,
            stream)
    us = {"use site": [], "bf16 use site": [], "wrapper": [], "C launch": []}
    for _ in range(3):
        us["use site"].append(host_us(lambda: matmul(quant, "w", x3, bf)))
        us["bf16 use site"].append(host_us(lambda: matmul(plain, "w", x3,
                                                          bf)))
        us["wrapper"].append(host_us(lambda: quant_matmul(x, w, s)))
        us["C launch"].append(host_us(lambda: fwd(*args)))
    calls = 6 * get_config(ARCH).num_layers + 1
    print(f"[kernel] quant_matmul host time per decode-step call (B {BATCH}, "
          f"K = N = 1024), median of 3 turns: params.matmul "
          f"{statistics.median(us['use site']):.2f} us quantised, "
          f"{statistics.median(us['bf16 use site']):.2f} us on the bf16 "
          f"weight; the wrapper {statistics.median(us['wrapper']):.2f} us; "
          f"its C launch alone {statistics.median(us['C launch']):.2f} us "
          f"(the SM count read once a device); {calls} calls per decode "
          f"step", flush=True)


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


def ssd_bwd_work(B, T, H, P, N, G, Q, elem):
    """(FLOP, bytes) of the chunked SSD backward in chunks of Q steps: per
    (b, h) and chunk of q steps, over its q (q + 1) / 2 causal pairs C B^T,
    dy x^T, (S o L)^T dy, dS B and dS^T C (2 (3 N + 2 P) a pair), and five
    state products of 2 q P N (B dh^T, x dh, dy h_prev, dh_prev and the
    recomputed state); x, dt, B_ and C (once a group) and dy read, dx, ddt,
    dB_ and dC (dense over heads) and dA written once."""
    flops = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        flops += B * H * (q * (q + 1) * (3 * N + 2 * P) + 10 * q * P * N)
    nbytes = (3 * B * T * H * P * elem + 4 * 2 * B * T * H
              + 2 * B * T * G * N * elem + 2 * B * T * H * N * elem + 4 * H)
    return flops, nbytes


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()

    def lap(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = phase_device()
    phase_build()
    lap("2 build")
    errs = phase_parity(gen)
    lap("3 parity")
    phase_full_width_f32(gen, ARCH)
    phase_full_width_f32(gen, SSM_ARCH)
    phase_full_width_f32(gen, ARCH, quantize="int8")
    lap("4 full width")
    launches = phase_serve(gen, ARCH)
    launches["ssd"] = phase_serve(gen, SSM_ARCH)["ssd"]
    launches["quant_matmul"] = phase_serve(gen, ARCH, "int8")["quant_matmul"]
    phase_serve(gen, ARCH, "int4", depth=INT4_DEPTH)
    lap("5 serve")
    launches["gae"] = phase_train()["gae"]
    lap("6 train")
    phase_emulation(gen)
    phase_pool()
    lap("7-8 emulation, pool")
    launches["pack"] = phase_host()["pack"]
    lap("9 host")
    phase_checkpoint()
    lap("10 checkpoint")
    phase_async()
    lap("11 async")
    phase_ocean2()
    lap("12 ocean2")
    phase_selfplay()
    lap("13 selfplay")
    lm_launches, lm_errs = phase_lm_train(gen)
    lap("14 lm train")
    phase_moe_frontends(gen)
    lap("15 moe+frontends")
    hd_launches = phase_headdims(gen)
    lap("16 head dims")
    phase_shard()
    lap("17 shard")
    rows = kernel_rows(gen, launches, errs, hd_launches) + bwd_rows(
        gen, lm_launches, lm_errs, hd_launches)
    lap("kernel rows")
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
