#!/usr/bin/env python3
"""The data-parallel tier across ranks against its one-process emulation.

    python3 tools/shard_parity.py [--ranks 4] [--env squared]
        [--updates 4] [--device cuda|cpu]

Runs ``python -m repro_torch.launch.train --ocean ENV --engine-backend
shard_map --devices RANKS`` at the env's ``configs/ocean.py`` preset for
``--updates`` updates in a subprocess (NCCL over RANKS cards on ``cuda``,
gloo over RANKS processes on ``cpu``), with a checkpoint at its last
update, which rank 0 writes from the gathered state. Then, in this
process, the jit tier's ``num_shards=RANKS`` emulation of the same layout
(seed 0, one device) runs as many updates, and the script prints the
launcher's lines and the largest difference between the two runs' params
and AdamW moments. They differ only in the order of float sums (each
rank's gradient mean against the global minibatch's), so the
differences sit near float rounding; the script fails above ``--tol``.
Torch only.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.ocean import ocean_tcfg, preset  # noqa: E402
from repro_torch.envs.ocean import OCEAN  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.rl.engine import TrainEngine  # noqa: E402
from repro_torch.rl.trainer import ocean_policy_stack  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--env", default="squared")
    ap.add_argument("--updates", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tol", type=float, default=1e-4)
    args = ap.parse_args(argv)
    tcfg = ocean_tcfg(args.env)
    p = preset(args.env)
    steps = args.updates * tcfg.num_envs * tcfg.unroll_length
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--ocean",
               args.env, "--engine-backend", "shard_map", "--devices",
               str(args.ranks), "--device", args.device,
               "--total-env-steps", str(steps), "--full-budget",
               "--ckpt-dir", d, "--save-every", str(args.updates)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=900,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
        print(r.stdout.strip(), flush=True)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        if args.device == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        em, dist, pol = ocean_policy_stack(OCEAN[args.env](), hidden=p.hidden,
                                           recurrent=p.recurrent, conv=p.conv)
        eng = TrainEngine(em, pol, tcfg, dist, seed=0, device=args.device,
                          num_shards=args.ranks)
        eng.run(args.updates * eng.steps_per_update)
        saved = ckpt.restore(os.path.join(d, args.env), {"ts": eng.ts})["ts"]
    worst = {}
    for part in ("params", "m", "v"):
        got = (saved[0] if part == "params" else getattr(saved[1], part))
        want = (eng.ts.params if part == "params"
                else getattr(eng.ts.opt, part))
        worst[part] = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(tree_leaves(got),
                                          tree_leaves(want)))
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(f"shard_parity: {args.env} preset, {args.ranks} ranks on "
          f"{args.device} ({name} x {args.ranks if args.device == 'cuda' else 1}"
          f") through the launcher in {wall:.1f} s wall, {args.updates} "
          f"updates, against the jit tier's num_shards={args.ranks} "
          f"emulation: max abs difference params {worst['params']:.3e}, "
          f"AdamW m {worst['m']:.3e}, v {worst['v']:.3e} (tol {args.tol})",
          flush=True)
    return 0 if max(worst.values()) <= args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
