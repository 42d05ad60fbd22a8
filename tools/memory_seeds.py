#!/usr/bin/env python3
"""An Ocean env at its preset over several seeds, on the card or the CPU.

    python3 tools/memory_seeds.py [--env memory] [--device cuda|cpu]
        [--seeds 0,1,2]

Trains one env of ``envs/ocean.py`` (by default ``Memory``) through
``rl.trainer.Trainer`` at its ``configs/ocean.py`` preset (memory: 64 envs
x 64 steps, an LSTM of 64, a budget of 500,000 env steps, target score
0.9; tagteam: 600,000 steps) once per seed, with early exit at the target,
and prints one line per seed: SOLVED or unsolved, the score, the env steps
at the exit, the best score of any update and the wall time.
``tools/ocean_seeds_ref.py`` runs the JAX reference's preset the same way.
Compare the card's spread over seeds with the CPU's: a difference larger
than the seeds' own spread would be a fault of the port on the card.
Torch only; the card's runs turn TF32 off, as the parity checks do.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.ocean import ocean_tcfg, preset  # noqa: E402
from repro_torch.envs.ocean import OCEAN  # noqa: E402
from repro_torch.rl.trainer import Trainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="memory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0,1,2")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
              flush=True)
    else:
        print(f"device: cpu ({torch.get_num_threads()} threads)", flush=True)
    p = preset(args.env)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        tr = Trainer(OCEAN[args.env](), ocean_tcfg(args.env), hidden=p.hidden,
                     recurrent=p.recurrent, conv=p.conv, seed=seed,
                     device=args.device)
        t0 = time.perf_counter()
        m = tr.train(p.total_steps, target_score=p.target_score)
        wall = time.perf_counter() - t0
        best = max(h["score"] for h in tr.history if h["episodes"] > 0)
        status = "SOLVED" if m["score"] >= p.target_score else "unsolved"
        out.append((seed, status, m["score"], m["env_steps"]))
        print(f"{args.env} seed {seed} on {args.device}: {status} score "
              f"{m['score']:.4f} at {m['env_steps']} env steps (budget "
              f"{p.total_steps}), best {best:.4f}, {len(tr.history)} "
              f"updates, {wall:.1f} s wall", flush=True)
    return out


if __name__ == "__main__":
    main()
