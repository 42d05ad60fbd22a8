#!/usr/bin/env python3
"""The JAX reference's Ocean preset over several seeds, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/ocean_seeds_ref.py [--env tagteam]
        [--seeds 0,1,2]

Trains one env of ``repro/envs/ocean.py`` through ``repro.rl.trainer``'s
``Trainer`` at its ``configs/ocean.py`` preset, once per seed, with early
exit at the target score, and prints one line per seed as
``tools/memory_seeds.py`` does for the port: the spread of the reference
over seeds, to set the port's beside. It runs the JAX package only.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro.configs.ocean import ocean_tcfg, preset  # noqa: E402
from repro.envs.ocean import OCEAN  # noqa: E402
from repro.rl.trainer import Trainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="tagteam")
    ap.add_argument("--seeds", default="0,1,2")
    args = ap.parse_args(argv)
    p = preset(args.env)
    for seed in (int(s) for s in args.seeds.split(",")):
        tr = Trainer(OCEAN[args.env](), ocean_tcfg(args.env), hidden=p.hidden,
                     recurrent=p.recurrent, conv=p.conv, seed=seed)
        t0 = time.perf_counter()
        m = tr.train(p.total_steps, target_score=p.target_score)
        wall = time.perf_counter() - t0
        best = max(h["score"] for h in tr.history if h["episodes"] > 0)
        status = "SOLVED" if m["score"] >= p.target_score else "unsolved"
        print(f"{args.env} seed {seed} (JAX reference, cpu): {status} score "
              f"{m['score']:.4f} at {m['env_steps']} env steps (budget "
              f"{p.total_steps}), best {best:.4f}, {len(tr.history)} "
              f"updates, {wall:.1f} s wall", flush=True)


if __name__ == "__main__":
    main()
