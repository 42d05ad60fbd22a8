"""Ocean PPO launcher, the jit tier.

  PYTHONPATH=src python -m repro_torch.launch.train --ocean bandit,squared

trains each named env (or ``all``: the eight of ``envs/ocean.py``) with its
``configs/ocean.py`` preset on the card and prints ``SOLVED`` or
``unsolved``, the score, the env steps and the steps per second.
``--device cpu`` trains on the CPU. The counterpart of the ``--ocean``
branch of ``repro/launch/train.py``.
"""
from __future__ import annotations

import argparse

from repro_torch import device as _device
from repro_torch.configs.ocean import ocean_tcfg, preset
from repro_torch.envs.ocean import OCEAN
from repro_torch.rl.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ocean", required=True,
                    help="ocean env name(s, comma-separated) or 'all'")
    ap.add_argument("--updates-per-launch", "-K", type=int, default=1,
                    help="fused PPO updates per launch (one metrics fetch "
                         "per launch)")
    ap.add_argument("--total-env-steps", type=int, default=0,
                    help="env-step budget (0 → the env preset)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    names = list(OCEAN) if args.ocean == "all" \
        else [n.strip() for n in args.ocean.split(",")]
    unknown = [n for n in names if n not in OCEAN]
    if unknown:
        ap.error(f"unknown ocean env(s) {unknown}; have {list(OCEAN)}")
    results = {}
    for name in names:
        p = preset(name)
        tcfg = ocean_tcfg(name, updates_per_launch=args.updates_per_launch)
        tr = Trainer(OCEAN[name](), tcfg, hidden=p.hidden,
                     recurrent=p.recurrent, conv=p.conv, seed=args.seed,
                     device=dev)
        steps = args.total_env_steps or p.total_steps
        print(f"=== {name} (recurrent={p.recurrent}, device={dev}) ===")
        m = tr.train(steps, log_every=10, target_score=p.target_score)
        status = "SOLVED" if m["score"] >= p.target_score else "unsolved"
        print(f"  -> {status} score={m['score']:.3f} "
              f"steps={m['env_steps']} sps={m['sps']:.0f}")
        results[name] = m
    return results


if __name__ == "__main__":
    main()
