"""Ocean PPO launcher: the jit and pool tiers on the batched envs, the host
tier on bridged host envs.

  PYTHONPATH=src python -m repro_torch.launch.train --ocean bandit,squared
  PYTHONPATH=src python -m repro_torch.launch.train --ocean squared \\
      --engine-backend pool
  PYTHONPATH=src python -m repro_torch.launch.train --host-env bandit \\
      [--host-backend proc]

``--ocean`` trains each named env (or ``all``: the eight of
``envs/ocean.py``) with its ``configs/ocean.py`` preset; ``--host-env``
trains the numpy mirrors of ``envs/ocean_host.py`` (or ``all``) through
``bridge.make_host_engine`` on the host tier, M = 2N envs on worker threads
or spawned processes. Each prints ``SOLVED`` or ``unsolved``, the score, the
env steps and the steps per second; host runs also print the act steps and
the kernel launches. Runs on the card unless ``--device cpu``. The
counterpart of the ``--ocean`` and ``--host-env`` branches of
``repro/launch/train.py``.

The module imports no torch at its top: ``--host-backend proc`` spawns
workers, and spawn re-imports this module in every one of them.
"""
from __future__ import annotations

import argparse


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ocean", default=None,
                    help="ocean env name(s, comma-separated) or 'all'")
    ap.add_argument("--host-env", default=None,
                    help="host-mirror env name(s, comma-separated) or 'all' "
                         "(envs/ocean_host.py), trained through bridge.wrap "
                         "on the host tier")
    ap.add_argument("--engine-backend", default=None,
                    choices=("jit", "pool", "host"),
                    help="TrainEngine tier (default: jit for --ocean; "
                         "--host-env always runs the host tier)")
    ap.add_argument("--host-backend", default=None,
                    choices=("thread", "proc"),
                    help="host-tier workers: 'thread' (default) or 'proc' "
                         "(shared-memory spawn processes)")
    ap.add_argument("--num-envs", type=int, default=0,
                    help="envs per batch N (0 → the preset's 64); the pool "
                         "and host tiers step pool_buffers × N")
    ap.add_argument("--updates-per-launch", "-K", type=int, default=1,
                    help="jit tier: fused PPO updates per launch (one "
                         "metrics fetch per launch)")
    ap.add_argument("--total-env-steps", type=int, default=0,
                    help="env-step budget (0 → the env preset)")
    ap.add_argument("--full-budget", action="store_true",
                    help="train the whole step budget: no early exit when "
                         "the preset's target score is reached")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def _report(m, target):
    status = "SOLVED" if m["score"] >= target else "unsolved"
    return (f"  -> {status} score={m['score']:.3f} steps={m['env_steps']} "
            f"sps={m['sps']:.0f}")


def _target(args, p):
    return None if args.full_budget else p.target_score


def _train_host(args, ap, dev):
    from repro_torch.bridge import make_host_engine
    from repro_torch.configs.ocean import ocean_tcfg, preset
    from repro_torch.envs.ocean_host import OCEAN_HOST
    from repro_torch.kernels import build

    if args.engine_backend not in (None, "host"):
        ap.error(f"--host-env runs on the host tier; got --engine-backend "
                 f"{args.engine_backend}")
    if args.updates_per_launch != 1:
        ap.error("-K/--updates-per-launch is the jit tier's knob; the host "
                 "tier runs one update per trajectory (K=1)")
    names = list(OCEAN_HOST) if args.host_env == "all" \
        else [n.strip() for n in args.host_env.split(",")]
    unknown = [n for n in names if n not in OCEAN_HOST]
    if unknown:
        ap.error(f"unknown host env(s) {unknown}; have {list(OCEAN_HOST)}")
    results = {}
    for name in names:
        p = preset(name)
        over = {"num_envs": args.num_envs} if args.num_envs else {}
        tcfg = ocean_tcfg(name, engine_backend="host", updates_per_launch=1,
                          host_backend=args.host_backend or "thread", **over)
        eng = make_host_engine(OCEAN_HOST[name], tcfg, hidden=p.hidden,
                               recurrent=p.recurrent, seed=args.seed,
                               device=dev)
        steps = args.total_env_steps or p.total_steps
        print(f"=== host/{name} (M={eng.hvec.num_envs} "
              f"N={eng.hvec.batch_envs} workers={eng.hvec.backend}, "
              f"device={dev}) ===", flush=True)
        build.reset_launches()
        try:
            hist, solved = eng.run(steps, target_score=_target(args, p))
        finally:
            eng.close()
        m = solved if solved is not None else hist[-1]
        print(f"{_report(m, p.target_score)} updates={len(hist)} "
              f"act_steps={eng.act_steps} launches={dict(build.LAUNCHES)}",
              flush=True)
        results[name] = m
    return results


def _train_ocean(args, ap, dev):
    from repro_torch.configs.ocean import ocean_tcfg, preset
    from repro_torch.envs.ocean import OCEAN
    from repro_torch.rl.trainer import Trainer

    backend = args.engine_backend or "jit"
    if backend == "host":
        ap.error("--engine-backend host trains --host-env envs")
    names = list(OCEAN) if args.ocean == "all" \
        else [n.strip() for n in args.ocean.split(",")]
    unknown = [n for n in names if n not in OCEAN]
    if unknown:
        ap.error(f"unknown ocean env(s) {unknown}; have {list(OCEAN)}")
    results = {}
    for name in names:
        p = preset(name)
        over = {"num_envs": args.num_envs} if args.num_envs else {}
        tcfg = ocean_tcfg(name, engine_backend=backend,
                          updates_per_launch=args.updates_per_launch, **over)
        tr = Trainer(OCEAN[name](), tcfg, hidden=p.hidden,
                     recurrent=p.recurrent, conv=p.conv, seed=args.seed,
                     device=dev)
        steps = args.total_env_steps or p.total_steps
        print(f"=== {name} (recurrent={p.recurrent}, backend={backend}, "
              f"device={dev}) ===", flush=True)
        m = tr.train(steps, log_every=10, target_score=_target(args, p))
        print(_report(m, p.target_score), flush=True)
        results[name] = m
    return results


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if (args.ocean is None) == (args.host_env is None):
        ap.error("pass exactly one of --ocean and --host-env")
    from repro_torch import device as _device
    dev = _device.resolve(args.device)
    if args.host_env is not None:
        return _train_host(args, ap, dev)
    return _train_ocean(args, ap, dev)


if __name__ == "__main__":
    main()
