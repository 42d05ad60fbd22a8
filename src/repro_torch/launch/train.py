"""Training launcher: Ocean PPO (the jit, shard_map, pool and async tiers
on the batched envs, the host tier on bridged host envs) or LM-backbone
PPO.

  PYTHONPATH=src python -m repro_torch.launch.train --ocean bandit,squared
  PYTHONPATH=src python -m repro_torch.launch.train --ocean squared \\
      --engine-backend pool
  PYTHONPATH=src python -m repro_torch.launch.train --ocean squared \\
      --engine-backend shard_map [--devices 2 --device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --ocean squared \\
      --metrics-port 0 --run-dir runs/sq --profile prof [--profile-launches 3]
  PYTHONPATH=src python -m repro_torch.launch.train --ocean bandit \\
      --engine-backend async --num-actors 2
  PYTHONPATH=src python -m repro_torch.launch.train --host-env bandit \\
      [--host-backend proc]
  PYTHONPATH=src python -m repro_torch.launch.train --ocean squared \\
      --ckpt-dir ckpts --save-every 10 [--resume] [--run-dir runs/sq]
  PYTHONPATH=src python -m repro_torch.launch.train --ocean duel \\
      --selfplay --league-dir league [--snapshot-every 10] \\
      [--strategy prioritized]
  PYTHONPATH=src python -m repro_torch.launch.train --ocean all \\
      --conformance [--selfplay] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --batch 8 --seq 256 --steps 20 [--smoke] [--ckpt-dir ckpts --resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --mesh 2x2 --devices 4 --device cpu [--ckpt-dir ckpts --resume]

``--ocean`` trains each named env (or ``all``: the 13 of
``envs/ocean.py``) with its ``configs/ocean.py`` preset; ``--host-env``
trains the numpy mirrors of ``envs/ocean_host.py`` (or ``all``) through
``bridge.make_host_engine`` on the host tier, M = 2N envs on worker threads
or spawned processes. Each prints ``SOLVED`` or ``unsolved``, the score, the
env steps and the steps per second; host runs also print the act steps and
the kernel launches, async runs the updates, the launches, the learner's
idle share, the fragments' ages, and each actor's device and steps per
second, shard_map runs the world size, the updates, the launches and the
all-reduces. ``--engine-backend shard_map`` is the data-parallel tier: one
rank per process over a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU); ``--devices N`` spawns N ranks (on the CPU, or on N cards)
and rank 0 prints, and without it the run is one rank. The Ocean tiers
take ``--mesh 1x1`` only.

``--ckpt-dir`` (default ``/tmp/repro_ckpt``, as the reference's) saves each
``--ocean`` env's resumable state under ``<dir>/<env>`` every
``--save-every`` updates (0: never) and ``--resume`` continues from the
newest one in the ``--ckpt-dir`` it is given (a resume names its
directory); ``--run-dir`` turns on span tracing into that directory and
writes the metrics log there (``python -m repro_torch.telemetry summarize
<dir>``). ``--metrics-port`` serves ``/metrics``, ``/healthz`` and
``/spans`` on 127.0.0.1 while ``--ocean`` trains (0: a free port; the
``monitoring:`` line names it); ``--profile DIR`` records the first
``--profile-launches`` launches with ``torch.profiler`` (CPU, and CUDA on
the card) into a trace in DIR that Perfetto reads. ``--selfplay`` trains
a multi-agent ``--ocean`` env under league self-play on the jit or
shard_map tier: frozen opponents sampled (``--strategy``) from the policy
store in ``--league-dir``, a snapshot every ``--snapshot-every`` updates
rated in the arena; it prints the final winrate against the random
policy, the store's versions, the updates and kernel launches, and the
leaderboard; it takes no ``--ckpt-dir``, ``--resume`` or ``--run-dir``.
``--arch`` trains that LM backbone (``--smoke``: its reduced config) with
PPO on random token rollouts of ``--batch`` × ``--seq`` for ``--steps``
steps of ``rl.learner.make_lm_train_step`` through
``distributed.fault.ResilientLoop``, printing the reference's ``step``
lines and ``done:`` line; it saves the train state under ``--ckpt-dir``
every ``--save-every`` steps and ``--resume`` continues from the newest.
``--mesh DxM`` (or ``PxDxM``: axes ``data, model`` or ``pod, data,
model``) trains it by the reference's FSDP/TP plan over that mesh, one
rank a process (``distributed/plan.py``): ``embed`` split over the data
axes, ``vocab``/``heads``/``kv_heads``/``mlp``/``expert``/``ssm_heads``
over ``model``, the batch over the data axes; ``--devices N`` spawns the
N = D·M ranks (NCCL on N cards, gloo on ``--device cpu``), and without it
the mesh must be 1x1 (one rank, over a group of its own). Each rank
saves its blocks of the train state and ``--resume`` restores each
rank's region, onto any mesh (``checkpoint/ckpt.py``). Rank 0 prints the
step lines, then ``world_size=… mesh=… collectives={…}`` (the
collectives a step, by kind). A batch the data size does not divide is
refused. Training takes float weights (quantised weights on a mesh
serve only: ``BackbonePolicy(mesh=, quantize=)``, ``rl/actor.py``).
Runs on the card unless ``--device cpu``. ``--conformance`` runs the
env-conformance harness (``envs/conformance.py``) on the ``--ocean``
env(s) instead of training, the competitive-env profile with
``--selfplay``, and exits 1 on any violation. The counterpart of
``repro/launch/train.py``.

The module imports no torch at its top: ``--host-backend proc``, the async
tier and ``--devices`` spawn processes, and spawn re-imports this module in
each.
"""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple

DEFAULT_CKPT_DIR = "/tmp/repro_ckpt"


class _Given(argparse.Action):
    """Store the value and note that the command line gave it
    (``<dest>_given``): a check refuses what the user passed, never the
    default."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        setattr(namespace, self.dest + "_given", True)


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ocean", default=None,
                    help="ocean env name(s, comma-separated) or 'all'")
    ap.add_argument("--conformance", action="store_true",
                    help="run the env-conformance harness on the --ocean "
                         "env(s) instead of training; exit 1 on violations")
    ap.add_argument("--host-env", default=None,
                    help="host-mirror env name(s, comma-separated) or 'all' "
                         "(envs/ocean_host.py), trained through bridge.wrap "
                         "on the host tier")
    ap.add_argument("--engine-backend", default=None,
                    choices=("jit", "shard_map", "pool", "host", "async"),
                    help="TrainEngine tier (default: jit for --ocean; "
                         "--host-env always runs the host tier; 'shard_map' "
                         "is data-parallel over torch.distributed ranks; "
                         "'async' is the actor–learner split: spawned "
                         "actors stream rollout fragments, the learner "
                         "consumes at its own rate)")
    ap.add_argument("--num-actors", type=int, default=None,
                    help="async tier: spawned actor processes (default 2)")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="async tier: max learner-version lag before a "
                         "fragment is dropped or importance-clipped "
                         "(default 2)")
    ap.add_argument("--staleness-mode", default=None,
                    choices=("drop", "vtrace"),
                    help="async tier: stale-fragment policy — 'drop' "
                         "discards, 'vtrace' keeps them under truncated "
                         "importance weights (default drop)")
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
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR, action=_Given,
                    help="--ocean: save each env's resumable state under "
                         "<dir>/<env>; --arch: the train state under <dir> "
                         f"(default {DEFAULT_CKPT_DIR})")
    ap.add_argument("--save-every", type=int, default=50,
                    help="updates (--arch: steps) between checkpoints; 0 "
                         "saves none")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt-dir")
    ap.add_argument("--run-dir", default=None,
                    help="--ocean: span tracing and the metrics log into "
                         "this directory; inspect with `python -m "
                         "repro_torch.telemetry summarize <dir>`")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /healthz, /spans on "
                         "127.0.0.1:<port> for the duration of --ocean "
                         "training (0 = pick a free ephemeral port; "
                         "default: no server)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record the first --profile-launches engine "
                         "launches with torch.profiler into a trace in DIR "
                         "(Perfetto / TensorBoard)")
    ap.add_argument("--profile-launches", type=int, default=3,
                    help="launches to capture under --profile (default 3)")
    ap.add_argument("--mesh", default="1x1", action=_Given,
                    help="--arch: DxM or PxDxM, train by the FSDP/TP plan "
                         "over that mesh; the Ocean tiers take 1x1")
    ap.add_argument("--devices", type=int, default=0,
                    help="--ocean on the shard_map tier, or --arch with "
                         "--mesh: spawn this many ranks (gloo on --device "
                         "cpu, NCCL on as many cards); rank 0 prints")
    ap.add_argument("--selfplay", action="store_true",
                    help="train --ocean env(s) under league self-play: "
                         "frozen opponents sampled from the policy store "
                         "in --league-dir (multi-agent envs only)")
    ap.add_argument("--league-dir", default=None,
                    help="policy-league directory (store + ratings); "
                         "required with --selfplay")
    ap.add_argument("--snapshot-every", type=int, default=10,
                    help="selfplay: updates between store snapshots")
    ap.add_argument("--strategy", default="prioritized",
                    choices=("latest", "uniform", "prioritized"),
                    help="selfplay opponent sampling strategy")
    ap.add_argument("--arch", default=None,
                    help="LM-backbone PPO on this arch (repro_torch.configs)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--steps", type=int, default=100,
                    help="--arch: train steps")
    ap.add_argument("--batch", type=int, default=8,
                    help="--arch: sequences per step")
    ap.add_argument("--seq", type=int, default=256,
                    help="--arch: tokens per sequence")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.set_defaults(ckpt_dir_given=False, mesh_given=False)
    return ap


class LMRun(NamedTuple):
    """What ``_train_lm`` leaves: the final state, the last step's metrics,
    the step function, the batch source (``batches(start) → iterator``),
    the loop and the policy."""
    state: object
    metrics: dict
    step: object
    batches: object
    loop: object
    policy: object


def _train_lm(args, ap, dev):
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.policy import BackbonePolicy

    if args.resume and not args.ckpt_dir_given:
        ap.error("--resume needs --ckpt-dir")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mesh = own_group = shardings = None
    if args.mesh_given:
        mesh, own_group = _lm_mesh(args, ap, dev)
    try:
        policy = BackbonePolicy(cfg, device=dev, generator=gen, mesh=mesh)
        if mesh is not None:
            rules = shd.make_rules(mesh)
            shardings = shd.named(mesh, shd.train_state_pspecs(policy,
                                                              rules))
        return _run_lm(args, cfg, tcfg, dev, policy, shardings)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _lm_mesh(args, ap, dev):
    """The mesh of ``--mesh`` over the process group (one of its own when
    there is none: then the mesh must be 1x1); returns (mesh, whether this
    call made the group)."""
    from repro_torch.launch import mesh as tmesh
    try:
        shape = tuple(int(x) for x in args.mesh.split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        ap.error(f"--mesh {args.mesh}: DxM or PxDxM")
    axes = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    data = shape[-2] * (shape[0] if len(shape) == 3 else 1)
    if args.batch % data:
        ap.error(f"--batch {args.batch} is not divisible by the mesh's data "
                 f"size {data}")
    own = tmesh.init_process_group(dev)
    try:
        mesh = tmesh.make_mesh(shape, axes)
    except ValueError as e:
        if own:
            import torch.distributed as dist
            dist.destroy_process_group()
        ap.error(str(e))
    return mesh, own


def _run_lm(args, cfg, tcfg, dev, policy, shardings):
    from repro_torch.data.buffer import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.fault import ResilientLoop
    from repro_torch.models.layers import dtype_of
    from repro_torch.rl.learner import init_train_state, make_lm_train_step
    import torch

    state = init_train_state(policy.params(),
                             dtype_of(tcfg.optimizer_state_dtype))
    train_step = make_lm_train_step(policy, tcfg,
                                    loss_chunk=min(256, args.seq))

    def step(state, batch):
        # the policy takes each step's params, so that it serves the trained
        # weights and the run holds two copies at most (a step's input and
        # output), not the initial ones besides
        state, metrics = train_step(state, batch)
        policy.bind(state.params)
        return state, metrics

    loop = ResilientLoop(step, args.ckpt_dir, save_every=args.save_every,
                         shardings=shardings)
    if args.resume:
        state, start = loop.resume_or_init(state)
        policy.bind(state.params)
        loop.steps_done = start
        print(f"resumed at step {start}", flush=True)

    def batches(start):
        # batch i drives step i + 1: its own seed, so a replay or a resumed
        # run sees the same data
        for i in range(start, args.steps):
            g = torch.Generator(device=dev).manual_seed(
                args.seed * 1_000_003 + 1000 + i)
            yield random_batch(cfg, args.batch, args.seq, g)

    last = {}
    per_step = []

    def on_metrics(i, m):
        last.update(m)
        per_step.append(dict(shd.COLLECTIVES))
        if i % 5 == 0 or i == 1:
            print(f"step {i:5d} loss {float(m['loss']):+.4f} "
                  f"kl {float(m['approx_kl']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} "
                  f"median_step {loop.monitor.median * 1e3:.0f}ms",
                  flush=True)

    plan = policy.plan
    print(f"=== {cfg.name} LM PPO (layers={cfg.num_layers} "
          f"d_model={cfg.d_model}, batch={args.batch} seq={args.seq}, "
          f"device={dev}"
          f"{'' if plan is None else ', mesh=' + args.mesh}) ===",
          flush=True)
    shd.reset_collectives()
    # the loop takes the only reference to the initial state, so that each
    # step's input state is freed once the step has returned its output
    init, state = [state], None
    state = loop.run(init.pop(), batches, on_metrics)
    loop.join_save()
    print(f"done: {loop.steps_done} steps, {loop.recoveries} recoveries, "
          f"{loop.monitor.flagged} straggler flags", flush=True)
    if plan is not None:
        # the last step's collectives (the counts between two steps' ends)
        a = per_step[-2] if len(per_step) > 1 else \
            {k: 0 for k in shd.COLLECTIVES}
        coll = {k: per_step[-1][k] - a[k] for k in a} if per_step else {}
        print(f"world_size={plan.mesh.size} mesh={args.mesh} "
              f"dp={plan.dp} tp={plan.tp} collectives={coll}", flush=True)
    return LMRun(state, last, step, batches, loop, policy)


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
    if args.ckpt_dir_given or args.resume:
        ap.error("--ckpt-dir/--resume are --ocean and --arch options: the "
                 "host tier's env states live in its workers")
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


def _async_report(eng, h):
    """The async tier's lines: the learner's idle share, the fragments'
    ages and drops, reshards, and each actor's device and steps/s (from
    its stat row: steps over its busy and waiting time)."""
    st = eng.stats()["rollouts"]
    waits = eng.collect_waits
    idle = sum(waits) / eng.run_s if eng.run_s else 0.0
    # after the first batch: the actors' start-up left out
    after = eng.run_s - eng.first_batch_s
    idle_after = sum(waits[1:]) / after if after > 0 else 0.0
    # every update's learn falls after the first batch's arrival
    sps_after = (len(waits) * eng.steps_per_update / after
                 if after > 0 else 0.0)
    lines = [f"  async: learner_idle={idle:.4f} "
             f"learner_idle_after_first_batch={idle_after:.4f} "
             f"first_batch_s={eng.first_batch_s:.2f} "
             f"sps_after_first_batch={sps_after:.0f} "
             f"frag_age_mean={h.get('frag_age_mean', 0.0):.3f} "
             f"frag_age_max={h.get('frag_age_max', 0.0):.0f} "
             f"dropped={h.get('dropped_fragments', 0)} "
             f"reshards={st['reshards']} "
             f"actors_alive={len(eng.rollouts.alive_actors())} "
             f"dead={st['dead']}"]
    per = st["actors"]["per_worker"]
    for a, devname in enumerate(st["devices"]):
        busy_s = (per["busy_ns"][a] + per["wait_ns"][a]) / 1e9
        sps = per["steps"][a] / busy_s if busy_s else 0.0
        lines.append(f"  actor {a}: device={devname} steps={per['steps'][a]}"
                     f" fragments={per['fragments'][a]} sps={sps:.0f}")
    return "\n".join(lines)


def _train_selfplay(args, ap, dev):
    from repro_torch.configs.ocean import ocean_tcfg, preset
    from repro_torch.envs.ocean import OCEAN
    from repro_torch.kernels import build
    from repro_torch.league import run_selfplay

    names = [n.strip() for n in args.ocean.split(",")]
    unknown = [n for n in names if n not in OCEAN]
    if unknown:
        ap.error(f"unknown ocean env(s) {unknown}; have {list(OCEAN)}")
    backend = args.engine_backend or "jit"
    results = {}
    for name in names:
        p = preset(name)
        over = {"num_envs": args.num_envs} if args.num_envs else {}
        tcfg = ocean_tcfg(name, engine_backend=backend,
                          updates_per_launch=args.updates_per_launch, **over)
        steps = args.total_env_steps or p.total_steps
        ldir = os.path.join(args.league_dir, name) if len(names) > 1 \
            else args.league_dir
        print(f"=== selfplay/{name} (league={ldir}, backend={backend}, "
              f"device={dev}) ===", flush=True)
        build.reset_launches()
        res = run_selfplay(
            OCEAN[name](), tcfg, league_dir=ldir, total_steps=steps,
            snapshot_every=args.snapshot_every, hidden=p.hidden,
            recurrent=p.recurrent, conv=p.conv, strategy=args.strategy,
            seed=args.seed, backend=backend, device=dev, log_every=10)
        status = ("SOLVED" if res.winrate_random >= p.target_score
                  else "unsolved")
        print(f"  -> {status} winrate_vs_random={res.winrate_random:.3f} "
              f"versions={res.store.versions()} updates={len(res.history)} "
              f"steps={res.history[-1]['env_steps']} "
              f"launches={dict(build.LAUNCHES)}", flush=True)
        print(res.ranker.leaderboard(), flush=True)
        results[name] = res
    return results


class _Profile:
    """``torch.profiler`` over the first ``launches`` engine launches
    (CPU activity, and CUDA's on the card), counted by ``on_launch``; the
    trace lands in ``out_dir`` (``tensorboard_trace_handler``: Chrome
    trace JSON that Perfetto reads) when it stops."""

    def __init__(self, out_dir: str, launches: int, dev):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.launches, self.seen = launches, 0
        self.active = self.done = False
        self._sync = (torch.cuda.synchronize if dev.type == "cuda"
                      else lambda: None)
        self.prof = profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(out_dir))

    def start(self):
        if not (self.active or self.done):
            self.prof.start()
            self.active = True

    def on_launch(self, u):
        self.seen += 1
        if self.seen >= self.launches:
            self.stop()

    def stop(self):
        if self.active:
            self._sync()             # the last launch's kernels in the trace
            self.prof.stop()
            self.active, self.done = False, True


def _train_ocean(args, ap, dev):
    from repro_torch import telemetry
    from repro_torch.configs.ocean import ocean_tcfg, preset
    from repro_torch.distributed import sharding as shd
    from repro_torch.envs.ocean import OCEAN
    from repro_torch.kernels import build
    from repro_torch.rl import trainer as trainer_mod

    backend = args.engine_backend or "jit"
    if backend == "host":
        ap.error("--engine-backend host trains --host-env envs")
    if args.resume and not args.ckpt_dir_given:
        ap.error("--resume needs --ckpt-dir")
    async_overrides = {
        k: v for k, v in (("num_actors", args.num_actors),
                          ("max_staleness", args.max_staleness),
                          ("staleness_mode", args.staleness_mode))
        if v is not None}
    if async_overrides and backend != "async":
        ap.error("--num-actors/--max-staleness/--staleness-mode are async-"
                 "tier knobs; pass --engine-backend async")
    if backend == "async" and args.updates_per_launch != 1:
        ap.error("-K/--updates-per-launch is the jit tier's knob; the async "
                 "tier's learner runs one update per fragment batch (K=1)")
    names = list(OCEAN) if args.ocean == "all" \
        else [n.strip() for n in args.ocean.split(",")]
    unknown = [n for n in names if n not in OCEAN]
    if unknown:
        ap.error(f"unknown ocean env(s) {unknown}; have {list(OCEAN)}")
    if args.run_dir:
        telemetry.enable(args.run_dir)
    server = prof = None
    if args.metrics_port is not None:
        from repro_torch.telemetry.http import MetricsServer
        server = MetricsServer(port=args.metrics_port)
        print(f"monitoring: {server.url}/metrics  {server.url}/healthz  "
              f"{server.url}/spans", flush=True)
    if args.profile:
        prof = _Profile(args.profile, args.profile_launches, dev)
    results = {}
    try:
        for name in names:
            p = preset(name)
            over = {"num_envs": args.num_envs} if args.num_envs else {}
            tcfg = ocean_tcfg(name, engine_backend=backend,
                              updates_per_launch=args.updates_per_launch,
                              checkpoint_every=args.save_every,
                              metrics_port=server.port if server else 0,
                              **async_overrides, **over)
            tr = trainer_mod.Trainer(
                OCEAN[name](), tcfg, hidden=p.hidden, recurrent=p.recurrent,
                conv=p.conv, seed=args.seed, device=dev,
                log_dir=args.run_dir)
            eng = tr.engine
            if server is not None:
                # one key: replaces the previous env's engine, so a closed
                # engine never lingers as a dead health source
                server.add_source("engine", eng.stats)
            steps = args.total_env_steps or p.total_steps
            extra = ""
            if backend == "async":
                extra = (f", actors={tcfg.num_actors} pids="
                         f"{[pr.pid for pr in eng.rollouts._procs]} "
                         f"staleness={tcfg.staleness_mode}<="
                         f"{tcfg.max_staleness}")
            if backend == "shard_map":
                extra = f", world_size={eng.num_shards}"
            print(f"=== {name} (recurrent={p.recurrent}, backend={backend}, "
                  f"device={dev}{extra}) ===", flush=True)
            build.reset_launches()
            shd.reset_collectives()
            if prof is not None:
                prof.start()
            try:
                m = tr.train(steps, log_every=10,
                             target_score=_target(args, p),
                             checkpoint_dir=os.path.join(args.ckpt_dir, name),
                             resume=args.resume,
                             on_launch=prof.on_launch if prof else None)
                if not m:
                    print("  -> resumed past the step budget; nothing to do",
                          flush=True)
                    continue
                line = _report(m, p.target_score)
                if backend == "async":
                    line += (f" updates={len(tr.history)} "
                             f"last_update={eng._resume_update} "
                             f"launches={dict(build.LAUNCHES)}\n"
                             f"{_async_report(eng, m)}")
                    if dev.type == "cuda":
                        import torch
                        free, total = torch.cuda.mem_get_info(dev)
                        line += (f"\n  learner mem_get_info: free "
                                 f"{free / 2**30:.2f} GiB of "
                                 f"{total / 2**30:.2f} GiB")
                if backend == "shard_map":
                    line += (f" updates={len(tr.history)} "
                             f"world_size={eng.num_shards} "
                             f"launches={dict(build.LAUNCHES)} "
                             f"collectives={dict(shd.COLLECTIVES)}")
                print(line, flush=True)
            finally:
                eng.close()          # async tier: actor processes + slab
                tr.logger.close()    # the metrics log's final flush
            results[name] = m
    finally:
        if prof is not None:
            prof.stop()
        if server is not None:
            server.close()
        if args.run_dir:
            telemetry.flush()
            print(f"telemetry: python -m repro_torch.telemetry summarize "
                  f"{args.run_dir}", flush=True)
    return results


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, argv, world, port, device_type, out):
    """One spawned rank of ``--devices N``: join the group (NCCL on card
    ``rank``, gloo on the CPU), run the launcher as that rank and hand rank
    0's results to the parent. Ranks past 0 print nothing and leave the
    run directory, the monitoring server and the profile to rank 0."""
    import datetime
    import sys

    import torch.distributed as dist

    from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S
    ap = _parser()
    args = ap.parse_args(argv)
    args.devices = 0
    kw = {}
    if device_type == "cuda":
        # one card a rank: NCCL binds each rank's communicator to its card
        import torch
        args.device = f"cuda:{rank}"
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    else:
        # the ranks share the cores: each takes its share of the threads
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if rank > 0:
        sys.stdout = open(os.devnull, "w")
        args.run_dir = args.metrics_port = args.profile = None
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw)
    try:
        res = _dispatch(args, ap)
        if rank == 0 and isinstance(res, LMRun):
            # --arch: the steps run and the last step's metrics
            out.put({"steps": res.loop.steps_done,
                     "metrics": {k: float(v) for k, v in res.metrics.items()}})
        elif rank == 0:
            # each env's final metrics (self-play: its winrate and updates)
            out.put({k: (v if isinstance(v, dict) else
                         {"winrate_random": v.winrate_random,
                          "updates": len(v.history)})
                     for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def _spawn(args, argv, ap, dev):
    """``--devices N``: N ranks in spawned processes; returns rank 0's
    results (a rank that fails fails the run: the others are stopped and
    the failure raises here)."""
    import torch
    import torch.multiprocessing as mp

    n = args.devices
    if dev.type == "cuda" and n > torch.cuda.device_count():
        ap.error(f"--devices {n} needs {n} cards; this machine has "
                 f"{torch.cuda.device_count()}")
    out = mp.get_context("spawn").SimpleQueue()
    ranks = mp.spawn(_rank_main, args=(argv, n, _free_port(), dev.type, out),
                     nprocs=n, join=False)
    res = None
    # read while joining: rank 0's put must never wait on a full pipe
    while not ranks.join(timeout=0.5):
        if res is None and not out.empty():
            res = out.get()  # repro_torch: noqa[BLOCKING-NO-TIMEOUT] — not empty
    # every rank exited cleanly (join raises otherwise): rank 0's result is in
    return out.get() if res is None else res  # repro_torch: noqa[BLOCKING-NO-TIMEOUT]


def _dispatch(args, ap):
    from repro_torch import device as _device
    dev = _device.resolve(args.device)
    if args.arch is not None:
        return _train_lm(args, ap, dev)
    if args.host_env is not None:
        return _train_host(args, ap, dev)
    if args.selfplay:
        return _train_selfplay(args, ap, dev)
    return _train_ocean(args, ap, dev)


def main(argv=None):
    import sys
    ap = _parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.conformance:
        if not args.ocean:
            ap.error("--conformance requires --ocean <name(s)|all>")
        # --selfplay routes to the competitive-env (league) profile
        from repro_torch.envs.conformance import run_cli
        raise SystemExit(run_cli(args.ocean, seed=args.seed,
                                 selfplay=args.selfplay, device=args.device))
    if args.mesh != "1x1" and args.arch is None:
        ap.error(f"--mesh {args.mesh}: the Ocean tiers take 1x1; a mesh "
                 f"lays out --arch training")
    if args.selfplay:
        if args.engine_backend == "async":
            ap.error("--selfplay drives the device-resident tiers (frozen "
                     "opponents live in the fused update); the async tier "
                     "does not ship opponent params through the slab")
        if args.engine_backend not in (None, "jit", "shard_map"):
            ap.error(f"--selfplay runs on the jit tier or the shard_map "
                     f"tier, not --engine-backend {args.engine_backend}")
        if not args.ocean:
            ap.error("--selfplay requires --ocean <name(s)> (e.g. duel)")
        if not args.league_dir:
            ap.error("--selfplay requires --league-dir")
        if args.ckpt_dir_given or args.resume or args.run_dir:
            ap.error("--ckpt-dir/--resume/--run-dir are not taken with "
                     "--selfplay: the store in --league-dir is the league's "
                     "durable state")
    if sum(x is not None for x in (args.ocean, args.host_env,
                                   args.arch)) != 1:
        ap.error("pass exactly one of --ocean, --host-env and --arch")
    if args.devices < 0:
        ap.error(f"--devices {args.devices}: pass a positive rank count")
    if args.devices > 1:
        if args.arch is not None:
            if not args.mesh_given:
                ap.error(f"--devices {args.devices} with --arch spawns the "
                         f"ranks of a --mesh: pass one")
        elif args.ocean is None or args.engine_backend != "shard_map":
            ap.error(f"--devices {args.devices} spawns ranks of the "
                     f"data-parallel tier: pass --ocean and "
                     f"--engine-backend shard_map, or of --arch's --mesh")
        from repro_torch import device as _device
        return _spawn(args, argv, ap, _device.resolve(args.device))
    return _dispatch(args, ap)


if __name__ == "__main__":
    main()
