"""The repo's own audit targets, and the hot-step table the lint reads.

The counterpart of ``repro/analysis/targets.py``. Three surfaces whose steps
must never make the host wait for the card, each run once under
``dispatch_audit.audit_fn``:

  * every op in the kernel registry (``kernels/dispatch.py::OPS``) at small
    canonical shapes, and the backward kernels of ``flash_attention`` and
    ``ssd`` through autograd; on ``cuda`` each call launches its hand-written
    kernel, under ``set_sync_debug_mode("error")``. A registered op with no
    canonical case here is itself a violation, so coverage cannot shrink
    quietly;
  * the engine tiers' device work: the jit tier's fused update launch, the
    ``shard_map`` tier's at world size 1, the pool tier's learn, act and
    bootstrap on a real trajectory, and the host tier's recurrent learn and
    its act step up to the one packed buffer it sends to the host (the
    ``pack`` kernel); the copy to the host is that tier's one designed
    transfer, and is left out;
  * every registered Ocean env's ``step`` under a random action.

``audit_all(device=…)`` is what ``python -m repro_torch.analysis --self``
runs. Entry points run on ``cuda`` unless the caller passes ``"cpu"``; on
the CPU the kernel ops run their ``ref`` backends.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

# The port's hot steps: module path (under src/) -> the qualnames of the
# functions that run once per env step, update or decoded token. The lint
# (rules.py) holds them, the functions nested in them and the local
# functions they call to no host sync, no unseeded draw and no telemetry; an
# entry that names no function of its module is a STALE-HOT-STEP finding.
HOT_STEPS: Dict[str, tuple] = {
    # the engine tiers: the fused update (jit, shard_map), the learn of the
    # pool and host tiers, and the act and bootstrap steps
    "repro_torch/rl/learner.py": ("make_ocean_update.update",
                                  "make_ocean_update.collect",
                                  "make_ocean_learn.learn"),
    "repro_torch/rl/rollout.py": ("rollout", "sample"),
    "repro_torch/rl/engine.py": ("TrainEngine._make_act.act",
                                 "TrainEngine._make_bootstrap.boot"),
    # serving: one decoded token
    "repro_torch/rl/actor.py": ("make_serve_step.serve_step",),
    # each Ocean env's step
    "repro_torch/envs/ocean.py": tuple(f"{c}.step" for c in (
        "Squared", "Password", "Stochastic", "Memory", "Multiagent",
        "Spaces", "Bandit", "Continuous", "Pong", "Drone", "TagTeam", "Maze",
        "Duel")),
}

# Targets whose f64 is the design, each with its reason. The rule stays
# strict everywhere else: an f64 result in a call given no f64 input is a
# violation.
F64_ALLOWED = {
    # kernels/ref.py:108: the plain SSD (the CPU path and the card's
    # yardstick) steps its recurrence in f64 on purpose: in f32 its rounding
    # over 48 Mamba2 layers moved a full-width gradient 13x as far as the
    # CUDA kernels' (tools/lm_gate_spread.py)
    "kernel:ssd[ref]": "the plain SSD steps in f64 (kernels/ref.py:108)",
    "kernel:ssd_bwd[ref]": "autograd of the plain SSD, which steps in f64 "
                           "(kernels/ref.py:108)",
    # kernels/ssd.py:255: the backward kernel's CUDA-core route carries dA
    # as a telescoping sum in f64 walks; the wrapper allocates that scratch
    "kernel:ssd_bwd[cuda]": "the backward kernel's f64 scratch for its dA "
                            "walks (kernels/ssd.py:255)",
}


def _kernel_cases(dev, mode: str) -> Dict[str, tuple]:
    """name -> (fn, args): every registered op, and the two backward
    kernels (reached through autograd), at small shapes the kernels take on
    the card (head dims 128 and 64, an SSD head dim and state of 16)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    bf = torch.bfloat16
    attn = (rand(1, 64, 4, 128, dtype=bf), rand(1, 64, 2, 128, dtype=bf),
            rand(1, 64, 2, 128, dtype=bf))
    ssd = (rand(1, 48, 2, 16, scale=0.5), F.softplus(rand(1, 48, 2)),
           -torch.exp(rand(2, scale=0.3)), rand(1, 48, 2, 16, scale=0.5),
           rand(1, 48, 2, 16, scale=0.5))
    wq = torch.randint(-127, 128, (64, 64), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)

    def attn_bwd(q, k, v, do):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            o = ops.flash_attention(*ins, causal=True, mode=mode)
            return torch.autograd.grad(o, ins, do)

    def ssd_bwd(x, dt, A, B_, C, dy):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, dt, A, B_, C)]
            y, _ = ops.ssd(*ins, chunk=16, mode=mode)
            return torch.autograd.grad(y, ins, dy)

    return {
        "flash_attention": (lambda q, k, v: ops.flash_attention(
            q, k, v, causal=True, mode=mode), attn),
        "flash_decode": (lambda q, k, v, n: ops.flash_decode(
            q, k, v, n, mode=mode), (rand(2, 8, 64), rand(2, 96, 2, 64),
                                     rand(2, 96, 2, 64),
                                     torch.tensor(57, dtype=torch.int32,
                                                  device=dev))),
        "gae": (lambda r, v, d, lv: ops.gae(r, v, d, lv, 0.99, 0.95,
                                            mode=mode),
                (rand(4, 32), rand(4, 32),
                 torch.rand((4, 32), generator=g, device=dev) < 0.1,
                 rand(4))),
        "ssd": (lambda *a: ops.ssd(*a, chunk=16, mode=mode), ssd),
        "quant_matmul": (lambda x, w, s: ops.quant_matmul(x, w, s,
                                                          mode=mode),
                         (rand(16, 64), wq, rand(64).abs() * 0.02)),
        "pack": (lambda *leaves: ops.pack(list(leaves), mode=mode),
                 tuple(torch.randint(0, 256, (4, n), generator=g, device=dev,
                                     dtype=torch.int32).to(torch.uint8)
                       for n in (3, 7))),
        "flash_attention_bwd": (attn_bwd, attn + (attn[0] * 0.5,)),
        "ssd_bwd": (ssd_bwd, ssd + (rand(1, 48, 2, 16),)),
    }


def audit_kernel_ops(mode: str = None, device=None) -> list:
    """Audit every op of the dispatch registry, and the backward kernels,
    once each. ``mode``: the backend (default ``cuda`` on a CUDA device,
    ``ref`` on the CPU)."""
    from repro_torch.analysis.dispatch_audit import (AuditResult,
                                                     AuditViolation,
                                                     audit_fn)
    from repro_torch.device import resolve
    from repro_torch.kernels import dispatch
    dev = resolve(device)
    mode = mode or ("cuda" if dev.type == "cuda" else "ref")
    cases = _kernel_cases(dev, mode)
    out: List = []
    for op in sorted(dispatch.OPS) + ["flash_attention_bwd", "ssd_bwd"]:
        name = f"kernel:{op}[{mode}]"
        if op not in cases:
            r = AuditResult(target=name)
            r.violations.append(AuditViolation(
                "coverage", name,
                f"op '{op}' is registered in kernels.dispatch but has no "
                f"canonical audit case in analysis.targets — add one so "
                f"the audit keeps covering every registered op"))
            out.append(r)
            continue
        fn, args = cases[op]
        out.append(audit_fn(fn, args, name=name, device=dev,
                            allow_f64=F64_ALLOWED.get(name, "")))
    return out


# ---------------------------------------------------------------------------
# engine tiers

def _engine(backend: str, dev, recurrent: bool = False):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.envs.ocean import Bandit
    from repro_torch.rl.engine import TrainEngine
    from repro_torch.rl.trainer import ocean_policy_stack
    em, dist, pol = ocean_policy_stack(Bandit(), hidden=16,
                                       recurrent=recurrent)
    tcfg = TrainConfig(num_envs=8, unroll_length=8, update_epochs=1,
                       num_minibatches=2, learning_rate=1e-3)
    return TrainEngine(em, pol, tcfg, dist, seed=0, device=dev,
                       backend=backend)


def _trajectory(eng):
    """A real rollout trajectory of ``eng``'s envs, for the learn steps."""
    import torch

    from repro_torch.core.vector import VecEnv
    from repro_torch.rl.rollout import RolloutCarry, rollout
    g = torch.Generator(device=eng.device).manual_seed(1)
    vec = VecEnv(eng.env, eng.tcfg.num_envs)
    state, obs = vec.init(g)
    B = vec.batch_size
    carry0 = eng.policy.initial_carry(B, eng.device)
    rc = RolloutCarry(state, obs, carry0,
                      torch.zeros((B,), dtype=torch.bool, device=eng.device))
    _, traj, last_value = rollout(eng.policy, eng.ts.params, vec.step, rc, g,
                                  eng.tcfg.unroll_length, eng.dist)
    return traj, last_value, obs, carry0


def audit_engine_tiers(device=None) -> list:
    import torch

    from repro_torch.analysis.dispatch_audit import audit_fn
    from repro_torch.core.emulation import emulate
    from repro_torch.device import resolve
    from repro_torch.rl.engine import act_transfer_spec
    from repro_torch.rl.learner import make_ocean_learn
    dev = resolve(device)
    out: List = []
    g = torch.Generator(device=dev).manual_seed(2)

    # jit tier: the fused update launch
    eng = _engine("jit", dev)
    out.append(audit_fn(lambda: eng.launch(1), name="engine:jit:launch",
                        device=dev))
    # shard_map tier at world size 1 (a group of its own, closed after)
    sm = _engine("shard_map", dev)
    try:
        out.append(audit_fn(lambda: sm.launch(1),
                            name="engine:shard_map:launch", device=dev))
    finally:
        sm.close()

    # pool tier: learn on a real trajectory, act and bootstrap (the three
    # device steps its host loop dispatches)
    traj, last_value, obs, carry0 = _trajectory(eng)
    learn = make_ocean_learn(eng.policy, eng.tcfg, eng.dist)
    out.append(audit_fn(learn, (eng.ts, carry0, traj, last_value, g),
                        name="engine:pool:learn", device=dev))
    reset = torch.zeros((obs.shape[0],), dtype=torch.bool, device=dev)
    act, boot = eng._make_act(), eng._make_bootstrap()
    out.append(audit_fn(act, (eng.ts.params, obs, carry0, reset, g),
                        name="engine:pool:act", device=dev))
    out.append(audit_fn(boot, (eng.ts.params, obs, carry0, reset),
                        name="engine:pool:bootstrap", device=dev))

    # host tier: the recurrent learn the bridged first-finisher loop runs,
    # and its act step up to the packed buffer (one pack launch)
    rec = _engine("jit", dev, recurrent=True)
    traj, last_value, obs, carry0 = _trajectory(rec)
    learn = make_ocean_learn(rec.policy, rec.tcfg, rec.dist)
    out.append(audit_fn(learn, (rec.ts, carry0, traj, last_value, g),
                        name="engine:host:learn", device=dev))
    spec = act_transfer_spec(rec.env.act_spec)
    ract = rec._make_act()

    def host_act(params, obs, carry, reset, gen):
        action, logp, value, pc = ract(params, obs, carry, reset, gen)
        return emulate(spec, {"action": action, "logp": logp,
                              "value": value}), pc

    out.append(audit_fn(host_act, (rec.ts.params, obs, carry0, reset, g),
                        name="engine:host:act", device=dev))
    return out


# ---------------------------------------------------------------------------
# Ocean envs

def audit_ocean_envs(names: Sequence[str] = (), device=None) -> list:
    import torch

    from repro_torch.analysis.dispatch_audit import audit_fn
    from repro_torch.core import spaces as sp
    from repro_torch.device import resolve
    from repro_torch.envs.ocean import OCEAN
    dev = resolve(device)
    out: List = []
    for name in (names or sorted(OCEAN)):
        env = OCEAN[name]()
        g = torch.Generator(device=dev).manual_seed(3)
        s, _ = env.reset(env.init(4, g), g)
        batch = (4, env.num_agents) if env.num_agents > 1 else (4,)
        a = sp.sample(env.action_space, g, batch)
        env.step(s, a, g)        # builds the env's per-device constants
        out.append(audit_fn(env.step, (s, a, g), name=f"env:{name}",
                            device=dev))
    return out


def audit_all(include: Sequence[str] = ("kernels", "engine", "envs"),
              device=None) -> list:
    out: List = []
    if "kernels" in include:
        out.extend(audit_kernel_ops(device=device))
    if "engine" in include:
        out.extend(audit_engine_tiers(device=device))
    if "envs" in include:
        out.extend(audit_ocean_envs(device=device))
    return out
