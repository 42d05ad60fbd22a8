"""Env-conformance harness: the machine-checkable definition of "plays nice".

The counterpart of ``repro/envs/conformance.py``, for the port's batched envs
(``envs/base.py``: ``init(n, generator)``, ``reset(state, generator)``,
``step(state, action, generator)``, a leading env axis on everything). A
check steps one env as a batch of one unless it says otherwise:

  jit_purity        — restated: ``init``, ``reset`` and ``step`` make no
                      host sync (the reference traces them under jit and
                      reads the jaxpr for host callbacks; eager torch has
                      no trace, and what stalls a fused rollout here is the
                      host waiting for the card). On ``cuda`` the calls run
                      under ``torch.cuda.set_sync_debug_mode("error")``; on
                      every device under ``analysis.SyncDetector``, which
                      also names ``.item()``, ``.tolist()``, ``.numpy()``,
                      ``.cpu()``, ``np.asarray`` and boolean-mask indexing
                      on the CPU, where they dispatch no syncing op. The
                      first call of each runs outside the check: it builds
                      the env's per-device constants (one host-to-device
                      copy).
  vmap_purity       — restated: N envs stepped together are N envs stepped
                      alone. In one batched call, each env's outputs
                      depend on its own state row only: for every row i,
                      giving the other rows other states, with the
                      generator reseeded alike, leaves row i as it was;
                      and every output has the batch's leading dim.
  stability         — obs/reward/done/info shapes and dtypes are identical
                      at every step.
  determinism       — step is a pure function of (state, action, generator
                      state): same inputs ⇒ bitwise-identical outputs.
  emulation         — emulate∘unemulate is the identity on observations
                      (f32 and bytes modes) and actions.
  agent_axis        — multi-agent envs are agent-major: (n, num_agents, …)
                      obs and reward, and an episode-scoped (n,) done.
  autoreset         — under ``VecEnv`` episodes terminate within the
                      declared horizon, infos carry valid end-of-episode
                      rows, and stepping continues cleanly past resets.
  procgen_keys      — envs whose layout depends on the reset's generator
                      get fresh layouts across episodes.
  score_bounds      — episode scores are normalized to [0, 1] with exact
                      info dtypes.

A ``Key`` stands in for the reference's JAX key: a seed, a device and a path
of folds (``key.fold(i)``); ``key.gen()`` is a fresh generator seeded from
them, so "the same key" is "a generator in the same state".

Library API: ``check_env(env_or_name, device=...) -> ConformanceReport``,
``check_selfplay_env`` and ``check_host_env`` likewise; ``run_cli`` and
``main`` are the reference's CLI (``python -m repro_torch.envs.conformance
all --device cpu``), which ``launch/train.py --conformance`` runs. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import emulation as em
from repro_torch.core import spaces as sp
from repro_torch.core.vector import VecEnv


@dataclass
class CheckResult:
    name: str
    ok: bool
    violations: tuple = ()           # human-readable strings, empty when ok


@dataclass
class ConformanceReport:
    env_name: str
    results: list = field(default_factory=list)
    # informational cross-link to the zero-execution layer: the
    # repro_torch.analysis lint findings in the env's source (never affects
    # ``ok`` — the runtime checks are the verdict)
    static_findings: tuple = ()

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def violations(self) -> list:
        return [f"{r.name}: {v}" for r in self.results for v in r.violations]

    def summary(self) -> str:
        lines = [f"conformance report — {self.env_name}: "
                 f"{'OK' if self.ok else 'VIOLATIONS'}"]
        for r in self.results:
            lines.append(f"  [{'pass' if r.ok else 'FAIL'}] {r.name}")
            for v in r.violations:
                lines.append(f"         - {v}")
        if self.static_findings:
            lines.append(f"  static analysis (informational, "
                         f"{len(self.static_findings)} finding(s) — "
                         f"see `python -m repro_torch.analysis`):")
            for f in self.static_findings:
                lines.append(f"         - {f.render()}")
        return "\n".join(lines)

    __str__ = summary


# ---------------------------------------------------------------------------
# helpers

@dataclass(frozen=True)
class Key:
    """A seed, a device and a path of folds: ``fold(i)`` derives a key,
    ``gen()`` makes a fresh generator in the state the key names."""
    seed: int
    device: torch.device
    path: tuple = ()

    def fold(self, i: int) -> "Key":
        return Key(self.seed, self.device, self.path + (int(i),))

    def gen(self) -> torch.Generator:
        h = hashlib.blake2b(repr((self.seed,) + self.path).encode(),
                            digest_size=8).digest()
        return torch.Generator(device=self.device).manual_seed(
            int.from_bytes(h, "little") >> 1)


def _horizon(env) -> int:
    return int(getattr(env, "horizon", getattr(env, "length", 64)))


def _sample_action(env, key: Key, n: int = 1):
    """A random action for each of n envs (and each agent row)."""
    batch = (n, env.num_agents) if env.num_agents > 1 else (n,)
    return sp.sample(env.action_space, key.gen(), batch)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_sig(tree, path=""):
    """(path, shape, dtype) signature of a nested tree — the stability
    invariant."""
    if isinstance(tree, dict):
        return tuple(s for k in tree
                     for s in _tree_sig(tree[k], f"{path}[{k!r}]"))
    if isinstance(tree, (tuple, list)):
        return tuple(s for i, v in enumerate(tree)
                     for s in _tree_sig(v, f"{path}[{i}]"))
    t = torch.as_tensor(tree)
    return ((path, tuple(t.shape), str(t.dtype)),)


def _trees_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.as_tensor(x).shape == torch.as_tensor(y).shape
        and bool(torch.equal(torch.as_tensor(x), torch.as_tensor(y)))
        for x, y in zip(la, lb))


def _rows(tree, idx):
    if isinstance(tree, dict):
        return {k: _rows(v, idx) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rows(v, idx) for v in tree)
    return tree[idx]


def _splice(a, b, i: int, n: int):
    """Row i of ``a`` and the other rows of ``b`` (n rows each)."""
    if isinstance(a, dict):
        return {k: _splice(a[k], b[k], i, n) for k in a}
    return torch.cat([b[:i], a[i:i + 1], b[i + 1:n]])


# ---------------------------------------------------------------------------
# individual checks — each returns a list of violation strings

def check_jit_purity(env, key: Key) -> list:
    from repro_torch.analysis.dispatch_audit import SyncDetector
    out = []
    # the first calls build the env's per-device constants (a host-to-device
    # copy, once per device): outside the check
    try:
        s = env.init(1, key.gen())
        s, _ = env.reset(s, key.fold(1).gen())
        a = _sample_action(env, key.fold(2))
        env.step(s, a, key.fold(3).gen())
    except Exception as e:   # noqa: BLE001 — any failure is the finding
        return [f"init/reset/step failed: {type(e).__name__}: {e}"]
    g4, g5, g6 = (key.fold(i).gen() for i in (4, 5, 6))
    calls = (("init", lambda: env.init(1, g4)),
             ("reset", lambda: env.reset(s, g5)),
             ("step", lambda: env.step(s, a, g6)))
    for name, call in calls:
        det = SyncDetector(key.device)
        try:
            with det:
                call()
        except Exception as e:   # noqa: BLE001 — a sync raises on cuda
            out.append(f"{name} raised under the sync check (a host sync "
                       f"on the card?): {type(e).__name__}: {e}")
            continue
        if det.syncs or det.copies:
            out.append(f"{name} makes host syncs "
                       f"{sorted(set(det.syncs + det.copies))}; a fused "
                       f"rollout would wait for the card every step")
    return out


def check_vmap_purity(env, key: Key, batch: int = 4) -> list:
    try:
        s1 = env.init(batch, key.fold(200).gen())
        s2 = env.init(batch, key.fold(201).gen())
        acts = _sample_action(env, key.fold(202), batch)
        r1 = env.step(s1, acts, key.fold(203).gen())
        # env i's row, with every other row's state from s2
        rs = [env.step(_splice(s1, s2, i, batch), acts, key.fold(203).gen())
              for i in range(batch)]
    except Exception as e:   # noqa: BLE001
        return [f"env does not step as a batch: {type(e).__name__}: {e}"]
    out = []
    moved = [i for i, r in enumerate(rs)
             if not _trees_equal(_rows(r1, slice(i, i + 1)),
                                 _rows(r, slice(i, i + 1)))]
    if moved:
        out.append(f"the step outputs of envs {moved} changed with the other "
                   f"envs' states: the batch rows are coupled")
    lead = {tuple(x.shape[:1]) for x in _leaves(r1)}
    if lead != {(batch,)}:
        out.append(f"batched outputs' leading dims {sorted(lead)} != "
                   f"({batch},)")
    return out


def check_stability(env, key: Key) -> list:
    out = []
    s = env.init(1, key.gen())
    s, obs = env.reset(s, key.gen())
    state_sig, sig0 = _tree_sig(s), None
    for t in range(min(_horizon(env), 32)):
        s, obs, rew, done, info = env.step(
            s, _sample_action(env, key.fold(t)), key.fold(100 + t).gen())
        rew, done = torch.as_tensor(rew), torch.as_tensor(done)
        if _tree_sig(s) != state_sig:
            # eager torch does not retrace: the reference's jit would
            out.append(f"step {t} returned a state of another shape/dtype "
                       f"signature than the one it was given")
            break
        sig = (_tree_sig(obs), _tree_sig(s),
               (tuple(rew.shape), str(rew.dtype)),
               (tuple(done.shape), str(done.dtype)), _tree_sig(info))
        if sig0 is None:
            sig0 = sig
        elif sig != sig0:
            out.append(f"shape/dtype signature changed at step {t}")
            break
        if bool(done.any()):
            break
    if not rew.is_floating_point():
        out.append(f"reward dtype {rew.dtype} is not floating")
    if done.dtype != torch.bool:
        out.append(f"done dtype {done.dtype} != bool")
    if tuple(done.shape) != (1,):
        out.append(f"done must be episode-scoped, one flag an env: shape "
                   f"(1,) for one env, got {tuple(done.shape)}")
    for f in ("score", "episode_return", "episode_length", "valid"):
        if f not in info:
            out.append(f"info missing required field {f!r}")
    return out


def check_determinism(env, key: Key) -> list:
    s = env.init(1, key.gen())
    s, obs = env.reset(s, key.gen())
    a = _sample_action(env, key)
    r1 = env.step(s, a, key.fold(7).gen())
    r2 = env.step(s, a, key.fold(7).gen())
    if not _trees_equal(r1, r2):
        return ["step(state, action, generator) is not deterministic: "
                "identical inputs gave different outputs (host-side "
                "randomness?)"]
    if not _trees_equal(env.init(1, key.gen()), env.init(1, key.gen())):
        return ["init(n, generator) is not deterministic for a fixed "
                "generator state"]
    return []


def check_emulation(env, key: Key) -> list:
    out = []
    for mode in ("f32", "bytes"):
        try:
            spec = em.flat_spec(env.observation_space, mode)
            x = sp.sample(env.observation_space, key.gen())
            back = em.unemulate(spec, em.emulate(spec, x))
        except Exception as e:   # noqa: BLE001
            out.append(f"obs emulation ({mode}) failed: "
                       f"{type(e).__name__}: {e}")
            continue
        for p, _ in sp.leaves(env.observation_space):
            a = torch.as_tensor(sp.get_path(x, p))
            b = torch.as_tensor(sp.get_path(back, p))
            close = (torch.equal(a, b) if mode == "bytes" else
                     torch.allclose(a.float(), b.float(), rtol=1e-6))
            if not close:
                out.append(f"obs round-trip ({mode}) not identity at "
                           f"leaf {p}")
    try:
        aspec = em.action_spec(env.action_space)
        a = sp.sample(env.action_space, key.fold(1).gen())
        flat = em.emulate_action(aspec, a)
        flat2 = em.emulate_action(aspec, em.unemulate_action(aspec, flat))
        if not torch.allclose(flat.float(), flat2.float()):
            out.append("action round-trip emulate∘unemulate∘emulate is not "
                       "the identity")
    except Exception as e:   # noqa: BLE001
        out.append(f"action emulation failed: {type(e).__name__}: {e}")
    return out


def check_agent_axis(env, key: Key) -> list:
    A = env.num_agents
    if A == 1:
        return []
    out = []
    s = env.init(1, key.gen())
    s, obs = env.reset(s, key.gen())
    lead = tuple(_leaves(obs)[0].shape[:2])
    if lead != (1, A):
        out.append(f"reset obs leading dims {lead} != (1, num_agents {A}) "
                   f"(obs must be agent-major in canonical order)")
    s, obs, rew, done, info = env.step(s, _sample_action(env, key), key.gen())
    lead = tuple(_leaves(obs)[0].shape[:2])
    if lead != (1, A):
        out.append(f"step obs leading dims {lead} != (1, num_agents {A})")
    if tuple(torch.as_tensor(rew).shape) != (1, A):
        out.append(f"multi-agent reward shape "
                   f"{tuple(torch.as_tensor(rew).shape)} != (1, {A})")
    return out


def _random_vec_actions(vec: VecEnv, key: Key):
    """Uniform random batch of emulated actions for a VecEnv — each
    MultiDiscrete component drawn over its own [0, n) range."""
    return sp.sample(vec.single_action_space, key.gen(), (vec.batch_size,))


def check_autoreset(env, key: Key, num_envs: int = 4) -> list:
    out = []
    try:
        vec = VecEnv(em.Emulated(env), num_envs)
    except Exception as e:   # noqa: BLE001
        return [f"env does not wrap under Emulated+VecEnv: "
                f"{type(e).__name__}: {e}"]
    state, obs = vec.init(key.gen())
    H = _horizon(env)
    dones_seen = 0
    for t in range(2 * H + 2):
        k = key.fold(t)
        state, obs, rew, done, info = vec.step(
            state, _random_vec_actions(vec, k), k.gen())
        if not bool(torch.isfinite(obs.float()).all()):
            out.append(f"non-finite observation after autoreset at step {t}")
            break
        d = done.cpu().numpy()
        v = info["valid"].cpu().numpy()
        dones_seen += int(d.sum())
        # per-env info rows must fire exactly with that env's done
        env_done = d.reshape(vec.num_envs, vec.num_agents)[:, 0]
        if not np.array_equal(env_done, v):
            out.append(f"info['valid'] disagrees with done at step {t}: "
                       f"episode stats must fire exactly at episode end")
            break
        lens = info["episode_length"].cpu().numpy()[v]
        if (lens <= 0).any() or (lens > H).any():
            out.append(f"episode_length outside (0, horizon={H}] at "
                       f"step {t}: {lens}")
            break
    if dones_seen == 0:
        out.append(f"no episode terminated in {2 * H + 2} random steps "
                   f"(declared horizon {H})")
    return out


def check_procgen_keys(env, key: Key) -> list:
    """Layout must follow the generator. If ``init`` draws (a procgen env),
    ``reset`` — which the autoreset path calls with a generator that has
    moved on every episode — must draw too: resetting one state from the
    two generator states that made ``init`` differ must give different
    states. States, not observations, are compared."""
    kA, kB = key.fold(0), key.fold(1)
    if _trees_equal(env.init(1, kA.gen()), env.init(1, kB.gen())):
        return []                    # generator-independent init: static env
    s = env.init(1, key.gen())
    s, _ = env.reset(s, key.gen())
    rA, _ = env.reset(s, kA.gen())
    rB, _ = env.reset(s, kB.gen())
    if _trees_equal(rA, rB):
        return ["init depends on its generator but reset ignores its "
                "generator — the procgen draw is stale in the autoreset "
                "path, so every episode would replay the same layout"]
    rA2, _ = env.reset(s, kA.gen())
    if not _trees_equal(rA, rA2):
        return ["reset is not deterministic for a fixed generator state"]
    return []


def check_score_bounds(env, key: Key, episodes: int = 3) -> list:
    out = []
    H = _horizon(env)
    for e in range(episodes):
        s = env.init(1, key.fold(e).gen())
        s, obs = env.reset(s, key.fold(50 + e).gen())
        for t in range(10 * H):
            s, obs, rew, done, info = env.step(
                s, _sample_action(env, key.fold(e * 131 + t)),
                key.fold(e * 977 + t).gen())
            if not bool(torch.isfinite(torch.as_tensor(rew).float()).all()):
                out.append(f"non-finite reward at episode {e} step {t}")
                return out
            if bool(torch.as_tensor(done).any()):
                break
        else:
            out.append(f"episode {e} never terminated within 10×horizon")
            return out
        score = float(info["score"].reshape(-1)[0])
        if not (0.0 <= score <= 1.0):
            out.append(f"terminal score {score} outside [0, 1] — scores "
                       f"must be normalized so 0.9 means solved")
        if not bool(info["valid"].all()):
            out.append(f"info['valid'] false at episode end (episode {e})")
        if info["score"].dtype != torch.float32:
            out.append(f"info['score'] dtype {info['score'].dtype} "
                       f"!= float32")
        if info["episode_length"].dtype != torch.int32:
            out.append(f"info['episode_length'] dtype "
                       f"{info['episode_length'].dtype} != int32")
        length = int(info["episode_length"].reshape(-1)[0])
        if length != t + 1:
            out.append(f"episode_length {length} != actual steps {t + 1}")
    return out


# ---------------------------------------------------------------------------

CHECKS = {
    "jit_purity": check_jit_purity,
    "vmap_purity": check_vmap_purity,
    "stability": check_stability,
    "determinism": check_determinism,
    "emulation": check_emulation,
    "agent_axis": check_agent_axis,
    "autoreset": check_autoreset,
    "procgen_keys": check_procgen_keys,
    "score_bounds": check_score_bounds,
}


def _resolve_env(env_or_name):
    if isinstance(env_or_name, str):
        from repro_torch.envs.ocean import OCEAN
        return env_or_name, OCEAN[env_or_name]()
    return type(env_or_name).__name__, env_or_name


def _run(report, table, checks, *args) -> ConformanceReport:
    for cname in (checks or table):
        try:
            violations = table[cname](*args)
        except Exception as e:   # noqa: BLE001 — report, don't crash
            violations = [f"check raised {type(e).__name__}: {e}"]
        report.results.append(
            CheckResult(cname, not violations, tuple(violations)))
    return report


def check_env(env_or_name, *, seed: int = 0, checks: Optional[list] = None,
              device=None) -> ConformanceReport:
    """Run the conformance suite against an env instance or registry name on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    Returns a ``ConformanceReport``; ``report.ok`` is the machine-checkable
    "plays nice" verdict, ``report.summary()`` the human one. A check that
    raises is recorded as a violation, never as a crash — one broken
    invariant must not mask the others.
    """
    from repro_torch.device import resolve
    name, env = _resolve_env(env_or_name)
    report = _run(ConformanceReport(env_name=name), CHECKS, checks, env,
                  Key(seed, resolve(device)))
    report.static_findings = _static_findings(type(env))
    return report


def _static_findings(cls) -> tuple:
    """Lint the env class's source with ``repro_torch.analysis``, its own
    ``init``, ``reset`` and ``step`` as the hot steps, and keep the findings
    inside the class body — the static half of the report."""
    import inspect
    try:
        from repro_torch.analysis.lint import check_source
        path = inspect.getsourcefile(cls)
        body, start = inspect.getsourcelines(cls)
        with open(path) as f:
            src = f.read()
    except (TypeError, OSError, ImportError):   # builtins, REPL classes, …
        return ()
    hot = {f"{cls.__qualname__}.{m}" for m in ("init", "reset", "step")
           if m in vars(cls)}
    return tuple(f for f in check_source(src, path, hot=hot)
                 if start <= f.line < start + len(body))


# ---------------------------------------------------------------------------
# host profile — the "plays nice" contract for bridged host envs
#
# A bridged env's state lives in Python, but the protocol the training stack
# consumes — stable flat f32 observation batches, autoreset with valid ==
# done episode stats, seeded determinism — is just as checkable.
# ``check_host_env`` runs these against a *factory* of synchronous
# (num_envs == batch_size) ``bridge.HostVecEnv`` instances: sync mode makes
# row layout deterministic, which the determinism check needs.

def _random_host_actions(venv, rng):
    space = venv.action_space
    if isinstance(space, sp.MultiDiscrete):
        return np.stack([rng.integers(0, n, venv.batch_size)
                         for n in space.nvec], axis=-1).astype(np.int32)
    return rng.uniform(-1.0, 1.0,
                       (venv.batch_size,) + space.shape).astype(np.float32)


def _host_horizon(venv) -> int:
    return int(venv.horizon or 64)


_INFO_DTYPES = {"score": np.float32, "episode_return": np.float32,
                "episode_length": np.int32, "valid": np.bool_}


def check_host_protocol(factory, seed) -> list:
    out = []
    v = factory()
    try:
        if v.num_envs != v.batch_envs:
            out.append(f"host profile needs a sync wrapper (num_envs="
                       f"{v.num_envs} != batch_size={v.batch_envs}); build "
                       f"the factory with bridge.wrap(fn, num_envs=N)")
        obs = v.reset(timeout=30.0)
        if obs.shape != (v.batch_size, v.obs_dim):
            out.append(f"reset obs shape {obs.shape} != "
                       f"{(v.batch_size, v.obs_dim)}")
        if obs.dtype != np.float32:
            out.append(f"reset obs dtype {obs.dtype} != float32 (the bridge "
                       f"packs model-facing f32)")
        if not isinstance(v.action_space, (sp.MultiDiscrete, sp.Box)):
            out.append(f"emulated action space {v.action_space} is neither "
                       f"MultiDiscrete nor Box")
    finally:
        v.close()
    return out


def check_host_stability(factory, seed) -> list:
    out = []
    v = factory()
    rng = np.random.default_rng(seed)
    try:
        v.reset(timeout=30.0)
        sig0 = None
        for t in range(min(2 * _host_horizon(v) + 2, 64)):
            obs, rew, done, info = v.step(_random_host_actions(v, rng),
                                          timeout=30.0)
            sig = (obs.shape, str(obs.dtype), rew.shape, str(rew.dtype),
                   done.shape, str(done.dtype),
                   tuple(sorted((k, x.shape, str(x.dtype))
                                for k, x in info.items())))
            if sig0 is None:
                sig0 = sig
            elif sig != sig0:
                out.append(f"shape/dtype signature changed at step {t}")
                break
            if not np.all(np.isfinite(obs)):
                out.append(f"non-finite observation at step {t}")
                break
            for k, dt in _INFO_DTYPES.items():
                if k not in info:
                    out.append(f"info missing required field {k!r}")
                    return out
                if info[k].dtype != dt:
                    out.append(f"info[{k!r}] dtype {info[k].dtype} != "
                               f"{np.dtype(dt)}")
                    return out
            env_done = done.reshape(v.batch_envs, v.num_agents)[:, 0]
            if not np.array_equal(env_done, info["valid"]):
                out.append(f"info['valid'] disagrees with done at step {t}: "
                           f"episode stats must fire exactly at episode end")
                break
    finally:
        v.close()
    return out


def check_host_autoreset(factory, seed) -> list:
    out = []
    v = factory()
    rng = np.random.default_rng(seed)
    try:
        H = _host_horizon(v)
        v.reset(timeout=30.0)
        dones_seen = 0
        for t in range(2 * H + 2):
            _obs, _rew, done, info = v.step(_random_host_actions(v, rng),
                                            timeout=30.0)
            dones_seen += int(np.asarray(done).sum())
            lens = np.asarray(info["episode_length"])[info["valid"]]
            if len(lens) and ((lens <= 0).any() or (lens > H).any()):
                out.append(f"episode_length outside (0, horizon={H}] at "
                           f"step {t}: {lens}")
                break
            scores = np.asarray(info["score"])[info["valid"]]
            if len(scores) and not np.all((scores >= 0.0) & (scores <= 1.0)):
                out.append(f"terminal score outside [0, 1] at step {t}: "
                           f"{scores}")
                break
        if dones_seen == 0:
            out.append(f"no episode terminated in {2 * H + 2} steps "
                       f"(declared horizon {H}); autoreset unverifiable")
    finally:
        v.close()
    return out


def check_host_determinism(factory, seed) -> list:
    """Two same-seed instances fed the same actions must produce identical
    streams across at least one autoreset boundary — what the per-env seed
    sequence in ``HostPool`` guarantees."""
    va, vb = factory(), factory()
    try:
        steps = min(2 * _host_horizon(va) + 2, 80)
        rng = np.random.default_rng(seed)
        acts = [_random_host_actions(va, rng) for _ in range(steps)]
        oa = [va.reset(timeout=30.0)]
        ob = [vb.reset(timeout=30.0)]
        ra, rb = [], []
        for t in range(steps):
            o, r, _d, _i = va.step(acts[t], timeout=30.0)
            oa.append(o)
            ra.append(r)
            o, r, _d, _i = vb.step(acts[t], timeout=30.0)
            ob.append(o)
            rb.append(r)
        for t, (a, b) in enumerate(zip(oa, ob)):
            if not np.array_equal(a, b):
                return [f"same-seed instances diverged in obs at step {t} "
                        f"(autoreset seeding or hidden host randomness?)"]
        for t, (a, b) in enumerate(zip(ra, rb)):
            if not np.array_equal(a, b):
                return [f"same-seed instances diverged in reward at step "
                        f"{t}"]
    finally:
        va.close()
        vb.close()
    return []


HOST_CHECKS = {
    "host_protocol": check_host_protocol,
    "host_stability": check_host_stability,
    "host_autoreset": check_host_autoreset,
    "host_determinism": check_host_determinism,
}


# ---------------------------------------------------------------------------
# selfplay profile — the contract competitive (league) envs add on top of
# the base profile: zero-sum rewards at every step, roles symmetric under
# the env-declared agent-row permutation (``swap_agents``), and one
# episode-scoped done per match.

def _rollout_states(env, key: Key, steps):
    """(state, action, key) triples along a one-env random rollout with
    resets."""
    s = env.init(1, key.gen())
    s, _ = env.reset(s, key.gen())
    for t in range(steps):
        a = _sample_action(env, key.fold(t))
        kt = key.fold(1000 + t)
        yield s, a, kt
        s, _obs, _rew, done, _info = env.step(s, a, kt.gen())
        if bool(torch.as_tensor(done).any()):
            s, _ = env.reset(s, key.fold(2000 + t).gen())


def check_zero_sum(env, key: Key) -> list:
    if env.num_agents < 2:
        return [f"selfplay profile needs a multi-agent env "
                f"(num_agents={env.num_agents})"]
    steps = min(2 * _horizon(env) + 2, 80)   # spans >= 1 episode boundary
    for t, (s, a, kt) in enumerate(_rollout_states(env, key, steps)):
        _s2, _obs, rew, _done, _info = env.step(s, a, kt.gen())
        tot = float(torch.as_tensor(rew).sum())
        if abs(tot) > 1e-5:
            return [f"reward vector sums to {tot:+.6f} at step {t} "
                    f"(rewards {rew.cpu().numpy()}); a competitive env must "
                    f"be zero-sum at every step"]
    return []


def check_role_swap(env, key: Key, steps: int = 0) -> list:
    """Stepping the agent-row-reversed state with reversed actions must give
    the reversed outputs: obs/reward rows reversed, same done, and the next
    state equal to ``swap_agents`` of the unswapped next state. The env
    declares the permutation via ``swap_agents(state)``."""
    if not hasattr(env, "swap_agents"):
        return ["competitive envs must expose swap_agents(state) — the "
                "agent-row permutation the role-swap symmetry is checked "
                "under"]

    def rev(x):      # the agent axis is dim 1 of (n, A, …)
        if isinstance(x, dict):
            return {k: rev(v) for k, v in x.items()}
        return x.flip(1)

    out = []
    steps = steps or min(2 * _horizon(env) + 2, 80)
    for t, (s, a, kt) in enumerate(_rollout_states(env, key, steps)):
        s2, obs, rew, done, info = env.step(s, a, kt.gen())
        s2w, obsw, reww, donew, infow = env.step(env.swap_agents(s), rev(a),
                                                 kt.gen())
        if not _trees_equal(obsw, rev(obs)):
            out.append(f"swapped-role obs is not the row-reversed obs at "
                       f"step {t}")
        if not bool(((reww - rew.flip(1)).abs() < 1e-6).all()):
            out.append(f"swapped-role reward is not the row-reversed "
                       f"reward at step {t}: {reww.cpu().numpy()} vs "
                       f"{rew.flip(1).cpu().numpy()}")
        if not torch.equal(donew, done):
            out.append(f"swapped-role done disagrees at step {t}")
        if not _trees_equal(s2w, env.swap_agents(s2)):
            out.append(f"swapped-role next state != swap_agents(next "
                       f"state) at step {t}")
        if out:
            return out
        # side-0-centric score must mirror at episode end
        if bool(done.any()):
            sc, scw = float(info["score"][0]), float(infow["score"][0])
            if abs((1.0 - sc) - scw) > 1e-5:
                return [f"score is not side-0-centric: swap gives "
                        f"{scw:.6f}, expected 1 - {sc:.6f} (the arena "
                        f"reads score > 0.5 as a side-A win)"]
    return []


def check_team_done(env, key: Key, episodes: int = 2) -> list:
    """One match, one outcome: done is one episode-scoped flag an env,
    shared by every agent row, and the terminal info row fires exactly once
    per episode."""
    out = []
    H = _horizon(env)
    for e in range(episodes):
        s = env.init(1, key.fold(e).gen())
        s, _ = env.reset(s, key.fold(50 + e).gen())
        ends = 0
        for t in range(2 * H):
            a = _sample_action(env, key.fold(e * 71 + t))
            s, _obs, rew, done, info = env.step(s, a,
                                                key.fold(e * 113 + t).gen())
            if tuple(done.shape) != (1,):
                return [f"done shape {tuple(done.shape)} is per-agent; all "
                        f"rows of a match must terminate together "
                        f"(episode-scoped scalar done, (n,) for n envs)"]
            if tuple(rew.shape) != (1, env.num_agents):
                return [f"reward shape {tuple(rew.shape)} != "
                        f"(1, {env.num_agents}): every agent row needs its "
                        f"side of the zero-sum transfer"]
            ends += int(bool(info["valid"].any()))
            if bool(done.any()):
                break
        else:
            out.append(f"episode {e} never terminated within 2×horizon")
            continue
        if ends != 1:
            out.append(f"episode {e}: terminal info fired {ends} times "
                       f"(must fire exactly once, at the shared episode "
                       f"end)")
    return out


SELFPLAY_CHECKS = {
    "zero_sum": check_zero_sum,
    "role_swap": check_role_swap,
    "team_done": check_team_done,
}


def check_selfplay_env(env_or_name, *, seed: int = 0,
                       checks: Optional[list] = None,
                       device=None) -> ConformanceReport:
    """Run the selfplay (competitive-env) profile — zero-sum rewards,
    role-swap symmetry under agent-row permutation, and team-consistent
    termination — against an env instance or OCEAN registry name. Same
    report semantics as ``check_env``; league workloads should pass both
    profiles."""
    from repro_torch.device import resolve
    name, env = _resolve_env(env_or_name)
    return _run(ConformanceReport(env_name=f"selfplay/{name}"),
                SELFPLAY_CHECKS, checks, env, Key(seed, resolve(device)))


def check_host_env(factory, *, name: str = None,
                   seed: int = 0, checks: Optional[list] = None
                   ) -> ConformanceReport:
    """Run the host-profile conformance suite.

    ``factory`` builds a fresh **synchronous** ``bridge.HostVecEnv`` per
    call, e.g. ``lambda: bridge.wrap(MyEnv, num_envs=2)``. Same report
    semantics as ``check_env``: a check that raises is a violation, never a
    crash. Host envs live in numpy: no device."""
    return _run(ConformanceReport(env_name=name or "host_env"), HOST_CHECKS,
                checks, factory, seed)


def _names(env_arg: str, registry) -> list:
    return list(registry) if env_arg == "all" \
        else [n.strip() for n in env_arg.split(",")]


def run_cli(env_arg: str, seed: int = 0, host: bool = False,
            selfplay: bool = False, host_backend: str = "thread",
            device=None) -> int:
    """Check 'all' or a comma-separated name list against the registry,
    print each report, return a process exit code (1 on any violation).
    Shared by this module's ``main`` and ``launch.train --conformance``.
    With ``host=True`` the names come from the ``OCEAN_HOST`` mirror
    registry and run the host profile through ``bridge.wrap`` on the given
    ``host_backend`` ("thread" | "proc"); with ``selfplay=True`` the
    competitive-env profile runs instead of the base one. ``device``: where
    the base and selfplay profiles step the envs (``cuda`` by default)."""
    reports = []
    if host:
        from repro_torch.bridge import wrap
        from repro_torch.envs.ocean_host import OCEAN_HOST
        for name in _names(env_arg, OCEAN_HOST):
            cls = OCEAN_HOST[name]
            reports.append(check_host_env(
                lambda cls=cls: wrap(cls, num_envs=2, seed=seed,
                                     backend=host_backend),
                name=f"host/{name}[{host_backend}]", seed=seed))
            print(reports[-1].summary(), flush=True)
    else:
        from repro_torch.envs.ocean import OCEAN
        check = check_selfplay_env if selfplay else check_env
        for name in _names(env_arg, OCEAN):
            reports.append(check(name, seed=seed, device=device))
            print(reports[-1].summary(), flush=True)
    return 1 if any(not r.ok for r in reports) else 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Run the env-conformance suite (see envs/conformance.py)")
    ap.add_argument("env", help="OCEAN registry name(s, comma-separated), "
                                "or 'all'")
    ap.add_argument("--host", action="store_true",
                    help="run the host profile over the OCEAN_HOST mirror "
                         "registry (bridge-wrapped) instead of the batched "
                         "suite")
    ap.add_argument("--selfplay", action="store_true",
                    help="run the competitive-env (league) profile: "
                         "zero-sum, role-swap symmetry, team done")
    ap.add_argument("--host-backend", default="thread",
                    choices=("thread", "proc"),
                    help="worker backend for the host profile (the contract "
                         "must hold under both)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return run_cli(args.env, seed=args.seed, host=args.host,
                   selfplay=args.selfplay, host_backend=args.host_backend,
                   device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
