"""HostBridge adapters: any third-party host env → the HostPool protocol.

The paper's one-line-wrapper claim is that envs written for *other* stacks
(Gymnasium, PettingZoo, or nothing at all) train unchanged. This module is
the normalization layer that makes it true for host (stateful Python) envs:

  * ``detect_api`` duck-types the env into one of three styles —
    ``"gymnasium"`` (``reset(seed=) -> (obs, info)``, 5-tuple ``step``),
    ``"pettingzoo"`` (parallel API: ``possible_agents`` + per-agent dicts),
    ``"duck"`` (``reset(seed) -> obs``, 4-tuple ``step``) — without
    importing any of those libraries.
  * ``convert_space`` maps foreign space objects (again by duck-typing:
    ``.nvec`` / ``.n`` / ``.spaces`` / ``.shape``) onto
    ``repro_torch.core.spaces`` trees, so the emulation specs come from the
    same ``core/emuspec`` machinery the device envs use.
  * ``np_emulate_obs`` / ``np_unemulate_action`` are numpy twins of
    ``emulation.emulate`` / ``unemulate_action`` driven by the *same*
    ``FlatSpec`` / ``ActionSpec`` layouts — packing happens on the worker
    (thread or process), off the device, but byte-for-byte where the model
    expects it. ``np_unemulate_bytes`` is the numpy twin of a bytes-mode
    ``emulation.unemulate``: the host tier cuts the act step's packed
    transfer with it.
  * the three ``*Adapter`` classes present every style as the minimal host
    protocol ``core/host.py`` speaks: ``reset(seed) -> obs`` and
    ``step(flat_action) -> (obs, rew, done, info)`` with flat f32
    observations and flat emulated actions.
  * ``AdapterFactory`` is the picklable form of "build env, wrap in
    adapter" that the ``backend="proc"`` shared-memory workers unpickle.

The counterpart of ``repro/bridge/adapters.py``. This module must stay
importable without torch (it runs inside spawn workers), which is why it
consumes the specs from ``core.emuspec`` — the numpy-only half of the
emulation machinery.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np

from repro_torch.core import emuspec as em
from repro_torch.core import spaces as sp

APIS = ("gymnasium", "pettingzoo", "duck")


# ---------------------------------------------------------------------------
# space conversion (duck-typed: no gymnasium/pettingzoo import)

def convert_space(space) -> sp.Space:
    """Foreign (Gymnasium-like) space → ``repro_torch.core.spaces`` tree.

    Detection is structural: ``.nvec`` ⇒ MultiDiscrete, ``.n`` ⇒ Discrete
    (``MultiBinary`` by class name, since it also has ``.n``), ``.spaces``
    mapping/sequence ⇒ Dict/Tuple, ``.shape``+``.dtype`` ⇒ Box."""
    if isinstance(space, sp.Space):
        return space
    if type(space).__name__ == "MultiBinary":
        n = int(np.prod(np.asarray(space.n)))
        return sp.MultiDiscrete((2,) * n)
    nvec = getattr(space, "nvec", None)
    if nvec is not None:
        return sp.MultiDiscrete(tuple(int(v)
                                      for v in np.asarray(nvec).reshape(-1)))
    n = getattr(space, "n", None)
    if n is not None:
        return sp.Discrete(int(n))
    sub = getattr(space, "spaces", None)
    if sub is not None:
        if isinstance(sub, Mapping) or hasattr(sub, "items"):
            return sp.Dict({str(k): convert_space(v) for k, v in sub.items()})
        return sp.Tuple([convert_space(s) for s in sub])
    shape = getattr(space, "shape", None)
    if shape is not None:
        dtype = np.dtype(getattr(space, "dtype", None) or np.float32)
        low = np.min(np.asarray(getattr(space, "low", -np.inf)))
        high = np.max(np.asarray(getattr(space, "high", np.inf)))
        return sp.Box(tuple(int(s) for s in shape), dtype,
                      low=float(low), high=float(high))
    raise TypeError(f"cannot convert space {space!r} (type {type(space)}) "
                    f"to a repro_torch.core.spaces tree")


# ---------------------------------------------------------------------------
# numpy emulation twins (same FlatSpec/ActionSpec layouts as core/emulation)

def np_emulate_obs(spec: em.FlatSpec, tree) -> np.ndarray:
    """Pack one unbatched obs tree into the flat f32 buffer ``spec``
    describes — the host-side twin of ``emulation.emulate``."""
    assert spec.mode == "f32", "host bridge packs model-facing f32 obs"
    out = np.empty((spec.total,), np.float32)
    for ls in spec.leaf_specs:
        x = np.asarray(sp.get_path(tree, ls.path), dtype=np.float32)
        out[ls.offset:ls.offset + ls.size] = x.reshape(-1)
    return out


def np_unemulate_action(spec: em.ActionSpec, flat) -> Any:
    """Flat emulated action row → env-native action tree (numpy / python
    scalars) — the host-side twin of ``emulation.unemulate_action``.
    Discrete leaves come back as python ints (what Gymnasium envs expect)."""
    flat = np.asarray(flat).reshape(-1)
    tree = _np_zeros_tree(spec.space)
    for ls in spec.leaf_specs:
        chunk = flat[ls.offset:ls.offset + ls.size]
        if spec.kind == "discrete" and ls.shape == ():
            leaf: Any = int(chunk[0])
        else:
            leaf = chunk.astype(np.dtype(ls.dtype)).reshape(ls.shape)
        tree = sp.set_path(tree, ls.path, leaf)
    return tree


def np_unemulate_bytes(spec: em.FlatSpec, flat: np.ndarray):
    """(…, spec.total) uint8 rows → the tree ``spec`` describes, each leaf
    (…, *shape) — the numpy twin of a bytes-mode ``emulation.unemulate``.
    Leaves are bitcast back with ``ndarray.view`` (bool: ``!= 0``), never
    cast, and own their memory: ``flat`` may be overwritten afterwards."""
    assert spec.mode == "bytes", "np_unemulate_bytes takes a bytes FlatSpec"
    flat = np.asarray(flat)
    if flat.dtype != np.uint8 or flat.shape[-1] != spec.total:
        raise ValueError(f"expected (..., {spec.total}) uint8 rows, got "
                         f"{flat.shape} {flat.dtype}")
    batch = flat.shape[:-1]
    tree = _np_zeros_tree(spec.space)
    for ls in spec.leaf_specs:
        chunk = flat[..., ls.offset:ls.offset + ls.size]
        if ls.dtype == np.bool_:
            leaf = chunk != 0
        else:
            leaf = np.array(chunk).view(ls.dtype)
        tree = sp.set_path(tree, ls.path, leaf.reshape(batch + ls.shape))
    return tree


def _np_zeros_tree(space: sp.Space):
    if isinstance(space, sp.Dict):
        return {k: _np_zeros_tree(s) for k, s in space.items()}
    if isinstance(space, sp.Tuple):
        return tuple(_np_zeros_tree(s) for s in space.spaces)
    return None                                 # leaf — filled by set_path


# ---------------------------------------------------------------------------
# API detection

def detect_api(env) -> str:
    """Which of the three host-env styles ``env`` speaks.

    PettingZoo-parallel is structural (``possible_agents``); Gymnasium vs
    duck is probed with one ``reset`` call — a keyword ``seed`` plus an
    ``(obs, info)`` 2-tuple return is the Gymnasium signature. The probe env
    is reset again by the pool before use, so the call is side-effect-free
    for training. Pass ``api=`` to ``wrap`` to skip the probe."""
    if hasattr(env, "possible_agents"):
        return "pettingzoo"
    try:
        out = env.reset(seed=0)
    except TypeError:
        return "duck"
    if (isinstance(out, tuple) and len(out) == 2
            and isinstance(out[1], dict)):
        return "gymnasium"
    return "duck"


def _pz_agent_space(env, name: str, agent):
    """PettingZoo space lookup across API generations: method
    ``observation_space(agent)`` (modern) or ``observation_spaces`` dict."""
    attr = getattr(env, name, None)
    if callable(attr):
        return attr(agent)
    maps = getattr(env, name + "s", None)
    if maps is not None:
        return maps[agent]
    raise TypeError(f"pettingzoo env exposes neither {name}(agent) nor "
                    f"{name}s")


def spaces_of(env, api: str):
    """(observation_space, action_space) as repro space trees. For
    pettingzoo-parallel envs the per-agent spaces must be homogeneous (the
    paper's fixed-size batching needs one layout for every agent row)."""
    if api != "pettingzoo":
        return (convert_space(env.observation_space),
                convert_space(env.action_space))
    agents = list(env.possible_agents)
    obs = [convert_space(_pz_agent_space(env, "observation_space", a))
           for a in agents]
    act = [convert_space(_pz_agent_space(env, "action_space", a))
           for a in agents]
    if any(o != obs[0] for o in obs) or any(a != act[0] for a in act):
        raise ValueError(
            "bridge.wrap requires homogeneous per-agent spaces on "
            "pettingzoo-parallel envs (heterogeneous agents would need "
            "per-agent emulation specs)")
    return obs[0], act[0]


# ---------------------------------------------------------------------------
# adapters: each presents `reset(seed) -> obs` / `step(a) -> (o, r, d, info)`

class DuckAdapter:
    """``reset(seed) -> obs``, ``step(a) -> (obs, rew, done, info)``."""

    api = "duck"

    def __init__(self, env, obs_spec: em.FlatSpec, act_spec: em.ActionSpec):
        self.env, self.obs_spec, self.act_spec = env, obs_spec, act_spec

    def reset(self, seed: int):
        return np_emulate_obs(self.obs_spec, self.env.reset(seed))

    def step(self, flat_action):
        a = np_unemulate_action(self.act_spec, flat_action)
        obs, rew, done, info = self.env.step(a)
        return (np_emulate_obs(self.obs_spec, obs), float(rew), bool(done),
                info if isinstance(info, dict) else {})


class GymnasiumAdapter:
    """Gymnasium API: ``reset(seed=) -> (obs, info)``,
    ``step(a) -> (obs, rew, terminated, truncated, info)``."""

    api = "gymnasium"

    def __init__(self, env, obs_spec: em.FlatSpec, act_spec: em.ActionSpec):
        self.env, self.obs_spec, self.act_spec = env, obs_spec, act_spec

    def reset(self, seed: int):
        obs, _info = self.env.reset(seed=int(seed))
        return np_emulate_obs(self.obs_spec, obs)

    def step(self, flat_action):
        a = np_unemulate_action(self.act_spec, flat_action)
        obs, rew, terminated, truncated, info = self.env.step(a)
        done = bool(terminated) or bool(truncated)
        return (np_emulate_obs(self.obs_spec, obs), float(rew), done,
                info if isinstance(info, dict) else {})


class PettingZooAdapter:
    """PettingZoo parallel API, flattened agent-major: observations are
    stacked per-agent rows in ``possible_agents`` (canonical) order, padded
    to ``num_agents`` with zero rows (the host twin of
    ``emulation.pad_agents``); rewards follow the same layout; ``done`` is
    episode-scoped (all agents terminated/truncated)."""

    api = "pettingzoo"

    def __init__(self, env, obs_spec: em.FlatSpec, act_spec: em.ActionSpec,
                 num_agents: int = None):
        self.env, self.obs_spec, self.act_spec = env, obs_spec, act_spec
        self.order = list(env.possible_agents)
        self.num_agents = num_agents or len(self.order)
        assert self.num_agents >= len(self.order)

    def _rows(self, obs_dict):
        rows = np.zeros((self.num_agents, self.obs_spec.total), np.float32)
        for j, ag in enumerate(self.order):
            if ag in obs_dict:
                rows[j] = np_emulate_obs(self.obs_spec, obs_dict[ag])
        return rows

    def reset(self, seed: int):
        obs, _infos = self.env.reset(seed=int(seed))
        return self._rows(obs)

    def step(self, flat_actions):
        flat_actions = np.asarray(flat_actions)
        live = getattr(self.env, "agents", None) or self.order
        acts = {ag: np_unemulate_action(self.act_spec, flat_actions[j])
                for j, ag in enumerate(self.order) if ag in live}
        obs, rew, term, trunc, infos = self.env.step(acts)
        rew_rows = np.zeros((self.num_agents,), np.float32)
        for j, ag in enumerate(self.order):
            rew_rows[j] = float(rew.get(ag, 0.0))
        done = all(bool(term.get(ag, True)) or bool(trunc.get(ag, True))
                   for ag in self.order)
        info: dict = {}
        scores = [i["score"] for i in infos.values()
                  if isinstance(i, dict) and "score" in i]
        if scores:
            info["score"] = float(np.mean(scores))
        return self._rows(obs), rew_rows, done, info


ADAPTERS = {
    "duck": DuckAdapter,
    "gymnasium": GymnasiumAdapter,
    "pettingzoo": PettingZooAdapter,
}


class AdapterFactory:
    """Picklable "build env, wrap in the right adapter" closure substitute.

    The proc backend ships env factories into spawn workers with plain
    pickle, so they cannot be lambdas/closures. This object carries the api
    *name* plus the (picklable) emulation specs and the user's env factory;
    calling it inside the worker constructs the env and wraps it. Also works
    under ``backend="thread"``, where picklability is simply unused."""

    def __init__(self, api: str, env_fn: Callable, obs_spec: em.FlatSpec,
                 act_spec: em.ActionSpec, num_agents: Optional[int] = None):
        assert api in ADAPTERS, api
        self.api = api
        self.env_fn = env_fn
        self.obs_spec = obs_spec
        self.act_spec = act_spec
        self.num_agents = num_agents

    def __call__(self):
        kw = {} if self.num_agents is None else {"num_agents":
                                                 self.num_agents}
        return ADAPTERS[self.api](self.env_fn(), self.obs_spec,
                                  self.act_spec, **kw)
