"""HostVecEnv — the VecEnv protocol over bridged host environments.

``wrap(env_fn)`` is the one-liner: auto-detect the env's API, derive the
emulation specs from ``core/emuspec``, and return a ``HostVecEnv`` whose
batches look exactly like the device ``VecEnv``'s — flat f32 observations
of stable shape, flat emulated actions, autoreset with ``valid == done``
episode stats — so the policy, the learner and the conformance harness
never notice the env lives on the host. The counterpart of ``repro/bridge/vecenv.py``.

Two usage modes, mirroring ``core/pool.py`` vs ``core/vector.py``:

  * async (num_envs > batch_size): ``recv()/send()`` over the first-finisher
    ``HostPool`` — M = 2N double-buffers env stepping against device compute
    (the paper's EnvPool, §3.3). This is what the TrainEngine ``host`` tier
    drives.
  * sync (num_envs == batch_size): deterministic wait-for-all rows, the
    Gymnasium/SB3 baseline; ``reset()``/``step()`` convenience methods give
    the classic loop for tests and the conformance host profile.

The module imports no torch: ``make_host_engine`` imports the engine where
it runs.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.bridge import adapters as ad
from repro_torch.configs.base import TrainConfig
from repro_torch.core import emuspec as em
from repro_torch.core import shm as _shm
from repro_torch.core import spaces as sp
from repro_torch.core.host import HostPool, _UNSET


class HostVecEnv:
    """N-of-M first-finisher batches of bridged host envs.

    Shapes (``A = num_agents``, rows agent-major like ``VecEnv``):
      recv obs  (batch_size, obs_dim) f32   batch_size = batch_envs * A
      recv rew  (batch_size,) f32
      recv done (batch_size,) bool          broadcast per env
      recv info {score, episode_return, episode_length, valid} (batch_envs,)
      env_ids   (batch_envs,)               which envs these rows belong to
    """

    def __init__(self, env_fns: Sequence[Callable], batch_size: int,
                 *, seed: int = 0, obs_spec: em.FlatSpec,
                 act_spec: em.ActionSpec, single_observation_space: sp.Space,
                 single_action_space: sp.Space, num_agents: int = 1,
                 recv_timeout: Optional[float] = None,
                 backend: str = "thread",
                 spin: Optional["_shm.SpinConfig"] = None,
                 horizon: Optional[int] = None):
        self.num_envs = len(env_fns)            # M simulated envs
        self.batch_envs = int(batch_size)       # N envs per batch
        self.num_agents = int(num_agents)
        self.batch_size = self.batch_envs * self.num_agents
        self.obs_spec, self.act_spec = obs_spec, act_spec
        self.obs_dim = obs_spec.total
        self.single_observation_space = single_observation_space
        self.single_action_space = single_action_space
        # emulated (Atari-shaped) spaces, like Emulated.observation_space
        self.observation_space = sp.Box((obs_spec.total,), np.float32)
        self.action_space = (sp.MultiDiscrete(act_spec.nvec)
                             if act_spec.kind == "discrete"
                             else sp.Box((act_spec.cont_dim,)))
        self.backend = backend
        self.horizon = horizon
        A = self.num_agents
        # per-env slab rows, sized from the emulation specs (used by the
        # proc backend; harmless metadata under threads)
        self.slab = _shm.SlabSpec(
            obs_shape=(A, obs_spec.total) if A > 1 else (obs_spec.total,),
            act_shape=((A, act_spec.num_components) if A > 1
                       else (act_spec.num_components,)),
            act_dtype=("int32" if act_spec.kind == "discrete"
                       else "float32"),
            rew_shape=(A,) if A > 1 else ())
        self.pool = HostPool(env_fns, batch_size=self.batch_envs, seed=seed,
                             recv_timeout=recv_timeout, backend=backend,
                             rew_shape=self.slab.rew_shape, slab=self.slab,
                             spin=spin)
        self._ids = None

    @property
    def is_sync(self) -> bool:
        return self.num_envs == self.batch_envs

    # -- async protocol (what the engine's host tier drives) -----------------
    def recv(self, timeout=_UNSET):
        """Defaults to the pool's ``recv_timeout``; ``timeout=None`` is an
        explicit wait-forever opt-in (a hung env then deadlocks the loop —
        prefer a finite timeout, which raises ``TimeoutError``)."""
        obs, rew, done, info, ids = self.pool.recv(timeout=timeout)
        A = self.num_agents
        obs = np.asarray(obs, np.float32).reshape(len(ids) * A, self.obs_dim)
        if A > 1:
            rew = np.broadcast_to(
                np.asarray(rew, np.float32).reshape(len(ids), -1),
                (len(ids), A)).reshape(len(ids) * A)
            done = np.repeat(done, A)
        return obs, rew, done, info, ids

    def send(self, actions, env_ids):
        actions = np.asarray(actions)
        if self.num_agents > 1:
            actions = actions.reshape((len(env_ids), self.num_agents)
                                      + actions.shape[1:])
        self.pool.send(actions, env_ids)

    # -- sync convenience (tests, conformance, sync baselines) ----------------
    def reset(self, timeout=_UNSET):
        """First observations (construction already queued the resets)."""
        assert self._ids is None, "reset() after stepping; build a fresh env"
        obs, _rew, _done, _info, self._ids = self.recv(timeout=timeout)
        return obs

    def step(self, actions, timeout=_UNSET):
        """``send`` for the last received rows, then ``recv`` the next batch
        (identical to the classic VecEnv step in sync mode)."""
        assert self._ids is not None, "call reset() before step()"
        self.send(actions, self._ids)
        obs, rew, done, info, self._ids = self.recv(timeout=timeout)
        return obs, rew, done, info

    @property
    def last_ids(self):
        return self._ids

    def close(self, timeout: float = 5.0):
        self.pool.close(timeout=timeout)


def wrap(env_fn: Union[Callable, object], num_envs: int = 1,
         batch_size: Optional[int] = None, *, seed: int = 0,
         api: Optional[str] = None, pad_to: Optional[int] = None,
         recv_timeout: Optional[float] = TrainConfig.host_recv_timeout,
         backend: str = "thread",
         spin: Optional["_shm.SpinConfig"] = None,
         horizon: Optional[int] = None) -> HostVecEnv:
    """One-line wrapper: any host env factory → a trainable ``HostVecEnv``.

        venv = bridge.wrap(lambda: MyGymEnv(), num_envs=8)

    ``env_fn`` — factory returning a fresh env (an instance is accepted for
    ``num_envs=1``). API style is auto-detected (``detect_api``); pass
    ``api=`` ("gymnasium" | "pettingzoo" | "duck") to skip the probe.
    ``num_envs``/``batch_size`` — M simulated / N batched; defaults give the
    synchronous baseline, ``num_envs=2 * batch_size`` the paper's
    double-buffered async pool. ``pad_to`` — pad pettingzoo agent rows to a
    fixed larger count; ``horizon`` — declared episode bound (defaults to
    the env's ``horizon`` attribute), used by the conformance host profile.
    ``recv_timeout`` — default bound on every ``recv``/``reset``/``step``
    wait (``TrainConfig.host_recv_timeout``, 60 s): a hung host env raises
    ``TimeoutError`` instead of deadlocking; ``None`` waits forever.
    ``backend`` — "thread" (default; GIL-releasing env steps) or "proc"
    (spawn processes over shared-memory slabs; pure-Python env steps
    actually parallelize). proc requires ``env_fn`` to be picklable — a
    module-level class/function or ``functools.partial``, not a lambda.
    """
    if callable(env_fn):
        probe = env_fn()
    else:
        probe, env_fn = env_fn, None
        if num_envs != 1:
            raise ValueError("pass a factory (callable) to wrap more than "
                             "one env instance")
    if api is None:
        api = ad.detect_api(probe)
    if api not in ad.APIS:
        raise ValueError(f"unknown host-env api {api!r}; expected one of "
                         f"{ad.APIS}")
    obs_space, act_space = ad.spaces_of(probe, api)
    obs_spec = em.flat_spec(obs_space, "f32")
    act_spec = em.action_spec(act_space)
    adapter_cls = ad.ADAPTERS[api]
    num_agents = 1
    kw = {}
    if api == "pettingzoo":
        num_agents = pad_to or len(probe.possible_agents)
        kw["num_agents"] = num_agents

    if backend == "proc":
        # workers rebuild envs from pickled factories; the probe instance
        # cannot be shipped, so it is only spec metadata here
        if env_fn is None:
            raise ValueError("backend='proc' needs an env *factory* "
                             "(instances cannot be shipped to workers)")
        close = getattr(probe, "close", None)
        if callable(close):
            close()
        env_fns = [ad.AdapterFactory(api, env_fn, obs_spec, act_spec,
                                     kw.get("num_agents"))
                   for _ in range(num_envs)]
    else:
        def make(fn=None, inst=None):
            return adapter_cls(inst if inst is not None else fn(),
                               obs_spec, act_spec, **kw)

        env_fns = [lambda: make(inst=probe)]    # reuse the probe as env 0
        env_fns += [lambda: make(fn=env_fn) for _ in range(num_envs - 1)]
    return HostVecEnv(
        env_fns, batch_size or num_envs, seed=seed,
        obs_spec=obs_spec, act_spec=act_spec,
        single_observation_space=obs_space, single_action_space=act_space,
        num_agents=num_agents,
        recv_timeout=recv_timeout, backend=backend, spin=spin,
        horizon=horizon if horizon is not None
        else getattr(probe, "horizon", None))


def make_host_engine(env_fn, tcfg, *, hidden: int = 64,
                     recurrent: bool = False, seed: int = 0,
                     num_envs: Optional[int] = None, api: Optional[str] = None,
                     pad_to: Optional[int] = None,
                     backend: Optional[str] = None, device=None):
    """Build a ``TrainEngine(backend="host")`` around a bridged env: policy
    and distribution are sized from the bridge's emulation specs exactly as
    ``Trainer`` sizes them from ``Emulated``. ``tcfg.num_envs`` is the batch
    N; M defaults to ``tcfg.pool_buffers * N`` (M = 2N ⇒ the paper's double
    buffering). ``backend`` overrides ``tcfg.host_backend`` (worker threads
    vs shared-memory processes). ``device=None`` means CUDA (raises without
    a Hopper card, before any worker starts). Close with ``engine.close()``.
    """
    from repro_torch import device as _device
    from repro_torch.models.policy import OceanPolicy
    from repro_torch.rl.distributions import Dist
    from repro_torch.rl.engine import TrainEngine

    device = _device.resolve(device)
    N = tcfg.num_envs
    M = num_envs or tcfg.pool_buffers * N
    hv = wrap(env_fn, num_envs=M, batch_size=N, seed=seed, api=api,
              pad_to=pad_to, recv_timeout=tcfg.host_recv_timeout,
              backend=backend or tcfg.host_backend)
    try:
        if hv.act_spec.kind == "discrete":
            dist = Dist("categorical", nvec=hv.act_spec.nvec)
        else:
            dist = Dist("gaussian", cont_dim=hv.act_spec.cont_dim)
        policy = OceanPolicy(hv.obs_spec.total, dist.nvec, hidden=hidden,
                             recurrent=recurrent,
                             num_outputs=dist.num_outputs)
        return TrainEngine(hv, policy, tcfg, dist, seed=seed, device=device,
                           backend="host")
    except BaseException:
        hv.close()
        raise
