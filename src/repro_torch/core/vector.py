"""Vectorization — the paper's §3.3, one batched path.

The counterpart of ``repro/core/vector.py``'s ``vmap`` backend. All N env
states live in device tensors with a leading env axis, and one ``step`` call
steps them all (the envs are batched, see ``envs/base.py``), with auto-reset
inside the step: no host sync, and observations are never re-laid-out
between the env, the emulation layer and the model.

Multiagent envs are exposed agent-major: ``batch_size = N * num_agents``;
observations and rewards arrive as ``(N·A, …)``, ``done`` is each env's flag
repeated A times consecutively, and the infos stay per env, ``(N,)``.

Randomness by block: where the reference keys every draw by global env
index, so that an S-way data-parallel run draws what one device draws,
the port gives each of S contiguous env blocks a generator of its own.
``init``, ``reset`` and ``step`` take one generator, or a list of S — one
per block, which then draws block s's init, resets and steps in the order
a ``VecEnv`` of that block alone would (``blocks``). Rank s of an S-rank
run steps block s with generator s, and so draws what block s of the
one-process emulation draws.

Backends (the reference's names): ``vmap`` is the batched path above;
``serial`` steps each env as a batch of one, in a Python loop (the
baseline that ``autotune`` times the batched path against). It is the
``blocks`` mechanism with every env a block: env i draws from generator i
of a list of N, and given fewer generators (one, or S blocks) each
block's envs draw from its generator in turn.

``autotune`` times both backends on the real env and returns env steps per
second for each and the winner, as the reference's does (the paper's
§3.3). It stays out of the kernel registry, which has no autotune.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import spaces as sp
from repro_torch.distributed.sharding import block, cat_blocks


def tree_select(pred, on_true, on_false):
    """Branch-free select over nested dicts: ``pred`` (N,) bool picks along
    the leading axis of every leaf."""
    if isinstance(on_true, dict):
        return {k: tree_select(pred, on_true[k], on_false[k])
                for k in on_true}
    p = pred.reshape((-1,) + (1,) * (on_true.dim() - 1))
    return torch.where(p, on_true, on_false)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def blocks(generator):
    """The per-block generators, or None for a single generator."""
    return generator if isinstance(generator, (list, tuple)) else None


def block_seed(seed: int, s: int) -> int:
    """The seed of block s's generator: ``seed`` itself for block 0 (whose
    generator, the engine's, first draws the params), and
    (seed + s · 0x9E3779B97F4A7C15) mod 2^63 for s > 0."""
    return seed if s == 0 else (seed + s * 0x9E3779B97F4A7C15) % (1 << 63)


def block_generators(seed: int, S: int, device, first=None) -> list:
    """S generators on ``device`` seeded by ``block_seed``; ``first``, when
    given, is block 0's (a generator that has already drawn)."""
    gens = [torch.Generator(device=device).manual_seed(block_seed(seed, s))
            for s in range(1 if first is not None else 0, S)]
    return ([first] if first is not None else []) + gens


def _split(tree, S):
    return [block(tree, S, s) for s in range(S)]


class VecEnv:
    """N copies of a (usually ``Emulated``) batched env, stepped as one
    batch with auto-reset: where ``done``, the state and observation are
    those of a fresh reset, which draws new randomness."""

    def __init__(self, env, num_envs: int, backend: str = "vmap"):
        if backend not in ("serial", "vmap"):
            raise ValueError(f"backend {backend!r}: 'serial' or 'vmap'")
        self.env, self.num_envs, self.backend = env, num_envs, backend
        self.num_agents = getattr(env, "num_agents", 1)
        self.batch_size = num_envs * self.num_agents
        self.single_observation_space = env.observation_space
        self.single_action_space = env.action_space

    def init(self, generator):
        gens = self._blocks(generator)
        if gens is not None:
            n = self.num_envs // len(gens)
            return self._by_block(
                [(self.env.init(n, g), g) for g in gens], self._reset)
        state = self.env.init(self.num_envs, generator)
        return self._reset(state, generator)

    def reset(self, state, generator):
        gens = self._blocks(generator)
        if gens is not None:
            return self._by_block(zip(_split(state, len(gens)), gens),
                                  self._reset)
        return self._reset(state, generator)

    def _reset(self, state, generator):
        state, obs = self.env.reset(state, generator)
        return state, self._flatten_agents(obs)

    def step(self, state, actions, generator):
        """actions: (N·A, …). Returns (state, obs (N·A, …), reward (N·A,),
        done (N·A,), info (N,))."""
        gens = self._blocks(generator)
        if gens is not None:
            S = len(gens)
            return self._by_block(zip(_split(state, S), _split(actions, S),
                                      gens), self._step)
        return self._step(state, actions, generator)

    def _step(self, state, actions, generator):
        actions = self._unflatten_agents(actions)
        s2, obs, rew, done, info = self.env.step(state, actions, generator)
        s_reset, obs_reset = self.env.reset(s2, generator)
        state = tree_select(done, s_reset, s2)
        obs = tree_select(done, obs_reset, obs)
        return (state, self._flatten_agents(obs), self._flatten_rew(rew),
                self._broadcast_done(done), info)

    def _blocks(self, generator):
        """The generator of each block, or None for one batch: for
        ``serial`` every env is a block, and block s's generator serves
        each of its N / S envs in turn."""
        gens = blocks(generator)
        if self.backend != "serial":
            return gens
        gens = gens or [generator]
        per = self.num_envs // len(gens)
        return [gens[i // per] for i in range(self.num_envs)]

    @staticmethod
    def _by_block(args, fn):
        """``fn`` on each block's arguments, the outputs joined in block
        order (the blocks are contiguous along the env and row axes)."""
        return cat_blocks([fn(*a) for a in args])

    # -- agent-major reshapes (of any number of envs) -------------------------
    def _flatten_agents(self, obs):
        if self.num_agents == 1:
            return obs
        return _tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), obs)

    def _unflatten_agents(self, actions):
        if self.num_agents == 1:
            return actions
        return _tree_map(
            lambda x: x.reshape((-1, self.num_agents) + tuple(x.shape[1:])),
            actions)

    def _flatten_rew(self, rew):
        if self.num_agents == 1:
            return rew
        return rew.reshape(-1)

    def _broadcast_done(self, done):
        if self.num_agents == 1:
            return done
        return torch.repeat_interleave(done, self.num_agents)


def autotune(env, num_envs: int, steps: int = 64, generator=None,
             device="cuda"):
    """Time every backend on the real env (the paper's autotune): a warm-up
    step, then ``steps`` steps of zero actions, synchronised with the device
    only at the two timing boundaries. Returns ({backend: env steps per
    second}, the fastest backend)."""
    from repro_torch.device import resolve
    dev = resolve(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    results = {}
    for backend in ("serial", "vmap"):
        vec = VecEnv(env, num_envs, backend=backend)
        state, _ = vec.init(gen)
        zero = _zero_actions(vec.single_action_space, vec.batch_size, dev)
        state, *_ = vec.step(state, zero, gen)          # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, *_ = vec.step(state, zero, gen)
        _sync(dev)
        results[backend] = steps * vec.batch_size / (time.perf_counter() - t0)
    return results, max(results, key=results.get)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _zero_actions(space, batch: int, dev) -> torch.Tensor:
    if isinstance(space, sp.MultiDiscrete):
        return torch.zeros((batch, len(space.nvec)), dtype=torch.int32,
                           device=dev)
    return torch.zeros((batch,) + tuple(space.shape), device=dev)
