"""Ocean host mirrors — pure-Python/numpy twins of the Ocean envs: a copy of
``repro/envs/ocean_host.py``.

These exist so the HostBridge has exact parity targets: each mirror
reimplements an Ocean env's dynamics with plain numpy state (the shape of a
real third-party env — NetHack, Atari — that cannot run as batched device
code), and deliberately speaks a different host API so ``bridge.wrap``'s
auto-detection is exercised end to end:

  HostBandit   — duck-typed  (``reset(seed) -> obs``, 4-tuple ``step``);
                 mirror of ``ocean.Bandit``.
  HostSquared  — duck-typed; mirror of ``ocean.Squared``.
  HostDrone    — Gymnasium API (``reset(seed=...) -> (obs, info)``, 5-tuple
                 ``step``, real ``gymnasium.spaces`` when installed, duck
                 stand-ins otherwise); mirror of the reference's
                 ``ocean.Drone``.
  HostTeam     — PettingZoo-parallel API (``possible_agents`` + per-agent
                 dicts); mirror of ``ocean.Multiagent``.
  HostCrafterLite — a Crafter-shaped gridworld whose step is pure-Python
                 work: the env class the ``proc`` backend exists for.

Terminal step ``info`` carries ``"score"`` normalized to [0, 1] exactly like
the originals. Optional ``jitter_ms`` injects lognormal step latency — the
NetHack/Crafter-shaped variance the paper's EnvPool exploits.

numpy and the stdlib only: spawned host-pool workers import this module.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core import spaces as sp

try:                                            # real Gymnasium when present
    from gymnasium import spaces as _gym_spaces
except ImportError:                             # duck stand-ins otherwise
    _gym_spaces = None


class _Jitter:
    """Optional lognormal step latency (mean ``jitter_ms``, σ=0.6)."""

    def __init__(self, jitter_ms: float, seed: int):
        self.jitter_ms = jitter_ms
        self.rng = np.random.RandomState(seed)

    def sleep(self):
        if self.jitter_ms > 0:
            time.sleep(self.rng.lognormal(
                np.log(self.jitter_ms), 0.6) / 1e3)


# ---------------------------------------------------------------------------


class HostBandit:
    """Duck-typed mirror of ``ocean.Bandit``: stochastic arm payouts, score
    = return / best-arm payout."""

    PROBS = (0.2, 0.5, 0.1, 0.9)

    def __init__(self, horizon: int = 16, jitter_ms: float = 0.0,
                 jitter_seed: int = 0):
        self.horizon = horizon
        self.observation_space = sp.Box((1,))
        self.action_space = sp.Discrete(len(self.PROBS))
        self._jit = _Jitter(jitter_ms, jitter_seed)
        self.rng: Optional[np.random.RandomState] = None
        self.t, self.ret = 0, 0.0

    def reset(self, seed):
        self.rng = np.random.RandomState(
            None if seed is None else int(seed) % (2 ** 32))
        self.t, self.ret = 0, 0.0
        return np.zeros((1,), np.float32)

    def step(self, action):
        self._jit.sleep()
        rew = float(self.rng.random_sample() < self.PROBS[int(action)])
        self.t += 1
        self.ret += rew
        done = self.t >= self.horizon
        info = {}
        if done:
            info["score"] = min(
                1.0, self.ret / (self.horizon * max(self.PROBS)))
        return np.zeros((1,), np.float32), rew, done, info


class HostSquared:
    """Duck-typed mirror of ``ocean.Squared``: perimeter targets on a g×g
    grid, reward = 1 − normalized L∞ distance to the closest unhit target."""

    def __init__(self, size: int = 5, horizon: int = 32):
        assert size % 2 == 1
        self.size, self.horizon = size, horizon
        self.observation_space = sp.Box((size, size))
        self.action_space = sp.Discrete(5)      # stay, N, S, W, E
        g = size
        per = np.zeros((g, g), bool)
        per[0, :] = per[-1, :] = per[:, 0] = per[:, -1] = True
        self._perimeter = per
        ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        self._coords = np.stack([ii, jj], -1)
        r = g // 2
        self._optimal = float(sum(1.0 - d / r for d in range(1, r))
                              + 4 * (g - 1))
        self.pos = None
        self.hit = None
        self.t, self.ret = 0, 0.0

    def reset(self, seed):
        g = self.size
        self.pos = np.array([g // 2, g // 2])
        self.hit = np.zeros((g, g), bool)
        self.t, self.ret = 0, 0.0
        return self._obs()

    def _obs(self):
        grid = np.where(self._perimeter & ~self.hit, 0.5, 0.0)
        grid[self.pos[0], self.pos[1]] = 1.0
        return grid.astype(np.float32)

    def step(self, action):
        g = self.size
        moves = np.array([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]])
        self.pos = np.clip(self.pos + moves[int(action)], 0, g - 1)
        active = self._perimeter & ~self.hit
        dist = np.max(np.abs(self._coords - self.pos), -1)
        d = np.min(np.where(active, dist, g * 2))
        reward = float(1.0 - d / (g // 2)) if active.any() else 0.0
        if active[self.pos[0], self.pos[1]]:
            self.hit[self.pos[0], self.pos[1]] = True
        self.t += 1
        self.ret += reward
        done = (self.t >= self.horizon
                or bool(np.all(self.hit | ~self._perimeter)))
        info = {}
        if done:
            info["score"] = float(np.clip(self.ret / self._optimal, 0.0, 1.0))
        return self._obs(), reward, done, info


class HostCrafterLite:
    """Duck-typed Crafter-shaped gridworld whose step cost is *pure-Python
    bytecode* — the workload class where thread pools serialize on the GIL
    and ``backend="proc"`` actually parallelizes.

    The agent walks a g×g grid, gathers wood/stone nodes, and crafts tools
    (2 wood + 1 stone → reward 1; gather → 0.1). World randomness is a
    64-bit LCG advanced ``work`` times per step — that walk *is* the CPU
    burn (~2 ms at the default ``work`` on a ~2020s core) and it is
    load-bearing: its final state places regrown resources, so the burn
    cannot be optimized away without changing the dynamics. All integer
    arithmetic ⇒ bitwise-deterministic across processes and backends.

    ``sleep_ms`` swaps the burn profile: a GIL-*releasing* ``time.sleep``
    before the (still deterministic) dynamics, where threads are already
    optimal.

    Score = tools crafted / (horizon // 8), clipped to [0, 1].
    """

    MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))
    _LCG_MUL = 6364136223846793005
    _LCG_ADD = 1442695040888963407
    _MASK = (1 << 64) - 1

    def __init__(self, size: int = 8, horizon: int = 32,
                 work: int = 20_000, sleep_ms: float = 0.0):
        self.size, self.horizon = size, horizon
        self.work = int(work)
        self.sleep_ms = float(sleep_ms)
        self.observation_space = sp.Box((size * size + 4,))
        self.action_space = sp.Discrete(6)      # N, S, W, E, gather, craft
        self._h = 1
        self.pos = [0, 0]
        self.res: dict = {}                     # cell -> 1 (wood) | 2 (stone)
        self.inv = [0, 0, 0]                    # wood, stone, tools
        self.t, self.tools = 0, 0

    def _mix(self, rounds: int) -> int:
        h = self._h
        mul, add, mask = self._LCG_MUL, self._LCG_ADD, self._MASK
        for _ in range(rounds):
            h = (h * mul + add) & mask
        self._h = h
        return h

    def reset(self, seed):
        s = 0 if seed is None else int(seed)
        self._h = ((s * 2654435761 + 0x9E3779B9) & self._MASK) or 1
        g = self.size
        self.pos = [g // 2, g // 2]
        self.res = {}
        for kind in (1, 2):                     # g wood + g stone nodes
            for _ in range(g):
                self.res.setdefault((self._mix(1) >> 16) % (g * g), kind)
        self.inv = [0, 0, 0]
        self.t, self.tools = 0, 0
        return self._obs()

    def _obs(self):
        g = self.size
        o = np.zeros((g * g + 4,), np.float32)
        for c, kind in self.res.items():
            o[c] = 0.33 * kind
        o[self.pos[0] * g + self.pos[1]] = 1.0
        o[g * g + 0] = self.inv[0] / 8.0
        o[g * g + 1] = self.inv[1] / 8.0
        o[g * g + 2] = self.inv[2] / 8.0
        o[g * g + 3] = self.t / self.horizon
        return o

    def step(self, action):
        if self.sleep_ms > 0:
            time.sleep(self.sleep_ms / 1e3)
        h = self._mix(self.work)                # CPU burn + world rng tick
        a, g = int(action), self.size
        rew = 0.0
        if a < 4:
            self.pos[0] = min(max(self.pos[0] + self.MOVES[a][0], 0), g - 1)
            self.pos[1] = min(max(self.pos[1] + self.MOVES[a][1], 0), g - 1)
        elif a == 4:                            # gather
            kind = self.res.pop(self.pos[0] * g + self.pos[1], 0)
            if kind:
                self.inv[kind - 1] += 1
                rew += 0.1
                self.res.setdefault((h >> 16) % (g * g), kind)  # regrow
        else:                                   # craft: 2 wood + 1 stone
            if self.inv[0] >= 2 and self.inv[1] >= 1:
                self.inv[0] -= 2
                self.inv[1] -= 1
                self.inv[2] += 1
                self.tools += 1
                rew += 1.0
        self.t += 1
        done = self.t >= self.horizon
        info = {}
        if done:
            info["score"] = min(1.0, self.tools / max(1, self.horizon // 8))
        return self._obs(), rew, done, info


# ---------------------------------------------------------------------------


class _DuckBox:
    """Minimal gymnasium.spaces.Box stand-in (shape/dtype/low/high)."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.low, self.high = np.full(shape, low), np.full(shape, high)
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)


def _gym_box(low, high, shape):
    if _gym_spaces is not None:
        return _gym_spaces.Box(low, high, shape, np.float32)
    return _DuckBox(low, high, shape)


class HostDrone:
    """Gymnasium-API mirror of ``ocean.Drone``: reach and hover at a random
    3-D target with a Box((3,)) thrust action. ``reset(seed=...) ->
    (obs, info)``; ``step -> (obs, rew, terminated, truncated, info)``
    (episodes end by truncation at the horizon, Gymnasium-style)."""

    metadata = {"render_modes": []}

    def __init__(self, horizon: int = 16, thrust: float = 0.5,
                 jitter_ms: float = 0.0, jitter_seed: int = 0):
        self.horizon, self.thrust = horizon, thrust
        self.observation_space = _gym_box(-1.0, 1.0, (6,))
        self.action_space = _gym_box(-1.0, 1.0, (3,))
        self._jit = _Jitter(jitter_ms, jitter_seed)
        self.pos = self.target = None
        self.t, self.ret = 0, 0.0

    def _obs(self):
        return np.concatenate([self.pos, self.target]).astype(np.float32)

    def reset(self, *, seed=None, options=None):
        rng = np.random.RandomState(
            None if seed is None else int(seed) % (2 ** 32))
        self.pos = np.zeros((3,))
        self.target = rng.uniform(-0.8, 0.8, (3,))
        self.t, self.ret = 0, 0.0
        return self._obs(), {}

    def step(self, action):
        self._jit.sleep()
        a = np.clip(np.asarray(action, np.float64).reshape(3), -1.0, 1.0)
        self.pos = np.clip(self.pos + self.thrust * a, -1.0, 1.0)
        reward = max(0.0, 1.0 - 0.5 * float(
            np.linalg.norm(self.pos - self.target)))
        self.t += 1
        self.ret += reward
        truncated = self.t >= self.horizon
        info = {}
        if truncated:
            info["score"] = float(np.clip(self.ret / self.horizon, 0.0, 1.0))
        return self._obs(), reward, False, truncated, info


class HostTeam:
    """PettingZoo-parallel mirror of ``ocean.Multiagent``: agent j must play
    action j; per-agent reward 1 on a match. Score (reported identically in
    every agent's terminal info) = mean correctness, like the original."""

    possible_agents = ("agent_0", "agent_1")

    def __init__(self, horizon: int = 8):
        self.horizon = horizon
        self.agents = list(self.possible_agents)
        self.t = 0
        self.ret = np.zeros((2,))

    def observation_space(self, agent):
        return sp.Box((2,))

    def action_space(self, agent):
        return sp.Discrete(2)

    def _obs(self):
        eye = np.eye(2, dtype=np.float32)
        return {ag: eye[j] for j, ag in enumerate(self.possible_agents)}

    def reset(self, *, seed=None, options=None):
        self.agents = list(self.possible_agents)
        self.t = 0
        self.ret = np.zeros((2,))
        return self._obs(), {ag: {} for ag in self.possible_agents}

    def step(self, actions):
        correct = np.array([float(int(actions[ag]) == j)
                            for j, ag in enumerate(self.possible_agents)])
        self.ret += correct
        self.t += 1
        done = self.t >= self.horizon
        score = float(np.mean(self.ret) / self.horizon)
        infos = {ag: ({"score": score} if done else {})
                 for ag in self.possible_agents}
        if done:
            self.agents = []
        rew = {ag: float(correct[j])
               for j, ag in enumerate(self.possible_agents)}
        term = {ag: done for ag in self.possible_agents}
        trunc = {ag: False for ag in self.possible_agents}
        return self._obs(), rew, term, trunc, infos


OCEAN_HOST = {
    "bandit": HostBandit,
    "squared": HostSquared,
    "crafter": HostCrafterLite,
    "drone": HostDrone,
    "team": HostTeam,
}


def make(name: str, **kw):
    return OCEAN_HOST[name](**kw)
