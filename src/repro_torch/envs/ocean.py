"""Puffer Ocean (paper §4), batched along a leading env axis.

The counterpart of the original eight envs of ``repro/envs/ocean.py`` (the
``OCEAN`` registry): the same dynamics, rewards, scores and infos, for N
envs at once (see ``envs/base.py``). Each env is trivial with a correct PPO
implementation and impossible with one specific common bug:

  Squared     — dense shaped reward; catches reward/advantage sign bugs.
  Password    — sparse exploration; catches premature determinization.
  Stochastic  — optimal policy is nonuniform-stochastic; catches entropy bugs.
  Memory      — recall after delay; catches broken recurrent state handling.
  Multiagent  — per-agent credit; catches agent-ordering scrambles.
  Spaces      — nested Dict obs + Dict action; catches emulation bugs.
  Bandit      — classic multiarmed bandit; catches value-baseline bugs.
  Continuous  — Box actions through a Gaussian head.

Scores are normalized so "solved" is score > 0.9. Per-env constants that a
score divides by are Python floats on the host; lookup tables are device
tensors built once per device. Ocean II (pong, drone, tagteam, maze, duel)
comes with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import spaces as sp
from repro_torch.envs.base import OceanEnv, end_info

I32, F32 = torch.int32, torch.float32


def _one_hot(idx, n: int) -> torch.Tensor:
    """(…,) int → (…, n) f32, by comparison (no host-side bounds check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _take(table, idx):
    """table[idx] with idx clamped into range, as a JAX gather clamps."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _zeros(n, dtype, device, *shape):
    return torch.zeros((n,) + shape, dtype=dtype, device=device)


class Squared(OceanEnv):
    """Agent starts at the center of a g×g grid; targets on the perimeter.
    Reward = 1 − normalized L∞ distance to the closest unhit target ∈ [−1, 1];
    hit targets stop paying; episode ends when all are hit (or at horizon).
    Score = return / optimal return (perfect perimeter sweep) ∈ [0, 1]."""

    def __init__(self, size: int = 5, horizon: int = 32):
        if size % 2 != 1:
            raise ValueError(f"Squared needs an odd size, got {size}")
        self.size, self.horizon = size, horizon
        self.observation_space = sp.Box((size, size))
        self.action_space = sp.Discrete(5)        # stay, N, S, W, E
        # optimal return: approach rewards + one reward-1 per perimeter cell
        r = size // 2
        self._optimal = float(sum(1.0 - d / r for d in range(1, r))
                              + 4 * (size - 1))

    def make_consts(self, device):
        g = self.size
        i = torch.arange(g, device=device)
        rows, cols = i[:, None].expand(g, g), i[None, :].expand(g, g)
        per = (rows == 0) | (rows == g - 1) | (cols == 0) | (cols == g - 1)
        moves = torch.tensor([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]],
                             dtype=I32).to(device)
        return {"rows": rows, "cols": cols, "per": per, "moves": moves}

    def init(self, n, generator):
        dev, g = generator.device, self.size
        return {"pos": torch.full((n, 2), g // 2, dtype=I32, device=dev),
                "hit": _zeros(n, torch.bool, dev, g, g),
                "t": _zeros(n, I32, dev), "ret": _zeros(n, F32, dev)}

    def _at(self, c, pos):
        return ((c["rows"] == pos[:, 0, None, None])
                & (c["cols"] == pos[:, 1, None, None]))

    def obs(self, s):
        c = self.consts(s["t"].device)
        grid = torch.where(c["per"] & ~s["hit"], 0.5, 0.0)
        return torch.where(self._at(c, s["pos"]), 1.0, grid)

    def step(self, state, action, generator):
        g = self.size
        c = self.consts(state["t"].device)
        pos = (state["pos"] + _take(c["moves"], action)).clamp(0, g - 1)
        active = c["per"] & ~state["hit"]
        dist = torch.maximum((c["rows"] - pos[:, 0, None, None]).abs(),
                             (c["cols"] - pos[:, 1, None, None]).abs())
        d = torch.where(active, dist, g * 2).flatten(1).amin(1)
        any_left = active.flatten(1).any(1)
        reward = torch.where(any_left, 1.0 - d.float() / (g // 2), 0.0)
        hit = state["hit"] | (active & self._at(c, pos))
        t = state["t"] + 1
        ret = state["ret"] + reward
        done = (t >= self.horizon) | (hit | ~c["per"]).flatten(1).all(1)
        score = (ret / self._optimal).clamp(0.0, 1.0)
        s2 = {"pos": pos, "hit": hit, "t": t, "ret": ret}
        return s2, self.obs(s2), reward, done, end_info(done, ret, t, score)


class Password(OceanEnv):
    """Guess a static binary string, one bit per step; reward only if the
    whole string matches. Tests exploration / premature determinization."""

    PASSWORD = (1, 0, 1, 1, 0)

    def __init__(self):
        self.length = len(self.PASSWORD)
        self.observation_space = sp.Box((self.length,))
        self.action_space = sp.Discrete(2)

    def make_consts(self, device):
        return {"pw": torch.tensor(self.PASSWORD, dtype=I32).to(device)}

    def init(self, n, generator):
        dev = generator.device
        return {"t": _zeros(n, I32, dev),
                "ok": torch.ones(n, dtype=torch.bool, device=dev)}

    def obs(self, s):
        return _one_hot(s["t"] % self.length, self.length)

    def step(self, state, action, generator):
        pw = self.consts(state["t"].device)["pw"]
        ok = state["ok"] & (action == _take(pw, state["t"]))
        t = state["t"] + 1
        done = t >= self.length
        reward = torch.where(done & ok, 1.0, 0.0)
        s2 = {"t": t, "ok": ok}
        return s2, self.obs(s2), reward, done, end_info(done, reward, t,
                                                        reward)


class Stochastic(OceanEnv):
    """Optimal policy plays action 0 with probability p. The observation is
    constant, so only a *stochastic* policy scores > 0.9: score at episode end
    is max(0, 1 − 2·|freq₀ − p|)."""

    def __init__(self, p: float = 0.75, horizon: int = 64):
        self.p, self.horizon = p, horizon
        self.observation_space = sp.Box((1,))
        self.action_space = sp.Discrete(2)

    def init(self, n, generator):
        dev = generator.device
        return {"t": _zeros(n, I32, dev), "count0": _zeros(n, I32, dev)}

    def obs(self, s):
        return _zeros(s["t"].shape[0], F32, s["t"].device, 1)

    def step(self, state, action, generator):
        count0 = state["count0"] + (action == 0).int()
        t = state["t"] + 1
        done = t >= self.horizon
        freq = count0.float() / t.float()
        score = (1.0 - 2.0 * (freq - self.p).abs()).clamp(min=0.0)
        reward = torch.where(done, score, 0.0)
        s2 = {"t": t, "count0": count0}
        return s2, self.obs(s2), reward, done, end_info(done, reward, t,
                                                        score)


class Memory(OceanEnv):
    """Repeat an observed random bit sequence after a delay. Obs shows the
    sequence one symbol at a time, then zeros; actions during the recall phase
    must reproduce it. Unsolvable without memory (recurrent policy)."""

    def __init__(self, length: int = 3):
        self.length = length
        self.horizon = 2 * length
        self.observation_space = sp.Box((3,))   # one-hot: [silent, bit0, bit1]
        self.action_space = sp.Discrete(2)

    def init(self, n, generator):
        dev = generator.device
        seq = (torch.rand((n, self.length), generator=generator, device=dev)
               < 0.5).int()
        return {"seq": seq, "t": _zeros(n, I32, dev),
                "correct": _zeros(n, I32, dev)}

    def _seq_at(self, seq, i):
        return seq.gather(1, i.long()[:, None])[:, 0]

    def obs(self, s):
        t, L = s["t"], self.length
        sym = torch.where(t < L, self._seq_at(s["seq"], t.clamp(max=L - 1))
                          + 1, 0)
        return _one_hot(sym, 3)

    def step(self, state, action, generator):
        t, L = state["t"], self.length
        target = self._seq_at(state["seq"], (t - L).clamp(0, L - 1))
        hit = (t >= L) & (action == target)
        correct = state["correct"] + hit.int()
        reward = torch.where(hit, 1.0 / L, 0.0)
        t2 = t + 1
        done = t2 >= self.horizon
        score = correct.float() / L
        s2 = {"seq": state["seq"], "t": t2, "correct": correct}
        # episodic return equals score here
        return s2, self.obs(s2), reward, done, end_info(done, score, t2,
                                                        score)


class Multiagent(OceanEnv):
    """Agent 0 must pick action 0; agent 1 must pick action 1. Catches any
    scramble of the canonical agent ordering (score pins to 0.5)."""

    num_agents = 2

    def __init__(self, horizon: int = 8):
        self.horizon = horizon
        self.observation_space = sp.Box((2,))    # per-agent one-hot id
        self.action_space = sp.Discrete(2)

    def init(self, n, generator):
        dev = generator.device
        return {"t": _zeros(n, I32, dev), "ret": _zeros(n, F32, dev, 2)}

    def obs(self, s):
        n, dev = s["t"].shape[0], s["t"].device
        return torch.eye(2, device=dev).expand(n, 2, 2)

    def step(self, state, action, generator):
        # action: (N, 2) — agent-major, canonical order
        correct = (action == torch.arange(2, device=action.device)).float()
        ret = state["ret"] + correct
        t = state["t"] + 1
        done = t >= self.horizon
        score = ret.mean(-1) / self.horizon
        s2 = {"t": t, "ret": ret}
        info = end_info(done, ret.sum(-1), t, score)
        return s2, self.obs(s2), correct, done, info


class Spaces(OceanEnv):
    """Hierarchical observation AND action spaces. A hidden bit lives in the
    center of obs["image"] and another in obs["flat"][0]; action "a" must match
    the image bit and action "b" the flat bit. Maximal score requires using
    every subspace — a learned end-to-end test of emulation."""

    def __init__(self, horizon: int = 8):
        self.horizon = horizon
        self.observation_space = sp.Dict({
            "image": sp.Box((3, 3)),
            "flat": sp.Box((4,)),
        })
        self.action_space = sp.Dict({
            "a": sp.Discrete(2),
            "b": sp.Discrete(2),
        })

    def _bits(self, n, generator):
        u = torch.rand((2, n), generator=generator, device=generator.device)
        return (u < 0.5).int()

    def init(self, n, generator):
        dev = generator.device
        img, flat = self._bits(n, generator)
        return {"img_bit": img, "flat_bit": flat, "t": _zeros(n, I32, dev),
                "ret": _zeros(n, F32, dev)}

    def obs(self, s):
        n, dev = s["t"].shape[0], s["t"].device
        img = _zeros(n, F32, dev, 3, 3)
        img[:, 1, 1] = s["img_bit"].float()
        flat = _zeros(n, F32, dev, 4)
        flat[:, 0] = s["flat_bit"].float()
        return {"image": img, "flat": flat}

    def step(self, state, action, generator):
        ra = (action["a"] == state["img_bit"]).float()
        rb = (action["b"] == state["flat_bit"]).float()
        reward = 0.5 * ra + 0.5 * rb
        ret = state["ret"] + reward
        t = state["t"] + 1
        done = t >= self.horizon
        img, flat = self._bits(t.shape[0], generator)
        s2 = {"img_bit": img, "flat_bit": flat, "t": t, "ret": ret}
        score = ret / self.horizon
        return s2, self.obs(s2), reward, done, end_info(done, ret, t, score)


class Bandit(OceanEnv):
    """Classic multiarmed bandit: stochastic payouts, fixed arm probabilities.
    Score = mean reward / best-arm payout."""

    PROBS = (0.2, 0.5, 0.1, 0.9)

    def __init__(self, horizon: int = 16):
        self.horizon = horizon
        self.observation_space = sp.Box((1,))
        self.action_space = sp.Discrete(len(self.PROBS))

    def make_consts(self, device):
        return {"probs": torch.tensor(self.PROBS, dtype=F32).to(device)}

    def init(self, n, generator):
        dev = generator.device
        return {"t": _zeros(n, I32, dev), "ret": _zeros(n, F32, dev)}

    def obs(self, s):
        return _zeros(s["t"].shape[0], F32, s["t"].device, 1)

    def step(self, state, action, generator):
        probs = self.consts(state["t"].device)["probs"]
        u = torch.rand(action.shape, generator=generator,
                       device=generator.device)
        reward = (u < _take(probs, action)).float()
        ret = state["ret"] + reward
        t = state["t"] + 1
        done = t >= self.horizon
        score = ret / (self.horizon * max(self.PROBS))
        s2 = {"t": t, "ret": ret}
        return s2, self.obs(s2), reward, done, end_info(done, ret, t, score)


class Continuous(OceanEnv):
    """1-D target tracking with a continuous Box action — exercises the
    Gaussian policy head. Reward per step = 1 − |pos − target|; optimal is a
    one-step jump."""

    def __init__(self, horizon: int = 16):
        self.horizon = horizon
        self.observation_space = sp.Box((2,))
        self.action_space = sp.Box((1,), low=-1.0, high=1.0)

    def init(self, n, generator):
        dev = generator.device
        u = torch.rand(n, generator=generator, device=dev)
        return {"pos": _zeros(n, F32, dev), "target": -0.8 + 1.6 * u,
                "t": _zeros(n, I32, dev), "ret": _zeros(n, F32, dev)}

    def obs(self, s):
        return torch.stack([s["pos"], s["target"]], dim=-1)

    def step(self, state, action, generator):
        a = action.reshape(-1).clamp(-1.0, 1.0)
        pos = (state["pos"] + a).clamp(-1.0, 1.0)
        reward = 1.0 - (pos - state["target"]).abs()
        ret = state["ret"] + reward
        t = state["t"] + 1
        done = t >= self.horizon
        score = (ret / self.horizon).clamp(0.0, 1.0)
        s2 = {"pos": pos, "target": state["target"], "t": t, "ret": ret}
        return s2, self.obs(s2), reward, done, end_info(done, ret, t, score)


OCEAN = {
    "squared": Squared,
    "password": Password,
    "stochastic": Stochastic,
    "memory": Memory,
    "multiagent": Multiagent,
    "spaces": Spaces,
    "bandit": Bandit,
    "continuous": Continuous,
}

