"""Puffer Ocean (paper §4), batched along a leading env axis.

The counterpart of ``repro/envs/ocean.py`` (the ``OCEAN`` registry, all 13
envs in the reference's order): the same dynamics, rewards, scores and
infos, for N envs at once (see ``envs/base.py``). Each env is trivial with
a correct PPO implementation and impossible with one specific common bug:

  Squared     — dense shaped reward; catches reward/advantage sign bugs.
  Password    — sparse exploration; catches premature determinization.
  Stochastic  — optimal policy is nonuniform-stochastic; catches entropy bugs.
  Memory      — recall after delay; catches broken recurrent state handling.
  Multiagent  — per-agent credit; catches agent-ordering scrambles.
  Spaces      — nested Dict obs + Dict action; catches emulation bugs.
  Bandit      — classic multiarmed bandit; catches value-baseline bugs.
  Continuous  — Box actions through a Gaussian head.

Ocean II — each stresses a code path the original eight leave untested:

  Pong        — pixel-grid 2D Box obs through the CNN frontend; catches
                obs-layout scrambles between emulation and the encoder.
  Drone       — multi-dim Box actions through the Gaussian head; catches
                per-component action-dim mixups.
  TagTeam     — two competing teams with per-team shared reward and
                padded agent rows (``pad_agents``); catches team credit
                assignment and dead-agent masking bugs.
  Maze        — per-episode procedurally generated layout; catches stale
                procgen draws through autoreset (every episode must get a
                fresh maze).
  Duel        — two-player zero-sum, role-symmetric grid duel: the league's
                self-play workload (``league/``).

Scores are normalized so "solved" is score > 0.9. Per-env constants that a
score divides by are Python floats on the host; lookup tables are device
tensors built once per device. What a step draws (TagTeam's signal, Duel's
coin) is drawn for all N envs every step and selected with
``torch.where``, so a step never branches on the host.
"""
from __future__ import annotations

import torch

from repro_torch.core import spaces as sp
from repro_torch.core.emulation import pad_agents
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



# =========================== Ocean II ========================================
# Four envs that each stress a code path the original eight leave untested
# (CNN frontend, multi-dim Gaussian actions, per-team reward + agent
# padding, per-episode procgen through autoreset), and the league's duel.

_MOVES = [[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]]     # stay, N, S, W, E


class Pong(OceanEnv):
    """Pixel Pong (catch variant): a ball falls from the top row with a fixed
    per-episode horizontal drift, bouncing off the side walls; a 3-wide paddle
    on the bottom row moves left/right to catch it. The observation is the
    raw 2D pixel grid — the one Ocean env whose obs is an image, exercising
    the CNN frontend end-to-end through emulation (which flattens it) and the
    policy (which restores it). Score = 1 on catch, 0 on miss."""

    obs_frontend = "conv"            # Trainer: route through the CNN encoder

    def __init__(self, rows: int = 6, cols: int = 6):
        if rows < 3 or cols < 3:
            raise ValueError(f"Pong needs rows, cols >= 3, got {rows}, "
                             f"{cols}")
        self.rows, self.cols = rows, cols
        self.horizon = rows - 1      # ball falls one row per step
        self.observation_space = sp.Box((rows, cols))
        self.action_space = sp.Discrete(3)       # stay, left, right

    def make_consts(self, device):
        return {"rows": torch.arange(self.rows, device=device)[:, None],
                "cols": torch.arange(self.cols, device=device)[None, :],
                "moves": torch.tensor([0, -1, 1], dtype=I32).to(device)}

    def init(self, n, generator):
        dev = generator.device
        col = torch.randint(0, self.cols, (n,), generator=generator,
                            device=dev, dtype=I32)
        dx = torch.randint(-1, 2, (n,), generator=generator, device=dev,
                           dtype=I32)
        return {"ball": torch.stack([_zeros(n, I32, dev), col], -1),
                "dx": dx,
                "paddle": torch.full((n,), self.cols // 2, dtype=I32,
                                     device=dev),
                "t": _zeros(n, I32, dev)}

    def obs(self, s):
        c = self.consts(s["t"].device)
        # the paddle first, then the ball over it, as the reference writes
        paddle = ((c["rows"] == self.rows - 1)
                  & ((c["cols"] - s["paddle"][:, None, None]).abs() <= 1))
        ball = ((c["rows"] == s["ball"][:, 0, None, None])
                & (c["cols"] == s["ball"][:, 1, None, None]))
        return torch.where(ball, 1.0, torch.where(paddle, 0.5, 0.0))

    def step(self, state, action, generator):
        c = self.consts(state["t"].device)
        paddle = (state["paddle"] + _take(c["moves"], action)).clamp(
            0, self.cols - 1)
        # ball falls one row; horizontal drift reflects off the side walls
        col = state["ball"][:, 1] + state["dx"]
        bounce = (col < 0) | (col >= self.cols)
        dx = torch.where(bounce, -state["dx"], state["dx"])
        col = col.clamp(0, self.cols - 1)
        row = state["ball"][:, 0] + 1
        t = state["t"] + 1
        done = row >= self.rows - 1
        caught = done & ((col - paddle).abs() <= 1)
        reward = caught.float()
        s2 = {"ball": torch.stack([row, col], -1), "dx": dx,
              "paddle": paddle, "t": t}
        return s2, self.obs(s2), reward, done, end_info(done, reward, t,
                                                        reward)


class Drone(OceanEnv):
    """3-D waypoint flight: reach and hover at a random target with a
    Box((3,)) thrust action — the multi-dim continuous control case
    (``Continuous`` is 1-D, so a transposed/mixed action component bug is
    invisible there). Reward per step = max(0, 1 − distance/2);
    score = return / horizon."""

    def __init__(self, horizon: int = 16, thrust: float = 0.5):
        self.horizon, self.thrust = horizon, thrust
        self.observation_space = sp.Box((6,))     # [pos ‖ target]
        self.action_space = sp.Box((3,), low=-1.0, high=1.0)

    def init(self, n, generator):
        dev = generator.device
        u = torch.rand((n, 3), generator=generator, device=dev)
        return {"pos": _zeros(n, F32, dev, 3), "target": -0.8 + 1.6 * u,
                "t": _zeros(n, I32, dev), "ret": _zeros(n, F32, dev)}

    def obs(self, s):
        return torch.cat([s["pos"], s["target"]], dim=-1)

    def step(self, state, action, generator):
        a = action.reshape(-1, 3).clamp(-1.0, 1.0)
        pos = (state["pos"] + self.thrust * a).clamp(-1.0, 1.0)
        dist = torch.linalg.vector_norm(pos - state["target"], dim=-1)
        reward = (1.0 - 0.5 * dist).clamp(min=0.0)
        ret = state["ret"] + reward
        t = state["t"] + 1
        done = t >= self.horizon
        score = (ret / self.horizon).clamp(0.0, 1.0)
        s2 = {"pos": pos, "target": state["target"], "t": t, "ret": ret}
        return s2, self.obs(s2), reward, done, end_info(done, ret, t, score)


class TagTeam(OceanEnv):
    """Two competing teams with *per-team* shared reward and padded agent
    rows. Four live agents (team 0: agents 0–1, team 1: agents 2–3) observe
    a common signal bit; team 0 must match it, team 1 must play its
    complement. Each agent's reward is its **team mean** correctness, so any
    per-agent credit scramble or team mixup pins the score at 0.5. The env
    declares ``num_agents = 6`` and pads the two dead rows with
    ``pad_agents`` — exercising the fixed-size agent padding path end to end
    (padded rows: zero obs, zero reward, excluded from the score). The
    signal is drawn afresh every step."""

    num_agents = 6
    LIVE = 4                         # 2 teams × 2 agents; rows 4–5 are padding

    def __init__(self, horizon: int = 8):
        self.horizon = horizon
        self.observation_space = sp.Box((4,))    # [team0, team1, signal, live]
        self.action_space = sp.Discrete(2)

    def make_consts(self, device):
        return {"team": torch.tensor([0, 0, 1, 1], dtype=I32).to(device)}

    def _signal(self, n, generator):
        u = torch.rand(n, generator=generator, device=generator.device)
        return (u < 0.5).int()

    def init(self, n, generator):
        dev = generator.device
        return {"signal": self._signal(n, generator),
                "t": _zeros(n, I32, dev),
                "ret": _zeros(n, F32, dev, self.num_agents)}

    def obs(self, s):
        n, dev = s["t"].shape[0], s["t"].device
        team = self.consts(dev)["team"].expand(n, self.LIVE)
        live = torch.stack([
            (team == 0).float(),
            (team == 1).float(),
            s["signal"].float()[:, None].expand(n, self.LIVE),
            torch.ones((n, self.LIVE), device=dev),
        ], dim=-1)                               # (N, LIVE, 4) agent-major
        obs, _ = pad_agents(live, torch.ones((n, self.LIVE), dtype=torch.bool,
                                             device=dev),
                            self.num_agents, axis=1)
        return obs

    def step(self, state, action, generator):
        n = state["t"].shape[0]
        team = self.consts(state["t"].device)["team"]
        want = team ^ state["signal"][:, None]               # team target
        correct = (action[:, :self.LIVE] == want).float()
        team_rew = torch.stack([correct[:, :2].mean(-1),
                                correct[:, 2:].mean(-1)], dim=-1)
        reward = torch.cat([
            team_rew.repeat_interleave(2, dim=-1),
            correct.new_zeros((n, self.num_agents - self.LIVE))], dim=-1)
        ret = state["ret"] + reward
        t = state["t"] + 1
        done = t >= self.horizon
        live_ret = ret[:, :self.LIVE].sum(-1)
        score = live_ret / (self.LIVE * self.horizon)
        s2 = {"signal": self._signal(n, generator), "t": t, "ret": ret}
        return s2, self.obs(s2), reward, done, end_info(done, live_ret, t,
                                                        score)


class Maze(OceanEnv):
    """Per-episode procedurally generated maze: wall pillars, start, and goal
    are all drawn at the episode's reset, so a stale procgen draw anywhere
    in the autoreset path shows up as every episode replaying the same maze.
    Walls occupy a random subset of the odd-odd "pillar" cells — a layout
    that can never disconnect the grid (even rows stay fully open), so every
    maze is solvable. Reward per step is the fraction of the initial
    Manhattan distance closed; score = fraction closed by episode end ∈
    [0, 1] (reaching the goal scores 1 regardless of path taken)."""

    def __init__(self, size: int = 7, horizon: int = 24):
        if size % 2 != 1 or size < 5:
            raise ValueError(f"Maze needs an odd size >= 5, got {size}")
        self.size, self.horizon = size, horizon
        self.observation_space = sp.Box((size, size))
        self.action_space = sp.Discrete(5)        # stay, N, S, W, E

    def make_consts(self, device):
        g = self.size
        i = torch.arange(g, device=device)
        # the even-coordinate cells: never walled, where start and goal lie
        even = torch.arange(g // 2 + 1, dtype=I32) * 2
        cells = torch.stack(torch.meshgrid(even, even, indexing="ij"),
                            -1).reshape(-1, 2)
        return {"rows": i[:, None].expand(g, g), "cols": i[None, :].expand(g, g),
                "cells": cells.to(device),
                "moves": torch.tensor(_MOVES, dtype=I32).to(device)}

    def init(self, n, generator):
        dev, g = generator.device, self.size
        cells = self.consts(dev)["cells"]
        p = g // 2                                # pillar grid side
        pillars = torch.rand((n, p, p), generator=generator, device=dev) < 0.5
        walls = torch.zeros((n, g, g), dtype=torch.bool, device=dev)
        walls[:, 1::2, 1::2] = pillars
        k = cells.shape[0]
        start = cells[torch.randint(0, k, (n,), generator=generator,
                                    device=dev)]
        target = cells[torch.randint(0, k, (n,), generator=generator,
                                     device=dev)]
        return {"pos": start, "target": target, "walls": walls,
                "d0": (start - target).abs().sum(-1).int(),
                "t": _zeros(n, I32, dev)}

    def _at(self, c, pos):
        return ((c["rows"] == pos[:, 0, None, None])
                & (c["cols"] == pos[:, 1, None, None]))

    def obs(self, s):
        c = self.consts(s["t"].device)
        grid = torch.where(s["walls"], 0.25, 0.0)
        grid = torch.where(self._at(c, s["target"]), 0.75, grid)
        return torch.where(self._at(c, s["pos"]), 1.0, grid)

    def step(self, state, action, generator):
        g = self.size
        c = self.consts(state["t"].device)
        cand = state["pos"] + _take(c["moves"], action)
        inside = ((cand >= 0) & (cand < g)).all(-1)
        cc = cand.clamp(0, g - 1).long()
        blocked = state["walls"].flatten(1).gather(
            1, (cc[:, 0] * g + cc[:, 1])[:, None])[:, 0]
        pos = torch.where((inside & ~blocked)[:, None], cand, state["pos"])
        d_prev = (state["pos"] - state["target"]).abs().sum(-1)
        d = (pos - state["target"]).abs().sum(-1)
        denom = state["d0"].clamp(min=1).float()
        reward = (d_prev - d).float() / denom
        t = state["t"] + 1
        done = (d == 0) | (t >= self.horizon)
        closed = (state["d0"] - d).float() / denom
        score = torch.where(state["d0"] == 0, 1.0, closed).clamp(0.0, 1.0)
        s2 = {"pos": pos, "target": state["target"], "walls": state["walls"],
              "d0": state["d0"], "t": t}
        return s2, self.obs(s2), reward, done, end_info(done, closed, t,
                                                        score)


class Duel(OceanEnv):
    """Two-player zero-sum grid duel — the Policy League's native workload.

    Both agents race on a g×g grid for a coin; the first to reach it takes
    +1 from the other (simultaneous arrival is a wash) and the coin respawns
    at a fresh draw. A dense shaping term transfers reward for relative
    progress toward the coin, so every step's reward vector sums to exactly
    zero — the defining invariant of a competitive env.

    Roles are symmetric: ``swap_agents`` permutes the agent rows of the
    state, and stepping the swapped state with swapped actions yields the
    swapped outputs (obs/reward rows reversed, same done/coin). Score is
    agent-0-centric: 0.5 + (caps₀ − caps₁) / 2·max(1, caps₀ + caps₁) ∈
    [0, 1], so 0.5 is a tie and "winrate vs opponent" is score > 0.5."""

    num_agents = 2
    SHAPING = 0.05                   # zero-sum per-step progress transfer

    def __init__(self, size: int = 5, horizon: int = 32):
        self.size, self.horizon = size, horizon
        self.observation_space = sp.Box((7,))  # [own ‖ opp ‖ coin ‖ t/H]
        self.action_space = sp.Discrete(5)     # stay, N, S, W, E

    def make_consts(self, device):
        return {"moves": torch.tensor(_MOVES, dtype=I32).to(device)}

    def _cells(self, generator, *shape):
        return torch.randint(0, self.size, shape, generator=generator,
                             device=generator.device, dtype=I32)

    def init(self, n, generator):
        dev = generator.device
        return {"pos": self._cells(generator, n, 2, 2),
                "coin": self._cells(generator, n, 2),
                "caps": _zeros(n, I32, dev, 2),
                "ret": _zeros(n, F32, dev, 2),
                "t": _zeros(n, I32, dev)}

    @staticmethod
    def swap_agents(state):
        """Agent-row permutation of the state — the role-swap symmetry is
        ``step ∘ swap == swap ∘ step`` (with actions permuted too)."""
        return {"pos": state["pos"].flip(1), "coin": state["coin"],
                "caps": state["caps"].flip(1), "ret": state["ret"].flip(1),
                "t": state["t"]}

    def obs(self, s):
        n, g = s["t"].shape[0], float(self.size - 1)
        own = s["pos"].float() / g                                # (N, 2, 2)
        coin = (s["coin"].float() / g)[:, None, :].expand(n, 2, 2)
        tt = (s["t"].float() / self.horizon)[:, None, None].expand(n, 2, 1)
        return torch.cat([own, own.flip(1), coin, tt], dim=-1)    # (N, 2, 7)

    def step(self, state, action, generator):
        g = self.size
        moves = self.consts(state["t"].device)["moves"]
        pos = (state["pos"] + _take(moves, action)).clamp(0, g - 1)
        coin = state["coin"][:, None, :]
        # zero-sum shaping: transfer for relative progress toward the coin
        d_prev = (state["pos"] - coin).abs().sum(-1)
        d_new = (pos - coin).abs().sum(-1)
        prog = (d_prev - d_new).float()                           # (N, 2)
        shaped0 = self.SHAPING * (prog[:, 0] - prog[:, 1])
        # capture: sole arrival takes +1 from the other; both → wash
        on = (pos == coin).all(-1)                                # (N, 2)
        sole = on & ~on.flip(1)
        cap0 = sole[:, 0].float() - sole[:, 1].float()
        r0 = shaped0 + cap0
        reward = torch.stack([r0, -r0], dim=-1)                   # sums to 0
        caps = state["caps"] + sole.int()
        fresh = self._cells(generator, state["t"].shape[0], 2)
        coin2 = torch.where(on.any(-1)[:, None], fresh, state["coin"])
        ret = state["ret"] + reward
        t = state["t"] + 1
        done = t >= self.horizon
        total = (caps[:, 0] + caps[:, 1]).clamp(min=1).float()
        score = (0.5 + (caps[:, 0] - caps[:, 1]).float()
                 / (2.0 * total)).clamp(0.0, 1.0)
        s2 = {"pos": pos, "coin": coin2, "caps": caps, "ret": ret, "t": t}
        return s2, self.obs(s2), reward, done, end_info(done, ret[:, 0], t,
                                                        score)


OCEAN.update(pong=Pong, drone=Drone, tagteam=TagTeam, maze=Maze, duel=Duel)
