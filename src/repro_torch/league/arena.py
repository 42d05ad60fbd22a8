"""Evaluation arena — round-robin matches over batched envs on the device.

The counterpart of ``repro/league/arena.py``. A match is a T-step autoreset
rollout of N envs where agent rows [0, L) act under side A's params and
rows [L, A) under side B's, counting completed episodes as wins/draws/losses
from the env's side-A-centric ``score`` (> 0.5 ⇒ A won).

The reference evaluates a K-opponent pool as one ``vmap`` over K keyed
matches. A torch generator cannot be consumed inside ``torch.func.vmap``,
so here the K matches lie on the env axis instead: one match program over
K·N envs, whose noise (env draws and action samples) is drawn once a step
for the whole batch. Only the policy forward differs between the forms:
``vs_pool`` runs the K opponents as one batched pass over stacked weights
(``OceanPolicy.step_stacked``: one batched product a layer), and
``vs_pool_sequential`` runs the same program with one forward pass per
opponent, K dispatches a step. The generator's stream belongs to the K·N
layout, so the two give the same outcomes from the same generator state
(the sequential form is the baseline the batched pass is timed against),
and ``round_robin`` plays every pair i < j the same way. Counts stay on
the device until the match ends; the results come to the host once.

Match records ``(a, b, outcome)`` feed ``ranker.Ranker`` directly;
``outcome`` is the standard match score (wins + draws/2) / episodes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.emulation import Emulated
from repro_torch.core.vector import VecEnv
from repro_torch.telemetry import span as _span

_EPS = 1e-6                           # score == 0.5 within eps ⇒ draw
_KEYS = ("wins_a", "wins_b", "draws", "episodes", "outcome")


def _index(tree, i):
    """Leaf-wise ``x[i]`` of a nested param dict (``i`` an int or index
    tensor)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


class Arena:
    """Evaluation arena for one competitive env + policy architecture.

    ``env`` is a raw batched Ocean env (wrapped in ``Emulated`` here) or an
    already-wrapped one; ``policy``/``dist`` must match the stored params
    (both sides share the learner's architecture). ``learner_agents`` is the
    agent-row split L (default A // 2). A ``random`` side samples from zero
    logits — uniform over discrete actions, a unit Gaussian for continuous
    ones — the league's fixed skill floor. ``device=None`` means CUDA."""

    def __init__(self, env, policy, dist, *, num_envs: int = 16,
                 steps: Optional[int] = None, learner_agents: int = 0,
                 device=None):
        self.em = env if isinstance(env, Emulated) else Emulated(env)
        self.policy, self.dist = policy, dist
        A = self.em.num_agents
        if A < 2:
            raise ValueError(f"arena needs a multi-agent env "
                             f"(num_agents={A}); matches split agent rows "
                             f"between two param sets")
        self.A = A
        self.L = learner_agents or A // 2
        if not 0 < self.L < A:
            raise ValueError(f"learner_agents={self.L} must split "
                             f"num_agents={A} into two non-empty sides")
        self.N = num_envs
        h = int(getattr(self.em.env, "horizon", 32))
        self.steps = steps or 2 * h
        self.device = _device.resolve(device)
        self._vecs = {}

    # -- the match program -------------------------------------------------------
    def _vec(self, k: int) -> VecEnv:
        if k not in self._vecs:
            self._vecs[k] = VecEnv(self.em, k * self.N)
        return self._vecs[k]

    def _forward(self, side, obs, carry, reset, k):
        """Logits and next carry of one side's rows. ``side`` is ``("one",
        params)`` (one param set for every match), ``("stacked", params)``
        (K sets, one batched pass), ``("each", params)`` (K sets, one pass
        each) or ``("random", None)``."""
        kind, params = side
        if kind == "random":
            return torch.zeros((obs.shape[0], self.policy.num_actions),
                               device=obs.device), carry
        if kind == "one":
            logits, _, carry = self.policy.step(params, obs, carry,
                                                reset=reset)
            return logits, carry
        split = lambda x: x.reshape((k, -1) + tuple(x.shape[1:]))
        merge = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        cs = None if carry is None else tuple(map(split, carry))
        if kind == "each":
            outs = [self.policy.step(_index(params, i), split(obs)[i],
                                     None if cs is None
                                     else tuple(c[i] for c in cs),
                                     reset=split(reset)[i])
                    for i in range(k)]
            logits = torch.cat([o[0] for o in outs])
            if carry is None:
                return logits, None
            return logits, tuple(torch.cat(x) for x in
                                 zip(*(o[2] for o in outs)))
        logits, _, cs = self.policy.step_stacked(params, split(obs), cs,
                                                 split(reset))
        return merge(logits), None if cs is None else tuple(map(merge, cs))

    @torch.no_grad()
    def _match(self, side_a, side_b, k: int, generator) -> list:
        """k matches at once, on k·N envs; returns k result dicts."""
        policy, dist, vec = self.policy, self.dist, self._vec(k)
        NN, A, L, dev = k * self.N, self.A, self.L, self.device

        def rows(x, lo, hi):
            e = x.reshape((NN, A) + tuple(x.shape[1:]))[:, lo:hi]
            return e.reshape((NN * (hi - lo),) + tuple(x.shape[1:]))

        state, obs = vec.init(generator)
        ca = policy.initial_carry(NN * L, dev)
        cb = policy.initial_carry(NN * (A - L), dev)
        done_prev = torch.zeros(NN * A, dtype=torch.bool, device=dev)
        counts = torch.zeros((3, k), device=dev)      # wins a, wins b, draws
        for _ in range(self.steps):
            la, ca = self._forward(side_a, rows(obs, 0, L), ca,
                                   rows(done_prev, 0, L), k)
            lb, cb = self._forward(side_b, rows(obs, L, A), cb,
                                   rows(done_prev, L, A), k)
            act_a, act_b = dist.sample(generator, la), dist.sample(generator,
                                                                   lb)
            action = torch.cat(
                [act_a.reshape((NN, L) + tuple(act_a.shape[1:])),
                 act_b.reshape((NN, A - L) + tuple(act_b.shape[1:]))],
                dim=1).reshape((NN * A,) + tuple(act_a.shape[1:]))
            state, obs, _, done_prev, info = vec.step(state, action,
                                                      generator)
            v = info["valid"].float().reshape(k, self.N)
            s = info["score"].reshape(k, self.N)
            counts += torch.stack([(v * (s > 0.5 + _EPS)).sum(-1),
                                   (v * (s < 0.5 - _EPS)).sum(-1),
                                   (v * ((s - 0.5).abs() <= _EPS)).sum(-1)])
        wa, wb, dr = counts
        ep = wa + wb + dr
        out = torch.stack([wa, wb, dr, ep,
                           (wa + 0.5 * dr) / ep.clamp(min=1.0)], dim=-1)
        return [dict(zip(_KEYS, r)) for r in out.tolist()]

    # -- public API ----------------------------------------------------------------
    def play(self, params_a, params_b, generator) -> dict:
        """One match; returns host floats."""
        with _span("arena.play"):
            return self._match(("one", params_a), ("one", params_b), 1,
                               generator)[0]

    def play_random(self, params_a, generator) -> dict:
        """Side A vs the random-policy baseline (zero logits)."""
        return self._match(("one", params_a), ("random", None), 1,
                           generator)[0]

    def vs_pool(self, params_a, stacked_b, generator) -> list:
        """Side A vs a K-stacked opponent pool in one batched pass; returns
        K per-opponent result dicts."""
        with _span("arena.vs_pool"):
            return self._match(("one", params_a), ("stacked", stacked_b),
                               _first_leaf(stacked_b).shape[0], generator)

    def vs_pool_sequential(self, params_a, stacked_b, generator) -> list:
        """The same matches with one forward pass per opponent (K
        dispatches a step) — the baseline the batched pass is timed
        against; identical outcomes from the same generator state."""
        return self._match(("one", params_a), ("each", stacked_b),
                           _first_leaf(stacked_b).shape[0], generator)

    def round_robin(self, stacked, versions, generator) -> list:
        """All ordered pairs i < j of a K-stacked param set as ONE batched
        match program. Returns ``(versions[i], versions[j], outcome_ij)``
        match records ready for ``Ranker.record``."""
        K = _first_leaf(stacked).shape[0]
        if K != len(versions):
            raise ValueError(f"stacked leading axis {K} != "
                             f"len(versions) {len(versions)}")
        ii, jj = np.triu_indices(K, k=1)
        if len(ii) == 0:
            return []
        with _span("arena.round_robin"):
            dev = _first_leaf(stacked).device
            side_a = _index(stacked, torch.as_tensor(ii, device=dev))
            side_b = _index(stacked, torch.as_tensor(jj, device=dev))
            res = self._match(("stacked", side_a), ("stacked", side_b),
                              len(ii), generator)
        return [(versions[i], versions[j], r["outcome"])
                for i, j, r in zip(ii, jj, res)]

