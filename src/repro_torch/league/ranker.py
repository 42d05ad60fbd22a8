"""Ranker + opponent samplers — the league's skill model.

A copy of ``repro/league/ranker.py`` (framework-free: numpy only), so the
same seed, ratings and strategy draw the same version sequence in either
package.

``Ranker`` is a standard Elo update over match records ``(a, b, outcome)``
where ``outcome`` is side a's score in [0, 1] (1 win, 0 loss, 0.5 draw).
Elo is what the paper's policy-ranker machinery uses for Neural MMO: it
needs only pairwise outcomes, tolerates noisy matches, and recovers a total
order after enough records — the planted-skill-tier recovery test pins that
property down.

Samplers turn ratings into an opponent curriculum:

  latest       — always the newest snapshot (classic mirror self-play).
  uniform      — every stored version equally likely (league play; prevents
                 strategy collapse / cycling).
  prioritized  — probability decays with rating distance from the learner's
                 current rating, so training time concentrates on peers
                 (the policy-pool analogue of prioritized fictitious
                 self-play).

All samplers are deterministic functions of their seed: the same seed and
the same store state replay the same opponent schedule.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


class Ranker:
    """Elo ratings over policy versions, updated from match outcomes."""

    def __init__(self, ratings: Optional[dict] = None, k: float = 32.0,
                 initial: float = 1000.0):
        self.k, self.initial = float(k), float(initial)
        self.ratings = {int(v): float(r) for v, r in (ratings or {}).items()}

    def rating(self, version) -> float:
        return self.ratings.get(int(version), self.initial)

    def expected(self, a, b) -> float:
        """P(a beats b) under the Elo model."""
        return 1.0 / (1.0 + 10.0 ** ((self.rating(b) - self.rating(a))
                                     / 400.0))

    def update(self, a, b, outcome: float):
        """One match: ``outcome`` is a's score in [0, 1]."""
        ea = self.expected(a, b)
        delta = self.k * (float(outcome) - ea)
        self.ratings[int(a)] = self.rating(a) + delta
        self.ratings[int(b)] = self.rating(b) - delta

    def record(self, records):
        """Apply an iterable of ``(a, b, outcome)`` match records."""
        for a, b, outcome in records:
            self.update(a, b, outcome)

    def rank(self) -> list:
        """Versions sorted best-first (ties broken by newest)."""
        return sorted(self.ratings, key=lambda v: (-self.ratings[v], -v))

    def leaderboard(self) -> str:
        lines = [f"{'rank':>4}  {'version':>7}  {'rating':>8}"]
        for i, v in enumerate(self.rank()):
            lines.append(f"{i + 1:>4}  v{v:<6}  {self.ratings[v]:>8.1f}")
        return "\n".join(lines)


SAMPLER_STRATEGIES = ("latest", "uniform", "prioritized")


class OpponentSampler:
    """Draws opponent versions from a ``PolicyStore`` under a strategy,
    deterministically from ``seed``. ``next_params()`` is the callable the
    TrainEngine's selfplay mode invokes once per launch, at the launch
    boundary; loaded params are cached per version (on ``like``'s device),
    so re-sampling a version costs no I/O and no host-to-device copy."""

    def __init__(self, store, ranker: Ranker, like, *,
                 strategy: str = "prioritized", seed: int = 0,
                 temperature: float = 200.0):
        if strategy not in SAMPLER_STRATEGIES:
            raise ValueError(f"unknown sampler strategy {strategy!r}; "
                             f"expected one of {SAMPLER_STRATEGIES}")
        self.store, self.ranker, self.like = store, ranker, like
        self.strategy, self.temperature = strategy, float(temperature)
        self._rng = np.random.default_rng(seed)
        self._cache = {}
        self.history = []                # sampled versions, in order

    def sample(self) -> int:
        versions = self.store.versions()
        if not versions:
            raise ValueError(f"policy store {self.store.directory!r} is "
                             f"empty; add a snapshot before sampling")
        if self.strategy == "latest":
            v = versions[-1]
        elif self.strategy == "uniform":
            v = int(self._rng.choice(versions))
        else:                            # prioritized by rating proximity
            anchor = self.ranker.rating(versions[-1])
            gaps = np.asarray([abs(self.ranker.rating(v) - anchor)
                               for v in versions])
            w = np.exp(-gaps / self.temperature)
            v = int(self._rng.choice(versions, p=w / w.sum()))
        self.history.append(v)
        return v

    def next_params(self):
        """Sample a version and return its (cached) param tree."""
        v = self.sample()
        if v not in self._cache:
            self._cache[v] = self.store.load(v, self.like)
        return self._cache[v]

    def invalidate(self, version: Optional[int] = None):
        """Drop cached params (all, or one version) — call after external
        writes to the store directory."""
        if version is None:
            self._cache.clear()
        else:
            self._cache.pop(int(version), None)
