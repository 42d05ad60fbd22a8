"""PolicyStore — versioned frozen-policy snapshots over ``checkpoint/ckpt``.

The counterpart of ``repro/league/store.py``, with its on-disk layout: every
snapshot of the learner becomes an immutable, monotonically numbered
*version* with metadata (env step, score at snapshot time, current rating),
one ``step_<v>`` checkpoint directory per version under ``<dir>/policies``,
so a crash mid-save never corrupts the archive (the ckpt commit protocol).

Metadata lives in ``<dir>/league.json``, written atomically (tmp + rename)
so the store survives concurrent readers. Ratings are stored here too: the
store is the single durable artifact of a league — point the arena CLI or a
fresh training run at the directory and everything resumes. A store written
by either package is read by the other (checkpoint leaves are named by key
path), except a conv policy's kernel, which JAX stores HWIO and the port
OIHW. A read that fails raises; the store never re-initialises a version.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.checkpoint import ckpt

INITIAL_RATING = 1000.0


class PolicyStore:
    """Append-only versioned policy archive rooted at ``directory``."""

    def __init__(self, directory: str):
        self.directory = directory
        self.policy_dir = os.path.join(directory, "policies")
        self.index_path = os.path.join(directory, "league.json")
        self._meta = self._read_index()

    # -- index I/O -------------------------------------------------------------
    def _read_index(self) -> dict:
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                return {int(k): v for k, v in json.load(f)["versions"].items()}
        return {}

    def _write_index(self):
        os.makedirs(self.directory, exist_ok=True)
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"versions": {str(k): v
                                    for k, v in sorted(self._meta.items())}},
                      f, indent=1)
        os.replace(tmp, self.index_path)       # atomic

    # -- write path ------------------------------------------------------------
    def add(self, params, *, step: int = 0, score: Optional[float] = None,
            rating: Optional[float] = None) -> int:
        """Snapshot ``params`` (copied to the host at the call) as the next
        version; returns its number. ``rating`` defaults to the current
        latest version's rating (a new snapshot starts where its parent left
        off), or INITIAL_RATING for the first."""
        v = max(self._meta) + 1 if self._meta else 0
        if rating is None:
            rating = (self._meta[max(self._meta)]["rating"] if self._meta
                      else INITIAL_RATING)
        ckpt.save(self.policy_dir, params, step=v, keep=None)
        self._meta[v] = {"step": int(step),
                         "score": None if score is None else float(score),
                         "rating": float(rating)}
        self._write_index()
        return v

    # -- read path -------------------------------------------------------------
    def versions(self) -> list:
        return sorted(self._meta)

    def __len__(self) -> int:
        return len(self._meta)

    def latest(self) -> Optional[int]:
        return max(self._meta) if self._meta else None

    def meta(self, version: int) -> dict:
        return dict(self._meta[int(version)])

    def load(self, version: int, like):
        """Restore one version's params into the structure of ``like`` (a
        param dict: each tensor leaf comes back on that leaf's device)."""
        path = os.path.join(self.policy_dir, f"step_{int(version)}")
        return ckpt.restore(path, like)

    def load_stacked(self, versions, like):
        """Restore K versions stacked along a new leading axis — the arena's
        opponent-pool layout (one batched match over axis 0)."""
        import torch
        trees = [self.load(v, like) for v in versions]
        return _stack(trees, torch.stack)

    # -- ratings ---------------------------------------------------------------
    def ratings(self) -> dict:
        return {v: m["rating"] for v, m in self._meta.items()}

    def set_rating(self, version: int, rating: float):
        self._meta[int(version)]["rating"] = float(rating)
        self._write_index()

    def set_ratings(self, ratings: dict):
        for v, r in ratings.items():
            self._meta[int(v)]["rating"] = float(r)
        self._write_index()


def _stack(trees, stack):
    """Leaf-wise ``stack`` of same-structure nested param dicts."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)
