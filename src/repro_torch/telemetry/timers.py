"""TierTimer: the SPS / launch / fetch clock of the training engine.

The counterpart of ``repro/telemetry/timers.py``. Every history record of
every tier carries the same keys:

- ``env_steps`` env interactions done when the record's update ended.
- ``sps``       steps/sec since ``run()`` started, resume-aware (steps done
                in previous runs are subtracted from the numerator).
- ``launch_ms`` host wall time of the most recent launch dispatch.
- ``fetch_ms``  host wall time of the most recent device→host metrics fetch.

``launch()`` / ``fetch()`` return context managers that both time the block
and open the matching span (``engine.launch`` / ``engine.fetch``), so the
Chrome trace and the history records agree by construction. Both are built
once per TierTimer on a ``CachedSpan``: the per-launch loop allocates
nothing, whether tracing is on or off.

torch-free (stdlib only).
"""
from __future__ import annotations

import time

from repro_torch.telemetry.spans import CachedSpan

__all__ = ["TierTimer"]


class _Timed:
    """Times a block into ``timer.<attr>`` (ms) and mirrors it as a span.
    Reused across launches; not reentrant, which launch/fetch blocks never
    are."""
    __slots__ = ("_timer", "_attr", "_span", "_t0")

    def __init__(self, timer: "TierTimer", attr: str, span_name: str):
        self._timer, self._attr = timer, attr
        self._span = CachedSpan(span_name)

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        setattr(self._timer, self._attr,
                (time.perf_counter() - self._t0) * 1e3)
        return self._span.__exit__(et, ev, tb)


class TierTimer:
    """Per-``run()`` clock. ``done_before_steps`` is the env-step count
    already completed by previous (resumed) runs, so a resumed run reports
    the rate of *this* run."""

    def __init__(self, steps_per_update: int, done_before_steps: int = 0):
        self.spu = int(steps_per_update)
        self.done_before = int(done_before_steps)
        self.t0 = time.perf_counter()
        self.launch_ms = 0.0
        self.fetch_ms = 0.0
        self._launch = _Timed(self, "launch_ms", "engine.launch")
        self._fetch = _Timed(self, "fetch_ms", "engine.fetch")

    def launch(self) -> _Timed:
        return self._launch

    def fetch(self) -> _Timed:
        return self._fetch

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def sps(self, env_steps: int) -> float:
        return (int(env_steps) - self.done_before) / max(
            self.elapsed(), 1e-9)

    def stamp(self, md: dict, env_steps: int) -> dict:
        """Set the unified keys on one history/metrics record in place."""
        md["env_steps"] = int(env_steps)
        md["sps"] = self.sps(env_steps)
        md["launch_ms"] = self.launch_ms
        md["fetch_ms"] = self.fetch_ms
        return md
