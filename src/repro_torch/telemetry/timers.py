"""TierTimer: the SPS / launch / fetch clock of the training engine.

A copy of ``repro/telemetry/timers.py`` without the spans, which come with
the telemetry slice. Every history record carries the same keys:

- ``env_steps`` env interactions done when the record's update ended.
- ``sps``       steps/sec since ``run()`` started.
- ``launch_ms`` host wall time of the most recent launch dispatch.
- ``fetch_ms``  host wall time of the most recent device→host metrics fetch.
"""
from __future__ import annotations

import time

__all__ = ["TierTimer"]


class _Timed:
    """Times a block into ``timer.<attr>`` (ms). Reused across launches;
    not reentrant, which launch/fetch blocks never are."""
    __slots__ = ("_timer", "_attr", "_t0")

    def __init__(self, timer: "TierTimer", attr: str):
        self._timer, self._attr = timer, attr

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        setattr(self._timer, self._attr,
                (time.perf_counter() - self._t0) * 1e3)
        return False


class TierTimer:
    """Per-``run()`` clock."""

    def __init__(self, steps_per_update: int):
        self.spu = int(steps_per_update)
        self.t0 = time.perf_counter()
        self.launch_ms = 0.0
        self.fetch_ms = 0.0
        self._launch = _Timed(self, "launch_ms")
        self._fetch = _Timed(self, "fetch_ms")

    def launch(self) -> _Timed:
        return self._launch

    def fetch(self) -> _Timed:
        return self._fetch

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def sps(self, env_steps: int) -> float:
        return int(env_steps) / max(self.elapsed(), 1e-9)

    def stamp(self, md: dict, env_steps: int) -> dict:
        """Set the unified keys on one history/metrics record in place."""
        md["env_steps"] = int(env_steps)
        md["sps"] = self.sps(env_steps)
        md["launch_ms"] = self.launch_ms
        md["fetch_ms"] = self.fetch_ms
        return md
