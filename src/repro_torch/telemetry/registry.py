"""Metrics registry: counters / gauges / histograms with labels.

The registry complements — never replaces — the JSONL ``MetricsLogger``
stream: training metrics (loss, sps, ...) keep flowing through the engine's
per-update records, while the registry holds *operational* counters (dropped
fragments, reshards, checkpoint writes, seqlock retries) that accumulate
across the run and export in one shot.

Concurrency model: instrument handles are cached per ``(name, labels)`` so
hot loops pay one dict lookup once and then plain attribute arithmetic.
Counter/gauge updates are single bytecode-level float ops under the GIL —
racing increments can in principle interleave, which is acceptable for
telemetry (we trade perfect counts for a lock-free hot path); the registry
lock only guards instrument *creation* and ``snapshot()``.

Exports: ``snapshot()`` (plain dict), ``to_prometheus()`` (text exposition
format), and ``emit(logger, step)`` which appends one flattened record to an
existing ``MetricsLogger`` stream.

The counterpart of ``repro/telemetry/registry.py`` (its HTTP endpoints come
with a later slice). torch-free: stdlib only (spawn workers may import this
chain).
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, Iterable, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry",
           "DEFAULT_BUCKETS_MS"]

# generic latency buckets (ms) — callers with known scales pass their own
DEFAULT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      1000.0, 5000.0)


class Counter:
    """Monotonically increasing value. ``inc`` only."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: ``observe(v)`` bisects into ``edges`` (bucket
    ``i`` counts ``v <= edges[i]``; the last bucket is +Inf overflow)."""
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Iterable[float] = DEFAULT_BUCKETS_MS):
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the q-th bucket)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target and c:
                return self.edges[i] if i < len(self.edges) else float("inf")
        return float("inf")


_Key = Tuple[str, str, Tuple[Tuple[str, str], ...]]


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _flat_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Registry:
    """Get-or-create instrument store. Hold the returned handle in hot loops
    — the lookup is cheap but not free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[_Key, object] = {}

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(key, factory())
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, edges: Iterable[float] = DEFAULT_BUCKETS_MS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(edges))

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exports -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict view: {"counters": {...}, "gauges": {...},
        "histograms": {flat_name: {edges, counts, sum, count}}}."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, labels), m in items:
            flat = _flat_name(name, labels)
            if kind == "counter":
                out["counters"][flat] = m.value
            elif kind == "gauge":
                out["gauges"][flat] = m.value
            else:
                out["histograms"][flat] = {
                    "edges": list(m.edges), "counts": list(m.counts),
                    "sum": m.sum, "count": m.count,
                }
        return out

    def flat(self, prefix: str = "") -> dict:
        """Scalars-only flattening (histograms become _count/_sum/_p50/_p99)
        — the shape ``MetricsLogger`` can serialize."""
        snap = self.snapshot()
        out = {}
        for k, v in snap["counters"].items():
            out[prefix + k] = v
        for k, v in snap["gauges"].items():
            out[prefix + k] = v
        for k, h in snap["histograms"].items():
            hist = Histogram(h["edges"])
            hist.counts, hist.sum, hist.count = \
                list(h["counts"]), h["sum"], h["count"]
            out[prefix + k + "_count"] = h["count"]
            out[prefix + k + "_sum"] = h["sum"]
            out[prefix + k + "_p50"] = hist.quantile(0.50)
            out[prefix + k + "_p99"] = hist.quantile(0.99)
        return out

    def emit(self, logger, step: int, prefix: str = "telemetry.") -> None:
        """Append one flattened registry record to an existing
        ``utils.metrics.MetricsLogger`` stream (same JSONL file, extra keys
        namespaced under ``prefix``)."""
        flat = self.flat(prefix)
        if flat:
            logger.log(step, flat)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (metric names sanitized to
        ``[a-zA-Z0-9_]``, labels preserved)."""
        snap = self.snapshot()
        lines = []

        def _san(name: str) -> str:
            return "".join(c if c.isalnum() or c == "_" else "_"
                           for c in name)

        def _split(flat: str):
            """Flat name -> (sanitized base, quoted-label block): the
            exposition format requires ``k="v"``, not the registry's
            bare ``k=v``."""
            if "{" not in flat:
                return _san(flat), ""
            base, rest = flat.split("{", 1)
            pairs = [p.split("=", 1) for p in rest[:-1].split(",") if p]
            inner = ",".join(f'{k}="{v}"' for k, v in pairs)
            return _san(base), "{" + inner + "}"

        for kind, bucket in (("counter", "counters"), ("gauge", "gauges")):
            for flat, v in sorted(snap[bucket].items()):
                base, lbl = _split(flat)
                lines.append(f"# TYPE {base} {kind}")
                lines.append(f"{base}{lbl} {v}")
        for flat, h in sorted(snap["histograms"].items()):
            base, lbl = _split(flat)
            inner = lbl[1:-1] if lbl else ""
            lines.append(f"# TYPE {base} histogram")
            acc = 0
            for edge, c in zip(list(h["edges"]) + ["+Inf"],
                               h["counts"]):
                acc += c
                le = f'le="{edge}"'
                joined = f"{inner},{le}" if inner else le
                lines.append(f"{base}_bucket{{{joined}}} {acc}")
            lines.append(f"{base}_sum{lbl} {h['sum']}")
            lines.append(f"{base}_count{lbl} {h['count']}")
        return "\n".join(lines) + "\n"


_DEFAULT = Registry()


def registry() -> Registry:
    """The process-wide default registry."""
    return _DEFAULT
