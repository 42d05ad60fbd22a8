"""Run telemetry: spans, the metrics registry, cross-process trace merging,
the shared launch/fetch/SPS clock (``timers``) and the per-worker stat rows
(``procstats``). The counterpart of ``repro/telemetry``. The live HTTP
endpoints (``http``), the bench sentinel (``benchwatch``) and the CLI
(``python -m repro_torch.telemetry``) are imported on demand, not here.

Everything here is torch-free (stdlib + numpy): the host pool's spawned
workers import this chain and never import torch.
"""
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            Registry, registry)
from repro_torch.telemetry.spans import (CachedSpan, SpanRecord, Tracer,
                                         chrome_trace, clock_offset_ns,
                                         disable, enable, enabled, flush,
                                         get_tracer, span, summarize_records)
from repro_torch.telemetry.timers import TierTimer

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "registry",
    "CachedSpan", "SpanRecord", "Tracer", "chrome_trace", "clock_offset_ns",
    "disable", "enable", "enabled",
    "flush", "get_tracer", "span", "summarize_records",
    "TierTimer",
]
