"""Run telemetry: the shared launch/fetch/SPS clock (``timers``) and the
host pool's per-worker stat rows (``procstats``, torch-free). Spans, the
metrics registry and the live endpoints come with the telemetry slice."""
from repro_torch.telemetry.timers import TierTimer

__all__ = ["TierTimer"]
