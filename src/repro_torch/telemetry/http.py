"""Live monitoring endpoints: /metrics, /healthz, /spans — stdlib only.

The counterpart of ``repro/telemetry/http.py``, a copy: its sources in the
port are ``TrainEngine.stats`` (the tier, and on the shard_map tier the
world size and the collectives issued), the host pool's stat rows and the
async tier's actor rows, whose ``last_beat_ns`` the /healthz document
reads.

A tiny threaded HTTP server for watching a training run from outside the
process (``curl``, Prometheus scrape, a k8s liveness probe) without
touching the hot path:

  * ``/metrics``  — the registry's Prometheus text exposition plus
    StatSlab-derived per-worker counters from every registered stats
    source (``repro_worker_steps_total{source=...,worker=...}`` lines).
  * ``/healthz``  — JSON per-worker/actor liveness computed from the
    ``last_beat_ns`` slab rows: HTTP 200 while every worker is alive
    (idle, slow-but-beating included), 503 the moment any is dead. A
    worker with a stale beat is labeled ``"stale"`` but does not flip the
    status — that is the "slow vs. dead" distinction the beat rows exist
    to make.
  * ``/spans``    — p50/p99 summary of the live tracer ring (JSON; empty
    object when tracing is off).

Server discipline (what the reference's BLOCKING-NO-TIMEOUT lint checks):
the accept queue is bounded (``request_queue_size``), requests are
serviced by a daemon thread running ``handle_request()`` under the
server's class-level ``timeout`` (bounded poll — never ``serve_forever``,
which blocks unboundedly and the lint rejects), handler threads are
daemonic, and ``close()`` is idempotent. Stats callables run on the
request thread; they must be cheap snapshot reads (``engine.stats`` /
``pool.stats`` are — slab aggregation is one vectorized sum).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Tuple

# import the submodule directly: the package __init__ rebinds the name
# ``registry`` to the accessor *function*, shadowing the module attribute
from repro_torch.telemetry import spans as _spans
from repro_torch.telemetry.registry import registry as _registry_fn

__all__ = ["MetricsServer", "collect_health", "slab_prometheus_lines"]

# beyond this beat age a live worker is labeled "stale" (slow, not dead)
DEFAULT_STALE_AFTER_S = 10.0


def _san(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def slab_prometheus_lines(sources: List[Tuple[str, dict]]) -> List[str]:
    """Prometheus lines from nested stats dicts.

    Walks each source dict for StatSlab aggregates (any mapping with a
    ``per_worker`` field table) and emits one
    ``repro_worker_<field>_total{source="...",worker="i"}`` line per
    worker per field, plus ``repro_stat_<key>{source="..."}`` lines for
    plain numeric leaves at any nesting level.
    """
    lines: List[str] = []

    def walk(prefix: str, d: dict):
        pw = d.get("per_worker")
        if isinstance(pw, dict):
            for field, vals in pw.items():
                if not isinstance(vals, (list, tuple)):
                    continue
                for w, x in enumerate(vals):
                    if isinstance(x, (int, float)):
                        lines.append(
                            f'repro_worker_{_san(field)}_total'
                            f'{{source="{prefix}",worker="{w}"}} {x}')
            return
        for key, val in d.items():
            sub = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, dict):
                walk(sub, val)
            elif isinstance(val, bool):
                lines.append(f'repro_stat_{_san(key)}'
                             f'{{source="{prefix}"}} {int(val)}')
            elif isinstance(val, (int, float)):
                lines.append(f'repro_stat_{_san(key)}'
                             f'{{source="{prefix}"}} {val}')

    for name, stats in sources:
        if isinstance(stats, dict):
            walk(name, stats)
    return lines


def _find_liveness(d: dict, path: str = "") -> List[Tuple[str, dict]]:
    """Every ``liveness`` block (``{"last_beat_ns", "dead", ...}``) in a
    nested stats dict, with its dotted path."""
    found = []
    for key, val in d.items():
        if not isinstance(val, dict):
            continue
        sub = f"{path}.{key}" if path else str(key)
        if key == "liveness" and "last_beat_ns" in val:
            found.append((path, val))
        else:
            found.extend(_find_liveness(val, sub))
    return found


def collect_health(sources: List[Tuple[str, Callable[[], dict]]],
                   stale_after_s: float = DEFAULT_STALE_AFTER_S) -> dict:
    """The /healthz document: per-worker status rows over every liveness
    block every source exposes. ``ok`` is False iff any worker is dead (or
    a source itself raised) — stale/booting workers do not flip it."""
    now = time.time_ns()
    workers = []
    ok = True
    for name, fn in sources:
        try:
            st = fn()
        except Exception as e:   # noqa: BLE001 — a broken source is a finding
            ok = False
            workers.append({"source": name, "worker": None,
                            "status": "source_error",
                            "error": f"{type(e).__name__}: {e}"})
            continue
        if not isinstance(st, dict):
            continue
        for path, live in _find_liveness(st):
            src = f"{name}.{path}" if path else name
            dead = set(live.get("dead") or ())
            beats = live.get("last_beat_ns") or []
            n = max(len(beats), int(live.get("workers") or 0))
            for i in range(n):
                beat = int(beats[i]) if i < len(beats) else 0
                age = (now - beat) / 1e9 if beat > 0 else None
                if i in dead:
                    status = "dead"
                    ok = False
                elif beat == 0:
                    status = "booting"
                elif age is not None and age > stale_after_s:
                    status = "stale"
                else:
                    status = "ok"
                workers.append({"source": src, "worker": i,
                                "status": status,
                                "beat_age_s": (round(age, 3)
                                               if age is not None else None)})
    return {"ok": ok, "checked_ns": now, "workers": workers}


class _Server(ThreadingHTTPServer):
    # bounded accept queue: a scrape storm backs up in the kernel and
    # overflows to connection refused instead of unbounded thread growth
    request_queue_size = 16
    daemon_threads = True
    allow_reuse_address = True
    # bounds each handle_request() poll so the serve loop re-checks the
    # stop flag instead of parking forever on accept
    timeout = 0.5


class MetricsServer:
    """Threaded monitoring server bound to ``127.0.0.1`` (loopback only by
    default — exposing training internals on all interfaces is an explicit
    opt-in via ``host=``). ``port=0`` picks a free ephemeral port; read it
    back from ``self.port``."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 stale_after_s: float = DEFAULT_STALE_AFTER_S):
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()
        self.stale_after_s = float(stale_after_s)
        self._closed = False
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):            # silence per-request noise
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = server.render_metrics().encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/healthz":
                        doc = server.render_health()
                        self._send(200 if doc["ok"] else 503,
                                   json.dumps(doc, indent=2).encode(),
                                   "application/json")
                    elif path == "/spans":
                        body = json.dumps(server.render_spans(),
                                          indent=2).encode()
                        self._send(200, body, "application/json")
                    else:
                        self._send(404, b'{"error": "not found"}',
                                   "application/json")
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — 500, never a hang
                    try:
                        self._send(500, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}).encode(),
                            "application/json")
                    except Exception:
                        pass

        self._srv = _Server((host, int(port)), _Handler)
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name=f"repro-metrics-http:{self.port}")
        self._thread.start()

    # -- sources -----------------------------------------------------------
    def add_source(self, name: str, stats_fn: Callable[[], dict]) -> None:
        """Register (or replace) a stats provider — e.g.
        ``add_source("engine", engine.stats)``. Called on request threads;
        must be a cheap snapshot read."""
        with self._lock:
            self._sources[name] = stats_fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def _snapshot_sources(self) -> List[Tuple[str, Callable[[], dict]]]:
        with self._lock:
            return list(self._sources.items())

    # -- endpoint bodies ---------------------------------------------------
    def render_metrics(self) -> str:
        text = _registry_fn().to_prometheus()
        evaluated = []
        for name, fn in self._snapshot_sources():
            try:
                evaluated.append((name, fn()))
            except Exception:   # noqa: BLE001 — /metrics must always serve
                continue
        lines = slab_prometheus_lines(evaluated)
        if lines:
            text = text + "\n".join(lines) + "\n"
        return text

    def render_health(self) -> dict:
        return collect_health(self._snapshot_sources(),
                              stale_after_s=self.stale_after_s)

    def render_spans(self) -> dict:
        t = _spans.get_tracer()
        if t is None:
            return {}
        return _spans.summarize_records(t.records())

    # -- lifecycle ---------------------------------------------------------
    def _serve(self) -> None:
        while not self._closed:
            try:
                # bounded by _Server.timeout (0.5s poll), so the loop
                # re-checks _closed instead of parking on accept forever
                self._srv.handle_request()
            except Exception:
                if self._closed:
                    return

    def close(self, timeout: float = 2.0) -> None:
        """Idempotent shutdown: stop the serve loop, close the socket,
        join the thread (bounded)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._srv.server_close()
        except Exception:
            pass
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
