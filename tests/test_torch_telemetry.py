"""The rest of the port's telemetry against the JAX package's: the live
monitoring endpoints (``telemetry/http.py``), the bench sentinel
(``telemetry/benchwatch.py``) and the run CLI (``python -m
repro_torch.telemetry``), and the launcher's ``--metrics-port``,
``--profile`` and ``--run-dir`` on the CPU.

The Prometheus lines and the /healthz document are computed by both
packages from the same stats dicts at one fixed clock and must be equal;
the servers run on port 0 over loopback; every bench history is a file
under ``tmp_path``.
"""
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from repro.telemetry import benchwatch as jbench
from repro.telemetry import http as jhttp
from repro_torch import telemetry
from repro_torch.telemetry import __main__ as tcli
from repro_torch.telemetry import benchwatch, http
from repro_torch.telemetry.registry import registry

ROOT = Path(__file__).resolve().parents[1]
HTTP_T = 5.0


def _get(url, timeout=HTTP_T):
    """(status, body bytes): non-2xx statuses returned, not raised."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.disable()
    registry().reset()
    yield
    telemetry.disable()
    registry().reset()


NOW = 1_700_000_000_000_000_000


def _sources():
    live = {"liveness": {"workers": 4, "dead": [3],
                         "last_beat_ns": [NOW - 1_000_000, 0,
                                          NOW - 60_000_000_000, NOW]}}
    return [
        ("engine", {"backend": "shard_map", "world_size": 2, "rank": 0,
                    "all_reduces": 17, "collectives": {"all_reduce": 17,
                                                       "all_gather": 16},
                    "pool": {"workers": 4, "steps": 120, "closed": False,
                             "workers_detail": {
                                 "per_worker": {"steps": [30, 31, 29, 30],
                                                "busy_ns": [5, 6, 7, 8],
                                                "note": "x"},
                                 "total": {"steps": 120}},
                             **live}}),
        ("async", {"rollouts": {"reshards": 1, "dead": [1],
                                "liveness": {"workers": 2, "dead": [1],
                                             "last_beat_ns": [NOW, NOW]},
                                "actors": {"per_worker": {
                                    "fragments": [3, 4]}}}}),
    ]


def test_prometheus_lines_match_the_reference():
    src = _sources()
    got = http.slab_prometheus_lines(src)
    assert got == jhttp.slab_prometheus_lines(src)
    assert 'repro_stat_all_reduces{source="engine"} 17' in got
    assert ('repro_worker_steps_total{source="engine.pool.workers_detail",'
            'worker="2"} 29') in got


def test_health_document_matches_the_reference(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: NOW)
    src = [(n, (lambda d=d: d)) for n, d in _sources()]

    def broken():
        raise RuntimeError("gone")

    src.append(("broken", broken))
    got = http.collect_health(src, stale_after_s=10.0)
    assert got == jhttp.collect_health(src, stale_after_s=10.0)
    assert not got["ok"]
    assert [w["status"] for w in got["workers"]] == [
        "ok", "booting", "stale", "dead", "ok", "dead", "source_error"]


def test_metrics_server_endpoints_and_idempotent_close(tmp_path):
    telemetry.enable(run_dir=str(tmp_path))
    with telemetry.span("op"):
        pass
    registry().counter("engine.updates", tier="shard_map").inc(3)
    srv = http.MetricsServer(port=0)
    try:
        assert srv.host == "127.0.0.1" and srv.port > 0
        srv.add_source("engine", lambda: {
            "backend": "shard_map", "all_reduces": 5,
            "pool": {"liveness": {"workers": 1, "dead": [],
                                  "last_beat_ns": [time.time_ns()]}}})
        code, body = _get(f"{srv.url}/metrics")
        text = body.decode()
        assert code == 200
        assert 'engine_updates{tier="shard_map"} 3' in text
        assert 'repro_stat_all_reduces{source="engine"} 5' in text
        code, body = _get(f"{srv.url}/healthz")
        assert code == 200 and json.loads(body)["ok"]
        srv.add_source("engine", lambda: {"pool": {"liveness": {
            "workers": 2, "dead": [1], "last_beat_ns": [time.time_ns()] * 2}}})
        code, body = _get(f"{srv.url}/healthz")
        assert code == 503
        assert [w["status"] for w in json.loads(body)["workers"]] == [
            "ok", "dead"]
        code, body = _get(f"{srv.url}/spans")
        assert code == 200 and json.loads(body)["op"]["count"] == 1
        assert _get(f"{srv.url}/nope")[0] == 404
        srv.remove_source("engine")
        assert _get(f"{srv.url}/healthz")[0] == 200
    finally:
        srv.close()
    srv.close()                            # a second close is a no-op
    with pytest.raises(urllib.error.URLError):
        _get(f"{srv.url}/metrics", timeout=1.0)


def test_http_module_passes_the_reference_lint():
    from repro.analysis import check_file
    path = ROOT / "src" / "repro_torch" / "telemetry" / "http.py"
    assert [f.rule for f in check_file(path)] == []


# -- benchwatch ---------------------------------------------------------------

def test_benchwatch_records_and_compares_as_the_reference(tmp_path):
    h = str(tmp_path / "hist.jsonl")
    for sps in (900.0, 1000.0, 1100.0, 1005.0):
        benchwatch.record("demo", {"sps": sps, "note": "x"},
                          acceptance={"fast": True}, history=h)
    recs = benchwatch.load_history(h)
    assert len(recs) == 4 and recs[0]["cells"] == {"sps": 900.0}
    assert recs[0]["fingerprint"] == benchwatch.fingerprint() \
        == jbench.fingerprint()
    with open(h, "a") as f:                # a torn tail is skipped
        f.write('{"schema": 1, "bench": "demo"')
    assert benchwatch.load_history(h) == jbench.load_history(h)
    got = benchwatch.compare(h)
    assert got == jbench.compare(h)
    assert got["benches"]["demo"]["cells"]["sps"]["baseline"] == 1000.0
    assert benchwatch.format_report(got) == jbench.format_report(got)


def test_benchwatch_gate(tmp_path):
    h = str(tmp_path / "hist.jsonl")
    benchwatch.record("demo", {"sps": 1000.0}, history=h)
    assert tcli.main(["compare", "--history", h, "--gate"]) == 0  # no base
    benchwatch.record("demo", {"sps": 1020.0}, history=h)
    assert tcli.main(["compare", "--history", h, "--gate"]) == 0
    benchwatch.record("demo", {"sps": 800.0}, history=h)      # -20%
    assert tcli.main(["compare", "--history", h, "--gate"]) == 1
    assert tcli.main(["compare", "--history", h]) == 0        # report only
    (reg,) = benchwatch.compare(h)["regressions"]
    assert reg["cell"] == "sps" and reg["delta_pct"] < -10
    other = dict(benchwatch.load_history(h)[-1], cells={"sps": 1.0},
                 fingerprint={"cores": 9999, "python": "9.9",
                              "platform": "Other"})
    with open(h, "a") as f:
        f.write(json.dumps(other) + "\n")
    assert tcli.main(["compare", "--history", h, "--gate"]) == 0


# -- the launcher's monitoring flags and the run CLI ------------------------------

def test_launcher_monitoring_profile_and_run_cli(tmp_path, capsys):
    """--metrics-port 0, --profile (3 launches) and --run-dir on a CPU run
    of bandit on the shard_map tier: the monitoring line, the
    torch.profiler trace file, then summarize / export-trace on the run
    directory, in this process and through ``python -m``."""
    from repro_torch.launch import train as train_cli
    run, prof = tmp_path / "run", tmp_path / "prof"
    res = train_cli.main(["--ocean", "bandit", "--device", "cpu",
                          "--engine-backend", "shard_map", "--num-envs", "8",
                          "--total-env-steps", str(4 * 8 * 64),
                          "--full-budget", "--ckpt-dir", str(tmp_path / "c"),
                          "--metrics-port", "0", "--run-dir", str(run),
                          "--profile", str(prof), "--profile-launches", "3"])
    out = capsys.readouterr().out
    assert res["bandit"]["env_steps"] == 4 * 8 * 64
    assert "monitoring: http://127.0.0.1:" in out and "/healthz" in out
    assert "all_reduce" in out and "world_size=1" in out
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "engine.run" or e.get("ph") == "X"
               for e in events)
    data = tcli.summarize(str(run))
    assert data["n_span_records"] > 0 and "engine.run" in data["spans"]
    assert data["sps_curve"]["n"] == 4
    n = tcli.export_trace(str(run), str(tmp_path / "trace.json"))
    assert n > 0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for cmd in (["summarize", str(run)], ["export-trace", str(run)]):
        r = subprocess.run([sys.executable, "-m", "repro_torch.telemetry",
                            *cmd], env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
    assert (run / "trace.json").exists()
    assert tcli.main(["summarize", str(tmp_path / "missing")]) == 2
