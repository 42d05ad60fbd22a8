"""The port's ``repro_torch.analysis``: the AST lint over the hot-step
table (one positive and one negative snippet for each kept rule), its
``noqa`` comments and baseline, a stale table entry, ``--self`` on the
port, and the dispatch audit catching a planted host sync and a planted
f64. BLOCKING-NO-TIMEOUT is the reference's rule as it is: its verdicts
are held to ``repro.analysis``'s on the same snippets."""
import json
import textwrap

import pytest
import torch

from repro_torch.analysis import (HOT_STEPS, RULES, apply_baseline, audit_fn,
                                  audit_kernel_ops, check_source,
                                  load_baseline, save_baseline)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.targets import F64_ALLOWED


def _rules(src, hot=("step",), rules=None):
    return [f.rule for f in check_source(textwrap.dedent(src), "m.py",
                                         rules=rules, hot=hot)]


def test_kept_and_dropped_rules():
    assert set(RULES) == {"HOST-SYNC", "BLOCKING-NO-TIMEOUT",
                          "NONDET-IN-PURE", "TELEMETRY-IN-HOT",
                          "STALE-HOT-STEP"}


# -- HOST-SYNC ----------------------------------------------------------------

SYNCS = {
    ".item()": "r = state['x'].sum().item()",
    ".cpu()": "r = action.cpu()",
    ".tolist()": "r = action.tolist()",
    ".numpy()": "r = action.numpy()",
    "float()": "r = float(action.sum())",
    "int()": "r = int(state['t'][0])",
    "bool()": "r = bool(action.any())",
    "an if": "r = 1 if action.max() > 0 else 0",
    "a branch": "if state['t'].any():\n            r = 1",
    "synchronize": "torch.cuda.synchronize()",
}


@pytest.mark.parametrize("form", list(SYNCS))
def test_host_sync_in_a_hot_step(form):
    src = f"""
    import torch
    def step(state, action, generator):
        {SYNCS[form]}
        return state
    """
    assert _rules(src) == ["HOST-SYNC"]
    assert _rules(src, hot=()) == []          # not a hot step: nothing


def test_host_sync_reaches_helpers_and_nested_functions():
    src = """
    def helper(x):
        return x.item()
    def make():
        def update(ts):
            def inner(y):
                return y.cpu()
            return helper(ts), inner(ts)
        return update
    """
    found = check_source(textwrap.dedent(src), "m.py",
                         hot={"make.update"})
    assert [(f.rule, f.line) for f in found] == [("HOST-SYNC", 3),
                                                ("HOST-SYNC", 7)]


def test_host_sync_negatives():
    src = """
    import torch
    def step(state, action, generator, gamma: float, n: int):
        if action.shape[0] > 1 and action.dim() == 2:
            pass
        if generator is None or len(state) > 2 or 'x' in state:
            pass
        g = float(gamma) + int(n)
        return torch.where(action > 0, action, 0)
    """
    assert _rules(src) == []


# -- BLOCKING-NO-TIMEOUT (the reference's rule as it is) ----------------------

BLOCKING = {
    "queue get": ("import queue\nq = queue.Queue()\nq.get()\n", True),
    "queue get, timeout": ("import queue\nq = queue.Queue()\n"
                           "q.get(timeout=1.0)\n", False),
    "thread join": ("import threading\nt = threading.Thread()\nt.join()\n",
                    True),
    "str join": ("import threading\n','.join(['a'])\n", False),
    "no threads": ("d = {}\nd.get()\n", False),
    "spin_until": ("from x import shm\nshm.spin_until(lambda: True)\n",
                   True),
}


@pytest.mark.parametrize("case", list(BLOCKING))
def test_blocking_no_timeout_matches_the_reference(case):
    from repro.analysis import check_source as jcheck
    src, bad = BLOCKING[case]
    got = _rules(src, hot=(), rules=["BLOCKING-NO-TIMEOUT"])
    want = [f.rule for f in jcheck(src, "m.py",
                                   rules=["BLOCKING-NO-TIMEOUT"])]
    assert got == want == (["BLOCKING-NO-TIMEOUT"] if bad else [])


# -- NONDET-IN-PURE -----------------------------------------------------------

@pytest.mark.parametrize("line,bad", [
    ("x = time.time()", True),
    ("x = random.random()", True),
    ("x = uuid.uuid4()", True),
    ("x = torch.rand(4)", True),
    ("x = action.uniform_()", True),
    ("x = torch.rand(4, generator=generator)", False),
    ("x = action.uniform_(generator=generator)", False),
    ("x = torch.zeros(4)", False),
])
def test_nondet_in_a_hot_step(line, bad):
    src = f"""
    import random, time, uuid
    import torch
    def step(state, action, generator):
        {line}
        return x
    """
    assert _rules(src) == (["NONDET-IN-PURE"] if bad else [])
    assert _rules(src, hot=()) == []


# -- TELEMETRY-IN-HOT ---------------------------------------------------------

def test_telemetry_in_a_hot_step():
    src = """
    from repro_torch.telemetry import span
    def step(state, action, generator):
        with span("env.step"):
            return state
    def run(env):
        with span("run"):
            return env
    """
    found = check_source(textwrap.dedent(src), "m.py", hot={"step"})
    assert [(f.rule, f.line) for f in found] == [("TELEMETRY-IN-HOT", 4)]


# -- noqa, baseline, the table ------------------------------------------------

def test_noqa_and_baseline_round_trip(tmp_path):
    src = textwrap.dedent("""
    def step(state, action, generator):
        a = action.item()  # repro_torch: noqa[HOST-SYNC] — a reason
        b = action.cpu()  # repro_torch: noqa
        c = action.tolist()  # repro_torch: noqa[NONDET-IN-PURE]
        d = action.numpy()  # repro: noqa[HOST-SYNC]
        return a, b, c, d
    """)
    found = check_source(src, "m.py", hot={"step"})
    assert [f.line for f in found] == [5, 6]
    path = tmp_path / "baseline.json"
    save_baseline(found, path)
    assert sum(load_baseline(path).values()) == 2
    assert apply_baseline(found, load_baseline(path)) == []
    # a finding is keyed on its text, not its line: one more line above
    moved = check_source("\n" + src, "m.py", hot={"step"})
    assert apply_baseline(moved, load_baseline(path)) == []
    extra = check_source(src.replace("return", "e = action.cpu()\n    return"),
                         "m.py", hot={"step"})
    assert [f.snippet for f in apply_baseline(extra, load_baseline(path))] \
        == ["e = action.cpu()"]                           # a new finding
    assert len(check_source(src.replace("b = action.cpu()  # repro_torch: "
                                        "noqa", "b = action.cpu()"),
                            "m.py", hot={"step"})) == 3


def test_a_stale_hot_step_entry_is_a_finding(monkeypatch):
    found = check_source("def step(s):\n    return s\n", "m.py",
                         hot={"step", "Renamed.step"})
    assert [f.rule for f in found] == ["STALE-HOT-STEP"]
    assert "Renamed.step" in found[0].message
    # a module of the table that is gone
    monkeypatch.setitem(HOT_STEPS, "repro_torch/rl/gone.py", ("step",))
    assert [f.path for f in cli._missing_hot_modules()] == \
        ["repro_torch/rl/gone.py"]


def test_the_table_covers_every_ocean_step_and_the_tiers():
    from repro_torch.envs.ocean import OCEAN
    steps = set(HOT_STEPS["repro_torch/envs/ocean.py"])
    assert steps == {f"{cls.__name__}.step" for cls in OCEAN.values()}
    assert "TrainEngine._make_act.act" in HOT_STEPS["repro_torch/rl/engine.py"]
    assert "make_serve_step.serve_step" in HOT_STEPS["repro_torch/rl/actor.py"]


def test_self_exits_0_on_the_port(tmp_path, capsys):
    base = json.loads(cli.SELF_BASELINE.read_text())
    assert base["findings"] == {}                     # committed empty
    out = tmp_path / "report.json"
    assert cli.main(["--self", "--device", "cpu", "--format", "json",
                     "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["findings"] == [] and report["grandfathered"] == 0
    assert report["audit"]["violations"] == []
    assert report["audit"]["targets"] == report["audit"]["passed"] >= 20
    counts = {c["target"]: c for c in report["audit"]["counts"]}
    assert all(c["syncs"] == 0 and c["copies"] == 0 for c in counts.values())
    assert counts["kernel:ssd[ref]"]["f64"] > 0                # not hidden
    assert counts["kernel:ssd[ref]"]["allowed"] == \
        F64_ALLOWED["kernel:ssd[ref]"]
    assert counts["engine:jit:launch"]["f64"] == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        cli.main([])


def test_lint_paths_exit_1_on_a_finding(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import queue\nq = queue.Queue()\nq.get()\n")
    assert cli.main([str(bad)]) == 1
    assert "BLOCKING-NO-TIMEOUT" in capsys.readouterr().out
    assert cli.main([str(bad), "--report-only"]) == 0


# -- the dispatch audit -------------------------------------------------------

def test_audit_catches_a_planted_item_and_f64():
    x = torch.randn(8)
    clean = audit_fn(lambda t: torch.where(t > 0, t, 0.0), (x,),
                     name="clean")
    assert clean.ok and clean.syncs == clean.copies == clean.f64 == 0
    item = audit_fn(lambda t: t * t.sum().item(), (x,), name="item")
    assert not item.ok and item.syncs == 1
    assert item.violations[0].check == "host-sync"
    assert "_local_scalar_dense" in item.violations[0].message
    f64 = audit_fn(lambda t: t.double().sum().float(), (x,), name="f64")
    assert [v.check for v in f64.violations] == ["f64-promotion"]
    # an f64 input is no promotion
    assert audit_fn(lambda t: t * 2, (x.double(),), name="in").ok
    raising = audit_fn(lambda t: t.reshape(3), (x,), name="raise")
    assert [v.check for v in raising.violations] == ["run"]


def test_kernel_audit_keeps_coverage(monkeypatch):
    from repro_torch.kernels import dispatch
    monkeypatch.setattr(dispatch, "OPS", dispatch.OPS + ("new_op",))
    res = {r.target: r for r in audit_kernel_ops(device="cpu")}
    assert [v.check for v in res["kernel:new_op[ref]"].violations] == \
        ["coverage"]
    assert res["kernel:ssd[ref]"].ok and res["kernel:ssd[ref]"].f64 > 0
    assert res["kernel:ssd_bwd[ref]"].ok
    assert res["kernel:flash_attention_bwd[ref]"].ok
    assert res["kernel:gae[ref]"].f64 == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        audit_kernel_ops()
