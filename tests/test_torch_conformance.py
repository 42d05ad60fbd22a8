"""The port's conformance harness (``repro_torch/envs/conformance.py``):
every Ocean env passes, and deliberately broken envs — the reference's
``tests/test_conformance.py`` cases, written on the port's batched torch
envs — are caught by the check they break. The reference's trace-failure,
retrace and host-callback-in-a-branch cases have no torch meaning as
written; each maps onto the restated ``jit_purity`` (no host sync in
init, reset or step): a ``float()`` of a live value, an ``if`` on a tensor,
and a host round trip of the reward. The five sync forms are each caught
on the CPU, where ``.tolist()``, ``.numpy()`` and ``.cpu()`` dispatch no
syncing op."""
import numpy as np
import pytest
import torch

from repro_torch.envs.conformance import (CHECKS, HOST_CHECKS,
                                          SELFPLAY_CHECKS, ConformanceReport,
                                          check_env, check_host_env,
                                          check_selfplay_env, run_cli)
from repro_torch.envs.ocean import (OCEAN, Bandit, Duel, Maze, Multiagent,
                                    Squared)

CPU = dict(device="cpu")


# -- the registry suite -------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OCEAN))
def test_registry_env_conforms(name):
    report = check_env(name, **CPU)
    assert report.ok, "\n" + report.summary()
    assert [r.name for r in report.results] == list(CHECKS)


def test_report_summary_readable():
    s = check_env("bandit", **CPU).summary()
    assert "bandit" in s and "OK" in s and "[pass] jit_purity" in s


def test_check_subset_and_instance():
    report = check_env(Bandit(), checks=["determinism", "score_bounds"],
                       **CPU)
    assert report.ok and len(report.results) == 2
    assert report.env_name == "Bandit"


def test_the_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_env("bandit")


# -- broken envs must be caught -----------------------------------------------

class _Wrapped:
    """Pass-through base: subclass and break one invariant."""

    def __init__(self, env):
        self._env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.num_agents = env.num_agents
        self.horizon = getattr(env, "horizon", 64)

    def init(self, n, generator):
        return self._env.init(n, generator)

    def reset(self, state, generator):
        return self._env.reset(state, generator)

    def step(self, state, action, generator):
        return self._env.step(state, action, generator)


def _violations(report: ConformanceReport, check: str):
    return next(r for r in report.results if r.name == check).violations


def test_catches_unnormalized_score():
    class BadScore(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            return s, obs, rew, done, dict(info,
                                           score=info["score"] * 10.0 + 5.0)

    report = check_env(BadScore(Bandit()), **CPU)
    assert not report.ok
    assert any("outside [0, 1]" in v
               for v in _violations(report, "score_bounds"))


def test_catches_nondeterministic_step():
    class Impure(_Wrapped):
        def step(self, state, action, generator):
            # host-side RNG leaking into the obs: same (state, action,
            # generator state) gives different outputs
            s, obs, rew, done, info = super().step(state, action, generator)
            return s, obs + float(np.random.randn()), rew, done, info

    report = check_env(Impure(Bandit()), checks=["determinism"], **CPU)
    assert not report.ok
    assert any("not deterministic" in v
               for v in _violations(report, "determinism"))


# the reference's trace failure, retrace and host callback in a branch, and
# the five sync forms: each a host sync inside step
SYNCS = {
    "trace failure: float() of a live value":
        lambda s, a, rew: rew if float(a.sum()) > -1e9 else rew,
    "retrace: an if on a tensor":
        lambda s, a, rew: rew * 2 if (s["t"] > 1e9).any() else rew,
    "host callback in a branch: the reward round-trips the host":
        lambda s, a, rew: torch.as_tensor(np.asarray(rew)),
    ".item()": lambda s, a, rew: rew + 0 * a.sum().item(),
    "an if on a tensor": lambda s, a, rew: rew if a.max() >= 0 else -rew,
    ".tolist()": lambda s, a, rew: torch.tensor(rew.tolist()),
    ".numpy()": lambda s, a, rew: torch.from_numpy(rew.numpy().copy()),
    ".cpu()": lambda s, a, rew: rew.cpu(),
}


@pytest.mark.parametrize("form", list(SYNCS))
def test_catches_a_host_sync_in_step(form):
    class Syncing(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            return s, obs, SYNCS[form](state, action, rew), done, info

    report = check_env(Syncing(Bandit()), checks=["jit_purity"], **CPU)
    assert not report.ok
    assert any("step makes host syncs" in v
               for v in _violations(report, "jit_purity"))


def test_catches_a_host_sync_in_reset_and_a_raise():
    class SyncingReset(_Wrapped):
        def reset(self, state, generator):
            s, obs = super().reset(state, generator)
            return s, obs + 0 * len(obs.nonzero())

    report = check_env(SyncingReset(Squared()), checks=["jit_purity"], **CPU)
    assert any("reset makes host syncs" in v and "nonzero" in v
               for v in _violations(report, "jit_purity"))

    class Raising(_Wrapped):
        def step(self, state, action, generator):
            raise RuntimeError("boom")

    report = check_env(Raising(Bandit()), checks=["jit_purity"], **CPU)
    assert any("failed" in v and "boom" in v
               for v in _violations(report, "jit_purity"))


def test_catches_dtype_drift_as_instability():
    """The reference's retrace case as written: the returned state's dtype
    differs from the input's. Eager torch does not retrace; the stability
    check sees the state's signature change."""
    class DtypeDrift(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            return dict(s, t=s["t"].float()), obs, rew, done, info

    report = check_env(DtypeDrift(Bandit()), checks=["stability"], **CPU)
    assert any("another shape/dtype signature" in v
               for v in _violations(report, "stability"))


def test_catches_shape_instability():
    class Unstable(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            t = int(state["t"][0])      # obs grows with t
            return s, torch.cat([obs] * (t + 1), dim=-1), rew, done, info

    report = check_env(Unstable(Bandit()), checks=["stability"], **CPU)
    assert not report.ok


def test_catches_coupled_batch_rows():
    """A step that shifts the obs by a mean over the batch couples the envs:
    the restated vmap_purity sees env 0's row move with the other rows'
    states (mazes drawn from another generator)."""
    class Coupled(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            shift = sum(v.float().mean() for v in state.values())
            return s, obs + shift, rew, done, info

    report = check_env(Coupled(Maze()), checks=["vmap_purity"], **CPU)
    assert any("coupled" in v for v in _violations(report, "vmap_purity"))
    assert check_env(Maze(), checks=["vmap_purity"], **CPU).ok


def test_catches_the_last_row_coupled_to_the_first():
    """Only the last env's obs reads env 0's state: vmap_purity holds every
    row, not only row 0, against the other rows' states."""
    class LastReadsFirst(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            row0 = torch.cat([v[0].float().flatten()
                              for v in state.values()])
            first = row0 @ torch.arange(1.0, len(row0) + 1)
            obs = torch.cat([obs[:-1], obs[-1:] + first])
            return s, obs, rew, done, info

    report = check_env(LastReadsFirst(Maze()), checks=["vmap_purity"], **CPU)
    assert any("envs [3]" in v for v in _violations(report, "vmap_purity"))


def test_catches_agent_axis_scramble():
    class Scrambled(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            # the agent axis flattened away
            return (s, obs.reshape(obs.shape[0], -1), rew.sum(-1), done,
                    info)

    report = check_env(Scrambled(Multiagent()), checks=["agent_axis"], **CPU)
    assert not report.ok
    vs = "\n".join(_violations(report, "agent_axis"))
    assert "num_agents" in vs and "reward shape" in vs


def test_catches_stale_procgen_generator():
    class StaleInit(_Wrapped):
        def init(self, n, generator):
            # ignores the episode's generator: every maze is the same maze
            g = torch.Generator(device=generator.device).manual_seed(1234)
            return self._env.init(n, g)

    # init is generator-independent, which reads as a static env: passes
    assert check_env(StaleInit(Maze()), checks=["procgen_keys"], **CPU).ok

    class StaleReset(_Wrapped):
        def reset(self, state, generator):
            g = torch.Generator(device=generator.device).manual_seed(1234)
            return self._env.reset(state, g)

    report = check_env(StaleReset(Maze()), checks=["procgen_keys"], **CPU)
    assert not report.ok
    assert any("stale" in v for v in _violations(report, "procgen_keys"))


def test_catches_never_terminating_env():
    class Endless(_Wrapped):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            return s, obs, rew, torch.zeros_like(done), info

    report = check_env(Endless(Bandit()), checks=["autoreset",
                                                  "score_bounds"], **CPU)
    assert not _violations(report, "autoreset") == ()
    assert not report.ok


def test_check_that_raises_is_reported_not_crashed():
    class Exploding(_Wrapped):
        def init(self, n, generator):
            raise RuntimeError("boom")

    report = check_env(Exploding(Bandit()), **CPU)
    assert not report.ok
    assert any("boom" in v or "RuntimeError" in v
               for v in report.violations)


# -- selfplay (competitive-env) profile ---------------------------------------

class _Duel(_Wrapped):
    def __init__(self):
        super().__init__(Duel())
        self.swap_agents = self._env.swap_agents


def test_duel_passes_selfplay_profile():
    report = check_selfplay_env("duel", **CPU)
    assert report.ok, "\n" + report.summary()
    assert [r.name for r in report.results] == list(SELFPLAY_CHECKS)
    assert report.env_name == "selfplay/duel"


def test_selfplay_profile_catches_broken_zero_sum():
    class LeakyDuel(_Duel):
        def step(self, state, action, generator):
            s, obs, rew, done, info = self._env.step(state, action,
                                                     generator)
            return s, obs, rew + 0.01, done, info       # both rows gain

    report = check_selfplay_env(LeakyDuel(), **CPU)
    assert not report.ok
    assert any("zero-sum" in v for v in _violations(report, "zero_sum"))


def test_selfplay_profile_catches_role_asymmetry():
    class HomeAdvantageDuel(_Duel):
        def step(self, state, action, generator):
            s, obs, rew, done, info = self._env.step(state, action,
                                                     generator)
            bonus = torch.tensor([0.01, -0.01])         # row 0 favoured
            return s, obs, rew + bonus, done, info

    report = check_selfplay_env(HomeAdvantageDuel(), **CPU)
    assert not report.ok
    assert any("row-reversed reward" in v
               for v in _violations(report, "role_swap"))


def test_selfplay_profile_requires_swap_agents():
    report = check_selfplay_env(_Wrapped(Duel()), **CPU)
    assert any("swap_agents" in v for v in _violations(report, "role_swap"))


def test_selfplay_profile_catches_per_agent_done():
    class PerAgentDone(_Duel):
        def step(self, state, action, generator):
            s, obs, rew, done, info = self._env.step(state, action,
                                                     generator)
            return s, obs, rew, torch.stack([done, done], -1), info

    report = check_selfplay_env(PerAgentDone(), **CPU)
    assert any("episode-scoped scalar done" in v
               for v in _violations(report, "team_done"))


def test_selfplay_profile_rejects_single_agent_env():
    report = check_selfplay_env("bandit", **CPU)
    assert any("multi-agent" in v for v in _violations(report, "zero_sum"))


def test_selfplay_cli_lane(capsys):
    assert run_cli("duel", selfplay=True, device="cpu") == 0
    assert "selfplay/duel: OK" in capsys.readouterr().out


# -- the host profile ---------------------------------------------------------

@pytest.mark.parametrize("backend", ["thread", "proc"])
def test_host_profile_passes_on_two_envs(backend, capsys):
    assert run_cli("bandit,team", host=True, host_backend=backend) == 0
    out = capsys.readouterr().out
    assert f"host/bandit[{backend}]: OK" in out
    assert f"host/team[{backend}]: OK" in out


def test_host_profile_catches_an_async_wrapper():
    from repro_torch.bridge import wrap
    from repro_torch.envs.ocean_host import HostBandit
    report = check_host_env(lambda: wrap(HostBandit, num_envs=4,
                                         batch_size=2),
                            checks=["host_protocol"])
    assert any("sync wrapper" in v
               for v in _violations(report, "host_protocol"))
    assert list(HOST_CHECKS) == ["host_protocol", "host_stability",
                                 "host_autoreset", "host_determinism"]


# -- the launcher -------------------------------------------------------------

def test_launcher_conformance_lane(capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as e:
        train.main(["--ocean", "bandit,duel", "--conformance", "--device",
                    "cpu"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "bandit: OK" in out and "duel: OK" in out
    with pytest.raises(SystemExit) as e:
        train.main(["--ocean", "duel", "--conformance", "--selfplay",
                    "--device", "cpu"])
    assert e.value.code == 0
    assert "selfplay/duel: OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        train.main(["--conformance", "--device", "cpu"])
    assert e.value.code == 2


def test_module_cli_exits_1_on_a_violation(monkeypatch, capsys):
    from repro_torch.envs import conformance, ocean

    class Broken(Bandit):
        def step(self, state, action, generator):
            s, obs, rew, done, info = super().step(state, action, generator)
            return s, obs, rew + 0 * float(rew.sum()), done, info

    monkeypatch.setitem(ocean.OCEAN, "broken", Broken)
    assert conformance.main(["broken", "--device", "cpu"]) == 1
    assert "broken: VIOLATIONS" in capsys.readouterr().out


def test_report_carries_the_lint_findings_of_the_env_class():
    """The static half: the env class's own step, linted as a hot step,
    shows a host sync that the runtime check also finds."""
    report = check_env(_SyncingStep(Bandit()), checks=["determinism"], **CPU)
    assert report.ok
    assert [f.rule for f in report.static_findings] == ["HOST-SYNC"]
    assert "static analysis (informational, 1 finding(s)" in report.summary()
    assert check_env("bandit", checks=["determinism"],
                     **CPU).static_findings == ()


class _SyncingStep(_Wrapped):
    def step(self, state, action, generator):
        s, obs, rew, done, info = super().step(state, action, generator)
        return s, obs, rew * float(rew.sum() >= 0), done, info
