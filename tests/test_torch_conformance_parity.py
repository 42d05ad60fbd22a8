"""The port's conformance verdicts against the reference's, computed live:
for each of the 13 Ocean envs, the same env name and seed through
``repro.envs.conformance.check_env`` and ``repro_torch.envs.conformance.
check_env`` (on the CPU), check by check, for the eight checks other than
``jit_purity``. The reference's ``jit_purity`` reads a jaxpr through
``jax.core.Jaxpr``, which JAX 0.9 no longer exports, and the port restates
it (no host sync), so it is no parity target; ``tests/test_torch_
conformance.py`` holds the port's own."""
import pytest

from repro.envs import conformance as jconf
from repro.envs.ocean import OCEAN as JOCEAN
from repro_torch.envs import conformance as tconf
from repro_torch.envs.ocean import OCEAN

CHECKS = [c for c in jconf.CHECKS if c != "jit_purity"]


def test_same_envs_and_checks():
    assert sorted(OCEAN) == sorted(JOCEAN)
    assert list(tconf.CHECKS) == list(jconf.CHECKS)
    assert list(tconf.SELFPLAY_CHECKS) == list(jconf.SELFPLAY_CHECKS)
    assert list(tconf.HOST_CHECKS) == list(jconf.HOST_CHECKS)


@pytest.mark.parametrize("name", sorted(JOCEAN))
def test_verdicts_match_the_reference(name):
    want = jconf.check_env(name, seed=0, checks=CHECKS)
    got = tconf.check_env(name, seed=0, checks=CHECKS, device="cpu")
    verdicts = lambda r: {c.name: c.ok for c in r.results}     # noqa: E731
    assert verdicts(got) == verdicts(want), (got.summary(), want.summary())
    assert got.env_name == want.env_name == name


def test_selfplay_verdicts_match_the_reference():
    for name in ("duel", "bandit"):
        want = jconf.check_selfplay_env(name, seed=0)
        got = tconf.check_selfplay_env(name, seed=0, device="cpu")
        assert {c.name: c.ok for c in got.results} == \
            {c.name: c.ok for c in want.results}, name
