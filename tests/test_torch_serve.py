"""The port's serving entry points: sampling, generate, the launcher, and the
guards that keep the port free of JAX and off the CPU unless asked.

Sampling cannot match JAX draw for draw (threefry keys are not torch
generators), so it is compared by distribution: frequencies over many draws
from fixed logits, against the softmax and against ``jax.random.categorical``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import actor

ROOT = Path(__file__).resolve().parents[1]
N_DRAWS = 40_000


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_categorical_matches_softmax_and_jax(temperature):
    logits = np.array([2.0, 0.5, -1.0, 1.0, -1e30, 0.0], np.float32)
    probs = np.exp(logits / temperature - np.max(logits / temperature))
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(0)
    draws = actor.categorical(
        torch.from_numpy(np.tile(logits, (N_DRAWS, 1))) / temperature, gen)
    assert draws.dtype == torch.int32
    freq = np.bincount(draws.numpy(), minlength=len(logits)) / N_DRAWS
    jdraws = jax.random.categorical(
        jax.random.PRNGKey(0), jnp.tile(jnp.asarray(logits) / temperature,
                                        (N_DRAWS, 1)))
    jfreq = np.bincount(np.asarray(jdraws), minlength=len(logits)) / N_DRAWS
    # binomial std <= sqrt(0.25 / 40000) = 0.0025: 0.015 is 6 sigma
    np.testing.assert_allclose(freq, probs, atol=0.015)
    np.testing.assert_allclose(freq, jfreq, atol=0.02)
    assert freq[4] == 0.0                     # a masked entry is never drawn


def _policy():
    return BackbonePolicy(get_smoke_config("qwen3-0.6b"), device="cpu",
                          generator=torch.Generator().manual_seed(0))


def test_prefill_samples_at_temperature_one():
    pol = _policy()
    prompt = torch.randint(0, 512, (4, 6), generator=torch.Generator()
                           .manual_seed(1))
    first = [actor.generate(pol, prompt, 1, torch.Generator().manual_seed(2),
                            temperature=t) for t in (1.0, 1e-3, 50.0)]
    assert all(torch.equal(first[0], f) for f in first[1:])


def test_generate_shapes_and_temperature():
    pol = _policy()
    prompt = torch.randint(0, 512, (3, 5), generator=torch.Generator()
                           .manual_seed(3))
    out = actor.generate(pol, prompt, 6, torch.Generator().manual_seed(4),
                         temperature=0.7)
    assert out.shape == (3, 6) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < 512
    # near-zero temperature decode equals greedy decode after the same prefill
    cold = actor.generate(pol, prompt, 6, torch.Generator().manual_seed(4),
                          temperature=1e-6)
    tok, _, caches = actor.make_prefill_step(pol, 11)(
        prompt, torch.Generator().manual_seed(4))
    greedy = actor.make_serve_step(pol, greedy=True)
    toks = [tok]
    for _ in range(5):
        tok, _, caches = greedy(tok, caches, None)
        toks.append(tok)
    assert torch.equal(cold, torch.cat(toks, 1))


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
        "new = {'repro_torch.checkpoint.ckpt', 'repro_torch.utils.metrics',"
        " 'repro_torch.distributed.fault',"
        " 'repro_torch.distributed.actor_learner',"
        " 'repro_torch.telemetry.spans', 'repro_torch.telemetry.traceprop',"
        " 'repro_torch.telemetry.registry', 'repro_torch.league',"
        " 'repro_torch.league.arena', 'repro_torch.league.ranker',"
        " 'repro_torch.league.selfplay', 'repro_torch.league.store',"
        " 'repro_torch.league.__main__', 'repro_torch.telemetry.http',"
        " 'repro_torch.telemetry.benchwatch',"
        " 'repro_torch.telemetry.__main__',"
        " 'repro_torch.distributed.sharding', 'repro_torch.launch.mesh',"
        " 'repro_torch.distributed.plan', 'repro_torch.envs.conformance',"
        " 'repro_torch.analysis', 'repro_torch.analysis.__main__',"
        " 'repro_torch.analysis.dispatch_audit', 'repro_torch.analysis.lint',"
        " 'repro_torch.analysis.rules', 'repro_torch.analysis.targets'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BackbonePolicy(get_smoke_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    assert tdevice.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve("meta")


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--tokens", "5"],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "tok/s" in r.stdout
    line = [l for l in r.stdout.splitlines()
            if l.startswith("first sequence:")]
    assert len(line) == 1
    assert len(ast.literal_eval(line[0].split(":", 1)[1])) == 5
