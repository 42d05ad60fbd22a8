"""The Mamba2 block and the SSM and hybrid stacks of the port against JAX.

JAX initialises the parameters; ``params_from_jax`` loads them into the
port; the same token and activation inputs (numpy, from a seed) go through
both. Everything runs in float32 on the CPU, where the port takes the plain
``ref.ssd`` and JAX its ``ref`` backend. Tolerances: 2e-5 for one block,
and atol 3e-4 / rtol 1e-3 for the whole stack — those of
tests/test_models.py::test_decode_consistency (sums in another order).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.models import ssm as jssm
from repro.models.params import init_params as jinit
from repro.models.params import param_count as jparam_count
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro.rl import actor as jactor

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tr
from repro_torch.models.convert import params_from_jax, to_torch
from repro_torch.models.params import param_count
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import actor as tactor

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-1.3b"
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
STACK_TOL = dict(atol=3e-4, rtol=1e-3)


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or LAYER_TOL))


def _tree(params):
    return {k: _tree(v) if isinstance(v, dict) else to_torch(np.asarray(v))
            for k, v in params.items()}


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _f32(jcfg, **kw):
    return jax_with_overrides(jcfg, dtype="float32", param_dtype="float32",
                              **kw)


# -- configuration ------------------------------------------------------------

def test_mamba2_config_matches_jax():
    for get_t, get_j in ((get_config, jax_get_config),
                         (get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get_t(ARCH)) == \
            dataclasses.asdict(get_j(ARCH))
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.d_inner, full.ssm_heads,
            full.ssm_head_dim, full.ssm_state, full.ssm_groups,
            full.ssm_conv, full.ssm_chunk, full.vocab_size,
            full.padded_vocab()) == \
        (48, 2048, 4096, 64, 64, 128, 1, 4, 128, 50280, 50304)
    for arch in ("mamba2-1.3b", "qwen3-0.6b", "jamba-v0.1-52b"):
        jcfg = jax_get_config(arch)
        cfg = _port_cfg(jcfg)
        for prop in ("d_inner", "ssm_heads", "attn_free", "subquadratic"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), (arch, prop)
    assert full.attn_free and full.subquadratic


def test_mamba2_spec_counts_its_parameters_without_allocating():
    cfg = get_config(ARCH)
    n = param_count(tr.transformer_spec(cfg)) + cfg.d_model   # + value head
    assert 1.0e9 <= n <= 1.7e9
    assert n == 1_446_605_824
    assert n == jparam_count(JaxPolicy(jax_get_config(ARCH), tp=1).spec())


# -- the Mamba2 block -----------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_apply_and_decode_match_jax(groups):
    """G = 2 catches a ``repeat`` where ``repeat_interleave`` belongs."""
    jcfg = _f32(jax_smoke_config(ARCH), ssm_groups=groups)
    cfg = _port_cfg(jcfg)
    jp = jinit(jssm.ssm_spec(jcfg), jax.random.PRNGKey(groups), jnp.float32)
    rng = np.random.default_rng(groups)
    # non-zero A_log, D, dt_bias and norm, so each of them is exercised
    for k in ("A_log", "D", "dt_bias", "norm"):
        jp[k] = jnp.asarray(0.3 * rng.standard_normal(jp[k].shape,
                                                      np.float32))
    tp = _tree(jp)
    B, T = 2, 21                       # a ragged last chunk (chunk 16)
    x = rng.standard_normal((B, T, cfg.d_model), np.float32)
    jy, jc = jssm.ssm_apply(jp, jnp.asarray(x), jcfg, kernel="ref",
                            return_cache=True)
    ty, tc = tssm.ssm_apply(tp, torch.from_numpy(x), cfg, return_cache=True)
    _close(ty, jy)
    _close(tc.conv, jc.conv)
    _close(tc.state, jc.state)
    _close(tssm.ssm_apply(tp, torch.from_numpy(x), cfg), jy)
    for _ in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        jy, jc = jssm.ssm_decode(jp, jnp.asarray(x1), jcfg, jc)
        ty, tc = tssm.ssm_decode(tp, torch.from_numpy(x1), cfg, tc)
        _close(ty, jy)
        _close(tc.conv, jc.conv)
        _close(tc.state, jc.state)


def test_init_ssm_cache_matches_jax():
    jcfg = jax_smoke_config(ARCH)
    jc = jssm.init_ssm_cache(jcfg, 3)
    tc = tssm.init_ssm_cache(_port_cfg(jcfg), 3)
    for t, j in zip(tc, jc):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).endswith(str(j.dtype)) and not bool(t.any())


# -- params_from_jax ------------------------------------------------------------

def test_params_from_jax_maps_the_ssm_leaves_bit_exactly():
    jcfg = jax_smoke_config(ARCH)                      # bf16 params
    jparams = JaxPolicy(jcfg, tp=1, kernel="ref").init(jax.random.PRNGKey(4))
    tree = jax.tree.map(np.asarray, jparams)
    pol = BackbonePolicy(get_smoke_config(ARCH), device="cpu")
    pol.load_state_dict(params_from_jax(tree), strict=True)
    jl = tree["backbone"]["layers"]["l0"]["ssm"]
    for i in range(jcfg.num_layers):
        got = pol.backbone["layers"][str(i)]["ssm"]
        for k in ("in_proj", "conv_w", "out_proj"):
            assert jl[k].dtype.name == "bfloat16"
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          jl[k][i].view(np.int16))
        for k in ("A_log", "D", "dt_bias", "norm"):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), jl[k][i])


# -- the whole stack --------------------------------------------------------------

def _pair(jcfg, seed):
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jparams = jpol.init(jax.random.PRNGKey(seed))
    pol = BackbonePolicy(_port_cfg(jcfg), device="cpu")
    pol.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return pol, jpol, jparams


@pytest.fixture(scope="module")
def mamba2():
    """(port policy, JAX policy, JAX params) on the f32 smoke mamba2."""
    return _pair(_f32(jax_smoke_config(ARCH)), 5)


@pytest.fixture(scope="module")
def hybrid():
    """The same on a hybrid stack: JAX's jamba smoke config without
    experts (SSM layers 0 and 2, attention layers 1 and 3, no rope)."""
    return _pair(_f32(jax_smoke_config("jamba-v0.1-52b"), num_experts=0), 6)


def _check_caches(tc, jc, cfg):
    assert int(tc.length) == int(jc.length)
    period = len(jc.kv) + len(jc.ssm)
    for i in range(cfg.num_layers):
        key, p = f"l{i % period}", i // period
        if cfg.is_attn_layer(i):
            assert tc.ssm[i] is None
            _close(tc.kv[i].k, jc.kv[key].k[p], **STACK_TOL)
            _close(tc.kv[i].v, jc.kv[key].v[p], **STACK_TOL)
        else:
            assert tc.kv[i] is None
            _close(tc.ssm[i].conv, jc.ssm[key].conv[p], **STACK_TOL)
            _close(tc.ssm[i].state, jc.ssm[key].state[p], **STACK_TOL)


@pytest.mark.parametrize("stack", ["mamba2", "hybrid"])
def test_prefill_and_decode_match_jax(stack, request):
    pol, jpol, jparams = request.getfixturevalue(stack)
    cfg = pol.cfg
    B, Tp, S = 2, 19, 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, Tp + 4))
    jlg, jv, jc = jpol.prefill(jparams, {"tokens": jnp.asarray(toks[:, :Tp])},
                               S)
    tlg, tv, tc = pol.prefill(torch.from_numpy(toks[:, :Tp]), S)
    assert tlg.shape == (B, cfg.padded_vocab()) and tlg.dtype == torch.float32
    _close(tlg, jlg, **STACK_TOL)
    _close(tv, jv, **STACK_TOL)
    _check_caches(tc, jc, cfg)
    for t in range(Tp, Tp + 4):                   # teacher-forced decode
        jlg, jv, jc = jpol.decode(jparams, jnp.asarray(toks[:, t:t + 1]), jc)
        tlg, tv, tc = pol.decode(torch.from_numpy(toks[:, t:t + 1]), tc)
        _close(tlg, jlg, **STACK_TOL)
        _close(tv, jv, **STACK_TOL)
    _check_caches(tc, jc, cfg)


@pytest.mark.parametrize("stack", ["mamba2", "hybrid"])
def test_seq_matches_jax(stack, request):
    pol, jpol, jparams = request.getfixturevalue(stack)
    toks = np.random.default_rng(6).integers(0, pol.cfg.vocab_size, (2, 35))
    jlg, jv, _ = jpol.seq(jparams, {"tokens": jnp.asarray(toks)})
    tlg, tv, _ = pol.seq(torch.from_numpy(toks))
    _close(tlg, jlg, **STACK_TOL)
    _close(tv, jv, **STACK_TOL)


def test_greedy_decode_matches_jax_tokens(mamba2):
    pol, jpol, jparams = mamba2
    B, Tp, N = 2, 8, 8
    toks = np.random.default_rng(7).integers(0, pol.cfg.vocab_size, (B, Tp))
    jlg, _, jc = jpol.prefill(jparams, {"tokens": jnp.asarray(toks)}, Tp + N)
    tlg, _, tc = pol.prefill(torch.from_numpy(toks), Tp + N)
    jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tlg, dim=-1).to(torch.int32)[:, None]
    jstep = jax.jit(jactor.make_serve_step(jpol, greedy=True))
    tstep = tactor.make_serve_step(pol, greedy=True)
    jout, tout = [jtok], [ttok]
    for _ in range(N - 1):
        jtok, _, jc = jstep(jparams, jtok, jc, jax.random.PRNGKey(0))
        ttok, _, tc = tstep(ttok, tc, None)
        jout.append(jtok)
        tout.append(ttok)
    np.testing.assert_array_equal(torch.cat(tout, 1).numpy(),
                                  np.asarray(jnp.concatenate(jout, 1)))


def test_serve_cli_runs_mamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--tokens", "5"],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "arch=mamba2-1.3b" in r.stdout and "tok/s" in r.stdout
