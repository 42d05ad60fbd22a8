"""Quantised serving in the port (int8 and int4 weights) against the JAX
package.

The same inputs, made with numpy from a seed, go through the JAX function
and the port: ``quant_matmul`` against JAX's ``ref`` and the Pallas body in
interpret mode (the sweep of tests/test_kernels.py, ragged shapes added,
atol = rtol = 1e-4 in f32, 2e-2 in bf16); ``quantize_spec`` and
``quantize_params`` exactly; the int4 layout; and the f32 smoke qwen3 and
mamba2 stacks quantised by JAX's ``quantize_params`` and loaded with
``params_from_jax``. On the CPU the port takes ``ref.quant_matmul``;
tests/test_torch_cuda.py holds the CUDA kernel against it on the card.

JAX dequantises in bf16 (``weight()`` rounds the scale and the product
``w_q · s`` to bf16, whatever the config's dtype); the port's kernel applies
the f32 scale to the f32 sum, as the Pallas kernel does. So the stacks are
compared twice: with every scale rounded to a power of two, where both
packages compute the same products exactly, at the stack tolerance of
tests/test_torch_models.py; and with the scales as ``quantize_params``
makes them, by greedy-token agreement (>= 0.95, as tests/test_models.py
asks of the int8 policy) and a relative error of logits and values of at
most 2^-6: each dequantised weight differs by at most two bf16 roundings
(relative 2^-8 each), and the bound allows twice that through the stack.
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

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.kernels import ref as jref
from repro.kernels.quant_matmul import quant_matmul as jax_pallas_qmm
from repro.models import attention as jattn
from repro.models.params import init_params as jinit
from repro.models.params import param_count as jparam_count
from repro.models.params import quantize_params as jquantize_params
from repro.models.params import quantize_spec as jquantize_spec
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro.rl import actor as jactor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.models import attention as tattn
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tr
from repro_torch.models.convert import params_from_jax, to_torch
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import actor as tactor

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "mamba2-1.3b")
QTYPES = {"int8": (jnp.int8, 127), "int4": (jnp.int4, 7)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STACK_TOL = dict(atol=3e-4, rtol=1e-3)       # tests/test_torch_models.py
REAL_SCALE_REL = 2.0 ** -6


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _qweights(rng, shape, qtype):
    """Random integers in [-qmax, qmax] as a JAX array of the quantised
    dtype and the port's stored tensor (int8, or int4 packed)."""
    qd, qmax = QTYPES[qtype]
    ints = rng.integers(-qmax, qmax + 1, shape).astype(np.int8)
    return jnp.asarray(ints).astype(qd), to_torch(np.asarray(
        jnp.asarray(ints).astype(qd)))


def _x(rng, shape, dtype):
    a = jnp.asarray(rng.standard_normal(shape, np.float32)).astype(dtype)
    return a, to_torch(np.asarray(a))


# -- the kernel's plain version and op ----------------------------------------

QMM_SWEEP = [(32, 64, 128, 16, 32), (64, 128, 128, 64, 64)]  # M,K,N,bm,bk
QMM_RAGGED = [(1, 64, 128), (5, 99, 101), (37, 130, 77)]      # M, K, N


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("M,K,N,bm,bk", QMM_SWEEP)
def test_quant_matmul_matches_jax(M, K, N, bm, bk, qtype, jax_mode):
    rng = np.random.default_rng(M + N)
    xj, x = _x(rng, (M, K), "float32")
    wj, w = _qweights(rng, (K, N), qtype)
    sj = jnp.asarray(np.abs(rng.standard_normal(N, np.float32)) * 0.02)
    s = to_torch(np.asarray(sj))
    want = (jax_pallas_qmm(xj, wj, sj, block_m=bm, block_k=bk,
                           interpret=True)
            if jax_mode == "interpret" else jref.quant_matmul(xj, wj, sj))
    for got in (ref.quant_matmul(x, w, s), tops.quant_matmul(x, w, s),
                quant_matmul(x, w, s)):
        assert got.dtype == torch.float32 and got.shape == (M, N)
        _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("M,K,N", QMM_RAGGED)
def test_quant_matmul_ragged_matches_jax_ref(M, K, N, qtype, dtype):
    """Shapes no block divides (the Pallas kernel asserts that they do),
    odd N packing int4 with a padded last nibble, and a strided x."""
    rng = np.random.default_rng(M * K)
    xj, x = _x(rng, (M, K + 6), dtype)
    xj, x = xj[:, 3:3 + K], x[:, 3:3 + K]
    assert x.stride(0) == K + 6
    wj, w = _qweights(rng, (K, N), qtype)
    assert w.shape == (K, N if qtype == "int8" else (N + 1) // 2)
    sj = jnp.asarray(np.abs(rng.standard_normal(N, np.float32)) * 0.02)
    got = tops.quant_matmul(x, w, to_torch(np.asarray(sj)))
    assert str(got.dtype).endswith(dtype) and got.shape == (M, N)
    tol = TOL[dtype]
    _close(got, jref.quant_matmul(xj, wj, sj), atol=tol, rtol=tol)


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_quant_matmul_transposed_takes_the_scale_on_k(qtype):
    """The tied unembed: x @ (E_q · s).T with E (V, d) and s (d,), as JAX's
    ``unembed`` reads the dequantised table."""
    rng = np.random.default_rng(3)
    V, d = 77, 33                       # an odd d packs int4 with padding
    xj, x = _x(rng, (5, d), "float32")
    ej, e = _qweights(rng, (V, d), qtype)
    sj = jnp.asarray(np.abs(rng.standard_normal(d, np.float32)) * 0.02)
    want = xj @ (ej.astype(jnp.float32) * sj[None, :]).T
    got = tops.quant_matmul(x, e, to_torch(np.asarray(sj)), transposed=True)
    assert got.shape == (5, V)
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_tiled_scale_order_matches_jax_projection(qtype):
    """wq (d, H, hd) carries wq_scale (hd,): flattened to N = H·hd, column
    h·hd + j takes scale[j] (``repeat``). Distinct per-column scales: a
    ``repeat_interleave`` in its place gives another result."""
    jcfg = jax_with_overrides(jax_smoke_config("qwen3-0.6b"),
                              dtype="float32", param_dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    qd = QTYPES[qtype][0]
    spec = jattn.attention_spec(jcfg, 1)
    jp = jquantize_params(jinit(spec, jax.random.PRNGKey(1), jnp.float32),
                          spec, qd)
    tp = {k: to_torch(np.asarray(v)) for k, v in jp.items()}
    hd = cfg.head_dim
    assert tp["wq_scale"].shape == (hd,)
    assert len(set(np.asarray(jp["wq_scale"]).tolist())) == hd
    x = np.random.default_rng(1).standard_normal((2, 3, cfg.d_model),
                                                 np.float32)
    want = jnp.einsum("btd,dhk->bthk", jnp.asarray(x),
                      jp["wq"].astype(jnp.float32) * jp["wq_scale"])
    got = tattn._proj(tp, "wq", torch.from_numpy(x), cfg)
    assert got.shape == (2, 3, cfg.num_heads, hd)
    _close(got, want, atol=1e-5, rtol=1e-5)
    H, n = cfg.num_heads, cfg.num_heads * hd
    w = tp["wq"].reshape(cfg.d_model, -1)
    w = ref.unpack_int4(w, n) if qtype == "int4" else w
    bad = torch.from_numpy(x) @ (w.float() * tp["wq_scale"]
                                 .repeat_interleave(H))
    assert not np.allclose(_np(bad), _np(want.reshape(2, 3, n)),
                           atol=1e-3, rtol=1e-3)


def test_quant_matmul_checks_and_dispatch():
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 6, dtype=torch.int8)
    s = torch.ones(6)
    assert set(dispatch.implementations("quant_matmul")) == {"ref", "cuda"}
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tops.quant_matmul(x, w, s, mode="cuda")
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(x, w.float(), s)
    with pytest.raises(TypeError, match="float32"):
        quant_matmul(x, w, s.double())
    with pytest.raises(TypeError):
        quant_matmul(x.double(), w, s)
    with pytest.raises(ValueError, match="tile"):
        quant_matmul(x, w, torch.ones(4))
    with pytest.raises(ValueError, match="K = 8"):
        quant_matmul(x, w, s, transposed=True)
    with pytest.raises(ValueError, match="2-D"):
        quant_matmul(x[0], w, s)
    with pytest.raises(ValueError, match="quantize"):
        BackbonePolicy(ModelConfig(**dataclasses.asdict(
            jax_smoke_config("qwen3-0.6b"))), device="cpu", quantize="int2")


# -- int4 layout --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 8), (4, 7), (2, 3, 1)])
def test_int4_pack_round_trip_matches_jax_values(shape):
    """JAX's int4 values → ``to_torch`` (packed) → ``unpack_int4``: the
    same integers, two to a byte, low nibble first."""
    ints = np.random.default_rng(len(shape)).integers(-8, 8, shape)
    a = np.asarray(jnp.asarray(ints, jnp.int32).astype(jnp.int4))
    assert a.dtype.name == "int4"
    p = to_torch(a)
    assert p.dtype == torch.uint8
    assert p.shape == shape[:-1] + ((shape[-1] + 1) // 2,)
    np.testing.assert_array_equal(
        ref.unpack_int4(p, shape[-1]).numpy(), a.astype(np.int8))
    lo, hi = (p & 0xF).numpy(), (p >> 4).numpy()
    np.testing.assert_array_equal(lo, (ints[..., 0::2] & 0xF))
    if shape[-1] % 2:
        assert not hi[..., -1].any()     # padded nibble
    torch.testing.assert_close(ref.pack_int4(ref.unpack_int4(p, shape[-1])),
                               p, rtol=0, atol=0)


# -- quantize_spec / quantize_params ------------------------------------------

def _cfgs(arch):
    jcfg = jax_with_overrides(jax_smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    return ModelConfig(**dataclasses.asdict(jcfg)), jcfg


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_spec_matches_jax(arch, qtype):
    cfg, jcfg = _cfgs(arch)
    spec = BackbonePolicy(cfg, device="cpu", quantize=qtype).spec()
    jspec = jquantize_spec(JaxPolicy(jcfg, tp=1).spec(), QTYPES[qtype][0])
    got = {k: v for k, v in _leaves(spec)}
    period = len(jspec["backbone"]["layers"])
    want = {}
    for k, v in _leaves(jspec):
        if ".layers.l" in k:             # unstack (n_periods, ...) leaves
            head, rest = k.split(".layers.l", 1)
            i, name = rest.split(".", 1)
            for p in range(v.shape[0]):
                want[f"{head}.layers.{p * period + int(i)}.{name}"] = \
                    (tuple(v.shape[1:]), v.dtype)
        else:
            want[k] = (tuple(v.shape), v.dtype)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k][0], k
        quantized = want[k][1] == QTYPES[qtype][0]
        assert (v.dtype in (torch.int8, torch.uint8)) == quantized, k
    assert tparams.param_count(spec) == jparam_count(
        JaxPolicy(jcfg, tp=1, quantize=qtype).spec())


@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_matches_jax_exactly(arch, qtype):
    """Integers exact, scales to the bit (0 ulp), from the same float
    parameters."""
    cfg, jcfg = _cfgs(arch)
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    params = jpol.init(jax.random.PRNGKey(2))
    want = params_from_jax(jax.tree.map(np.asarray, jquantize_params(
        params, jpol.spec(), QTYPES[qtype][0])))
    pol = BackbonePolicy(cfg, device="cpu")
    floats = _nest(params_from_jax(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(tparams.quantize_params(floats, pol.spec(), qtype)))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        assert torch.equal(v, want[k]), k
    assert got["backbone.embedding.embed"].dtype == \
        (torch.uint8 if qtype == "int4" else torch.int8)


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_params_from_jax_loads_a_quantised_tree(qtype):
    cfg, jcfg = _cfgs("qwen3-0.6b")
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jq = jax.tree.map(np.asarray, jquantize_params(
        jpol.init(jax.random.PRNGKey(3)), jpol.spec(), QTYPES[qtype][0]))
    pol = BackbonePolicy(cfg, device="cpu", quantize=qtype)
    pol.load_state_dict(params_from_jax(jq), strict=True)
    jl = jq["backbone"]["layers"]["l0"]["attn"]
    assert jl["wq"].dtype.name == qtype and jl["wq_scale"].shape == \
        (cfg.num_layers, cfg.head_dim)
    for i in range(cfg.num_layers):
        got = pol.backbone["layers"][str(i)]["attn"]
        np.testing.assert_array_equal(
            tparams.stored(got["wq"], got["wq_scale"]).numpy(),
            jl["wq"][i].astype(np.int8))
        np.testing.assert_array_equal(got["wq_scale"].numpy(),
                                      jl["wq_scale"][i])
    emb = pol.backbone["embedding"]
    np.testing.assert_array_equal(
        tparams.stored(emb["embed"], emb["embed_scale"]).numpy(),
        jq["backbone"]["embedding"]["embed"].astype(np.int8))
    np.testing.assert_array_equal(
        tparams.stored(pol.value, pol.value_scale).numpy(),
        jq["value"].astype(np.int8))


# -- the quantised stacks -----------------------------------------------------

def _pow2(tree):
    """Every ``*_scale`` leaf rounded to a power of two."""
    return {k: _pow2(v) if isinstance(v, dict) else
            (jnp.asarray(2.0 ** np.round(np.log2(np.asarray(v))),
                         jnp.float32) if k.endswith("_scale") else v)
            for k, v in tree.items()}


_STACKS: dict = {}


def _stack(arch, qtype, scales):
    """(port policy, JAX policy, JAX params) of the f32 smoke ``arch``,
    quantised by JAX's ``quantize_params``; ``scales`` "pow2" or "real"."""
    key = (arch, qtype, scales)
    if key not in _STACKS:
        cfg, jcfg = _cfgs(arch)
        jpol = JaxPolicy(jcfg, tp=1, kernel="ref", quantize=qtype)
        fpol = JaxPolicy(jcfg, tp=1, kernel="ref")
        jq = jquantize_params(fpol.init(jax.random.PRNGKey(5)), fpol.spec(),
                              QTYPES[qtype][0])
        if scales == "pow2":
            jq = _pow2(jq)
        pol = BackbonePolicy(cfg, device="cpu", quantize=qtype)
        pol.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jq)),
                            strict=True)
        _STACKS[key] = (pol, jpol, jq)
    return _STACKS[key]


def _caches_close(tc, jc, cfg):
    assert int(tc.length) == int(jc.length)
    period = len(jc.kv) + len(jc.ssm)
    for i in range(cfg.num_layers):
        key, p = f"l{i % period}", i // period
        if cfg.is_attn_layer(i):
            _close(tc.kv[i].k, jc.kv[key].k[p], **STACK_TOL)
            _close(tc.kv[i].v, jc.kv[key].v[p], **STACK_TOL)
        else:
            # The reference reads conv_w's raw integers (no scale), so the
            # quantised SSM state reaches |h| ~ 4e5 (int8): its f32 sums
            # round at that scale, and the absolute tolerance is taken
            # relative to the state's own magnitude.
            want = _np(jc.ssm[key].state[p])
            _close(tc.ssm[i].conv, jc.ssm[key].conv[p], **STACK_TOL)
            _close(tc.ssm[i].state, want, rtol=STACK_TOL["rtol"],
                   atol=STACK_TOL["atol"] * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantised_stack_matches_jax_with_pow2_scales(arch, qtype):
    """seq, prefill, caches, 4 teacher-forced decode steps and values at
    the stack tolerance: with power-of-two scales both packages compute the
    same products."""
    pol, jpol, jq = _stack(arch, qtype, "pow2")
    cfg = pol.cfg
    B, Tp, S = 2, 19, 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, Tp + 4))
    jlg, jv, _ = jpol.seq(jq, {"tokens": jnp.asarray(toks)})
    tlg, tv, _ = pol.seq(torch.from_numpy(toks))
    _close(tlg, jlg, **STACK_TOL)
    _close(tv, jv, **STACK_TOL)
    jlg, jv, jc = jpol.prefill(jq, {"tokens": jnp.asarray(toks[:, :Tp])}, S)
    tlg, tv, tc = pol.prefill(torch.from_numpy(toks[:, :Tp]), S)
    _close(tlg, jlg, **STACK_TOL)
    _close(tv, jv, **STACK_TOL)
    _caches_close(tc, jc, cfg)
    for t in range(Tp, Tp + 4):
        jlg, jv, jc = jpol.decode(jq, jnp.asarray(toks[:, t:t + 1]), jc)
        tlg, tv, tc = pol.decode(torch.from_numpy(toks[:, t:t + 1]), tc)
        _close(tlg, jlg, **STACK_TOL)
        _close(tv, jv, **STACK_TOL)
    _caches_close(tc, jc, cfg)


def _greedy(pol, jpol, jq, toks, n):
    jlg, _, jc = jpol.prefill(jq, {"tokens": jnp.asarray(toks)},
                              toks.shape[1] + n)
    tlg, _, tc = pol.prefill(torch.from_numpy(toks), toks.shape[1] + n)
    jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tlg, dim=-1).to(torch.int32)[:, None]
    jstep = jax.jit(jactor.make_serve_step(jpol, greedy=True))
    tstep = tactor.make_serve_step(pol, greedy=True)
    jout, tout = [jtok], [ttok]
    for _ in range(n - 1):
        jtok, _, jc = jstep(jq, jtok, jc, jax.random.PRNGKey(0))
        ttok, _, tc = tstep(ttok, tc, None)
        jout.append(jtok)
        tout.append(ttok)
    return torch.cat(tout, 1).numpy(), np.asarray(jnp.concatenate(jout, 1))


@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantised_greedy_tokens_match_jax_with_pow2_scales(arch, qtype):
    pol, jpol, jq = _stack(arch, qtype, "pow2")
    toks = np.random.default_rng(7).integers(0, pol.cfg.vocab_size, (2, 8))
    got, want = _greedy(pol, jpol, jq, toks, 8)
    np.testing.assert_array_equal(got, want)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantised_stack_agrees_with_jax_with_real_scales(arch, qtype):
    """With the scales ``quantize_params`` makes, JAX's bf16 dequant and
    the port's f32 scale differ by bf16 roundings: greedy tokens agree at
    >= 0.95, logits and values within a relative 2^-6."""
    pol, jpol, jq = _stack(arch, qtype, "real")
    V = pol.cfg.vocab_size
    toks = np.random.default_rng(6).integers(0, V, (2, 16))
    jlg, jv, _ = jpol.seq(jq, {"tokens": jnp.asarray(toks)})
    tlg, tv, _ = pol.seq(torch.from_numpy(toks))
    jl, tl = np.asarray(jlg)[..., :V], tlg.numpy()[..., :V]
    assert np.mean(jl.argmax(-1) == tl.argmax(-1)) >= 0.95
    assert _rel(tl, jl) <= REAL_SCALE_REL
    assert _rel(tv, jv) <= REAL_SCALE_REL
    got, want = _greedy(pol, jpol, jq, toks[:, :8], 8)
    assert np.mean(got == want) >= 0.95


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_value_head_reads_the_raw_integers(qtype):
    """The reference dots ``value`` without ``value_scale``
    (repro/models/policy.py:220-221); the port keeps that."""
    pol, jpol, jq = _stack("qwen3-0.6b", qtype, "real")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, pol.cfg.vocab_size, (2, 5)))
    _, tv, _ = pol.seq(toks)
    raw = tparams.stored(pol.value, pol.value_scale).float()
    assert raw.abs().max() == QTYPES[qtype][1]
    hidden, _ = tr.forward(pol.backbone, toks, pol.cfg)
    _close(tv, (hidden @ raw)[..., 0], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_serve_cli_runs_quantised_on_cpu(qtype):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--quantize", qtype,
         "--batch", "2", "--prompt-len", "8", "--tokens", "5"],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"quantize={qtype}" in r.stdout and "tok/s" in r.stdout
