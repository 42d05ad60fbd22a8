"""The port's Mixture-of-Experts (``models/moe.py``) against the JAX package.

JAX initialises the MoE parameters at the reference's smoke configs
(jamba: 4 experts top-2, dbrx: top-2 of its smoke 4, llama4: top-1); the
same numpy activations go through ``repro.models.moe.moe_apply`` and the
port's, on the CPU in float32 (and bfloat16 for one case). The routing is
compared itself: the router's probabilities, each token's experts (ties to
the lower index, as ``jax.lax.top_k`` breaks them), their gates, each
pair's place in its expert's queue and so which pairs the capacity drops,
all from the reference's own lines (``_jax_routing``). Tolerances: outputs
and gradients at atol = rtol = 2e-5 in f32 (the sums of
tests/test_torch_models.py's single layer), 2e-2 in bf16; the aux loss at
rtol 1e-6; the routing exactly. Quantised experts (int8, int4) take
power-of-two scales, so that JAX's bf16 dequantisation and the port's f32
scale on the f32 sum compute the same products, at the stack tolerance of
tests/test_torch_quant.py (atol 3e-4, rtol 1e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.models import moe as jmoe
from repro.models.params import init_params as jinit
from repro.models.params import quantize_params as jquantize_params

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import to_torch

ARCHS = ("jamba-v0.1-52b", "dbrx-132b", "llama4-maverick-400b-a17b")
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
STACK_TOL = dict(atol=3e-4, rtol=1e-3)        # tests/test_torch_quant.py
QTYPES = {"int8": jnp.int8, "int4": jnp.int4}


def _cfgs(arch, dtype="float32", **kw):
    jcfg = jax_with_overrides(jax_smoke_config(arch), dtype=dtype,
                              param_dtype=dtype, **kw)
    return ModelConfig(**dataclasses.asdict(jcfg)), jcfg


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x)
                      else x, np.float32)


def _tree(params):
    return {k: _tree(v) if isinstance(v, dict) else to_torch(np.asarray(v))
            for k, v in params.items()}


def _params(jcfg, seed, dtype):
    return jinit(jmoe.moe_spec(jcfg), jax.random.PRNGKey(seed),
                 jnp.dtype(dtype))


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype)


def _jax_routing(params, x, jcfg):
    """The reference's routing, line for line (repro/models/moe.py:64-86):
    (probs, gate, eidx, pos, keep)."""
    Bg, S, _ = x.shape
    E, k = jcfg.num_experts, jcfg.top_k
    logits = jnp.einsum("gsd,de->gse", x, params["router"].astype(x.dtype)
                        ).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(eidx, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot.reshape(Bg, S * k, E), axis=1) - 1
    pos = jnp.take_along_axis(pos, eidx.reshape(Bg, S * k, 1),
                              axis=-1)[..., 0].reshape(Bg, S, k)
    return probs, gate, eidx, pos, pos < jmoe.capacity(jcfg, S)


def _check(cfg, jcfg, jp, x, tol):
    """moe_apply's output and aux, and the routing, against JAX."""
    tp, tx = _tree(jp), to_torch(np.asarray(x))
    want, jaux = jmoe.moe_apply(jp, x, jcfg)
    got, aux = tmoe.moe_apply(tp, tx, cfg)
    assert got.dtype == tx.dtype and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    probs, gate, eidx, pos, keep = _jax_routing(jp, x, jcfg)
    tprobs, tgate, teidx = tmoe.route(tp, tx, cfg)
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(eidx))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tgate.numpy(), np.asarray(gate), rtol=1e-5,
                               atol=1e-7)
    tpos = tmoe.place(teidx, cfg.num_experts)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(
        (tpos < tmoe.capacity(cfg, x.shape[1])).numpy(), np.asarray(keep))
    # a token whose every choice was dropped comes back as zeros
    gone = ~np.asarray(keep).any(-1)
    assert not np.abs(_np(got)[gone]).any()
    return np.asarray(keep)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [1, 16, 40])
def test_moe_apply_matches_jax(arch, S):
    """Decode (S = 1: C = 8, nothing dropped), S = 16 and S = 40 (C 12
    and 28 at top-2, 8 at top-1). At these balanced random routers the
    capacity seldom binds; the next tests force drops."""
    cfg, jcfg = _cfgs(arch)
    jp = _params(jcfg, 1, "float32")
    x = _x((3, S, cfg.d_model), S, jnp.float32)
    keep = _check(cfg, jcfg, jp, x, TOL["float32"])
    if S == 1:
        assert keep.all()


def test_capacity_matches_jax_and_drops_at_jambas_prefill():
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch)
        for S in (1, 2, 7, 16, 40, 100, 512, 4096):
            assert tmoe.capacity(cfg, S) == jmoe.capacity(jcfg, S)
    from repro_torch.configs import get_config
    jamba = get_config("jamba-v0.1-52b")
    assert tmoe.capacity(jamba, 1) == 8             # decode: 16 per expert
    assert tmoe.capacity(jamba, 512) == 80          # prefill: 1024 pairs


def test_moe_apply_drops_at_half_capacity():
    """capacity_factor 0.5: C = 12 at S 40 (80 pairs, top-2 of 4), so that
    experts overflow and whole tokens drop."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b", capacity_factor=0.5)
    jp = _params(jcfg, 2, "float32")
    keep = _check(cfg, jcfg, jp, _x((2, 40, cfg.d_model), 3, jnp.float32),
                  TOL["float32"])
    assert 0 < keep.sum() < keep.size
    assert (~keep.any(-1)).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_breaks_ties_to_the_lower_expert(arch):
    """A zero router ties every expert (probabilities exactly 1/E): every
    token goes to experts 0..k-1 with equal gates, and all but each
    group's first C tokens are dropped."""
    cfg, jcfg = _cfgs(arch)
    jp = _params(jcfg, 3, "float32")
    jp["router"] = jnp.zeros_like(jp["router"])
    S = 24
    keep = _check(cfg, jcfg, jp, _x((2, S, cfg.d_model), 4, jnp.float32),
                  TOL["float32"])
    _, _, eidx = tmoe.route(_tree(jp), torch.zeros(1, 1, cfg.d_model), cfg)
    assert eidx.flatten().tolist() == list(range(cfg.top_k))
    C = tmoe.capacity(cfg, S)
    assert keep[:, :C].all() and not keep[:, C:].any()


def test_moe_apply_gelu_and_bf16_match_jax():
    cfg, jcfg = _cfgs("dbrx-132b", mlp_activation="gelu")
    jp = _params(jcfg, 4, "float32")
    _check(cfg, jcfg, jp, _x((2, 20, cfg.d_model), 5, jnp.float32),
           TOL["float32"])
    cfg, jcfg = _cfgs("jamba-v0.1-52b", dtype="bfloat16")
    jp = _params(jcfg, 5, "bfloat16")
    _check(cfg, jcfg, jp, _x((2, 20, cfg.d_model), 6, jnp.bfloat16),
           TOL["bfloat16"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_gradients_match_jax(arch):
    """jax.grad of <out, w> + 0.1 aux against autograd: the input, router,
    wi and wo, with capacity drops in the batch (S 40)."""
    cfg, jcfg = _cfgs(arch)
    jp = _params(jcfg, 6, "float32")
    x = _x((2, 40, cfg.d_model), 7, jnp.float32)
    w = _x((2, 40, cfg.d_model), 8, jnp.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(y * w) + 0.1 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    tp = {k: v.requires_grad_() for k, v in _tree(jp).items()}
    tx = to_torch(np.asarray(x)).requires_grad_()
    y, aux = tmoe.moe_apply(tp, tx, cfg)
    (torch.sum(y * to_torch(np.asarray(w))) + 0.1 * aux).backward()
    for name, want in (("x", jgx), *jgp.items()):
        got = tx.grad if name == "x" else tp[name].grad
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=2e-5,
            atol=2e-5 * max(1.0, float(np.abs(want).max())),
            err_msg=f"{arch} d{name}")


def _pow2(tree):
    return {k: (jnp.asarray(2.0 ** np.round(np.log2(np.asarray(v))),
                            jnp.float32) if k.endswith("_scale") else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("S", [1, 40])
def test_quantised_experts_match_jax_with_pow2_scales(qtype, S):
    """Experts quantised by JAX's ``quantize_params`` (one (2f,) / (d,)
    scale over E and d, as the reference lays it out), the scales rounded
    to powers of two; the port runs each expert through ``quant_matmul``."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    jp = _params(jcfg, 9, "float32")
    jq = _pow2(jquantize_params(jp, jmoe.moe_spec(jcfg), QTYPES[qtype]))
    assert jq["wi_scale"].shape == (2 * cfg.expert_d_ff,)
    assert jq["wo_scale"].shape == (cfg.d_model,)
    tq = _tree(jq)
    assert tq["wi"].dtype == (torch.uint8 if qtype == "int4" else torch.int8)
    x = _x((2, S, cfg.d_model), 10, jnp.float32)
    want, jaux = jmoe.moe_apply(jq, x, jcfg)
    got, aux = tmoe.moe_apply(tq, to_torch(np.asarray(x)), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **STACK_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_quantised_experts_launch_quant_matmul_per_expert(monkeypatch):
    """2·E ``quant_matmul`` calls a layer, each on one expert's contiguous
    2-D weight and its G·C rows, with the leaf's shared scale."""
    from repro_torch.kernels import ops as kops
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    jq = jquantize_params(_params(jcfg, 11, "float32"), jmoe.moe_spec(jcfg),
                          jnp.int8)
    tq = _tree(jq)
    calls = []
    real = kops.quant_matmul

    def spy(x, w, s, transposed=False, mode=None):
        calls.append((tuple(x.shape), w.is_contiguous(), w.dim(),
                      s.data_ptr()))
        return real(x, w, s, transposed, mode)

    monkeypatch.setattr(kops, "quant_matmul", spy)
    G, S = 3, 16
    tmoe.moe_apply(tq, torch.randn(G, S, cfg.d_model), cfg)
    E, C = cfg.num_experts, tmoe.capacity(cfg, S)
    assert len(calls) == 2 * E
    assert all(c[0][0] == G * C and c[1] and c[2] == 2 for c in calls)
    assert {c[3] for c in calls[0::2]} == {tq["wi_scale"].data_ptr()}
    assert {c[3] for c in calls[1::2]} == {tq["wo_scale"].data_ptr()}
