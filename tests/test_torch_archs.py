"""The archs of the MoE and frontend slice, and the two of the head-dim
slice, against the JAX package.

internlm2-20b (dense), internvl2-26b (dense, vlm prefix), musicgen-medium
(GeGLU, no rope, audio prefix), jamba-v0.1-52b (hybrid SSM/attention with
MoE), dbrx-132b (MoE top-4, every layer), llama4-maverick-400b-a17b (MoE
top-1 on every second layer), gemma-7b (GeGLU, tied embeddings scaled by
sqrt(d_model), head dim 256) and stablelm-12b (GQA, head dim 160; both at
the smoke head dim here, tests/test_torch_headdims.py at their own). Configs and parameter counts equal the
reference's without allocating; at the reference's smoke configs in f32,
JAX initialises the parameters, ``params_from_jax`` loads them, and the
same numpy tokens and prefixes go through both: ``seq``, ``prefill`` and
4 teacher-forced decode steps at the stack tolerance of
tests/test_torch_models.py (atol 3e-4, rtol 1e-3); one LM train step at
the tolerances of tests/test_torch_lm_train.py (scalars rtol 1e-4, params
atol 1e-5 under ``adam_eps`` 1e-6). ``params_from_jax`` on MoE trees
(float, int8, int4; period 2 and jamba's 8) is exact, and the quantised
init, drawn and quantised leaf by leaf, is bitwise the tree of
quantising the whole float tree after drawing it.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models.params import param_count as jparam_count
from repro.models.params import quantize_params as jquantize_params
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro.rl import learner as jlearner

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tr
from repro_torch.models.convert import (backbone_tree_from_jax,
                                        params_from_jax, to_torch,
                                        train_state_from_jax)
from repro_torch.models.frontends import stub_prefix
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import learner

NEW = ("internlm2-20b", "internvl2-26b", "musicgen-medium", "jamba-v0.1-52b",
       "dbrx-132b", "llama4-maverick-400b-a17b", "gemma-7b", "stablelm-12b")
STACK_TOL = dict(atol=3e-4, rtol=1e-3)
QTYPES = {"int8": jnp.int8, "int4": jnp.int4}


def _f32(jcfg, **kw):
    return jax_with_overrides(jcfg, dtype="float32", param_dtype="float32",
                              **kw)


def _port(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or STACK_TOL))


def _pair(jcfg, seed, quantize=None):
    """(port policy, JAX policy, JAX params) with JAX's parameters."""
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jparams = jpol.init(jax.random.PRNGKey(seed))
    if quantize:
        jparams = jquantize_params(jparams, jpol.spec(), QTYPES[quantize])
    pol = BackbonePolicy(_port(jcfg), device="cpu", quantize=quantize)
    pol.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)),
                        strict=True)
    return pol, jpol, jparams


def _prefix(cfg, B, seed):
    """(JAX, torch) copies of one bf16 prefix, or (None, None)."""
    if not cfg.frontend:
        return None, None
    x = np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_prefix, cfg.d_model)).astype(np.float32) * 0.02
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, to_torch(np.asarray(jx))


# -- configuration --------------------------------------------------------------

def test_registry_holds_the_eight_ported_archs():
    """Every arch of the reference is ported: the eight of the earlier
    slices and gemma-7b and stablelm-12b, the reference's ten in its
    order."""
    from repro.configs import ARCHS as JAX_ARCHS
    assert ARCHS == JAX_ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", NEW)
def test_config_and_param_count_match_jax(arch):
    for get_t, get_j in ((get_config, jax_get_config),
                         (get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
    cfg = get_config(arch)
    n = tparams.param_count(tr.transformer_spec(cfg)) + cfg.d_model  # value
    assert n == jparam_count(JaxPolicy(jax_get_config(arch), tp=1).spec())
    kinds = [tr.layer_kinds(cfg, i) for i in range(cfg.num_layers)]
    assert kinds == [(("attn" if cfg.is_attn_layer(i) else "ssm"),
                      ("moe" if cfg.is_moe_layer(i) else "mlp"))
                     for i in range(cfg.num_layers)]
    if arch == "jamba-v0.1-52b":
        assert math.isclose(n, 51.46e9, rel_tol=1e-3)
        assert [i for i, k in enumerate(kinds) if k[0] == "attn"] == \
            [7, 15, 23, 31]
        assert [i for i, k in enumerate(kinds) if k[1] == "moe"] == \
            list(range(1, 32, 2))
    if arch == "musicgen-medium":
        assert math.isclose(n, 1.82e9, rel_tol=1e-2)
    if arch == "gemma-7b":       # 28 x 276.8 M and a tied 256,000 x 3,072
        assert math.isclose(n, 8.54e9, rel_tol=1e-3)
    if arch == "stablelm-12b":   # 40 x 277.8 M, an untied embed and unembed
        assert math.isclose(n, 12.14e9, rel_tol=1e-3)


# -- the stacks against JAX -------------------------------------------------------

_PAIRS: dict = {}


def _stack(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = _pair(_f32(jax_smoke_config(arch)), 11)
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", NEW)
def test_seq_prefill_and_decode_match_jax(arch):
    """seq over tokens (and the prefix), then a prefill and 4 teacher-forced
    decode steps; the MoE aux of seq too."""
    pol, jpol, jparams = _stack(arch)
    cfg = pol.cfg
    B, Tp = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, Tp + 4))
    jpre, tpre = _prefix(cfg, B, 4)
    jin = {"tokens": jnp.asarray(toks[:, :Tp])}
    if jpre is not None:
        jin["prefix"] = jpre
    P = cfg.frontend_prefix if cfg.frontend else 0
    jlg, jv, jaux = jpol.seq(jparams, jin)
    tlg, tv, taux = pol.seq(torch.from_numpy(toks[:, :Tp]), prefix=tpre)
    assert tlg.shape == (B, P + Tp, cfg.padded_vocab())
    _close(tlg, jlg)
    _close(tv, jv)
    np.testing.assert_allclose(float(taux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-5)
    assert (float(taux["moe_aux"]) > 0) == bool(cfg.num_experts)
    S = P + Tp + 4
    jlg, jv, jc = jpol.prefill(jparams, jin, S)
    tlg, tv, tc = pol.prefill(torch.from_numpy(toks[:, :Tp]), S, prefix=tpre)
    assert int(tc.length) == int(jc.length) == P + Tp
    _close(tlg, jlg)
    _close(tv, jv)
    for t in range(Tp, Tp + 4):
        jlg, jv, jc = jpol.decode(jparams, jnp.asarray(toks[:, t:t + 1]), jc)
        tlg, tv, tc = pol.decode(torch.from_numpy(toks[:, t:t + 1]), tc)
        _close(tlg, jlg)
        _close(tv, jv)


def test_stub_prefix_draws_by_the_reference_rule():
    cfg = get_smoke_config("musicgen-medium")
    x = stub_prefix(cfg, torch.Generator().manual_seed(0), 64)
    assert x.shape == (64, cfg.frontend_prefix, cfg.d_model)
    assert x.dtype == torch.bfloat16
    assert 0.018 < float(x.float().std()) < 0.022
    with pytest.raises(ValueError, match="no frontend"):
        stub_prefix(get_smoke_config("qwen3-0.6b"), torch.Generator(), 1)


# -- parameters -------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_params_from_jax_unstacks_moe_trees(quantize):
    """jamba's smoke stack (period 2) and a jamba of smoke widths at its
    own period of 8 (attention on layer 7, MoE on the odd layers): every
    MoE leaf of layer p·period + i equals the JAX tree's entry p of
    ``layers/l{i}``, the router in f32, the experts' scale one (2f,) or
    (d,) vector a layer."""
    for jcfg, period in (
            (jax_smoke_config("jamba-v0.1-52b"), 2),
            (jax_with_overrides(jax_smoke_config("jamba-v0.1-52b"),
                                num_layers=16, attn_period=8), 8)):
        pol, _, jparams = _pair(jcfg, 5, quantize)
        jl = jax.tree.map(np.asarray, jparams)["backbone"]["layers"]
        assert len(jl) == period
        for i in range(jcfg.num_layers):
            got = pol.backbone["layers"][str(i)]
            if not jcfg.is_moe_layer(i):
                assert "moe" not in got and "mlp" in got
                continue
            want = jl[f"l{i % period}"]["moe"]
            p = i // period
            assert got["moe"]["router"].dtype == torch.float32
            for k in want:
                w = want[k][p]
                t = got["moe"][k]
                if k in ("wi", "wo") and quantize == "int4":
                    t = tparams.stored(t, got["moe"][k + "_scale"])
                    w = w.astype(np.int8)
                elif t.dtype == torch.bfloat16:
                    t, w = t.view(torch.int16), w.view(np.int16)
                np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
            if quantize:
                assert got["moe"]["wi_scale"].shape == \
                    (2 * jcfg.expert_d_ff,)


def _old_init(spec_tree, generator, param_dtype):
    """The draw-then-quantise init the leaf-by-leaf one replaces: every
    leaf drawn (normal / sqrt(fan_in), divided out of place, then cast)
    before any is quantised."""
    out = {}
    for path, spec in tparams._leaves(spec_tree):
        dtype = spec.dtype or param_dtype
        if spec.init == "zeros":
            x = torch.zeros(spec.shape, dtype=dtype)
        else:
            fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                                  else spec.shape[-1])
            x = (torch.randn(spec.shape, generator=generator,
                             dtype=torch.float32) / math.sqrt(fan)).to(dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b",
                                  "jamba-v0.1-52b"])
def test_quantised_init_leaf_by_leaf_is_bitwise_draw_then_quantise(
        arch, qtype, monkeypatch):
    """bf16 parameters (the smoke default), quantised in slices of 4096
    elements, so that the expert leaves and the embedding span several."""
    cfg = get_smoke_config(arch)
    pol = BackbonePolicy(cfg, device="cpu", quantize=qtype,
                         generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(tparams, "QUANT_ROWS", 4096)
    sliced = BackbonePolicy(cfg, device="cpu", quantize=qtype,
                            generator=torch.Generator().manual_seed(3))
    spec = pol._float_spec()
    want = dict(_named(tparams.quantize_params(
        _old_init(spec, torch.Generator().manual_seed(3), torch.bfloat16),
        spec, qtype)))
    for got in (dict(_named(pol.params())), dict(_named(sliced.params()))):
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


# -- one train step ---------------------------------------------------------------

B, T, CHUNK = 2, 16, 8
STEP_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
             "grad_norm", "lr", "moe_aux")


def _np_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    P = cfg.frontend_prefix if cfg.frontend else 0
    nb = {
        "tokens": rng.integers(0, v, (B, T - P)).astype(np.int32),
        "actions": rng.integers(0, v, (B, T)).astype(np.int32),
        "old_logprob": (-np.abs(rng.standard_normal((B, T)) * 0.1) - 1.0)
        .astype(np.float32),
        "old_values": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
        "rewards": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
        "dones": rng.random((B, T)) < 0.2,
        "last_value": (rng.standard_normal(B) * 0.1).astype(np.float32),
    }
    if P:
        nb["prefix"] = np.asarray(jnp.asarray(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
            * 0.1).astype(jnp.bfloat16))
    return nb


def _by_name(tree):
    return {k: v.numpy() for k, v in _named(tree)}


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "dbrx-132b",
                                  "musicgen-medium", "gemma-7b",
                                  "stablelm-12b"])
def test_lm_train_step_matches_jax(arch):
    """jamba: an SSM + MLP layer and an attention + MoE layer; dbrx: two
    top-2 MoE layers; musicgen: its prefix of 8 frames before 8 tokens;
    gemma: GeGLU under tied, scaled embeddings; stablelm: untied, GQA."""
    kw = dict(dtype="float32", param_dtype="float32", num_layers=2)
    jcfg = jax_with_overrides(jax_smoke_config(arch), **kw)
    cfg = _port(jcfg)
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jstate = jlearner.init_train_state(jpol.init(jax.random.PRNGKey(7)))
    pol = BackbonePolicy(cfg, device="cpu")
    tk = dict(warmup_steps=0, adam_eps=1e-6)
    jstep = jax.jit(jlearner.make_lm_train_step(
        jpol, JaxTrainConfig(**tk), total_steps=50, gae_mode="ref",
        loss_chunk=CHUNK))
    tstep = learner.make_lm_train_step(pol, TrainConfig(**tk), total_steps=50,
                                       loss_chunk=CHUNK)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    nb = _np_batch(cfg, 100)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    state, tm = tstep(state, {k: to_torch(v) for k, v in nb.items()})
    for k in STEP_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=f"{arch} {k}")
    assert (float(tm["moe_aux"]) > 0) == bool(cfg.num_experts)
    want = _by_name(backbone_tree_from_jax(jax.tree.map(np.asarray,
                                                        jstate.params)))
    got = _by_name(state.params)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=0,
                                   err_msg=f"{arch} {name}")


# -- the launchers ---------------------------------------------------------------

def test_serve_launcher_runs_jamba_int8_on_cpu(capsys):
    out = launch_serve.main(["--arch", "jamba-v0.1-52b", "--smoke",
                             "--quantize", "int8", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "20",
                             "--tokens", "4"])
    assert out.shape == (2, 4)
    assert "arch=jamba-v0.1-52b quantize=int8" in capsys.readouterr().out


def test_train_launcher_runs_musicgen_with_its_prefix_on_cpu(capsys):
    """--seq 16 with a smoke prefix of 8: 8 token positions a sequence."""
    run = launch_train.main(["--arch", "musicgen-medium", "--smoke",
                             "--batch", "2", "--seq", "16", "--steps", "2",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out
    batch = next(run.batches(0))
    assert batch["prefix"].shape == (2, 8, run.policy.cfg.d_model)
    assert batch["tokens"].shape == (2, 8)
    assert math.isfinite(float(run.metrics["loss"]))
