"""Port model layers and the serving slice against the JAX package.

JAX initialises the parameters; ``params_from_jax`` loads them into the
port; the same token and activation inputs (numpy, from a seed) go through
both. Everything runs in float32 on the CPU, where the port takes the plain
versions of its kernels and JAX its ``ref`` backend. Tolerances: 2e-5 for a
single layer, and atol 3e-4 / rtol 1e-3 for the whole stack — those of
tests/test_models.py, for the same reason (sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.params import init_params as jinit
from repro.models.params import param_count as jparam_count
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro.rl import actor as jactor

from repro_torch.configs import get_smoke_config, with_overrides
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax, to_torch
from repro_torch.models.params import param_count
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import actor as tactor

ARCH = "qwen3-0.6b"
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
STACK_TOL = dict(atol=3e-4, rtol=1e-3)


def _cfgs(dtype="float32"):
    return (with_overrides(get_smoke_config(ARCH), dtype=dtype,
                           param_dtype=dtype),
            jax_with_overrides(jax_smoke_config(ARCH), dtype=dtype,
                               param_dtype=dtype))


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or LAYER_TOL))


def _tree(params):
    """JAX param dict → the same dict of torch tensors."""
    return {k: _tree(v) if isinstance(v, dict) else to_torch(np.asarray(v))
            for k, v in params.items()}


def test_configs_match_jax():
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for get_t, get_j in ((get_config, jax_get_config),
                         (get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get_t(ARCH)) == \
            dataclasses.asdict(get_j(ARCH))
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == \
        (28, 1024, 16, 8, 128, 3072, 151936)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gemma-8b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_embed_match_jax(dtype):
    cfg, jcfg = _cfgs(dtype)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 5, cfg.d_model), np.float32)
                    ).astype(dtype)
    scale = jnp.asarray(rng.standard_normal(cfg.d_model, np.float32) * 0.1)
    got = tlayers.rms_norm(to_torch(np.asarray(x)),
                           to_torch(np.asarray(scale)), cfg.norm_eps)
    want = jlayers.rms_norm(x, scale, jcfg.norm_eps)
    assert str(got.dtype).endswith(dtype)
    tol = LAYER_TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    _close(got, want, **tol)

    emb = jinit(jlayers.embedding_spec(jcfg), jax.random.PRNGKey(1),
                jnp.dtype(dtype))
    toks = rng.integers(0, cfg.vocab_size, (2, 7))
    got = tlayers.embed_tokens(_tree(emb), torch.from_numpy(toks), cfg)
    want = jlayers.embed_tokens(emb, jnp.asarray(toks), jcfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, atol=0, rtol=0)      # a gather and one rounded product


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 32), np.float32)
    pos = np.broadcast_to(np.arange(3, 12, dtype=np.int32), (2, 9))
    for theta in (1e4, 1e6):
        got = tlayers.apply_rope(torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()), theta)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        _close(got, want, atol=1e-5, rtol=1e-5)


def test_mlp_matches_jax():
    cfg, jcfg = _cfgs()
    p = jinit(jlayers.make_mlp_spec(jcfg), jax.random.PRNGKey(2), jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 6, cfg.d_model),
                                                 np.float32)
    _close(tlayers.mlp_apply(_tree(p), torch.from_numpy(x), cfg),
           jlayers.mlp_apply(p, jnp.asarray(x), jcfg))


def test_attend_prefill_and_decode_match_jax():
    cfg, jcfg = _cfgs()
    B, T, S = 2, 10, 16
    p = jinit(jattn.attention_spec(jcfg, 1), jax.random.PRNGKey(3),
              jnp.float32)
    tp = _tree(p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, cfg.d_model), np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model), np.float32)

    jc = jattn.init_cache(jcfg, 1, B, S)
    jy, jc = jattn.attend_prefill(p, jnp.asarray(x), jcfg, 1, jc,
                                  kernel="ref")
    tc = tattn.init_cache(cfg, B, S)
    ty, tc = tattn.attend_prefill(tp, torch.from_numpy(x), cfg, tc)
    _close(ty, jy)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        _close(a, b)
    assert int(tc.length) == int(jc.length) == T

    jy, jc = jattn.attend_decode(p, jnp.asarray(x1), jcfg, 1, jc)
    ty, tc = tattn.attend_decode(tp, torch.from_numpy(x1), cfg, tc)
    _close(ty, jy)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        _close(a, b)
    assert int(tc.length) == int(jc.length) == T + 1
    assert float(tc.k[:, T + 1:].abs().max()) == 0.0   # nothing past length

    jy = jattn.attend_full(p, jnp.asarray(x), jcfg, 1, kernel="ref")
    _close(tattn.attend_full(tp, torch.from_numpy(x), cfg), jy)


# -- params_from_jax ----------------------------------------------------------

def test_params_from_jax_bf16_is_bit_exact():
    _, jcfg = _cfgs("bfloat16")
    cfg = get_smoke_config(ARCH)
    jparams = JaxPolicy(jcfg, tp=1, kernel="ref").init(jax.random.PRNGKey(4))
    tree = jax.tree.map(np.asarray, jparams)
    sd = params_from_jax(tree)
    pol = BackbonePolicy(cfg, device="cpu")
    pol.load_state_dict(sd, strict=True)
    emb = tree["backbone"]["embedding"]["embed"]
    assert emb.dtype.name == "bfloat16"
    got = pol.backbone["embedding"]["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  emb.view(np.int16))
    wq = tree["backbone"]["layers"]["l0"]["attn"]["wq"]     # (L, d, H, hd)
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(
            pol.backbone["layers"][str(i)]["attn"]["wq"].view(torch.int16)
            .numpy(), wq[i].view(np.int16))
    assert pol.backbone["final_norm"].dtype == torch.float32
    assert param_count(pol.spec()) == jparam_count(
        JaxPolicy(jcfg, tp=1).spec())


# -- the whole slice ----------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(port policy, JAX policy, JAX params) on the f32 smoke qwen3."""
    cfg, jcfg = _cfgs()
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jparams = jpol.init(jax.random.PRNGKey(5))
    pol = BackbonePolicy(cfg, device="cpu")
    pol.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return pol, jpol, jparams


def _check_caches(tc, jc, L):
    assert int(tc.length) == int(jc.length)
    for i in range(L):
        j = jc.kv["l0"]
        _close(tc.kv[i].k, j.k[i], **STACK_TOL)
        _close(tc.kv[i].v, j.v[i], **STACK_TOL)
        assert int(tc.kv[i].length) == int(j.length[i])


def test_prefill_and_decode_match_jax(pair):
    pol, jpol, jparams = pair
    cfg = pol.cfg
    B, Tp, S = 2, 12, 20
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, Tp + 4))
    jlg, jv, jc = jpol.prefill(jparams, {"tokens": jnp.asarray(toks[:, :Tp])},
                               S)
    tlg, tv, tc = pol.prefill(torch.from_numpy(toks[:, :Tp]), S)
    assert tlg.shape == (B, cfg.padded_vocab()) and tlg.dtype == torch.float32
    _close(tlg, jlg, **STACK_TOL)
    _close(tv, jv, **STACK_TOL)
    _check_caches(tc, jc, cfg.num_layers)
    for t in range(Tp, Tp + 4):                   # teacher-forced decode
        jlg, jv, jc = jpol.decode(jparams, jnp.asarray(toks[:, t:t + 1]), jc)
        tlg, tv, tc = pol.decode(torch.from_numpy(toks[:, t:t + 1]), tc)
        _close(tlg, jlg, **STACK_TOL)
        _close(tv, jv, **STACK_TOL)
    _check_caches(tc, jc, cfg.num_layers)


def test_seq_matches_jax(pair):
    pol, jpol, jparams = pair
    toks = np.random.default_rng(6).integers(0, pol.cfg.vocab_size, (2, 9))
    jlg, jv, _ = jpol.seq(jparams, {"tokens": jnp.asarray(toks)})
    tlg, tv, _ = pol.seq(torch.from_numpy(toks))
    _close(tlg, jlg, **STACK_TOL)
    _close(tv, jv, **STACK_TOL)


def test_greedy_decode_matches_jax_tokens(pair):
    pol, jpol, jparams = pair
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
