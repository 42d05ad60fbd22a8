"""Head dims 160 and 256 (stablelm-12b, gemma-7b) against the JAX package.

The attention kernels' plain versions at hd 160 and 256, which CPU tensors
take, against the Pallas kernels run in interpret mode (and the pure-jnp
``ref``) as tests/test_kernels.py runs them, at its tolerances (f32 2e-5,
bf16 2e-2): ``flash_attention``, its LSE (held by the Pallas output it
normalises), ``flash_decode``; the backward against ``jax.vjp`` of the
reference's forward at tests/test_torch_backward.py's 1e-5. T and S divide
the Pallas blocks; G is 1 (gemma) and 4 (stablelm). Then each arch at its
smoke config with its own head dim (4 query heads; 4 KV heads for gemma,
1 for stablelm), the JAX package's parameters loaded by
``params_from_jax``: ``seq`` logits, a prefill and 4 teacher-forced decode
steps at the stack tolerance of tests/test_torch_models.py (atol 3e-4, rtol
1e-3), and one LM train step's loss (rtol 1e-4), gradients (the first
moment after one step, 1e-4 of each leaf's largest) and params (atol 1e-5
under ``adam_eps`` 1e-6). Last, the contract: a CUDA tensor at a head dim
with no instance raises, a CPU one at hd 80 computes, and
``flash_decode.plan`` holds each split within a block's shared memory.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro.rl import learner as jlearner

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels._checks import HEAD_DIMS, check_heads
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.convert import (backbone_tree_from_jax,
                                        params_from_jax, to_torch,
                                        train_state_from_jax)
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import learner

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
STACK_TOL = dict(atol=3e-4, rtol=1e-3)
ARCH_HEADS = {"gemma-7b": (256, 4), "stablelm-12b": (160, 1)}  # hd, K

FA_SHAPES = [                        # B, T, H, K, hd, block_q, block_k
    (1, 32, 4, 4, 256, 16, 16),      # G 1, gemma's
    (1, 64, 8, 2, 160, 32, 32),      # G 4, stablelm's
    (2, 32, 4, 1, 160, 16, 32),      # MQA, uneven blocks
    (1, 32, 6, 2, 256, 32, 16),      # an odd group, G 3
]
FD_SHAPES = [                        # B, H, K, hd, S, block_s
    (2, 4, 4, 256, 64, 32),          # G 1
    (1, 8, 2, 160, 96, 32),          # G 4
    (2, 4, 1, 256, 48, 48),          # MQA, one block
]
BWD_SHAPES = [                       # B, T, S, H, K, hd, causal
    (1, 24, 24, 4, 4, 256, True),    # G 1
    (2, 19, 19, 8, 2, 160, True),    # G 4, ragged T
    (1, 16, 30, 4, 1, 160, True),    # S > T
    (1, 21, 13, 6, 2, 256, False),   # an odd group, non-causal
]


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (bit-exact)."""
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return a, to_torch(np.asarray(a))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# -- the kernels' plain versions ---------------------------------------------

@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,K,hd,bq,bk", FA_SHAPES)
def test_flash_attention_matches_jax(B, T, H, K, hd, bq, bk, dtype,
                                     jax_mode):
    rng = np.random.default_rng(T * H + hd)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, T, H, hd), (B, T, K, hd), (B, T, K, hd)))
    want = jops.flash_attention(qj, kj, vj, causal=True, mode=jax_mode,
                                block_q=bq, block_k=bk)
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)
    _close(tops.flash_attention(q, k, v), want, dtype)


@pytest.mark.parametrize("B,T,H,K,hd,bq,bk", FA_SHAPES)
def test_flash_attention_lse_normalises_the_pallas_output(B, T, H, K, hd, bq,
                                                          bk):
    """P = exp(scale q k^T - lse), masked, times v: the Pallas kernel's
    output, so the LSE the forward hands its backward is that kernel's
    normaliser."""
    rng = np.random.default_rng(T + hd)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, "float32") for s in
                                 ((B, T, H, hd), (B, T, K, hd), (B, T, K, hd)))
    want = jops.flash_attention(qj, kj, vj, causal=True, mode="interpret",
                                block_q=bq, block_k=bk)
    _, lse = flash_attention_fwd(q, k, v, True, with_lse=True)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref.flash_attention_lse(q, k, True),
                               atol=1e-6, rtol=1e-6)
    G = H // K
    s = torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(G, 2)) \
        / hd ** 0.5
    keep = torch.ones(T, T, dtype=torch.bool).tril()
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    o = torch.einsum("bhts,bshd->bthd", p, v.repeat_interleave(G, 2))
    _close(o, want, "float32")


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("B,H,K,hd,S,bs", FD_SHAPES)
def test_flash_decode_matches_jax(B, H, K, hd, S, bs, frac, dtype, jax_mode):
    rng = np.random.default_rng(S * H + hd)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    L = int(frac * (S - 1))
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(L, jnp.int32),
                             mode=jax_mode, block_s=bs)
    got = flash_decode(q, k, v, torch.tensor(L, dtype=torch.int32))
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("B,T,S,H,K,hd,causal", BWD_SHAPES)
def test_flash_attention_bwd_matches_jax_grad(B, T, S, H, K, hd, causal):
    rng = np.random.default_rng(T * S + hd)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, T, H, hd), (B, S, K, hd), (B, S, K, hd),
                    (B, T, H, hd)))
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention(q, k, v, causal),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd(tq, tk, tv, causal, with_lse=True)
    for got in (ref.flash_attention_bwd(tq, tk, tv, tdo, causal=causal),
                flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    # and by autograd through the op, as the training path differentiates
    tq, tk, tv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    o = tops.flash_attention(tq, tk, tv, causal=causal)
    for g, w in zip(torch.autograd.grad(o, (tq, tk, tv), tdo), want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


# -- the two archs at their own head dims ------------------------------------

def _jcfg(arch):
    hd, K = ARCH_HEADS[arch]
    return jax_with_overrides(jax_smoke_config(arch), head_dim=hd,
                              num_heads=4, num_kv_heads=K, dtype="float32",
                              param_dtype="float32")


def _port(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


_STACKS: dict = {}


def _stack(arch):
    """(port policy, JAX policy, JAX params) with JAX's parameters."""
    if arch not in _STACKS:
        jcfg = _jcfg(arch)
        jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
        jparams = jpol.init(jax.random.PRNGKey(13))
        pol = BackbonePolicy(_port(jcfg), device="cpu")
        pol.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                         jparams)),
                            strict=True)
        _STACKS[arch] = pol, jpol, jparams
    return _STACKS[arch]


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


@pytest.mark.parametrize("arch", sorted(ARCH_HEADS))
def test_seq_logits_match_jax(arch):
    pol, jpol, jparams = _stack(arch)
    assert pol.cfg.head_dim == ARCH_HEADS[arch][0]
    toks = np.random.default_rng(5).integers(0, pol.cfg.vocab_size, (2, 16))
    jlg, jv, _ = jpol.seq(jparams, {"tokens": jnp.asarray(toks)})
    tlg, tv, _ = pol.seq(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tlg), _np(jlg), **STACK_TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **STACK_TOL)


@pytest.mark.parametrize("arch", sorted(ARCH_HEADS))
def test_prefill_and_decode_match_jax(arch):
    """A prefill of 12 tokens into a cache of 16, then 4 teacher-forced
    decode steps: logits and values at each."""
    pol, jpol, jparams = _stack(arch)
    toks = np.random.default_rng(6).integers(0, pol.cfg.vocab_size, (2, 16))
    jlg, jv, jc = jpol.prefill(jparams, {"tokens": jnp.asarray(toks[:, :12])},
                               16)
    tlg, tv, tc = pol.prefill(torch.from_numpy(toks[:, :12]), 16)
    assert int(tc.length) == int(jc.length) == 12
    np.testing.assert_allclose(_np(tlg), _np(jlg), **STACK_TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **STACK_TOL)
    for t in range(12, 16):
        jlg, jv, jc = jpol.decode(jparams, jnp.asarray(toks[:, t:t + 1]), jc)
        tlg, tv, tc = pol.decode(torch.from_numpy(toks[:, t:t + 1]), tc)
        np.testing.assert_allclose(_np(tlg), _np(jlg), **STACK_TOL)
        np.testing.assert_allclose(_np(tv), _np(jv), **STACK_TOL)


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", sorted(ARCH_HEADS))
def test_lm_train_step_matches_jax(arch):
    """One make_lm_train_step of 2 layers at B 2 x T 16: its loss and
    metrics, each leaf's gradient (read from the first moment, which after
    one step is (1 - b1) clip g in both packages) and the updated params."""
    jcfg = jax_with_overrides(_jcfg(arch), num_layers=2)
    cfg = _port(jcfg)
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jstate = jlearner.init_train_state(jpol.init(jax.random.PRNGKey(17)))
    pol = BackbonePolicy(cfg, device="cpu")
    tk = dict(warmup_steps=0, adam_eps=1e-6)
    jstep = jax.jit(jlearner.make_lm_train_step(
        jpol, JaxTrainConfig(**tk), total_steps=50, gae_mode="ref",
        loss_chunk=8))
    tstep = learner.make_lm_train_step(pol, TrainConfig(**tk), total_steps=50,
                                       loss_chunk=8)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    rng = np.random.default_rng(21)
    B, T, V = 2, 16, cfg.vocab_size
    nb = {"tokens": rng.integers(0, V, (B, T)).astype(np.int32),
          "actions": rng.integers(0, V, (B, T)).astype(np.int32),
          "old_logprob": (-np.abs(rng.standard_normal((B, T)) * 0.1) - 1.0)
          .astype(np.float32),
          "old_values": (rng.standard_normal((B, T)) * 0.1)
          .astype(np.float32),
          "rewards": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
          "dones": rng.random((B, T)) < 0.2,
          "last_value": (rng.standard_normal(B) * 0.1).astype(np.float32)}
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    state, tm = tstep(state, {k: to_torch(v) for k, v in nb.items()})
    for k in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
              "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=f"{arch} {k}")
    jstate = jax.tree.map(np.asarray, jstate)
    for got_tree, want_tree, what in (
            (state.opt.m, jstate.opt.m, "gradient"),
            (state.params, jstate.params, "param")):
        want = {k: v.numpy() for k, v in
                _named(backbone_tree_from_jax(want_tree))}
        got = {k: v.numpy() for k, v in _named(got_tree)}
        assert set(got) == set(want)
        for name, w in want.items():
            atol = (1e-4 * float(np.abs(w).max()) if what == "gradient"
                    else 1e-5)
            np.testing.assert_allclose(got[name], w, atol=atol, rtol=0,
                                       err_msg=f"{arch} {what} {name}")


# -- the contract ------------------------------------------------------------

def test_cuda_head_dims_need_an_instance_and_cpu_takes_any():
    assert HEAD_DIMS == (16, 32, 64, 128, 160, 256)
    cuda = torch.device("cuda")
    for hd in HEAD_DIMS:
        check_heads("flash_attention", 8, 2, hd, cuda)
    for hd in (8, 48, 80, 96, 192, 512):
        with pytest.raises(ValueError, match="head_dim"):
            check_heads("flash_attention", 8, 2, hd, cuda)
    rng = np.random.default_rng(80)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 20, 4, 80), (2, 20, 2, 80), (2, 20, 2, 80)))
    np.testing.assert_allclose(
        flash_attention(q, k, v).numpy(),
        np.asarray(jref.flash_attention(*(jnp.asarray(t.numpy())
                                          for t in (q, k, v)))),
        atol=2e-5, rtol=2e-5)
    length = torch.tensor(11, dtype=torch.int32)
    np.testing.assert_allclose(
        flash_decode(q[:, 0], k, v, length).numpy(),
        np.asarray(jref.flash_decode(*(jnp.asarray(t.numpy())
                                       for t in (q[:, 0], k, v)),
                                     jnp.asarray(11, jnp.int32))),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("elem", [2, 4])
def test_decode_plan_fits_shared_memory(hd, elem):
    """Every cluster of the splits ``plan`` picks fits a block at its head
    dim, cache type and group; only f32 at hd 256 with 6 or more heads a
    block has its cluster held back (to 6 blocks, and to 5 at 8 heads, where
    8 ranks' slots would take 274,496 bytes), and a pair then takes several
    clusters of that size where one would leave SMs idle."""
    for G in (1, 2, 4, 6, 8, 20):
        cap = fd.cluster_cap(hd, elem, G)
        if cap < fd.MAX_SPLIT:
            assert elem == 4 and hd == 256 and G >= 6
            assert cap == (5 if G >= 8 else 6)
        for B, K, S in ((1, 1, 4096), (1, 2, 577), (8, 8, 576), (8, 16, 576),
                        (2, 1, 100)):
            _, n = fd.plan(B, K, S, fd.SMS, hd, elem, G)
            cl = fd.cluster(n, hd, elem, G)
            assert cl <= cap and n % cl == 0
            assert fd.smem_bytes(cl, hd, elem, G) <= fd.SMEM_MAX
    assert fd.smem_bytes(8, 256, 2, 8) == 221184
    assert fd.smem_bytes(8, 256, 4, 8) == 274496


# -- what lets the two archs train 8 layers deep on one card -----------------

def test_adamw_takes_large_leaves_a_slice_at_a_time_bit_for_bit(monkeypatch):
    """The update of a leaf past ``CHUNK`` elements, slice by slice with the
    clip factor applied as it goes, equals the whole-leaf update bit for
    bit (params, both moments), with and without clipping and decay."""
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(300, 37, generator=g).bfloat16(),
              "n": {"s": torch.randn(50, generator=g)}}
    grads = adamw.tree_map(lambda p: (torch.randn(p.shape, generator=g)
                                      * 3).to(p.dtype), params)
    state = adamw.init(params)
    state = adamw.AdamWState(
        state.step, adamw.tree_map(lambda m: torch.randn(m.shape,
                                                         generator=g),
                                   state.m),
        adamw.tree_map(lambda v: torch.rand(v.shape, generator=g), state.v))
    for kw in (dict(weight_decay=0.1, max_grad_norm=1.0), {}):
        whole = adamw.update(grads, state, params, lr=torch.tensor(1e-3),
                             **kw)
        monkeypatch.setattr(adamw, "CHUNK", 777)
        sliced = adamw.update(grads, state, params, lr=torch.tensor(1e-3),
                              **kw)
        monkeypatch.setattr(adamw, "CHUNK", 1 << 26)
        for a, b in zip(*(adamw.tree_leaves({"p": p, "m": s.m, "v": s.v})
                          for p, s, _ in (whole, sliced))):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_lm_launcher_policy_holds_the_trained_params(capsys):
    """The launcher's policy takes each step's params (``bind``), so a run
    holds one copy of them besides a step's output, and serves what it
    trained."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import tree_leaves
    run = launch_train.main(["--arch", "gemma-7b", "--smoke", "--batch", "2",
                             "--seq", "16", "--steps", "2", "--device",
                             "cpu"])
    assert "done: 2 steps" in capsys.readouterr().out
    held, trained = (tree_leaves(t) for t in (run.policy.params(),
                                              run.state.params))
    assert len(held) == len(trained)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(held, trained))
    init = BackbonePolicy(get_smoke_config("gemma-7b"), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(init.params()), trained))
