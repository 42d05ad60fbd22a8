"""LM-backbone PPO training of the port against the JAX package, on the CPU.

JAX initialises the parameters and the train state
(``init_train_state(policy.init(key))``); ``train_state_from_jax`` carries
them into the port; the same numpy batch goes through JAX's
``make_lm_train_step`` (``kernel="ref"``, ``gae_mode="ref"``) and the
port's, where the kernels take their plain versions and autograd
differentiates them. Smoke configs cut to 2 layers, f32, B 2, T 16, loss
chunk 8. Tolerances: the step's scalars at rtol 1e-4, every parameter after
a step at atol 1e-5, and the AdamW moments at 1e-4 of their leaf's largest
(sums in another order than XLA's). AdamW's first steps move a parameter by
about the rate, 3e-4, whatever its gradient's size: with ``adam_eps`` 1e-8
an element whose gradient is f32 noise about zero (1e-10 against a leaf's
1e-3, seen in mamba2's ``in_proj``) moves by a good part of the rate in a
direction the noise picks, in either package. So the tests that move the
parameters by the full rate set ``adam_eps`` 1e-6 in both packages, under
which such an element moves by noise / 1e-6 of the rate; the warmup test
keeps the default 1e-8 at rates of 0 and 3e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.buffer import random_batch as jax_random_batch
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro.optim import schedule as jschedule
from repro.rl import learner as jlearner
from repro.rl import ppo as jppo

from repro_torch.configs import get_smoke_config, with_overrides
from repro_torch.configs.base import TrainConfig
from repro_torch.data import buffer
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import (backbone_tree_from_jax,
                                        train_state_from_jax)
from repro_torch.models.policy import BackbonePolicy
from repro_torch.optim import schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl import learner, ppo

ARCHS = ("qwen3-0.6b", "mamba2-1.3b")
B, T, CHUNK = 2, 16, 8
STEP_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
             "grad_norm", "lr")


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", param_dtype="float32", num_layers=2, **kw)
    return (with_overrides(get_smoke_config(arch), **kw),
            jax_with_overrides(jax_smoke_config(arch), **kw))


def _np_batch(cfg, seed, done_p=0.2):
    """One rollout batch by the reference's value rules (dones denser, so
    that GAE crosses episode ends), as numpy."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    return {
        "tokens": rng.integers(0, v, (B, T)).astype(np.int32),
        "actions": rng.integers(0, v, (B, T)).astype(np.int32),
        "old_logprob": (-np.abs(rng.standard_normal((B, T)) * 0.1) - 1.0)
        .astype(np.float32),
        "old_values": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
        "rewards": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
        "dones": rng.random((B, T)) < done_p,
        "last_value": (rng.standard_normal(B) * 0.1).astype(np.float32),
    }


def _leaves_by_name(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves_by_name(v, name + "."))
        else:
            out[name] = v
    return out


def _jax_by_name(tree):
    """JAX params / moments → {port name: numpy array}, layers unstacked."""
    return {k: v.numpy() for k, v in
            _leaves_by_name(backbone_tree_from_jax(tree)).items()}


@pytest.fixture(scope="module", params=ARCHS)
def start(request):
    """(arch, port policy, JAX policy, JAX train state) on the f32 smoke
    config, 2 layers."""
    cfg, jcfg = _cfgs(request.param)
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jstate = jlearner.init_train_state(jpol.init(jax.random.PRNGKey(7)))
    pol = BackbonePolicy(cfg, device="cpu")
    return request.param, pol, jpol, jstate


def _run_both(start, tcfg, jtcfg, steps, microbatches):
    arch, pol, jpol, jstate = start
    jstep = jax.jit(jlearner.make_lm_train_step(
        jpol, jtcfg, total_steps=50, gae_mode="ref", loss_chunk=CHUNK,
        num_microbatches=microbatches))
    tstep = learner.make_lm_train_step(pol, tcfg, total_steps=50,
                                       loss_chunk=CHUNK,
                                       num_microbatches=microbatches)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    for i in range(steps):
        nb = _np_batch(pol.cfg, 100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        state, tm = tstep(state, {k: torch.from_numpy(v)
                                  for k, v in nb.items()})
        for k in STEP_KEYS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{arch} {k}")
        want = _jax_by_name(jax.tree.map(np.asarray, jstate.params))
        got = _leaves_by_name(state.params)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w, atol=1e-5,
                                       rtol=0, err_msg=f"{arch} {name}")
        for which in ("m", "v"):
            want = _jax_by_name(jax.tree.map(
                np.asarray, getattr(jstate.opt, which)))
            got = _leaves_by_name(getattr(state.opt, which))
            for name, w in want.items():
                scale = max(float(np.abs(w).max()), 1e-12)
                np.testing.assert_allclose(
                    got[name].numpy(), w, atol=1e-4 * scale, rtol=1e-3,
                    err_msg=f"{arch} opt.{which} {name}")
        assert int(state.step) == int(jstate.step) == i + 1
        assert int(state.opt.step) == int(jstate.opt.step)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_lm_train_step_matches_jax(start, steps, microbatches):
    """warmup 0, so that the first step's rate is the peak and moves every
    parameter (adam_eps 1e-6: see the module note); the moments after each
    step too."""
    kw = dict(warmup_steps=0, adam_eps=1e-6)
    _run_both(start, TrainConfig(**kw), JaxTrainConfig(**kw), steps,
              microbatches)


def test_lm_train_step_matches_jax_in_warmup(start):
    """The default TrainConfig: step 0's rate is 0 (warmup), step 1's
    the first of the ramp."""
    _run_both(start, TrainConfig(), JaxTrainConfig(), 2, 1)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10000])
def test_warmup_cosine_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    got = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    want = jschedule.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(schedule.constant(torch.tensor(step), peak_lr=1e-3)) == \
        np.float32(1e-3)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_token_loss_matches_jax(arch, chunk):
    cfg, jcfg = _cfgs(arch)
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jparams = jpol.init(jax.random.PRNGKey(3))
    tparams = train_state_from_jax(jax.tree.map(np.asarray, jlearner.
                                                init_train_state(jparams)))
    rng = np.random.default_rng(chunk)
    hidden = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    actions = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    olp = (-np.abs(rng.standard_normal((B, T))) - 1).astype(np.float32)
    adv = rng.standard_normal((B, T)).astype(np.float32)
    want = jppo.chunked_token_loss(
        jparams["backbone"], *map(jnp.asarray, (hidden, actions, olp, adv)),
        jcfg, JaxTrainConfig(), chunk=chunk)
    h = torch.from_numpy(hidden).requires_grad_()
    got = ppo.chunked_token_loss(
        tparams.params["backbone"], h,
        *map(torch.from_numpy, (actions, olp, adv)), cfg, TrainConfig(),
        chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5,
                                   atol=1e-7)
    # the chunks' checkpoints recompute in the backward: the gradient in
    # hidden equals JAX's
    jgrad = jax.grad(lambda x: jppo.chunked_token_loss(
        jparams["backbone"], x, *map(jnp.asarray, (actions, olp, adv)), jcfg,
        JaxTrainConfig(), chunk=chunk)[0])(jnp.asarray(hidden))
    (tgrad,) = torch.autograd.grad(got[0], h)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-6,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_batch_fields_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    got = learner.lm_batch_fields(cfg, 4, 32)
    want = jlearner.lm_batch_fields(jcfg, 4, 32)
    assert list(got) == list(want)
    for k, (shape, dtype) in want.items():
        assert got[k][0] == shape
        assert str(got[k][1]).replace("torch.", "") == np.dtype(dtype).name
    # a frontend arch's prefix field, in bf16
    fcfg = with_overrides(cfg, frontend="vlm", frontend_prefix=4)
    jf = jax_with_overrides(jcfg, frontend="vlm", frontend_prefix=4)
    got, want = (learner.lm_batch_fields(fcfg, 2, 16),
                 jlearner.lm_batch_fields(jf, 2, 16))
    assert list(got) == list(want) and got["prefix"] == (
        want["prefix"][0], torch.bfloat16)
    assert got["tokens"][0] == want["tokens"][0] == (2, 12)


def test_random_batch_value_rules():
    cfg, jcfg = _cfgs("qwen3-0.6b")
    g = torch.Generator().manual_seed(0)
    b = buffer.random_batch(cfg, 64, 128, g)
    jb = jax_random_batch(jcfg, 64, 128, jax.random.PRNGKey(0))
    assert list(b) == list(jb)
    for k, v in b.items():
        assert tuple(v.shape) == jb[k].shape
        assert str(v.dtype).replace("torch.", "") == np.dtype(
            jb[k].dtype).name
    for k in ("tokens", "actions"):
        assert int(b[k].min()) >= 0 and int(b[k].max()) < cfg.vocab_size
    assert float(b["old_logprob"].max()) < -1.0
    rate = float(b["dones"].float().mean())
    assert 0.01 < rate < 0.03, rate                 # Bernoulli(0.02)
    for k in ("old_values", "rewards", "last_value"):
        assert 0.07 < float(b[k].std()) < 0.13      # normal × 0.1
    g2 = torch.Generator().manual_seed(0)
    again = buffer.random_batch(cfg, 64, 128, g2)
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_abstract_batch_and_ring_buffer():
    cfg, _ = _cfgs("mamba2-1.3b")
    ab = buffer.abstract_batch(cfg, 3, 10)
    assert all(v.device.type == "meta" for v in ab.values())
    assert {k: (tuple(v.shape), v.dtype) for k, v in ab.items()} == \
        learner.lm_batch_fields(cfg, 3, 10)
    ring = buffer.RingBuffer(2)
    ring.put("a")
    ring.put("b")
    assert ring.get() == "a" and ring.get() == "b"
    with pytest.raises(IndexError):
        ring.get()


def test_params_tree_and_train_state_from_jax():
    """The policy's own tree and the one carried from JAX have the same
    names, shapes and dtypes; the JAX state's moments are zero and its
    step 0."""
    cfg, jcfg = _cfgs("qwen3-0.6b")
    pol = BackbonePolicy(cfg, device="cpu")
    own = _leaves_by_name(pol.params())
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    st = train_state_from_jax(jax.tree.map(np.asarray, jlearner.
                                           init_train_state(jpol.init(
                                               jax.random.PRNGKey(0)))))
    carried = _leaves_by_name(st.params)
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in carried.items()}
    assert all(not x.any() for x in tree_leaves(st.opt.m))
    assert int(st.step) == 0 and int(st.opt.step) == 0
    # seq over the carried tree equals seq over the loaded policy
    pol.load_state_dict(carried, strict=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    with torch.no_grad():
        a, av, _ = pol.seq(toks)
        b, bv, _ = pol.seq(st.params, toks)
    assert torch.equal(a, b) and torch.equal(av, bv)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_launcher_prints_steps_and_resumes(arch, tmp_path, capsys):
    """--smoke --steps 3 on the CPU: the step and done lines; with
    --ckpt-dir it saves, and --resume continues from the newest step and
    ends where an uninterrupted run ends."""
    base = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    full = launch_train.main(base + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "done: 3 steps, 0 recoveries" in out
    ck = str(tmp_path / "ck")
    launch_train.main(base + ["--steps", "2", "--ckpt-dir", ck,
                              "--save-every", "2"])
    capsys.readouterr()
    resumed = launch_train.main(base + ["--steps", "3", "--ckpt-dir", ck,
                                        "--save-every", "2", "--resume"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "done: 3 steps" in out
    assert int(resumed.state.step) == int(full.state.step) == 3
    for a, b in zip(tree_leaves(resumed.state.params),
                    tree_leaves(full.state.params)):
        assert torch.equal(a, b)


def test_recompute_context_carries_the_backend_scope_to_another_thread():
    """Autograd runs a CUDA backward, and so a checkpoint's recomputation,
    on a thread of its own: the recomputation's context re-enters the
    forward's ``dispatch.using`` scope there."""
    import threading

    from repro_torch.kernels import dispatch
    seen = []

    def recompute(ctx):
        with ctx:
            seen.append(dispatch.scope())

    with dispatch.using("ref"):
        fwd_ctx, re_ctx = dispatch.recompute_context()
    t = threading.Thread(target=recompute, args=(re_ctx,))
    t.start()
    t.join()
    _, plain = dispatch.recompute_context()
    t = threading.Thread(target=recompute, args=(plain,))
    t.start()
    t.join()
    assert seen == ["ref", None] and dispatch.scope() is None
