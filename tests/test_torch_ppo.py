"""The port's PPO pieces against the JAX package: distributions, PPO terms,
AdamW, OceanPolicy, and one whole ``learn`` (GAE → minibatched PPO epochs).

The same inputs, made with numpy from a seed (or produced by the JAX
rollout), go through both packages on the CPU. f32 at atol = rtol = 1e-5,
except one whole ``learn``: atol 1e-5, rtol 1e-4, since its E·M AdamW steps
sum gradients in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import emulation as jem
from repro.core.vector import VecEnv as JVecEnv
from repro.envs import ocean as jocean
from repro.models import policy as jpolicy
from repro.optim import adamw as jadamw
from repro.rl import distributions as jD
from repro.rl import learner as jlearner
from repro.rl import ppo as jppo
from repro.rl import rollout as jrollout
from repro_torch.configs.base import TrainConfig
from repro_torch.models import policy as tpolicy
from repro_torch.models.convert import ocean_params_from_jax
from repro_torch.optim import adamw as tadamw
from repro_torch.rl import distributions as tD
from repro_torch.rl import learner as tlearner
from repro_torch.rl import ppo as tppo
from repro_torch.rl.engine import METRIC_KEYS
from repro_torch.rl.rollout import Trajectory

TOL = dict(atol=1e-5, rtol=1e-5)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


def _tree_close(got, want, **tol):
    if isinstance(want, (dict, tuple)):
        items = want.items() if isinstance(want, dict) else enumerate(want)
        for k, w in items:
            _tree_close(got[k], w, **tol)
        return
    _close(got, want, **tol)


# -- distributions ----------------------------------------------------------------

@pytest.mark.parametrize("nvec", [(4,), (3, 2, 5)])
def test_categorical_log_prob_entropy_match_jax(nvec):
    rng = np.random.default_rng(len(nvec))
    logits = _f32(rng, 32, sum(nvec), scale=2.0)
    acts = np.stack([rng.integers(0, n, 32) for n in nvec], -1).astype(
        np.int32)
    jd, td = jD.Dist("categorical", nvec=nvec), tD.Dist("categorical",
                                                        nvec=nvec)
    lg, a = torch.from_numpy(logits), torch.from_numpy(acts)
    _close(td.log_prob(lg, a), jd.log_prob(jnp.asarray(logits),
                                           jnp.asarray(acts)))
    _close(td.entropy(lg), jd.entropy(jnp.asarray(logits)))
    np.testing.assert_array_equal(tD.mode(lg, nvec).numpy(),
                                  np.asarray(jD.mode(jnp.asarray(logits),
                                                     nvec)))


@pytest.mark.parametrize("cont_dim", [1, 3])
def test_gaussian_log_prob_entropy_match_jax(cont_dim):
    rng = np.random.default_rng(cont_dim)
    out = _f32(rng, 32, 2 * cont_dim, scale=4.0)    # log_std beyond the clip
    acts = _f32(rng, 32, cont_dim)
    jd, td = (jD.Dist("gaussian", cont_dim=cont_dim),
              tD.Dist("gaussian", cont_dim=cont_dim))
    o, a = torch.from_numpy(out), torch.from_numpy(acts)
    _close(td.log_prob(o, a), jd.log_prob(jnp.asarray(out),
                                          jnp.asarray(acts)))
    _close(td.entropy(o), jd.entropy(jnp.asarray(out)))


def test_categorical_sample_follows_softmax():
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).expand(8192, 4)
    a = tD.sample(torch.Generator().manual_seed(0), logits, (4,))
    assert a.dtype == torch.int32 and a.shape == (8192, 1)
    p = torch.softmax(logits[0], -1).numpy()
    freq = np.bincount(a[:, 0].numpy(), minlength=4) / 8192
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / 8192))


def test_gaussian_sample_clips_log_std():
    out = torch.tensor([[0.5, 9.0]]).expand(8192, 2)   # log_std clips to 2
    x = tD.gaussian_sample(torch.Generator().manual_seed(0), out, 1)
    assert abs(float(x.mean()) - 0.5) < 4 * np.exp(2) / np.sqrt(8192)
    assert abs(float(x.std()) / np.exp(2.0) - 1) < 0.05


# -- PPO terms ----------------------------------------------------------------------

@pytest.mark.parametrize("vf_clip", [0.0, 0.2])
def test_ppo_terms_and_value_loss_match_jax(vf_clip):
    rng = np.random.default_rng(0)
    new, old, adv, nv, ov, ret = (_f32(rng, 256, scale=0.3) for _ in range(6))
    jt, tt = JTrainConfig(vf_clip=vf_clip), TrainConfig(vf_clip=vf_clip)
    T = lambda x: torch.from_numpy(x)
    for got, want in zip(tppo.ppo_terms(T(new), T(old), T(adv), tt),
                         jppo.ppo_terms(new, old, adv, jt)):
        _close(got, want)
    _close(tppo.value_loss(T(nv), T(ov), T(ret), tt),
           jppo.value_loss(nv, ov, ret, jt))


def test_normalize_adv_uses_population_std():
    adv = _f32(np.random.default_rng(0), 64, scale=3.0) + 1.0
    got = tppo.normalize_adv(torch.from_numpy(adv), True)
    _close(got, jppo.normalize_adv(jnp.asarray(adv), True))
    _close(got, (adv - adv.mean()) / (adv.std(ddof=0) + 1e-8))
    assert torch.equal(tppo.normalize_adv(torch.from_numpy(adv), False),
                       torch.from_numpy(adv))


# -- AdamW --------------------------------------------------------------------------

def test_adamw_five_steps_with_clipping_match_jax():
    rng = np.random.default_rng(0)
    params = {"w": _f32(rng, 6, 4), "sub": {"b": _f32(rng, 4)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jadamw.init(jp), tadamw.init(tp)
    kw = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
              max_grad_norm=1.0)
    for i in range(5):
        grads = {"w": _f32(rng, 6, 4, scale=3.0), "sub": {"b": _f32(rng, 4)}}
        jp, js, jst = jadamw.update(jax.tree.map(jnp.asarray, grads), js, jp,
                                    **kw)
        tp, ts, tst = tadamw.update(jax.tree.map(torch.from_numpy, grads), ts,
                                    tp, **kw)
        assert float(tst["grad_norm"]) > 1.0          # clipping engaged
        _close(tst["grad_norm"], jst["grad_norm"])
    _tree_close(tp, jp)
    _tree_close(ts.m, js.m)
    _tree_close(ts.v, js.v)
    assert int(ts.step) == int(js.step) == 5


# -- OceanPolicy --------------------------------------------------------------------

def _policies(obs_dim, recurrent=False, conv_shape=None, hidden=16):
    kw = dict(hidden=hidden, recurrent=recurrent, conv_shape=conv_shape)
    jp = jpolicy.OceanPolicy(obs_dim, (3, 2), **kw)
    tp = tpolicy.OceanPolicy(obs_dim, (3, 2), **kw)
    params = jp.init(jax.random.PRNGKey(obs_dim))
    # non-zero biases, so a bias that went missing shows
    params = jax.tree.map(lambda x: x + 0.1 * jnp.cos(jnp.arange(x.size)
                                                      .reshape(x.shape)),
                          params)
    tparams = ocean_params_from_jax(jax.tree.map(np.asarray, params))
    return jp, tp, params, tparams


@pytest.mark.parametrize("conv_shape", [None, (6, 6)])
def test_ocean_policy_step_matches_jax(conv_shape):
    jp, tp, params, tparams = _policies(36, conv_shape=conv_shape)
    if conv_shape:
        assert tuple(tparams["conv"].shape) == (8, 1, 3, 3)
    obs = _f32(np.random.default_rng(0), 10, 36)
    jl, jv, _ = jp.step(params, jnp.asarray(obs), None)
    tl, tv, carry = tp.step(tparams, torch.from_numpy(obs), None)
    assert carry is None
    _close(tl, jl)
    _close(tv, jv)
    # the non-recurrent seq over (T, B) leading dims
    obs_seq = _f32(np.random.default_rng(1), 4, 5, 36)
    jl, jv, _ = jp.seq(params, jnp.asarray(obs_seq), None, None)
    tl, tv, _ = tp.seq(tparams, torch.from_numpy(obs_seq), None, None)
    _close(tl, jl)
    _close(tv, jv)


def test_ocean_policy_lstm_matches_jax_with_resets():
    jp, tp, params, tparams = _policies(5, recurrent=True)
    rng = np.random.default_rng(0)
    T, B = 12, 6
    obs = _f32(rng, T, B, 5)
    resets = rng.random((T, B)) < 0.25
    resets[T // 2, :] = True                          # a reset mid-sequence
    carry = (_f32(rng, B, 16), _f32(rng, B, 16))
    jl, jv, jc = jp.seq(params, jnp.asarray(obs), tuple(map(jnp.asarray,
                                                             carry)),
                        jnp.asarray(resets))
    tl, tv, tc = tp.seq(tparams, torch.from_numpy(obs),
                        tuple(map(torch.from_numpy, carry)),
                        torch.from_numpy(resets))
    _close(tl, jl)
    _close(tv, jv)
    _tree_close(tc, jc)
    # one step: the carry is zeroed where reset, before the step
    jl, jv, jc = jp.step(params, jnp.asarray(obs[0]),
                         tuple(map(jnp.asarray, carry)), jnp.asarray(resets[0]))
    tl, tv, tc = tp.step(tparams, torch.from_numpy(obs[0]),
                         tuple(map(torch.from_numpy, carry)),
                         torch.from_numpy(resets[0]))
    _close(tl, jl)
    _tree_close(tc, jc)


# -- one whole learn ----------------------------------------------------------------

def _jax_learn_case(env, recurrent):
    """A JAX rollout, JAX's learn from it, and the permutation indices that
    learn drew (learner.py's epoch_perm for one shard)."""
    cfg = dict(num_envs=8, unroll_length=16, update_epochs=2,
               num_minibatches=2, learning_rate=1e-3, gamma=0.95)
    jt, tt = JTrainConfig(**cfg), TrainConfig(**cfg)
    em = jem.Emulated(env)
    dist = jD.Dist("categorical", nvec=em.act_spec.nvec)
    pol = jpolicy.OceanPolicy(em.obs_spec.total, dist.nvec, hidden=32,
                              recurrent=recurrent,
                              num_outputs=dist.num_outputs)
    key = jax.random.PRNGKey(0)
    params = pol.init(jax.random.fold_in(key, 0))
    vec = JVecEnv(em, cfg["num_envs"])
    state, obs = vec.init(jax.random.fold_in(key, 1))
    B = vec.batch_size
    rc = jrollout.RolloutCarry(state, obs, pol.initial_carry(B),
                               jnp.zeros((B,), jnp.bool_))
    step_fn = vec.step_fn()
    # a first rollout, so the learn starts from a live carry
    rc, _, _ = jrollout.rollout(pol, params, step_fn, rc,
                                jax.random.fold_in(key, 2), 16, dist)
    carry0 = rc.policy_carry
    rc, traj, last_value = jrollout.rollout(pol, params, step_fn, rc,
                                            jax.random.fold_in(key, 3), 16,
                                            dist)
    kperm = jax.random.fold_in(key, 4)
    ts0 = jlearner.init_train_state(params)
    learn = jax.jit(jlearner.make_ocean_learn(pol, jt, dist,
                                              kernel_mode="ref"))
    ts1, metrics = learn(ts0, carry0, traj, last_value, kperm)
    E, M = jt.update_epochs, jt.num_minibatches
    n = B if recurrent else 16 * B
    perms = jnp.concatenate([
        jax.random.permutation(jax.random.fold_in(kperm, e), n)
        .reshape(M, n // M) for e in range(E)])
    return (tt, em, dist, params, carry0, traj, last_value, perms, ts1,
            metrics)


@pytest.mark.parametrize("name,recurrent", [("bandit", False),
                                            ("memory", True)])
def test_learn_matches_jax_from_the_same_rollout(name, recurrent):
    (tt, em, dist, params, carry0, traj, last_value, perms, jts,
     jm) = _jax_learn_case(jocean.OCEAN[name](), recurrent)
    assert bool(jnp.any(traj.dones)), "no episode ends in the data"
    tpol = tpolicy.OceanPolicy(em.obs_spec.total, dist.nvec, hidden=32,
                               recurrent=recurrent,
                               num_outputs=dist.num_outputs)
    tdist = tD.Dist("categorical", nvec=dist.nvec)
    T = lambda x: torch.from_numpy(np.array(x))
    ttraj = Trajectory(*(T(x) for x in traj[:7]),
                       infos={k: T(v) for k, v in traj.infos.items()})
    tcarry0 = tuple(map(T, carry0)) if carry0 is not None else None
    ts0 = tlearner.init_train_state(
        ocean_params_from_jax(jax.tree.map(np.asarray, params)))
    learn = tlearner.make_ocean_learn(tpol, tt, tdist)
    ts1, tm = learn(ts0, tcarry0, ttraj, T(last_value), perms=T(perms).long())
    tol = dict(atol=1e-5, rtol=1e-4)
    _tree_close(ts1.params, jts.params, **tol)
    _tree_close(ts1.opt.m, jts.opt.m, **tol)
    assert int(ts1.step) == int(jts.step) == len(perms)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)
