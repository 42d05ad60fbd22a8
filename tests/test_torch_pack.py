"""The port's byte pack and emulation's bytes mode against the JAX package.

``pack`` on the CPU (its plain version, ``torch.cat``) equals JAX's
``ref.pack`` and the Pallas kernel run in interpret mode, exactly, on the
sweep of tests/test_kernels.py::test_pack_sweep. Bytes-mode ``emulate``
equals JAX's byte for byte on every port Ocean env's observation space and
a mixed Dict, unbatched and batched; ``unemulate`` inverts it exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import emulation as jem
from repro.core import spaces as jsp
from repro.core.vector import VecEnv as JVecEnv
from repro.envs import ocean as jocean
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bridge import np_unemulate_bytes
from repro_torch.core import emulation as tem
from repro_torch.core import spaces as tsp
from repro_torch.envs import ocean as tocean
from repro_torch.kernels import build, dispatch, ops, ref


def _leaves(sizes, B, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, n), dtype=np.uint8) for n in sizes]


@pytest.mark.parametrize("sizes", [(3,), (3, 7, 16), (1, 1, 1, 128)])
@pytest.mark.parametrize("B", [4, 8])
def test_pack_matches_jax_ref_and_pallas_interpret(sizes, B):
    leaves = _leaves(sizes, B, sum(sizes))
    got = ops.pack([torch.from_numpy(x) for x in leaves])
    assert got.dtype == torch.uint8 and got.shape == (B, sum(sizes))
    jl = [jnp.asarray(x) for x in leaves]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.pack(jl)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.pack(jl, mode="interpret")))


def test_pack_edges_on_the_cpu():
    """Empty leaves, B = 0, a strided row view and more leaves than one
    launch holds: the plain version keeps the concatenation's layout."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.integers(0, 256, (5, 40), dtype=np.uint8))
    strided = base[:, 3:20]                    # row stride 40
    empty = torch.zeros((5, 0), dtype=torch.uint8)
    many = [torch.full((5, 1), i, dtype=torch.uint8) for i in range(70)]
    out = ops.pack([strided, empty] + many)
    assert out.shape == (5, 17 + 70) and out.is_contiguous()
    assert torch.equal(out[:, :17], strided)
    assert torch.equal(out[:, 17:], torch.arange(70, dtype=torch.uint8)
                       .expand(5, 70))
    assert ops.pack([torch.zeros((0, 3), dtype=torch.uint8)]).shape == (0, 3)


def test_pack_argument_errors():
    u8 = torch.zeros((4, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        ops.pack([u8, u8.float()])
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        ops.pack([u8[0]])
    with pytest.raises(ValueError, match="rows"):
        ops.pack([u8, u8[:3]])
    with pytest.raises(ValueError, match="is on meta"):
        ops.pack([u8, u8.to("meta")])
    with pytest.raises(ValueError, match="at least one"):
        ops.pack([])
    with pytest.raises(ValueError, match="at least one"):
        ops.pack([], mode="ref")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ops.pack([u8], mode="cuda")
    assert set(dispatch.implementations("pack")) == {"ref", "cuda"}


def test_pack_on_the_cpu_launches_nothing():
    before = dict(build.LAUNCHES)
    ops.pack([torch.zeros((2, 2), dtype=torch.uint8)])
    assert build.LAUNCHES == before
    assert torch.equal(ref.pack([torch.ones((1, 2), dtype=torch.uint8)]),
                       torch.ones((1, 2), dtype=torch.uint8))


# -- bytes emulation ------------------------------------------------------------

def _mixed(mod):
    return mod.Dict({"pos": mod.Box((2, 3)), "ids": mod.Box((4,), np.int32),
                     "pix": mod.Box((3,), np.uint8),
                     "mask": mod.Box((2,), np.bool_),
                     "arm": mod.Discrete(5),
                     "nested": mod.Tuple([mod.Box((1,)),
                                          mod.MultiDiscrete((2, 3))])})


def _spaces():
    """(name, JAX space, port space): every port Ocean env's observation
    space, then the mixed Dict of f32, int32, uint8 and bool leaves."""
    out = [(n, jocean.OCEAN[n]().observation_space,
            tocean.OCEAN[n]().observation_space) for n in tocean.OCEAN]
    return out + [("mixed", _mixed(jsp), _mixed(tsp))]


def _draw(space, batch, rng):
    """A numpy element of ``space`` (a port space) with leading ``batch``."""
    if isinstance(space, tsp.Dict):
        return {k: _draw(s, batch, rng) for k, s in space.items()}
    if isinstance(space, tsp.Tuple):
        return tuple(_draw(s, batch, rng) for s in space.spaces)
    shape = batch + tsp.leaf_shape(space)
    dt = np.dtype(space.dtype)
    if dt == np.bool_:
        return rng.random(shape) < 0.5
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    return rng.integers(0, 200, shape).astype(dt)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree(v, fn) for v in tree)
    return fn(tree)


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_list(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaf_list(v)]
    return [tree]


@pytest.mark.parametrize("batch", [(), (6,), (3, 4)])
@pytest.mark.parametrize("name,jspace,tspace", _spaces(),
                         ids=[s[0] for s in _spaces()])
def test_bytes_emulate_matches_jax_and_inverts(name, jspace, tspace, batch):
    rng = np.random.default_rng(len(name) + len(batch))
    x = _draw(tspace, batch, rng)
    js, ts = jem.flat_spec(jspace, "bytes"), tem.flat_spec(tspace, "bytes")
    assert ts.total == js.total
    got = tem.emulate(ts, _tree(x, torch.from_numpy))
    want = np.asarray(jem.emulate(js, _tree(x, jnp.asarray)))
    assert got.dtype == torch.uint8 and got.shape == batch + (ts.total,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the exact inverse, on the device tensor and by the numpy twin
    for back in (_tree(tem.unemulate(ts, got), lambda t: t.numpy()),
                 np_unemulate_bytes(ts, got.numpy())):
        for b, w in zip(_leaf_list(back), _leaf_list(x)):
            assert b.dtype == w.dtype and b.shape == w.shape
            np.testing.assert_array_equal(b, w)


def test_bytes_unemulate_bitcasts_and_checks():
    spec = tem.flat_spec(tsp.Box((2,), np.float32), "bytes")
    flat = torch.tensor([[0, 0, 128, 63, 0, 0, 0, 64]], dtype=torch.uint8)
    assert tem.unemulate(spec, flat).tolist() == [[1.0, 2.0]]
    with pytest.raises(TypeError, match="uint8"):
        tem.unemulate(spec, flat.float())
    with pytest.raises(ValueError):
        tem.unemulate(spec, flat[:, :7])


@pytest.mark.parametrize("name", ["spaces", "multiagent"])
def test_emulated_bytes_env_steps_the_obs_bytes_of_jax(name):
    """``Emulated(env, mode="bytes")`` steps N envs from the states the JAX
    envs reached; its obs bytes equal JAX's: for Spaces (whose step draws
    fresh bits) JAX's bytes-mode emulate of the port's next states, for
    Multiagent (deterministic) JAX's own bytes-mode step."""
    N = 16
    jenv, tenv = jocean.OCEAN[name](), tocean.OCEAN[name]()
    jem_env = jem.Emulated(jenv, mode="bytes")
    state, _ = JVecEnv(jem_env, N).init(jax.random.PRNGKey(0))
    tstate = _tree(jax.tree.map(np.asarray, state),
                   lambda a: torch.from_numpy(np.array(a)))
    em = tem.Emulated(tenv, mode="bytes")
    assert em.observation_space == tsp.Box((em.obs_spec.total,), np.uint8)
    rng = np.random.default_rng(1)
    shape = (N, jenv.num_agents, 1) if jenv.num_agents > 1 else (N, 1)
    if name == "spaces":
        shape = (N, 2)
    act = torch.from_numpy(rng.integers(0, 2, shape).astype(np.int32))
    s2, obs, _, _, _ = em.step(tstate, act, torch.Generator().manual_seed(2))
    if name == "spaces":
        js2 = _tree(s2, lambda t: jnp.asarray(t.numpy()))
        want = np.asarray(jem.emulate(jem_env.obs_spec,
                                      jax.vmap(jenv._obs)(js2)))
    else:
        keys = jax.random.split(jax.random.PRNGKey(3), N)
        want = np.asarray(jax.vmap(jem_env.step)(
            state, jnp.asarray(act.numpy()), keys)[1])
    assert obs.dtype == torch.uint8
    np.testing.assert_array_equal(obs.numpy(), want)
    back = em.unemulate_obs(obs)
    np.testing.assert_array_equal(
        tem.emulate(em.obs_spec, back).numpy(), obs.numpy())
