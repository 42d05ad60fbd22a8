"""The port's GAE op (repro_torch.kernels.ops.gae) against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX op (the
Pallas body in interpret mode, and the pure-jnp ``ref``) and through the
port's op. On the CPU the port runs its plain version (``ref.gae``);
tests/test_torch_cuda.py holds the CUDA kernel against it on the card.
Tolerance: atol = rtol = 1e-5, as tests/test_kernels.py::test_gae_sweep.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.gae import gae as gae_wrapper

TOL = dict(atol=1e-5, rtol=1e-5)
GAMMA, LAM = 0.99, 0.95


def _inputs(B, T, done_p, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T), dtype=np.float32)
    v = rng.standard_normal((B, T), dtype=np.float32)
    d = rng.random((B, T)) < done_p
    lv = rng.standard_normal(B, dtype=np.float32)
    return r, v, d, lv


def _jax(r, v, d, lv, mode, bt):
    args = (jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(lv))
    if mode == "ref":
        return np.asarray(jref.gae(*args, GAMMA, LAM))
    return np.asarray(jops.gae(*args, GAMMA, LAM, mode=mode, block_t=bt))


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("B,T,bt", [(4, 32, 8), (8, 128, 128), (2, 64, 16)])
@pytest.mark.parametrize("done_p", [0.0, 0.1, 0.5])
def test_gae_sweep_matches_jax(B, T, bt, done_p, jax_mode):
    r, v, d, lv = _inputs(B, T, done_p, B + T)
    want = _jax(r, v, d, lv, jax_mode, bt)
    got = tops.gae(*(torch.from_numpy(x) for x in (r, v, d, lv)), GAMMA, LAM)
    assert got.dtype == torch.float32 and got.shape == (B, T)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("B,T", [(4, 32), (8, 128), (2, 64)])
@pytest.mark.parametrize("done_p", [0.0, 0.1, 0.5])
def test_gae_reads_transposed_time_major_inputs(B, T, done_p):
    """The learner's call: (B, T) views of (T, B)-stored arrays."""
    r, v, d, lv = _inputs(B, T, done_p, 7 * B + T)
    want = _jax(r, v, d, lv, "ref", T)
    tm = [torch.from_numpy(np.ascontiguousarray(x.T)) for x in (r, v, d)]
    assert not tm[0].T.is_contiguous()
    got = tops.gae(tm[0].T, tm[1].T, tm[2].T, torch.from_numpy(lv),
                   GAMMA, LAM)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gae_matches_python_reference():
    """The op against an independent step-by-step Python loop (the loop of
    tests/test_kernels.py::test_gae_matches_python_reference)."""
    rng = np.random.RandomState(0)
    B, T, g, lam = 3, 20, 0.9, 0.8
    r = rng.randn(B, T).astype(np.float32)
    v = rng.randn(B, T).astype(np.float32)
    d = rng.rand(B, T) < 0.2
    lv = rng.randn(B).astype(np.float32)
    adv = np.zeros((B, T), np.float32)
    for b in range(B):
        a = 0.0
        for t in reversed(range(T)):
            nt = 1.0 - float(d[b, t])
            vn = lv[b] if t == T - 1 else v[b, t + 1]
            delta = r[b, t] + g * vn * nt - v[b, t]
            a = delta + g * lam * nt * a
            adv[b, t] = a
    got = tops.gae(*(torch.from_numpy(x) for x in (r, v, d, lv)), g, lam)
    np.testing.assert_allclose(got.numpy(), adv, **TOL)


def test_gae_cuda_mode_on_cpu_tensors_raises():
    r, v, d, lv = (torch.from_numpy(x) for x in _inputs(2, 8, 0.1, 0))
    before = dict(build.LAUNCHES)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tops.gae(r, v, d, lv, GAMMA, LAM, mode="cuda")
    assert build.LAUNCHES == before


def test_gae_wrapper_checks_shapes():
    r, v, d, lv = (torch.from_numpy(x) for x in _inputs(2, 8, 0.1, 0))
    with pytest.raises(ValueError, match="last_value"):
        gae_wrapper(r, v, d, lv[:1], GAMMA, LAM)
    with pytest.raises(ValueError, match="dones"):
        gae_wrapper(r, v, d[:, :4], lv, GAMMA, LAM)
