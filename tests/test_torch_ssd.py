"""The port's SSD op (repro_torch.kernels.ops.ssd) against the JAX package.

The same inputs, made with numpy from a seed as tests/test_kernels.py's
``test_ssd_sweep`` draws them, go through the JAX op (the Pallas body in
interpret mode, and the step-by-step ``ref``) and through the port's op.
On the CPU the port runs its plain version (``ref.ssd``);
tests/test_torch_cuda.py holds the CUDA kernel against it on the card.
Tolerances: f32 atol = rtol = 1e-4, as ``test_ssd_sweep``; bf16 2e-2 (y is
rounded to bf16 on both sides, at other places inside).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ssd import ssd as ssd_wrapper

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(B, T, H, hd, ds, seed):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, T, H, hd), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H), dtype=np.float32)))
    A = -np.exp(0.3 * rng.standard_normal(H, dtype=np.float32))
    B_ = 0.5 * rng.standard_normal((B, T, H, ds), dtype=np.float32)
    C = 0.5 * rng.standard_normal((B, T, H, ds), dtype=np.float32)
    return x, dt, A, B_, C


def _both(x, dt, A, B_, C, dtype):
    """The inputs as JAX arrays and torch tensors; x, B_, C in ``dtype``."""
    jx = [jnp.asarray(a) for a in (x, dt, A, B_, C)]
    tx = [torch.from_numpy(a) for a in (x, dt, A, B_, C)]
    if dtype == "bfloat16":
        for i in (0, 3, 4):
            jx[i] = jx[i].astype(jnp.bfloat16)
            tx[i] = tx[i].bfloat16()
    return jx, tx


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else
                      np.asarray(t, np.float32))


def _check(got, want, dtype):
    (y, h), (jy, jh) = got, want
    assert str(y.dtype).endswith(dtype) and h.dtype == torch.float32
    assert y.shape == jy.shape and h.shape == jh.shape
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype])
    np.testing.assert_allclose(_np(h), _np(jh), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("B,T,H,hd,ds,chunk", [
    (1, 16, 1, 8, 8, 4),
    (2, 64, 3, 16, 32, 16),
    (1, 128, 2, 32, 16, 64),
])
def test_ssd_sweep_matches_jax(B, T, H, hd, ds, chunk, jax_mode, dtype):
    jx, tx = _both(*_inputs(B, T, H, hd, ds, T + H), dtype)
    if jax_mode == "ref":
        want = jref.ssd(*jx)
    else:
        want = jops.ssd(*jx, chunk=chunk, mode="interpret")
    _check(tops.ssd(*tx, chunk=chunk), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,hd,ds,chunk", [
    (2, 37, 3, 16, 8, 16),      # ragged: T % chunk != 0
    (1, 1, 2, 8, 8, 4),         # one step
    (2, 5, 2, 8, 16, 16),       # T < chunk
])
def test_ssd_ragged_and_short_match_jax_ref(B, T, H, hd, ds, chunk, dtype):
    """Lengths the Pallas kernel refuses (it asserts T % chunk == 0) and the
    CUDA kernel takes: against JAX's step-by-step oracle only."""
    jx, tx = _both(*_inputs(B, T, H, hd, ds, 3 * T + hd), dtype)
    _check(tops.ssd(*tx, chunk=chunk), jref.ssd(*jx), dtype)


def test_ssd_wrapper_checks_shapes_and_backend():
    _, tx = _both(*_inputs(1, 8, 2, 8, 4, 0), "float32")
    x, dt, A, B_, C = tx
    with pytest.raises(ValueError, match="dt"):
        ssd_wrapper(x, dt[:, :4], A, B_, C)
    with pytest.raises(ValueError, match="C"):
        ssd_wrapper(x, dt, A, B_, C[..., :2])
    with pytest.raises(ValueError, match="T >= 1"):
        ssd_wrapper(x[:, :0], dt[:, :0], A, B_[:, :0], C[:, :0])
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tops.ssd(x, dt, A, B_, C, mode="cuda")
