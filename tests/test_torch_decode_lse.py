"""``flash_decode``'s LSE route (the context-parallel decode's) against
numpy and the JAX package.

* the plain version's ``out`` with ``with_lse`` against the Pallas kernel
  in interpret mode and JAX's ``ref`` (the tolerances of
  tests/test_torch_kernels.py: f32 2e-5, bf16 2e-2), and its ``lse``
  against a numpy log-sum-exp of the scaled scores in f64 (f32 1e-5
  relative to its magnitude); ``out`` is f32, unrounded, and rounded to
  the inputs' type equal bit for bit to the call without ``with_lse``;
* a local length of -1 (a context-parallel rank whose slice holds none of
  the filled prefix): ``out`` 0 and ``lse`` -inf;
* a cache split into slices, each decoded at its local length (clamped to
  [-1, S_l), as ``models/attention.py`` does), merged by the LSEs
  (``plan.merge_decode``'s arithmetic), equals the whole cache's decode
  within 1e-6 (f32), and a split into one slice is it bit for bit; in
  bf16 the merged rows, rounded once, are within half a bf16 unit of the
  whole cache's f32 decode and within one unit of its bf16 decode;
* the meta path: shapes, and the work recorded in ``kernels/cost.py``;
* the kernel's LSE route as tests/test_torch_decode_split.py emulates it,
  at B 1 shapes whose plan gives a (batch, KV head) several clusters:
  ``out`` against the Pallas kernel and JAX's ``ref`` at this file's
  tolerances, ``lse`` against numpy's, at lengths -1, 0, mid and S - 1.

The CUDA route is held to the plain version on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cost
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.models.convert import to_torch
from test_torch_decode_split import MULTI, _emulate

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [(2, 4, 2, 32, 64, 16), (1, 8, 1, 64, 48, 16),
          (3, 6, 3, 16, 40, 8)]              # B, H, K, hd, S, block_s


def _pair(rng, shape, dtype):
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return a, to_torch(np.asarray(a))


def _np_lse(q, k, L):
    """log-sum-exp over positions <= L of q . k / sqrt(hd), in f64."""
    B, H, hd = q.shape
    K = k.shape[2]
    qg = q.astype(np.float64).reshape(B, K, H // K, hd)
    s = np.einsum("bkgh,bskh->bkgs", qg, k.astype(np.float64)[:, :L + 1])
    s = s / math.sqrt(hd)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(B, H)


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("B,H,K,hd,S,bs", SHAPES)
def test_lse_route_matches_numpy_and_the_pallas_kernel(B, H, K, hd, S, bs,
                                                       frac, dtype,
                                                       jax_mode):
    rng = np.random.default_rng(B * S + hd)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    L = int(frac * (S - 1))
    length = torch.tensor(L, dtype=torch.int32)
    out, lse = tops.flash_decode(q, k, v, length, with_lse=True)
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(L, jnp.int32),
                             mode=jax_mode, block_s=bs)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert out.dtype == torch.float32
    assert torch.equal(out.to(q.dtype), tops.flash_decode(q, k, v, length))
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    w = _np_lse(q.float().numpy(), k.float().numpy(), L)
    np.testing.assert_allclose(lse.numpy(), w, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(w).max()))


def test_local_length_minus_one_is_empty():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)))
    none = torch.tensor(-1, dtype=torch.int32)
    out, lse = tops.flash_decode(q, k, v, none, with_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isinf(lse).all() and (lse < 0).all()
    assert torch.equal(tops.flash_decode(q, k, v, none), out)


def _merge(parts):
    """``plan.merge_decode``'s arithmetic over a list of (out, lse)."""
    m = torch.stack([lse for _, lse in parts]).amax(0)
    num = den = 0.0
    for out, lse in parts:
        w = torch.exp(lse - m)[..., None]
        num = num + out.float() * w
        den = den + w
    return num / den


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("L", [0, 15, 16, 40, 63])
def test_merged_slices_equal_the_whole_cache(n, L):
    """S 64 over n slices at local lengths clamp(L - r·S_l, -1, S_l - 1):
    empty, partial and full slices, and L on a slice boundary."""
    rng = np.random.default_rng(L + n)
    B, H, K, hd, S = 2, 4, 2, 32, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    length = torch.tensor(L, dtype=torch.int32)
    whole = tops.flash_decode(q, k, v, length)
    Sl = S // n
    parts = [tops.flash_decode(
        q, k[:, r * Sl:(r + 1) * Sl], v[:, r * Sl:(r + 1) * Sl],
        (length - r * Sl).clamp(-1, Sl - 1), with_lse=True)
        for r in range(n)]
    got = _merge(parts)
    if n == 1:
        assert torch.equal(got, whole)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("L", [15, 16, 40, 63])
def test_merged_bf16_slices_round_once(n, L):
    """bf16 caches over n slices: each slice's ``out`` stays f32, so the
    merged row rounded to bf16 is within half a bf16 unit of the whole
    cache's f32 decode (1e-7 beside it for the merge's f32 arithmetic), as
    one rounding is, and within one unit of the whole cache's bf16
    decode. Slices rounded to bf16 before the merge miss the first bound
    in 6 of these 8 cases, at 71-117 of their 256 elements."""
    rng = np.random.default_rng(100 + L + n)
    B, H, K, hd, S = 2, 4, 2, 32, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(torch.bfloat16)
               for s in ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    length = torch.tensor(L, dtype=torch.int32)
    truth = tops.flash_decode(q.float(), k.float(), v.float(), length)
    whole = tops.flash_decode(q, k, v, length)
    Sl = S // n
    got = _merge([tops.flash_decode(
        q, k[:, r * Sl:(r + 1) * Sl], v[:, r * Sl:(r + 1) * Sl],
        (length - r * Sl).clamp(-1, Sl - 1), with_lse=True)
        for r in range(n)]).to(torch.bfloat16).float()
    unit = 2.0 ** (torch.floor(torch.log2(truth.abs())) - 7)
    assert ((got - truth).abs() <= unit / 2 + 1e-7).all()
    assert ((got - whole.float()).abs() <= unit + 1e-7).all()


def test_meta_path_gives_shapes_and_records_the_work():
    q = torch.empty((2, 8, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((2, 128, 2, 64), device="meta", dtype=torch.bfloat16)
    length = torch.empty((), device="meta", dtype=torch.int32)
    with cost.recording() as log:
        out, lse = tops.flash_decode(q, k, k, length, with_lse=True)
    assert out.shape == (2, 8, 64) and lse.shape == (2, 8)
    assert lse.dtype == out.dtype == torch.float32
    assert out.device.type == "meta"
    assert log.kernels == [("flash_decode",
                            *map(float, cost.decode_work(2, 127, 8, 2, 64, 2,
                                                         True)))]
    # the bound of a full cache: K/V prefix and q, o and the lse in f32
    assert log.kernels[0][2] == 2 * (2 * 2 * 128 * 2 * 64 + 2 * 8 * 64) + \
        4 * 2 * 8 * 64 + 4 * 2 * 8


def test_plain_version_without_lse_is_unchanged():
    """The plain version's ``out`` is the softmax form of before, bit for
    bit, at every length in [0, S)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((1, 2, 16), (1, 20, 1, 16), (1, 20, 1, 16)))
    for L in range(20):
        length = torch.tensor(L, dtype=torch.int32)
        s = torch.einsum("bkgh,bskh->bkgs", q.reshape(1, 1, 2, 16),
                         k) / math.sqrt(16)
        s = s.masked_fill(~(torch.arange(20) <= length), -1e30)
        o = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, -1), v)
        assert torch.equal(ref.flash_decode(q, k, v, length),
                           o.reshape(1, 2, 16))


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [-1, 0.0, 0.4, 1.0])
@pytest.mark.parametrize("B,H,K,hd,S,bs", MULTI)
def test_lse_route_merged_across_clusters(B, H, K, hd, S, bs, frac, dtype,
                                          jax_mode):
    """The emulated LSE route over several clusters a pair (more than 8
    blocks at B 1): ``out`` f32 against JAX, ``lse`` against numpy, and
    rounded to the dtype ``out`` is the emulated plain route's; at -1 out 0
    and lse -inf."""
    rng = np.random.default_rng(S + hd + 7)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    L = -1 if frac < 0 else int(frac * (S - 1))
    out, lse = _emulate(q, k, v, L, with_lse=True)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out.to(q.dtype), _emulate(q, k, v, L))
    if L < 0:
        assert not out.any() and torch.isinf(lse).all() and (lse < 0).all()
        return
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(L, jnp.int32),
                             mode=jax_mode, block_s=bs)
    np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    w = _np_lse(q.float().numpy(), k.float().numpy(), L)
    np.testing.assert_allclose(lse.numpy(), w, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(w).max()))
