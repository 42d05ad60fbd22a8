"""The ssd wrapper's route rule, and the arithmetic of the kernels'
redesigns (``ssd`` on the tensor cores, ``gae`` as a segmented scan)
emulated on the CPU against JAX.

``ssd.route`` names the kernel a CUDA call takes, by the rule the launcher
in csrc/ssd.cu applies (the card tests hold the launcher's own count to
it): bf16 x with head dim and state size multiples of 16, head dim <= 64,
chunk >= 16 and inputs the 16-byte copies can read go to the tensor cores;
all else to the CUDA cores. ``ssd.bwd_route`` does the same for the
backward (csrc/ssd_bwd.cu): bf16 with head dim and state size multiples of
16, head dim <= 64 and aligned x, B_ and C to the tensor cores, whatever
the forward's chunk. On the CPU the wrappers take the plain version and
count nothing.

The SSD emulation repeats the tensor-core kernel's arithmetic in plain
torch: f32 products of the bf16 inputs, the cumsum of dt·A in log2 units and
exp2, and rounding at exactly three points: the masked scores enter S·x as
bf16 hi + lo; the f32 state enters C·hᵀ as bf16 hi + lo; x·w is rounded
once to bf16 before the state update. The state and h_last stay f32. It is
held
to JAX's ``ssd`` (the Pallas body in interpret mode, and the step-by-step
``ref``) at 2e-2 in bf16, over T that spans four chunks so that the carried
state's rounding is exercised.

The GAE emulation repeats csrc/gae.cu's order: T cut into ``gae.SEGMENTS``
segments of ceil(T / SEGMENTS) steps; each segment's affine map A_in =
a + b·A_out composed from A_out = 0 backward; the carries combined from the
last segment down; then each segment's recurrence rerun from its carry. It
is held to JAX's ``gae`` at 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ref
from repro_torch.kernels import gae as gae_mod
from repro_torch.kernels import ssd as ssd_mod

BF = torch.bfloat16
LOG2E = 1.4426950408889634
GAMMA, LAM = 0.99, 0.95


@pytest.mark.parametrize("dtype,hd,ds,chunk,aligned,want", [
    (BF, 64, 128, 128, True, "tensor_core"),            # mamba2's serve call
    (BF, 64, 128, 16, True, "tensor_core"),             # the shortest chunk
    (BF, 16, 16, 64, True, "tensor_core"),              # the smallest tiles
    (BF, 48, 32, 100, True, "tensor_core"),             # a ragged chunk
    (torch.float32, 64, 128, 128, True, "cuda_core"),   # f32 x
    (BF, 128, 128, 128, True, "cuda_core"),             # head dim past 64
    (BF, 8, 8, 4, True, "cuda_core"),                   # below a tile
    (BF, 40, 128, 128, True, "cuda_core"),              # head dim off 16
    (BF, 64, 24, 128, True, "cuda_core"),               # state off 16
    (BF, 64, 128, 15, True, "cuda_core"),               # chunk below 16
    (BF, 64, 128, 128, False, "cuda_core"),             # unaligned inputs
])
def test_route(dtype, hd, ds, chunk, aligned, want):
    assert ssd_mod.route(dtype, hd, ds, chunk, aligned) == want


@pytest.mark.parametrize("dtype,hd,ds,aligned,want", [
    (BF, 64, 128, True, "tensor_core"),             # mamba2's training call
    (BF, 16, 16, True, "tensor_core"),              # the smallest tiles
    (BF, 48, 32, True, "tensor_core"),              # partial tiles
    (BF, 32, 128, True, "tensor_core"),
    (torch.float32, 64, 128, True, "cuda_core"),    # f32: the f32 gates
    (BF, 128, 128, True, "cuda_core"),              # head dim past 64
    (BF, 80, 64, True, "cuda_core"),                # head dim past 64
    (BF, 8, 8, True, "cuda_core"),                  # below a tile
    (BF, 40, 128, True, "cuda_core"),               # head dim off 16
    (BF, 64, 24, True, "cuda_core"),                # state off 16
    (BF, 64, 128, False, "cuda_core"),              # unaligned inputs
])
def test_bwd_route(dtype, hd, ds, aligned, want):
    """``ssd.bwd_route`` names the backward kernel a CUDA call of
    ``ssd_bwd`` takes; the forward's chunk does not enter (the tensor
    cores take chunks of ``BWD_CHUNK`` steps of their own)."""
    assert ssd_mod.bwd_route(dtype, hd, ds, aligned) == want
    assert ssd_mod.BWD_CHUNK == 64


def test_ssd_bwd_on_a_cpu_tensor_takes_the_plain_version():
    """On the CPU ``ssd_bwd`` and ``ssd_bwd_cuda_core`` return the plain
    backward, and count no launch."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 9, 2, 16, generator=g)
    dt = torch.rand(1, 9, 2, generator=g) + 0.1
    A = -torch.rand(2, generator=g) - 0.1
    B_, C = (torch.randn(1, 9, 2, 16, generator=g) for _ in range(2))
    dy = torch.randn(1, 9, 2, 16, generator=g)
    before = dict(build.LAUNCHES)
    want = ref.ssd_bwd(x, dt, A, B_, C, dy)
    for got in (ssd_mod.ssd_bwd(x, dt, A, B_, C, dy),
                ssd_mod.ssd_bwd_cuda_core(x, dt, A, B_, C, dy)):
        for g_, w in zip(got, want):
            torch.testing.assert_close(g_, w)
    assert build.LAUNCHES == before


def _conv_row(B, T, H, hd, ds, G, offset=0, pad=0):
    """x, B_ and C as models/ssm.py cuts them from one conv-output buffer
    (B, T, H*hd + 2*G*ds): x a view, B_/C expanded over heads."""
    buf = torch.zeros((B, T, offset + H * hd + 2 * G * ds + pad), dtype=BF)
    row = buf[..., offset:]
    x = row[..., :H * hd].unflatten(-1, (H, hd))
    bc = [row[..., H * hd + i * G * ds:H * hd + (i + 1) * G * ds]
          .unflatten(-1, (G, ds)).unsqueeze(-2)
          .expand(B, T, G, H // G, ds).flatten(-3, -2) for i in range(2)]
    return x, bc[0], bc[1]


@pytest.mark.parametrize("offset,pad,G,want", [
    (0, 0, 1, True),      # mamba2-1.3b: rows of 4352 bf16, stride-0 B_/C
    (0, 0, 2, True),      # two groups
    (8, 8, 1, True),      # a 16-byte offset and row pad
    (4, 0, 1, False),     # an 8-byte offset
    (0, 4, 1, False),     # a row stride off 8 elements
])
def test_alignment_of_the_conv_views(offset, pad, G, want):
    x, B_, C = _conv_row(2, 5, 64, 64, 128, G, offset, pad)
    assert ssd_mod.alignment(x, B_, C) == want


def test_alignment_needs_unit_element_stride():
    x, B_, C = _conv_row(2, 5, 4, 64, 128, 1)
    xt = torch.zeros((2, 5, 4, 128), dtype=BF)[..., ::2]
    assert ssd_mod.alignment(x, B_, C)
    assert not ssd_mod.alignment(xt, B_, C)


def test_cpu_calls_take_the_plain_versions_and_count_nothing():
    build.reset_launches()
    rng = np.random.default_rng(0)
    x, dt, A, B_, C = _ssd_inputs(rng, 1, 20, 2, 16, 16)
    tx = [torch.from_numpy(a) for a in (x, dt, A, B_, C)]
    for got, want in zip(ssd_mod.ssd(*tx, chunk=16), ref.ssd(*tx)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    r, v = (torch.from_numpy(rng.standard_normal((3, 9), np.float32))
            for _ in range(2))
    d = torch.from_numpy(rng.random((3, 9)) < 0.2)
    lv = torch.from_numpy(rng.standard_normal(3, np.float32))
    torch.testing.assert_close(gae_mod.gae(r, v, d, lv, GAMMA, LAM),
                               ref.gae(r, v, d, lv, GAMMA, LAM), atol=0,
                               rtol=0)
    assert build.LAUNCHES["ssd"] == 0 and build.LAUNCHES["gae"] == 0


# -- ssd: the tensor-core route's arithmetic ----------------------------------

def _ssd_inputs(rng, B, T, H, hd, ds):
    """As tests/test_kernels.py's test_ssd_sweep draws them."""
    x = 0.5 * rng.standard_normal((B, T, H, hd), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H), dtype=np.float32)))
    A = -np.exp(0.3 * rng.standard_normal(H, dtype=np.float32))
    B_ = 0.5 * rng.standard_normal((B, T, H, ds), dtype=np.float32)
    C = 0.5 * rng.standard_normal((B, T, H, ds), dtype=np.float32)
    return x, dt, A, B_, C


def _bf(t):
    return t.to(BF).float()


def _hilo(t):
    """bf16 hi + lo of f32 t, as the kernel's two products see it."""
    hi = _bf(t)
    return hi + _bf(t - hi)


def _emulate_ssd(x, dt, A, B_, C, chunk):
    """csrc/ssd.cu's tensor-core arithmetic for bf16 x, B_, C (B,T,H,*),
    dt (B,T,H) and A (H,) in f32: (y in bf16, h_last in f32)."""
    Bb, T, H, hd = x.shape
    ds = B_.shape[-1]
    xf, bf, cf = (t.float().transpose(1, 2) for t in (x, B_, C))  # (B,H,T,*)
    a2 = A.float() * torch.tensor(LOG2E, dtype=torch.float32)
    dth = dt.float().transpose(1, 2)                               # (B,H,T)
    h = torch.zeros((Bb, H, hd, ds))
    ys = []
    Q = min(chunk, T)
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        xs, bs, cs = (t[:, :, c0:c0 + q] for t in (xf, bf, cf))
        d = dth[:, :, c0:c0 + q]
        cum = torch.cumsum(d * a2[None, :, None], dim=-1)          # (B,H,q)
        clast = cum[..., -1:]
        w = torch.exp2(clast - cum) * d
        xw = _bf(xs * w[..., None])
        causal = torch.ones(q, q).tril().bool()
        decay = torch.exp2((cum[..., :, None] - cum[..., None, :])
                           .masked_fill(~causal, -math.inf))
        s = (cs @ bs.transpose(-1, -2)) * (decay * d[..., None, :])
        y = torch.exp2(cum)[..., None] * (cs @ _hilo(h).transpose(-1, -2))
        y = y + _hilo(s) @ xs
        ys.append(y)
        h = torch.exp2(clast)[..., None] * h + xw.transpose(-1, -2) @ bs
    y = torch.cat(ys, dim=2).transpose(1, 2)
    return y.to(x.dtype), h


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("B,T,H,hd,ds,chunk", [
    (1, 64, 2, 16, 16, 16),      # four chunks: the carried h rounded thrice
    (2, 128, 2, 32, 32, 32),     # four chunks at wider tiles
    (1, 128, 1, 64, 128, 128),   # mamba2's head dim, state and chunk
    (2, 48, 3, 16, 48, 16),      # three chunks, a state of 48
    (2, 300, 4, 48, 32, 100),    # head dim 48, a chunk of 100 (not 16k)
])
def test_tensor_core_arithmetic_matches_jax(B, T, H, hd, ds, chunk,
                                            jax_mode):
    rng = np.random.default_rng(T + hd + ds)
    x, dt, A, B_, C = _ssd_inputs(rng, B, T, H, hd, ds)
    jx = [jnp.asarray(a) for a in (x, dt, A, B_, C)]
    for i in (0, 3, 4):
        jx[i] = jx[i].astype(jnp.bfloat16)
    if jax_mode == "ref":
        jy, jh = jref.ssd(*jx)
    else:
        jy, jh = jops.ssd(*jx, chunk=chunk, mode="interpret")
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in jx]
    for i in (0, 3, 4):
        tx[i] = tx[i].to(BF)
    y, h = _emulate_ssd(*tx, chunk=chunk)
    assert y.dtype == BF and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("T,chunk", [(1, 128), (15, 128), (129, 128),
                                     (300, 100), (37, 16)])
def test_tensor_core_arithmetic_on_ragged_lengths_matches_jax_ref(T, chunk):
    """Lengths the Pallas kernel refuses (T % chunk != 0, T < 16) and the
    kernel takes, padding its tail chunk: against JAX's oracle."""
    rng = np.random.default_rng(T)
    x, dt, A, B_, C = _ssd_inputs(rng, 1, T, 2, 16, 32)
    jx = [jnp.asarray(a) for a in (x, dt, A, B_, C)]
    for i in (0, 3, 4):
        jx[i] = jx[i].astype(jnp.bfloat16)
    jy, jh = jref.ssd(*jx)
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in jx]
    for i in (0, 3, 4):
        tx[i] = tx[i].to(BF)
    y, h = _emulate_ssd(*tx, chunk=chunk)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh, np.float32),
                               atol=2e-2, rtol=2e-2)


# -- gae: the segmented scan's order ------------------------------------------

def _emulate_gae(r, v, d, lv, gamma, lam):
    """csrc/gae.cu's arithmetic for (B, T) rewards, values, dones and (B,)
    last values, in f32."""
    B, T = r.shape
    S = gae_mod.SEGMENTS
    L = -(-T // S)
    nt = 1.0 - d.float()
    gl = torch.tensor(gamma * lam, dtype=torch.float32)
    gamma = torch.tensor(gamma, dtype=torch.float32)
    v_after = torch.cat([v[:, 1:], lv[:, None]], dim=1)    # V_{t+1}
    delta = r + gamma * v_after * nt - v
    bounds = [(min(s * L, T), min(s * L + L, T)) for s in range(S)]
    maps = []
    for t0, t1 in bounds:                # A_in = a + c A_out, from A_out = 0
        a, c = torch.zeros(B), torch.ones(B)
        for t in range(t1 - 1, t0 - 1, -1):
            a = delta[:, t] + gl * nt[:, t] * a
            c = gl * nt[:, t] * c
        maps.append((a, c))
    out = torch.empty_like(r)
    for s, (t0, t1) in enumerate(bounds):
        adv = torch.zeros(B)
        for k in range(S - 1, s, -1):    # the later maps, last first
            adv = maps[k][0] + maps[k][1] * adv
        for t in range(t1 - 1, t0 - 1, -1):
            adv = delta[:, t] + gl * nt[:, t] * adv
            out[:, t] = adv
    return out


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("B,T,block_t", [
    (33, 64, 16),     # the full-size update's T: one chunk a segment
    (3, 1000, 200),   # segments of 125 steps, streamed in chunks
    (5, 37, 37),      # ragged segments, the last one short
    (4, 1, 1),        # one step: seven empty segments
    (2, 9, 9),        # segments of 2 steps, the last three empty
])
@pytest.mark.parametrize("done_p", [0.0, 0.1, 0.5])
def test_segmented_gae_matches_jax(B, T, block_t, done_p, jax_mode):
    rng = np.random.default_rng(B * T + int(10 * done_p))
    r = rng.standard_normal((B, T), dtype=np.float32)
    v = rng.standard_normal((B, T), dtype=np.float32)
    d = rng.random((B, T)) < done_p
    lv = rng.standard_normal(B, dtype=np.float32)
    args = (jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(lv))
    if jax_mode == "ref":
        want = jref.gae(*args, GAMMA, LAM)
    else:
        want = jops.gae(*args, GAMMA, LAM, mode="interpret", block_t=block_t)
    got = _emulate_gae(*(torch.from_numpy(a) for a in (r, v, d, lv)),
                       GAMMA, LAM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_segmented_gae_last_segment_is_the_plain_walk():
    """With carry 0 the last segment repeats the step-by-step recurrence."""
    rng = np.random.default_rng(1)
    r, v = (torch.from_numpy(rng.standard_normal((6, 64), np.float32))
            for _ in range(2))
    d = torch.from_numpy(rng.random((6, 64)) < 0.1)
    lv = torch.from_numpy(rng.standard_normal(6, np.float32))
    got = _emulate_gae(r, v, d, lv, GAMMA, LAM)
    want = ref.gae(r, v, d, lv, GAMMA, LAM)
    torch.testing.assert_close(got[:, 56:], want[:, 56:], atol=0, rtol=0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
