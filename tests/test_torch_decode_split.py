"""The flash_decode wrapper's split rule, and the kernel's split-KV
arithmetic emulated on the CPU against JAX.

``plan`` chooses, from B, K and S alone, how many blocks share one (batch,
KV head)'s cache and how many positions each takes, and ``cluster`` how
many of them form a thread block cluster (all of them, up to 8; past 8, a
pair has several clusters); the wrapper passes these to
csrc/flash_decode.cu, which uses them as given (the card tests hold the
kernel to the plain version at the split's edges). On the CPU the wrapper
takes the plain version and counts nothing.

The emulation repeats the kernel's arithmetic in plain torch: each block of
the plan walks its split's 16-position tiles, warp w taking tiles w, w + 2,
..., with an online softmax in log2 units (scores times scale·log2 e, exp2)
whose P is rounded to bf16 before P·V when the cache is bf16 (l sums the f32
P); blocks whose split starts past ``length`` contribute m = -1e30, l = 0.
A cluster's parts merge in (rank, warp) order, each weighted by
2^(m - M) / max(L, 1e-30), into its out and lse = ln 2 (M + log2 L); with
several clusters a pair their (out, lse) then merge in cluster order by
the log-sum-exps, as the context-parallel ranks' do (weights
e^(lse - max lse), normalised by their sum). It is held to
JAX's ``flash_decode`` (the Pallas body in interpret mode, and the pure-jnp
``ref``) at 1e-5 in f32 and 2e-2 in bf16; the LSE route's emulation (out
in f32, lse = ln 2 (M + log2 L)) is held in tests/test_torch_decode_lse.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_decode as fd
from repro_torch.models.convert import to_torch

LOG2E = 1.4426950408889634


@pytest.mark.parametrize("B,K,S,want", [
    (8, 8, 576, (288, 2)),      # qwen3-0.6b's serve step: 128 blocks
    (8, 8, 8192, (4096, 2)),    # a cache past the L2
    (4, 8, 576, (144, 4)),      # half the batch: twice the splits
    (2, 2, 100, (16, 7)),       # S not a multiple of 16: one tile a block
    (1, 1, 577, (80, 8)),       # one pair: a whole cluster
    (1, 1, 15, (16, 1)),        # S < 16: one block
    (1, 1, 1, (16, 1)),         # S = 1
    (33, 4, 576, (576, 1)),     # B·K = 132: a block a pair fills the SMs
    (64, 8, 300, (304, 1)),     # B·K = 512 fills the card unsplit
    (1, 8, 32_768, (2048, 16)),     # the LSE row: two clusters of 8 a pair
    (1, 8, 131_072, (8192, 16)),    # a context-parallel rank of long_500k
    (1, 8, 524_288, (32768, 16)),   # long_500k on one card
    (4, 8, 524_288, (131072, 4)),   # B·K = 32: one cluster of 4 a pair
])
def test_plan(B, K, S, want):
    assert fd.plan(B, K, S) == want


@pytest.mark.parametrize("sms", [132, 114])
def test_plan_invariants(sms):
    """Splits are multiples of 16 and cover S, none of the n_split blocks
    empty; they form clusters of 1 to 8 blocks (``cluster``), at most 16 a
    pair; the grid keeps at most WAVE blocks an SM unless one block a pair
    already exceeds it."""
    for B in (1, 2, 3, 8, 16, 64):
        for K in (1, 2, 4, 8):
            for S in (1, 15, 16, 17, 100, 576, 577, 1000, 4096, 8193,
                      32_768, 524_288):
                split, n = fd.plan(B, K, S, sms)
                cl = fd.cluster(n)
                assert split % fd.TILE == 0 and 1 <= cl <= fd.MAX_SPLIT
                assert n % cl == 0 and n // cl <= fd.MAX_CLUSTERS
                assert (n - 1) * split < S <= n * split
                assert n == 1 or B * K * n <= fd.WAVE * sms


def test_cpu_call_takes_the_plain_version_and_counts_nothing():
    build.reset_launches()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((2, 4, 32), (2, 50, 2, 32), (2, 50, 2, 32)))
    length = torch.tensor(40, dtype=torch.int32)
    torch.testing.assert_close(fd.flash_decode(q, k, v, length),
                               ref.flash_decode(q, k, v, length), atol=0,
                               rtol=0)
    assert build.LAUNCHES["flash_decode"] == 0


def _merge(parts):
    """(out, lse) of parts (m, l, acc) merged in order: the kernel's
    ``merge_weights`` and ``merge_values``, out the parts' acc each weighted
    by 2^(m - M) / max(L, 1e-30), lse = ln 2 (M + log2 L), -inf at L 0."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    a = [torch.exp2(m - M) for m, _, _ in parts]
    Ls = sum(ai * l for ai, (_, l, _) in zip(a, parts))
    inv = 1.0 / Ls.clamp_min(1e-30)
    out = torch.zeros_like(parts[0][2])
    for ai, (_, _, x) in zip(a, parts):
        out = out + (ai * inv)[..., None] * x
    lse = torch.where(Ls > 0, (M + torch.log2(Ls)) * math.log(2.0),
                      -math.inf)
    return out, lse


def _merge_lse(parts):
    """The clusters' (out, lse) merged in order by their log-sum-exps: the
    kernel's ``merge_lse``."""
    M = torch.stack([lse for _, lse in parts]).amax(0)
    w = [torch.where(M > -math.inf, torch.exp2((lse - M) * LOG2E), 0.0)
         for _, lse in parts]
    L = sum(w)
    inv = torch.where(L > 0, 1.0 / L, 0.0)
    out = torch.zeros_like(parts[0][0])
    for wi, (x, _) in zip(w, parts):
        out = out + (wi * inv)[..., None] * x
    return out, torch.where(L > 0, M + torch.log(L), -math.inf)


def _emulate(q, k, v, L, with_lse=False):
    """csrc/flash_decode.cu's arithmetic for q (B,H,hd), caches (B,S,K,hd)
    and the newest valid index L (-1: none); with ``with_lse`` the LSE
    route's (out in f32, lse)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    bf16 = q.dtype == torch.bfloat16
    split, n_split = fd.plan(B, K, S, fd.SMS, hd, q.element_size(), G)
    cl = fd.cluster(n_split, hd, q.element_size(), G)
    c2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    nvalid = min(S, max(L, -1) + 1)
    qf = q.float().reshape(B, K, G, hd)
    kf, vf = k.float(), v.float()
    parts = []                                   # (rank, warp) order
    for r in range(n_split):
        s0, s1 = r * split, min(r * split + split, nvalid)
        ntiles = -(-(s1 - s0) // fd.TILE) if s1 > s0 else 0
        for w in range(fd.WARPS):
            m = torch.full((B, K, G), -1e30)
            l = torch.zeros((B, K, G))
            acc = torch.zeros((B, K, G, hd))
            for tile in range(w, ntiles, fd.WARPS):
                p0 = s0 + tile * fd.TILE
                p1 = min(p0 + fd.TILE, s1)
                s = torch.einsum("bkgd,bpkd->bkgp", qf, kf[:, p0:p1]) * c2
                mn = torch.maximum(m, s.amax(-1))
                al = torch.exp2(m - mn)
                p = torch.exp2(s - mn[..., None])
                l = l * al + p.sum(-1)
                pv = p.to(torch.bfloat16).float() if bf16 else p
                acc = acc * al[..., None] + torch.einsum(
                    "bkgp,bpkd->bkgd", pv, vf[:, p0:p1])
                m = mn
            parts.append((m, l, acc))
    per = cl * fd.WARPS                          # clusters, in order
    clusters = [_merge(parts[c * per:(c + 1) * per])
                for c in range(n_split // cl)]
    out, lse = clusters[0] if len(clusters) == 1 else _merge_lse(clusters)
    out = out.reshape(B, H, hd)
    if not with_lse:
        return out.to(q.dtype)
    return out, lse.reshape(B, H)


def _pair(rng, shape, dtype):
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return a, to_torch(np.asarray(a))


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,H,K,hd,S,L,block_s", [
    (2, 4, 2, 32, 64, 63, 16),     # every split full
    (1, 8, 2, 64, 100, 99, 20),    # S not a multiple of 16
    (2, 4, 2, 32, 200, 30, 40),    # splits wholly past length
    (1, 2, 1, 16, 577, 300, 577),  # the last split ragged, half filled
    (2, 8, 1, 32, 96, 0, 32),      # length 0: one position, G 8
    (1, 2, 2, 128, 48, 33, 48),    # G 1 at hd 128
    (1, 4, 4, 256, 96, 70, 32),    # G 1 at hd 256 (gemma-7b)
    (1, 8, 2, 160, 80, 79, 16),    # G 4 at hd 160 (stablelm-12b)
])
def test_split_arithmetic_matches_jax(B, H, K, hd, S, L, block_s, dtype, tol,
                                      jax_mode):
    rng = np.random.default_rng(S + L + hd)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(L, jnp.int32),
                             mode=jax_mode, block_s=block_s)
    got = _emulate(q, k, v, L)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# B 1 shapes whose plan gives a pair several clusters: (B, H, K, hd, S,
# block_s of the Pallas run)
MULTI = [(1, 4, 1, 64, 512, 64),       # 4 clusters of 8 blocks of 16
         (1, 8, 2, 128, 1024, 128),    # 8 clusters of 8, G 4
         (1, 4, 4, 256, 768, 96),      # 3 clusters of 8 of 32, hd 256
         (1, 8, 2, 160, 640, 80)]      # 5 clusters of 8, hd 160


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("frac", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("B,H,K,hd,S,block_s", MULTI)
def test_merge_across_clusters_matches_jax(B, H, K, hd, S, block_s, frac,
                                           dtype, tol, jax_mode):
    """More than 8 blocks a pair at B 1: each cluster's (out, lse), the
    clusters merged in order by their log-sum-exps, against JAX's decode;
    at 0.4 of the cache the later clusters hold nothing."""
    assert fd.plan(B, K, S, fd.SMS, hd)[1] > fd.MAX_SPLIT
    L = int(frac * (S - 1))
    rng = np.random.default_rng(S + L + hd)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(L, jnp.int32),
                             mode=jax_mode, block_s=block_s)
    got = _emulate(q, k, v, L)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_emulation_splits_where_the_plan_says():
    """The emulated cases reach more than one block, blocks wholly past
    length, a ragged last split, and several clusters a pair with the
    later ones past length."""
    assert fd.plan(2, 2, 64)[1] > 1
    split, n = fd.plan(2, 2, 200)
    assert 30 < split * (n - 1)              # blocks past L = 30
    split, n = fd.plan(1, 1, 577)
    assert 577 % split and 300 < split * (n - 1)
    for B, H, K, hd, S, _ in MULTI:
        split, n = fd.plan(B, K, S, fd.SMS, hd, 2, H // K)
        cl = fd.cluster(n, hd, 2, H // K)
        assert n // cl > 2 and int(0.4 * (S - 1)) < split * cl * (n // cl - 1)
