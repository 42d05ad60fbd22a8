"""One-token GQA decode attention: wrapper of ``csrc/flash_decode.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_decode.py``
(``flash_decode``, def at :65, ``pallas_call`` at :84). On the H100 it is
bound by bytes: it must read the filled K/V prefix, 2·B·(length+1)·K·hd
elements, at 3.35 TB/s, and does 4 FLOPs per element read. ``length`` is
read on the device, so a decode step needs no host sync.

The Pallas kernel walks the cache in order on one core; one block per
(batch, KV head) would fill 64 of 132 SMs at the serve shape (B 8, K 8).
So the kernel splits the cache over a thread block cluster of up to 8
blocks per (batch, KV head), each streaming its split through a
``cp.async`` ring, and merges the blocks' softmax statistics and
accumulators inside the cluster, in a fixed order. Where one cluster a
pair leaves SMs idle (B 1, K 8: 64 blocks), a pair takes several
clusters, up to 16; each writes its merge (out in f32 and its
log-sum-exp) to a workspace, and the last to finish merges the parts by
their log-sum-exps in cluster order (a counter on the device that resets
itself: no memset, no second launch).
``plan`` chooses the split from B, K and S on the host (never from
``length``), so one launch serves every prefix length of a cache.

The LSE route (``with_lse``, the context-parallel decode's: each rank
attends over its slice of the sequence, and the ranks merge their softmax
statistics, ``distributed/plan.py::merge_decode``) runs in the same
launch: rank 0 of each cluster already merges the blocks' (m, l), and
writes m + log l beside ``out``, which it writes in f32 so that the
ranks' merge rounds once, as one device's decode does. A local length of
-1 (a rank's slice holds none of the filled prefix) gives out 0 and lse
-inf. The launcher counts each call's route (``build.routes(NAME)``:
"out", "lse").

CPU tensors take the plain version (``ref.flash_decode``); a CUDA tensor
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import check_heads, check_tensors

NAME = "flash_decode"
TILE = 16         # cache positions a tile; splits are multiples of it
MAX_SPLIT = 8     # blocks a cluster (the portable limit); csrc's MAX_SPLIT
MAX_CLUSTERS = 16  # clusters a (batch, KV head, head group); csrc's
WARPS = 2         # warps a block, warp w taking its tiles w, w + 2, ...
GB = 8            # query heads a block
SMEM_MAX = 232448 - 1024  # dynamic shared memory a launch may take (H100:
                          # the block's less 1 KiB of static), csrc's
WAVE = 1          # blocks an SM, at most, unless one a pair exceeds it
SMS = 132         # the H100's SMs
_SMS: dict = {}   # torch.device -> its SM count


def smem_bytes(cl: int, hd: int = 128, elem: int = 2, G: int = 1) -> int:
    """Dynamic shared memory of a launch in clusters of ``cl`` blocks at
    head dim ``hd``, ``elem``-byte caches and G query heads a KV head: the
    layout of ``csrc/flash_decode.cu`` (``Layout``, ``smem_bytes``; the
    card checks the two agree, ``flash_decode_smem``). Each warp's ring of
    R stages of a K and a V tile (rows padded by 16 bytes); f32 then keeps
    the warps' parts, their P tiles, rescales and q, bf16 above hd 128 q
    (rows padded by 16 bytes); and rank 0 takes the other ranks' parts,
    (2 + hd) f32 a head."""
    f32 = elem == 4
    stages = 2 if f32 and hd > 160 else 3
    ring = WARPS * stages * 2 * TILE * (hd + 16 // elem) * elem
    part = (2 * GB + GB * hd) * 4
    if f32:
        slots_off = ring + WARPS * (part + GB * TILE * 4 + GB * 4) + \
            GB * hd * 4
    else:
        slots_off = ring + (GB * (hd + 8) * 2 if hd > 128 else 0)
    return slots_off + (cl - 1) * WARPS * (2 * GB + min(G, GB) * hd) * 4


@functools.lru_cache(maxsize=None)
def cluster_cap(hd: int = 128, elem: int = 2, G: int = 1) -> int:
    """The most blocks a cluster may have at this head dim, cache type and
    group: ``MAX_SPLIT``, less where rank 0's slots would not fit a block's
    shared memory (``smem_bytes``: only f32 at hd 256 with 6 or more heads
    a block, 6 blocks, and 5 at 8 heads)."""
    n = MAX_SPLIT
    while n > 1 and smem_bytes(n, hd, elem, G) > SMEM_MAX:
        n -= 1
    return n


@functools.lru_cache(maxsize=None)
def plan(B: int, K: int, S: int, sms: int = SMS, hd: int = 128,
         elem: int = 2, G: int = 1):
    """(split, n_split) for a cache of S positions at B·K (batch, KV head)
    pairs (each of ceil(G / 8) head groups): n_split blocks a pair, as many
    as keep ``WAVE`` blocks or fewer on each of ``sms`` SMs and at most one
    per 16-position tile, each taking ``split`` positions, a multiple of
    16, the last one the rest. They run in clusters of ``cluster(n_split,
    ...)`` blocks: one cluster of up to ``cluster_cap`` blocks a pair, or,
    where that leaves SMs idle, up to ``MAX_CLUSTERS`` clusters of
    ``cluster_cap`` blocks, as many as keep every block non-empty (the
    split rounds to 16). At the serve shape (B 8, K 8, S 576) that is 2
    blocks of 288 positions, 128 blocks for 132 SMs; at B 1, K 8, S 32,768
    two clusters of 8 blocks of 2,048 (one cluster of 8 would fill 64 SMs).
    A block streams near the card's rate by itself, and more blocks an SM
    measured slower (tools/flash_decode_plans.py): more parts to merge, and
    past about 2.5 blocks an SM clusters that must share a GPC no longer fit
    at once and run in a second wave."""
    tiles = max(1, -(-S // TILE))
    want = min(tiles, max(1, int(WAVE * sms) // max(1, B * K * -(-G // GB))))
    cap = cluster_cap(hd, elem, G)
    for n_cl in range(min(MAX_CLUSTERS, want // cap), 1, -1):
        split = -(-tiles // (n_cl * cap))
        if -(-tiles // split) == n_cl * cap:
            return split * TILE, n_cl * cap
    split = -(-tiles // min(want, cap)) * TILE
    return split, max(1, -(-S // split))


def cluster(n_split: int, hd: int = 128, elem: int = 2, G: int = 1) -> int:
    """Blocks a cluster of a launch of ``n_split`` blocks a pair (``plan``):
    all of them up to ``cluster_cap``, else ``cluster_cap`` (``plan`` makes
    n_split a multiple of it)."""
    return min(n_split, cluster_cap(hd, elem, G))


def max_clusters(cl: int, G: int, hd: int = 128,
                 dtype=torch.bfloat16) -> int:
    """Clusters of ``cl`` blocks (G query heads a KV head) that the current
    card holds at once, by the launcher's
    ``cudaOccupancyMaxActiveClusters``: a grid of more runs in waves."""
    fn = build.load(NAME).flash_decode_max_clusters
    fn.argtypes = [ctypes.c_int] * 4
    n = fn(hd, int(dtype == torch.bfloat16), cl, G)
    if n < 0:
        raise RuntimeError(f"{NAME}: occupancy query failed with "
                           f"cudaError_t {-n}")
    return n


def _sms(dev) -> int:
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def flash_decode(q, k, v, length, with_lse: bool = False):
    """q: (B,H,hd); k, v: (B,S,K,hd) caches; length: () int32 tensor on q's
    device — the newest valid cache index, in [-1, S) (-1: nothing filled,
    the output 0). Returns (B,H,hd) in q.dtype; with ``with_lse`` (out,
    lse), both f32: lse (B,H), each row's log-sum-exp of the scaled scores
    (-inf where nothing is filled), written by the same launch beside
    ``out``, which rounded to q.dtype is the other route's, bit for bit.
    Meta tensors (the dry run) get outputs of the shapes."""
    check_tensors(NAME, {"q": q, "k": k, "v": v}, {"q": 3, "k": 4, "v": 4})
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, hd) or v.shape != k.shape:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    check_heads(NAME, H, K, hd, q.device)
    if q.device.type == "cpu":
        return ref.flash_decode(q, k, v, length, with_lse)
    if q.device.type == "meta":     # the dry run: the outputs' shapes
        if not with_lse:
            return q.new_empty((B, H, hd))
        return (q.new_empty((B, H, hd), dtype=torch.float32),
                q.new_empty((B, H), dtype=torch.float32))
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    if not (torch.is_tensor(length) and length.dtype == torch.int32
            and length.numel() == 1 and length.device == q.device):
        raise TypeError(f"{NAME}: length must be a one-element int32 tensor "
                        f"on {q.device}")
    o = torch.empty((B, H, hd), dtype=torch.float32 if with_lse else q.dtype,
                    device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0 or S == 0:
        o.zero_()
        return (o, lse.fill_(float("-inf"))) if with_lse else o
    G, elem = H // K, q.element_size()
    split, n_split = plan(B, K, S, _sms(q.device), hd, elem, G)
    cl = cluster(n_split, hd, elem, G)
    ws = None        # the clusters' parts, where a pair has several
    if n_split > cl:
        ws = torch.empty(B * K * -(-G // GB) * (n_split // cl) * GB *
                         (1 + hd), dtype=torch.float32, device=q.device)
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            o.data_ptr(), lse.data_ptr() if with_lse else None,
            None if ws is None else ws.data_ptr(), B, S, H, K,
            hd, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd), split,
            n_split, cl, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return (o, lse) if with_lse else o
