"""Causal GQA flash attention: wraps ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward).

The forward replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py`` (``flash_attention``, def at :74,
``pallas_call`` at :93). What bounds it on the H100: at the serve shape (B 8,
T 512, H 16, K 8, hd 128, bf16) it must move q, k, v and o once, 50 MB (15
µs at 3.35 TB/s), and do 8.6 GFLOP of causal products (8.7 µs at 989
TFLOP/s of bf16 tensor cores): bytes bound it up to T ≈ 885 at this head
layout, operations beyond. In bf16 the products run on the tensor cores: at
head dims 64, 128, 160 and 256 (the serve path; 160 carried as three
64-column halves, K/V tiles of 64 rows above 128) as ``wgmma`` fed by TMA
through an mbarrier ring, at 16 and 32 as ``mma.sync`` fed by
``cp.async``; both round P to bf16 before P·V. The f32 kernel, which only
the TF32-off parity checks use, runs on the f32 CUDA cores (see the .cu
note). The launcher counts the route each call took (``fwd_route``,
``build.routes(NAME)``). Asked for it (``with_lse``), each writes the
rows' log-sum-exp, f32 (B, H, T).

The backward has no Pallas counterpart: JAX differentiates the jnp program
around its forward-only kernel. On the card ``flash_attention`` is an
autograd ``Function`` when a gradient is needed: its forward launches the
forward kernel with the LSE output, its backward ``flash_attention_bwd``
(dq, dk, dv; dk and dv summed over a KV head's query heads; deterministic,
no atomics). With no gradient needed (serving) it is the forward launch
alone, as before. The backward takes one of two routes (``bwd_route``;
the launcher counts the one each call took, ``build.routes(BWD)``): bf16
at head dims 64, 128, 160 and 256 (the training path) runs ``wgmma`` fed
by TMA, rounding P and dS to bf16 before its three products from
registers, as FlashAttention-2 and -3 do (above 128 the two consumer
warpgroups of a block share one 64-row tile and split the output's head
dim); f32, and bf16 at 16 and 32, run the CUDA-core kernels (32-row tiles
at 256).

CPU tensors take the plain versions (``ref.flash_attention``,
``ref.flash_attention_lse``, ``ref.flash_attention_bwd``; autograd
differentiates the first); a CUDA tensor launches the kernel or raises —
there is no fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels._checks import check_heads, check_tensors

NAME = "flash_attention"
BWD = "flash_attention_bwd"


def _check(q, k, v):
    check_tensors(NAME, {"q": q, "k": k, "v": v}, {"q": 4, "k": 4, "v": 4})
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, hd) or v.shape != k.shape:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    check_heads(NAME, H, K, hd, q.device)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{NAME}: unsupported device {q.device}")


def flash_attention(q, k, v, causal: bool = True, scale: float = None):
    """q: (B,T,H,hd); k, v: (B,S,K,hd). Returns (B,T,H,hd) in q.dtype,
    differentiable in q, k and v."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal, scale)[0]


class _Attention(torch.autograd.Function):
    """The forward kernel with its LSE, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal: bool = True, scale: float = None,
                        with_lse: bool = False):
    """The forward launch: (o (B,T,H,hd) in q.dtype, and with ``with_lse``
    the rows' log-sum-exp (B,H,T) f32, else None). No autograd."""
    _check(q, k, v)
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        o = ref.flash_attention(q, k, v, causal=causal, scale=scale)
        return o, (ref.flash_attention_lse(q, k, causal, scale)
                   if with_lse else None)
    if q.device.type == "meta":     # the dry run: the outputs' shapes
        return q.new_empty((B, T, H, hd)), (
            q.new_empty((B, H, T), dtype=torch.float32) if with_lse
            else None)
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0 or S == 0:
        if lse is not None:
            lse.fill_(-1e30)        # the kernel's masked score: no key
        return o.zero_(), lse
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, T, S, H, K, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(q.dtype == torch.bfloat16), int(causal), scale, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return o, lse


def fwd_route(dtype, hd: int) -> str:
    """The forward kernel a CUDA call takes, by the rule
    ``flash_attention_fwd`` of ``csrc/flash_attention.cu`` applies (it
    counts the route it took under these names, ``build.routes(NAME)``):
    bf16 at head dims 64 and up "wgmma", below "mma_sync", f32
    "cuda_core"."""
    if dtype != torch.bfloat16:
        return "cuda_core"
    return "wgmma" if hd >= 64 else "mma_sync"


def bwd_route(dtype, hd: int) -> str:
    """The backward kernels a CUDA call takes, by the rule
    ``flash_attention_bwd`` of ``csrc/flash_attention_bwd.cu`` applies (it
    counts the route it took under these names, ``build.routes(BWD)``):
    bf16 at head dims 64, 128, 160 and 256 "wgmma", all else (f32; bf16 at
    16 and 32) "cuda_core"."""
    return ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128, 160, 256)
            else "cuda_core")


def _tma_ready(t) -> bool:
    """Whether TMA can read ``t`` as it lies: a contiguous last dim, a
    16-byte aligned base and strides, no broadcast (stride 0) dim."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 and (st > 0 or n == 1)
                    for st, n in zip(t.stride()[:-1], t.shape[:-1])))


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: float = None):
    """(dq, dk, dv) in q's dtype, contiguous: the gradients of
    ``flash_attention(q, k, v)`` at output gradient ``do``, given its output
    ``o`` and the LSE of ``flash_attention_fwd(..., with_lse=True)``. dk and
    dv sum over the query heads of a KV head.

    q, k, v and o must have the layout the forward takes (else it raises);
    ``do``, which autograd may hand over in any layout (a broadcast view
    from a sum, say), is made contiguous first where TMA cannot read it as
    it lies: a layout copy, not another route."""
    _check(q, k, v)
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, T, H, hd) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{BWD}: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; expected "
                             f"{(B, T, H, hd)} {q.dtype} on {q.device}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                       scale=scale)
    if q.device.type == "meta":
        cost.record(BWD, *cost.attention_bwd_work(B, T, H, K, hd,
                                                  q.element_size()))
        return (q.new_empty((B, T, H, hd)), k.new_empty((B, S, K, hd)),
                k.new_empty((B, S, K, hd)))
    if tuple(lse.shape) != (B, H, T) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{BWD}: lse must be a contiguous f32 "
                         f"{(B, H, T)} tensor on {q.device}")
    check_tensors(BWD, {"q": q, "o": o}, {"q": 4, "o": 4})
    if not _tma_ready(do):
        do = do.contiguous()
    dq = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, K, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or S == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # scratch: D and lse log2 e, rows padded to a multiple of 64
    Tp = -(-T // 64) * 64
    D = torch.empty((2, B, H, Tp), dtype=torch.float32, device=q.device)
    lib = build.load(BWD)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), D.data_ptr(), B, T, S, H, K, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3],
            int(q.dtype == torch.bfloat16), int(causal), scale, stream)
    build.check(err, BWD)
    build.LAUNCHES[BWD] += 1
    return dq, dk, dv
