"""Causal GQA flash attention (prefill): wraps ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, def at :74, ``pallas_call`` at :93). What bounds it on
the H100: at the serve shape (B 8, T 512, H 16, K 8, hd 128, bf16) it must
move q, k, v and o once, 50 MB (15 µs at 3.35 TB/s), and do 8.6 GFLOP of
causal products (8.7 µs at 989 TFLOP/s of bf16 tensor cores): bytes bound
it up to T ≈ 885 at this head layout, operations beyond. In bf16 the
products run on the tensor cores: at head dims 64 and 128 (the serve path)
as ``wgmma`` fed by TMA through an mbarrier ring, at 16 and 32 as
``mma.sync`` fed by ``cp.async``; both round P to bf16 before P·V. The f32
kernel, which only the TF32-off parity checks use, runs on the f32 CUDA
cores (see the .cu note).

CPU tensors take the plain version (``ref.flash_attention``); a CUDA tensor
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import check_heads, check_tensors

NAME = "flash_attention"


def flash_attention(q, k, v, causal: bool = True, scale: float = None):
    """q: (B,T,H,hd); k, v: (B,S,K,hd). Returns (B,T,H,hd) in q.dtype."""
    check_tensors(NAME, {"q": q, "k": k, "v": v}, {"q": 4, "k": 4, "v": 4})
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, hd) or v.shape != k.shape:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    check_heads(NAME, H, K, hd)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or S == 0:
        return o.zero_()
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, T, S, H, K, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(q.dtype == torch.bfloat16), int(causal), scale, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return o
