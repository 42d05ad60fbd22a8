"""One-token GQA decode attention: wrapper of ``csrc/flash_decode.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_decode.py``
(``flash_decode``, def at :65, ``pallas_call`` at :84). On the H100 it is
bound by bytes: it must read the filled K/V prefix, 2·B·(length+1)·K·hd
elements, at 3.35 TB/s, and does 4 FLOPs per element read. ``length`` is
read on the device, so a decode step needs no host sync. With one block per
(batch, KV head) it fills 64 of 132 SMs at the serve shape (B 8, K 8);
split-KV plus a combine pass is the first fix.

CPU tensors take the plain version (``ref.flash_decode``); a CUDA tensor
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import check_heads, check_tensors

NAME = "flash_decode"


def flash_decode(q, k, v, length):
    """q: (B,H,hd); k, v: (B,S,K,hd) caches; length: () int32 tensor on q's
    device — the newest valid cache index, in [0, S). Returns (B,H,hd)."""
    check_tensors(NAME, {"q": q, "k": k, "v": v}, {"q": 3, "k": 4, "v": 4})
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, hd) or v.shape != k.shape:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    check_heads(NAME, H, K, hd)
    if q.device.type == "cpu":
        return ref.flash_decode(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    if not (torch.is_tensor(length) and length.dtype == torch.int32
            and length.numel() == 1 and length.device == q.device):
        raise TypeError(f"{NAME}: length must be a one-element int32 tensor "
                        f"on {q.device}")
    o = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or S == 0:
        return o.zero_()
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            o.data_ptr(), B, S, H, K, hd,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd), stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return o
