"""Emulation's byte pack: wrapper of ``csrc/pack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/pack.py`` (``pack``, def
at :29, ``pallas_call`` at :37): K uint8 leaves of shape (B, n_i) go into one
new contiguous (B, Σ n_i) uint8 buffer, leaf i at columns
[Σ_{j<i} n_j, Σ_{j≤i} n_j). On the H100 it is bound by bytes: it reads each
leaf once and writes the output once, 2·B·Σ n_i bytes at 3.35 TB/s.

Unlike the Pallas kernel it takes any B (no ``B % block_b``), any n_i ≥ 0 and
any row stride of a leaf; a leaf's last stride must be 1 where n_i > 1. The
kernel holds ``MAX_LEAVES`` leaves a launch in its parameters: more leaves
take more launches, each writing its own columns.

At the host tier's act shape (B 64, three 4-byte leaves) it moves 1,536
bytes, so one round trip to device memory and the launch bound it, on the
card and on the host: every leaf gets its own blocks, so all leaves' loads
are in flight at once; the table ships 40 bytes a leaf (csrc/pack.cu); and
the wrapper hands the launcher one ctypes array of four numbers a leaf
(address, row stride, width, column).

CPU tensors take the plain version (``ref.pack``, ``torch.cat``); a CUDA
tensor launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

NAME = "pack"
MAX_LEAVES = 32          # leaves per launch; csrc/pack.cu's MAX_LEAVES
_INT_MAX = 2 ** 31 - 1   # the kernel keeps widths and column offsets in int


def check(leaves) -> None:
    """Raise unless ``leaves`` is a non-empty sequence of 2-D uint8 tensors
    with one leading size B, on one device."""
    if len(leaves) == 0:
        raise ValueError(f"{NAME}: needs at least one leaf")
    first = leaves[0]
    for i, t in enumerate(leaves):
        if t.dtype != torch.uint8:
            raise TypeError(f"{NAME}: leaf {i} is {t.dtype}; leaves are "
                            f"uint8 (emulate bitcasts them first)")
        if t.dim() != 2:
            raise ValueError(f"{NAME}: leaf {i} must be (B, n), got shape "
                             f"{tuple(t.shape)}")
        if t.shape[0] != first.shape[0]:
            raise ValueError(f"{NAME}: leaf {i} has {t.shape[0]} rows, leaf "
                             f"0 has {first.shape[0]}")
        if t.device != first.device:
            raise ValueError(f"{NAME}: leaf {i} is on {t.device}, leaf 0 on "
                             f"{first.device}")


def pack(leaves):
    """[(B, n_i) uint8] → (B, Σ n_i) uint8, one contiguous row per batch
    row."""
    leaves = list(leaves)
    check(leaves)
    dev = leaves[0].device
    if dev.type == "cpu":
        return ref.pack(leaves)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {dev}")
    B = leaves[0].shape[0]
    widths = [t.shape[1] for t in leaves]
    total = sum(widths)
    if total > _INT_MAX:
        raise ValueError(f"{NAME}: output rows of {total} bytes; the kernel "
                         f"takes rows below 2^31 bytes")
    for i, t in enumerate(leaves):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{NAME}: leaf {i} has strides {t.stride()}; "
                             f"the kernel needs a last stride of 1")
    out = torch.empty((B, total), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    table = []                 # four numbers a non-empty leaf
    col = 0
    for t, w in zip(leaves, widths):
        if w > 0:
            table += (t.data_ptr(), t.stride(0), w, col)
        col += w
    lib = build.load(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, len(table), 4 * MAX_LEAVES):
            part = table[k0:k0 + 4 * MAX_LEAVES]
            err = lib.pack_fwd((ctypes.c_longlong * len(part))(*part),
                               len(part) // 4, out.data_ptr(), B,
                               out.stride(0), stream)
            build.check(err, NAME)
            build.LAUNCHES[NAME] += 1
    return out
