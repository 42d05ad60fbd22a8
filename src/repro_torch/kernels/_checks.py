"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# head_dim template instances in csrc/: what a CUDA tensor may have. A CPU
# tensor takes the plain versions, which, as the Pallas kernels' BlockSpecs
# (spanning the whole head dim), take any.
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
DTYPES = (torch.float32, torch.bfloat16)


def check_tensors(op: str, named: dict, ndim: dict) -> None:
    """Raise unless every tensor has the rank in ``ndim``, one dtype from
    ``DTYPES``, one device, a contiguous last dimension, and a 16-byte
    aligned base and strides (the kernels load 16 bytes per thread)."""
    first = next(iter(named.values()))
    for name, t in named.items():
        if t.dim() != ndim[name]:
            raise ValueError(f"{op}: {name} must have {ndim[name]} dims, "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != first.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{op}: {name} is {t.dtype}; all inputs must "
                            f"share one dtype from {DTYPES}")
        if t.device != first.device:
            raise ValueError(f"{op}: {name} is on {t.device}, "
                             f"{next(iter(named))} on {first.device}")
        if t.device.type == "cuda":
            vec = 16 // t.element_size()
            if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                    or t.data_ptr() % 16:
                raise ValueError(
                    f"{op}: {name} needs a contiguous last dim and a 16-byte "
                    f"aligned base and strides; got strides {t.stride()}")


def check_heads(op: str, H: int, K: int, hd: int, device) -> None:
    """Raise unless the H query heads group over the K KV heads and, on a
    CUDA ``device``, the kernels have an instance at head dim ``hd``."""
    if K == 0 or H % K:
        raise ValueError(f"{op}: {H} query heads do not group over {K} "
                         f"KV heads")
    if hd < 1 or (torch.device(device).type == "cuda"
                  and hd not in HEAD_DIMS):
        raise ValueError(f"{op}: head_dim {hd} has no instance on "
                         f"{device}; CUDA tensors take {HEAD_DIMS}")
