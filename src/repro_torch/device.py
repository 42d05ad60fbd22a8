"""Device resolution for the port's entry points.

The default device is ``cuda``, and it must be a Hopper card (compute
capability 9.x): the kernels are built for ``sm_90a`` only. When CUDA is
missing the default raises; the CPU is used only when the caller asks for it
by name, as the tests do.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device (raises without a
    Hopper card); ``"cpu"`` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    major, minor = torch.cuda.get_device_capability(dev)
    if major != 9:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{major}.{minor}; the kernels are built for sm_90a (Hopper)")
    return dev
