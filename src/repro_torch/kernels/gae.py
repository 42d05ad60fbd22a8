"""Generalized advantage estimation: wrapper of ``csrc/gae.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/gae_scan.py`` (``gae``,
def at :56, ``pallas_call`` at :69). On the H100 it is bound by bytes: it
reads rewards, values (f32), dones (one byte) and ``last_value`` once and
writes the advantages once, 13 bytes per element for about 8 FLOP; at the
full-size update (B 4096, T 64) that is 3.4 MB, about 1 µs at 3.35 TB/s.

The kernel reads every input through its strides, so the learner passes the
``(B, T)`` transposed views of its ``(T, B)`` trajectory without a copy, and
consecutive threads read consecutive envs. The output is allocated as a
``(T, B)``-contiguous buffer and returned as its ``(B, T)`` view, which the
learner transposes back for free.

CPU tensors take the plain version (``ref.gae``); a CUDA tensor launches the
kernel or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

NAME = "gae"


def _check(rewards, values, dones, last_value) -> None:
    if rewards.dim() != 2:
        raise ValueError(f"{NAME}: rewards must be (B, T), got shape "
                         f"{tuple(rewards.shape)}")
    B, T = rewards.shape
    for name, t, shape in (("values", values, (B, T)),
                           ("dones", dones, (B, T)),
                           ("last_value", last_value, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != rewards.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, rewards on "
                             f"{rewards.device}")


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """rewards, values, dones: (B, T); last_value: (B,). ``dones[b, t]``
    marks that the episode ended at step t (no bootstrap across it).
    Returns the advantages (B, T) in f32, a view of a (T, B) buffer."""
    _check(rewards, values, dones, last_value)
    if rewards.device.type == "cpu":
        return ref.gae(rewards, values, dones, last_value, gamma, lam)
    if rewards.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {rewards.device}")
    for name, t in (("rewards", rewards), ("values", values),
                    ("last_value", last_value)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} is {t.dtype}; the kernel takes "
                            f"float32")
    if dones.dtype != torch.bool:
        raise TypeError(f"{NAME}: dones is {dones.dtype}; the kernel takes "
                        f"bool")
    B, T = rewards.shape
    out = torch.empty((T, B), dtype=torch.float32, device=rewards.device).T
    if out.numel() == 0:
        return out
    lib = build.load(NAME)
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream(rewards.device).cuda_stream
        err = lib.gae_fwd(
            rewards.data_ptr(), values.data_ptr(), dones.data_ptr(),
            last_value.data_ptr(), out.data_ptr(), B, T,
            rewards.stride(0), rewards.stride(1),
            values.stride(0), values.stride(1),
            dones.stride(0), dones.stride(1), last_value.stride(0),
            out.stride(0), out.stride(1), float(gamma), float(lam), stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out
