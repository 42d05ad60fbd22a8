"""Public kernel ops — thin wrappers over the dispatch registry.

Each ported op registers ``ref`` (plain PyTorch) and ``cuda`` (the
hand-written kernel). Selection: explicit ``mode=`` > ``dispatch.using(...)``
scope > device default (``cuda`` for CUDA tensors, ``ref`` for CPU tensors);
see kernels/dispatch.py. The ops of later slices (``ssd``, ``quant_matmul``,
``pack``) are not registered yet and raise.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _fa_cuda
from repro_torch.kernels.flash_decode import flash_decode as _fd_cuda
from repro_torch.kernels.gae import gae as _gae_cuda

dispatch.register("flash_attention", dispatch.REF)(_ref.flash_attention)
dispatch.register("flash_attention", dispatch.CUDA)(_fa_cuda)
dispatch.register("flash_decode", dispatch.REF)(_ref.flash_decode)
dispatch.register("flash_decode", dispatch.CUDA)(_fd_cuda)
dispatch.register("gae", dispatch.REF)(_ref.gae)
dispatch.register("gae", dispatch.CUDA)(_gae_cuda)


def flash_attention(q, k, v, causal: bool = True, mode: str = None):
    return dispatch.call("flash_attention", q, k, v, mode=mode,
                         causal=causal)


def flash_decode(q, k, v, length, mode: str = None):
    return dispatch.call("flash_decode", q, k, v, length, mode=mode)


def gae(rewards, values, dones, last_value, gamma: float, lam: float,
        mode: str = None):
    return dispatch.call("gae", rewards, values, dones, last_value, gamma,
                         lam, mode=mode)
