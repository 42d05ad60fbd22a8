"""Public kernel ops — thin wrappers over the dispatch registry.

Each ported op registers ``ref`` (plain PyTorch) and ``cuda`` (the
hand-written kernel). Selection: explicit ``mode=`` > ``dispatch.using(...)``
scope > device default (``cuda`` for CUDA tensors, ``ref`` for CPU tensors);
see kernels/dispatch.py.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _fa_cuda
from repro_torch.kernels.flash_decode import flash_decode as _fd_cuda
from repro_torch.kernels.gae import gae as _gae_cuda
from repro_torch.kernels import pack as _pack
from repro_torch.kernels.quant_matmul import quant_matmul as _qmm_cuda
from repro_torch.kernels.ssd import ssd as _ssd_cuda

dispatch.register("flash_attention", dispatch.REF)(_ref.flash_attention)
dispatch.register("flash_attention", dispatch.CUDA)(_fa_cuda)
dispatch.register("flash_decode", dispatch.REF)(_ref.flash_decode)
dispatch.register("flash_decode", dispatch.CUDA)(_fd_cuda)
dispatch.register("gae", dispatch.REF)(_ref.gae)
dispatch.register("gae", dispatch.CUDA)(_gae_cuda)
dispatch.register("ssd", dispatch.CUDA)(_ssd_cuda)
dispatch.register("pack", dispatch.REF)(_ref.pack)
dispatch.register("pack", dispatch.CUDA)(_pack.pack)
dispatch.register("quant_matmul", dispatch.REF)(_ref.quant_matmul)
dispatch.register("quant_matmul", dispatch.CUDA)(_qmm_cuda)


@dispatch.register("ssd", dispatch.REF)
def _ssd_ref(x, dt, A, B_, C, chunk: int = 128):
    return _ref.ssd(x, dt, A, B_, C)     # the chunk is the kernel's tiling


def flash_attention(q, k, v, causal: bool = True, mode: str = None):
    return dispatch.call("flash_attention", q, k, v, mode=mode,
                         causal=causal)


def flash_decode(q, k, v, length, mode: str = None):
    return dispatch.call("flash_decode", q, k, v, length, mode=mode)


def gae(rewards, values, dones, last_value, gamma: float, lam: float,
        mode: str = None):
    return dispatch.call("gae", rewards, values, dones, last_value, gamma,
                         lam, mode=mode)


def ssd(x, dt, A, B_, C, chunk: int = 128, mode: str = None):
    """Mamba2 SSD scan from a zero state: (y, h_last); see ``ref.ssd``."""
    return dispatch.call("ssd", x, dt, A, B_, C, mode=mode, chunk=chunk)


def quant_matmul(x, w_q, scale, transposed: bool = False,
                 mode: str = None):
    """x (M, K) times int8 / packed int4 weights with a per-channel scale;
    see ``kernels/quant_matmul.py`` for the layouts."""
    return dispatch.call("quant_matmul", x, w_q, scale, mode=mode,
                         transposed=transposed)


def pack(leaves, mode: str = None):
    """[(B, n_i) uint8] → (B, Σ n_i) uint8: emulation's byte pack; see
    ``kernels/pack.py``."""
    leaves = list(leaves)
    _pack.check(leaves)
    return dispatch.call("pack", leaves, mode=mode)
