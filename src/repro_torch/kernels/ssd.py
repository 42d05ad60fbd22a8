"""Mamba2 SSD chunked scan, forward: wrapper of ``csrc/ssd.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd.py`` (``ssd``, def
at :69, ``pallas_call`` at :87). At the serve shape (B 8, T 512, H 64, hd
64, ds 128) it must read x, dt, B_ and C and write y and h_last, 87 MB with
B_/C counted once per group, 0.026 ms at 3.35 TB/s, against 2.1e10 FLOP:
0.022 ms on the bf16 tensor cores, 0.32 ms on the f32 CUDA cores. So bf16
calls take the tensor cores (``route``): a block walks a (batch, head)'s
chunks with the state in registers, its four products on ``mma.sync`` and
the next chunk's loads in flight; the masked scores and the carried state
enter their products as bf16 hi + lo and x·w rounded once to bf16
(``csrc/ssd.cu`` states the contract; ``tests/test_torch_ssd_route.py``
holds it to JAX). f32 calls, and shapes the tiles cannot take, keep the
CUDA-core kernel.

The kernel reads every input through its strides, so ``models/ssm.py``
passes x as a view of the conv output and, with one group, B_ and C as
stride-0 expansions over heads, without a copy. It takes any ``T >= 1``
(the Pallas kernel needs ``T % chunk == 0``), chunks of 1 to 128 steps, and
head dim and state size up to 128.

The backward (``ssd_bwd``, ``csrc/ssd_bwd.cu``) has no Pallas counterpart:
JAX differentiates the jnp program around its forward-only kernel. On the
card ``ssd`` is an autograd ``Function`` when a gradient is needed: its
forward launches the forward kernel, its backward ``ssd_bwd`` (dx, ddt,
dA, dB_, dC; dA summed over batch and time in a fixed order). It reads its
inputs through their strides as the forward does and returns dense
(B, T, H, ds) gradients of B_ and C, whose stride-0 expansion over heads
autograd then sums per group. bf16 calls the tiles take (``bwd_route``)
run the chunked backward on the tensor cores, in chunks of ``BWD_CHUNK``
steps whatever the forward's chunk, its dl from direct sums; f32 calls and
other shapes keep the f64 walks on the CUDA cores. With no gradient needed
(serving) it is the forward launch alone, as before.

CPU tensors take the plain versions (``ref.ssd``, ``ref.ssd_bwd``; autograd
differentiates the first); a CUDA tensor launches the kernel or raises —
there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels._checks import DTYPES

NAME = "ssd"
BWD = "ssd_bwd"
MAX_DIM = 128           # chunk, head dim and state size the kernel takes
TC_MAX_HD = 64          # largest head dim on the tensor cores
BWD_CHUNK = 64          # the tensor-core backward's chunk (``QB``)


def _check(x, dt, A, B_, C) -> None:
    if x.dim() != 4:
        raise ValueError(f"{NAME}: x must be (B, T, H, hd), got shape "
                         f"{tuple(x.shape)}")
    Bb, T, H, _ = x.shape
    ds = B_.shape[-1] if B_.dim() == 4 else -1
    for name, t, shape in (("dt", dt, (Bb, T, H)), ("A", A, (H,)),
                           ("B_", B_, (Bb, T, H, ds)),
                           ("C", C, (Bb, T, H, ds))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if T < 1:
        raise ValueError(f"{NAME}: needs T >= 1, got {T}")


def _vec16(t) -> bool:
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:3]))


def alignment(x, B_, C) -> bool:
    """Whether x, B_ and C each have a unit element stride and 16-byte
    aligned bases and (batch, seq, head) strides (in bf16: multiples of 8
    elements), as the tensor cores' 16-byte asynchronous copies need."""
    return all(_vec16(t) for t in (x, B_, C))


def route(dtype, hd: int, ds: int, chunk: int, aligned: bool) -> str:
    """The kernel a CUDA call takes, by the rule ``ssd_fwd`` of
    ``csrc/ssd.cu`` applies to the same arguments (it counts the route it
    took under these names, ``build.routes``): bf16 x with head dim and
    state size multiples of 16, head dim <= 64, chunk >= 16 and inputs the
    16-byte copies can read (``alignment``) the tensor cores
    ("tensor_core"); all else (f32 x, other shapes) the CUDA cores
    ("cuda_core"). T does not enter: a chunk shorter than 16 steps (T <
    16) is padded."""
    if (dtype == torch.bfloat16 and hd % 16 == 0 and hd <= TC_MAX_HD
            and ds % 16 == 0 and chunk >= 16 and aligned):
        return "tensor_core"
    return "cuda_core"


def bwd_route(dtype, hd: int, ds: int, aligned: bool) -> str:
    """The backward kernel a CUDA call of ``ssd_bwd`` takes, by the rule
    ``ssd_bwd`` of ``csrc/ssd_bwd.cu`` applies (it counts the route it took
    under these names, ``build.routes(BWD)``): bf16 x with head dim and
    state size multiples of 16, head dim <= 64, state size <= 128 and x, B_
    and C the 16-byte copies can read (``alignment``) the tensor cores
    ("tensor_core"); all else the f64 walks on the CUDA cores
    ("cuda_core"). T and the forward's chunk do not enter."""
    if (dtype == torch.bfloat16 and hd % 16 == 0 and hd <= TC_MAX_HD
            and ds % 16 == 0 and ds <= MAX_DIM and aligned):
        return "tensor_core"
    return "cuda_core"


def ssd(x, dt, A, B_, C, chunk: int = 128):
    """x: (B,T,H,hd); dt: (B,T,H) f32; A: (H,) f32; B_, C: (B,T,H,ds) in
    x's dtype. Returns (y (B,T,H,hd) in x.dtype, h_last (B,H,hd,ds) f32),
    from a zero initial state, differentiable in all five inputs."""
    _check(x, dt, A, B_, C)
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, B_, C)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_, C)):
        return _SSD.apply(x, dt, A, B_, C, chunk)
    return ssd_fwd(x, dt, A, B_, C, chunk)


class _SSD(torch.autograd.Function):
    """The forward kernel, and the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_, C)
        return ssd_fwd(x, dt, A, B_, C, chunk)

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, B_, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return (*ssd_bwd(x, dt, A, B_, C, dy, dh_last), None)


def _groups(B_, H: int) -> int:
    """Groups of B_ read once each: 1 for a stride-0 expansion over heads,
    else every head's own."""
    return 1 if B_.stride(2) == 0 else H


def _check_types(x, dt, A, B_, C) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{NAME}: x is {x.dtype}; the kernel takes "
                        f"{DTYPES}")
    for name, t, want in (("B_", B_, x.dtype), ("C", C, x.dtype),
                          ("dt", dt, torch.float32), ("A", A, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"{NAME}: {name} is {t.dtype}; the kernel takes "
                            f"{want} with x {x.dtype}")


def ssd_fwd(x, dt, A, B_, C, chunk: int = 128):
    """The forward launch: (y, h_last), as ``ssd`` returns them. No
    autograd."""
    _check(x, dt, A, B_, C)
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, B_, C)
    Bb, T, H, hd = x.shape
    ds = B_.shape[-1]
    if x.device.type == "meta":     # the dry run: the outputs' shapes
        return (x.new_empty((Bb, T, H, hd)),
                x.new_empty((Bb, H, hd, ds), dtype=torch.float32))
    _check_types(x, dt, A, B_, C)
    for name, n in (("chunk", chunk), ("head dim", hd), ("d_state", ds)):
        if not 1 <= n <= MAX_DIM:
            raise ValueError(f"{NAME}: {name} {n} outside [1, {MAX_DIM}]")
    y = torch.empty((Bb, T, H, hd), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bb, H, hd, ds), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0:                  # B or H is 0: nothing to launch
        return y, h_last
    lib = build.load(NAME)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            Bb, T, H, hd, ds, int(chunk), *x.stride(), *dt.stride(),
            A.stride(0),
            *B_.stride(), *C.stride(), int(x.dtype == torch.bfloat16),
            stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return y, h_last


def ssd_bwd(x, dt, A, B_, C, dy, dh_last=None):
    """(dx, ddt, dA, dB_, dC): the gradients of ``ssd(x, dt, A, B_, C)`` at
    ``dy`` (B,T,H,hd) in x's dtype and ``dh_last`` (B,H,hd,ds) f32 or None
    (h_last unused). dx, dB_, dC in x's dtype and ddt, dA in f32, all
    contiguous; dB_ and dC are dense (B,T,H,ds). A CUDA call takes the
    route ``bwd_route`` names."""
    return _bwd(x, dt, A, B_, C, dy, dh_last, cuda_core=False)


def ssd_bwd_cuda_core(x, dt, A, B_, C, dy, dh_last=None):
    """``ssd_bwd`` on the f64 walks of the CUDA cores whatever the call's
    route, so that a record can time them beside the tensor cores at the
    same shape."""
    return _bwd(x, dt, A, B_, C, dy, dh_last, cuda_core=True)


def _bwd(x, dt, A, B_, C, dy, dh_last, cuda_core):
    _check(x, dt, A, B_, C)
    Bb, T, H, hd = x.shape
    ds = B_.shape[-1]
    if tuple(dy.shape) != (Bb, T, H, hd) or dy.device != x.device:
        raise ValueError(f"{BWD}: dy is {tuple(dy.shape)} on {dy.device}; "
                         f"expected {(Bb, T, H, hd)} on {x.device}")
    if dh_last is not None and (tuple(dh_last.shape) != (Bb, H, hd, ds)
                                or dh_last.device != x.device):
        raise ValueError(f"{BWD}: dh_last is {tuple(dh_last.shape)} on "
                         f"{dh_last.device}; expected {(Bb, H, hd, ds)}")
    if x.device.type == "cpu":
        return ref.ssd_bwd(x, dt, A, B_, C, dy, dh_last)
    if x.device.type == "meta":
        cost.record(BWD, *cost.ssd_bwd_work(Bb, T, H, hd, ds, _groups(B_, H),
                                            BWD_CHUNK, x.element_size()))
        dB = x.new_empty((Bb, T, H, ds))
        return (x.new_empty((Bb, T, H, hd)), dt.new_empty((Bb, T, H)),
                A.new_empty((H,)), dB, torch.empty_like(dB))
    _check_types(x, dt, A, B_, C)
    if dy.dtype != x.dtype:
        raise TypeError(f"{BWD}: dy is {dy.dtype}; the kernel takes "
                        f"{x.dtype} with x {x.dtype}")
    for name, n in (("head dim", hd), ("d_state", ds)):
        if not 1 <= n <= MAX_DIM:
            raise ValueError(f"{BWD}: {name} {n} outside [1, {MAX_DIM}]")
    tc = not cuda_core and bwd_route(
        x.dtype, hd, ds, alignment(x, B_, C)) == "tensor_core"
    # autograd may hand dy over in any layout: copied only where the
    # tensor cores' 16-byte copies cannot read it as it lies
    if tc and not _vec16(dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bb, T, H, hd), dtype=x.dtype, device=x.device)
    dB = torch.empty((Bb, T, H, ds), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    ddt = torch.empty((Bb, T, H), **f32)
    dA = torch.zeros((H,), **f32)
    if dx.numel() == 0:                 # B or H is 0: nothing to launch
        return dx, ddt, dA, dB.zero_(), dC.zero_()
    f64 = dict(dtype=torch.float64, device=x.device)
    part = torch.empty((Bb, H), **f64)
    # the kernels' scratch: the f64 walks' yd; the tensor cores' states
    # entering chunks 1 .. nc - 1 of BWD_CHUNK steps
    nc = -(-T // BWD_CHUNK)
    yd = None if tc else torch.empty((Bb, H, T), **f64)
    states = (torch.empty((Bb, H, nc - 1, hd, ds), **f32)
              if tc and nc > 1 else None)
    lib = build.load(BWD)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), None if yd is None else yd.data_ptr(),
            part.data_ptr(), None if states is None else states.data_ptr(),
            Bb, T, H, hd, ds, *x.stride(), *dt.stride(), A.stride(0),
            *B_.stride(), *C.stride(), *dy.stride(),
            int(x.dtype == torch.bfloat16), int(cuda_core), stream)
    build.check(err, BWD)
    build.LAUNCHES[BWD] += 1
    return dx, ddt, dA, dB, dC
