"""Weight-quantised matmul (W8A16 / W4A16): wrapper of
``csrc/quant_matmul.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/quant_matmul.py``
(``quant_matmul``, def at :43, ``pallas_call`` at :56): ``x @ (w_q ·
scale)`` in x's dtype, products summed in f32, the weight dequantised in
registers or shared memory and never written back to device memory. At
decode (M = 8) it is bound by the weight bytes: 1 per weight in int8, half
that in int4; with bf16 x the products run on the tensor cores
(``mma.sync``, the weight as the A operand, built from its bytes in
registers), every load of a block is in flight before its first product,
and K is split over a thread block cluster so that the small grid fills the
SMs. At prefill (M = 4096) it is bound by operations: with bf16 x the
products run on the tensor cores (``wgmma``, x and the raw weight brought
by TMA, the weight dequantised to bf16 in shared memory). f32 x, and bf16 x
at prefill that the ``wgmma`` kernel does not take (an (N, K) weight, or an
x or weight TMA cannot describe), run FMAs on the CUDA cores. ``route``
names the kernel each call takes; the launcher counts the route it took,
and ``build.routes(NAME)`` reads the counts.

Layouts. ``w_q`` is row-major (K, N) (every projection), or with
``transposed=True`` (N, K): the tied unembed reads the (V, d) embedding
table as ``x @ E.T``. The scale is per channel of the stored last axis: on N
for (K, N), where the kernel applies it to the f32 sum, as the Pallas body
does; on K for (N, K), the embedding's ``(d,)`` scale, where the kernel folds
it into x as it stages x, ``(x · s) @ E_q.T``: in f32, and with bf16 x at
M <= 16 split into two bf16 terms, ``hi = bf16(x · s)`` and ``lo = bf16(x ·
s − hi)``, each multiplied by the weight on the tensor cores and summed in
f32 (``|x · s − hi − lo| <= 2^-16 |x · s|``). A scale shorter than that axis
is tiled over it: element i takes ``scale[i % len]``. Thus wq (d, H, hd) with
its (hd,) scale flattens to N = H·hd with ``scale.repeat(H)``, not
``repeat_interleave``.

int4 layout. torch has no int4 dtype: two signed 4-bit values per uint8
along the stored last axis (N for (K, N), K for (N, K)), the even index in
the low nibble, sign-extended on unpacking. An odd axis pads its last byte's
high nibble with 0. The axis's logical length is the scale's length when the
bytes hold exactly that many values (2·bytes or 2·bytes − 1), else 2·bytes,
which the scale then tiles. ``ref.pack_int4``, ``ref.unpack_int4`` and
``ref.last_len`` implement this layout.

The kernel takes any M, N and K (the Pallas kernel asserts that its blocks
divide them), x with any strides, and the weight with any row stride.
CPU tensors take the plain version (``ref.quant_matmul``); a CUDA tensor
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import DTYPES

NAME = "quant_matmul"
WEIGHT_DTYPES = (torch.int8, torch.uint8)   # int8, packed int4


def _check(x, w_q, scale, transposed: bool) -> tuple:
    """Raise on what the op does not take; return (M, N, K)."""
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{NAME}: needs x (M, K), a 2-D w_q and a 1-D "
                         f"scale; got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{NAME}: x is {x.dtype}; takes {DTYPES}")
    if w_q.dtype not in WEIGHT_DTYPES:
        raise TypeError(f"{NAME}: w_q is {w_q.dtype}; takes int8 or packed "
                        f"int4 (uint8)")
    if scale.dtype != torch.float32:
        raise TypeError(f"{NAME}: scale is {scale.dtype}; takes float32")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, x on "
                             f"{x.device}")
    n = ref.last_len(w_q, scale)
    if scale.numel() == 0 or n % scale.numel():
        raise ValueError(f"{NAME}: a scale of {scale.numel()} does not tile "
                         f"the weight's last axis of {n}")
    N, K = (w_q.shape[0], n) if transposed else (n, w_q.shape[0])
    if x.shape[1] != K:
        raise ValueError(f"{NAME}: x has K = {x.shape[1]}, the weight "
                         f"{K} ({'(N, K)' if transposed else '(K, N)'})")
    return x.shape[0], N, K


def alignment(x, w_q) -> tuple:
    """(vec, vec_x): the weight's base and row stride are 16-byte aligned
    and its rows do not overlap; x's rows are contiguous, do not overlap
    (no stride-0 view) and are not empty, and its base and row stride are
    16-byte aligned. Both hold for every tensor a TMA tensor map can
    describe as (rows, row length)."""
    vec = (w_q.data_ptr() % 16 == 0 and w_q.stride(0) % 16 == 0
           and w_q.stride(0) >= w_q.shape[1])
    vec_x = (x.stride(1) == 1 and x.data_ptr() % 16 == 0
             and x.stride(0) * x.element_size() % 16 == 0
             and x.stride(0) >= x.shape[1] > 0)
    return vec, vec_x


def route(M: int, dtype, transposed: bool, vec: bool, vec_x: bool) -> str:
    """The kernel a CUDA call takes, by the rule ``launch_m`` of
    ``csrc/quant_matmul.cu`` applies to the same arguments (it counts the
    route it took under these names, ``build.routes``): bf16 x at M <= 16
    the tensor-core decode kernel ("decode"), in either layout and whatever
    the strides; bf16 x at M > 16 with a (K, N) weight the ``wgmma``
    prefill kernel fed by TMA ("wgmma") where TMA can describe x and the
    weight (``vec`` and ``vec_x``, as ``alignment`` gives them); all else
    (f32 x, an (N, K) weight at prefill, an x or weight beyond TMA) the
    CUDA-core tiles ("fma")."""
    if dtype != torch.bfloat16:
        return "fma"
    if M <= 16:
        return "decode"
    return "wgmma" if vec and vec_x and not transposed else "fma"


def quant_matmul(x, w_q, scale, transposed: bool = False):
    """x: (M, K) f32/bf16; w_q: (K, N), or (N, K) with ``transposed``, int8
    or packed int4; scale: f32 over w_q's last axis (tiled when shorter).
    Returns (M, N) in x.dtype."""
    M, N, K = _check(x, w_q, scale, transposed)
    if x.device.type == "cpu":
        return ref.quant_matmul(x, w_q, scale, transposed)
    if x.device.type == "meta":     # the dry run: the output's shape
        return x.new_empty((M, N))
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    if w_q.stride(1) != 1 or scale.stride(0) != 1:
        raise ValueError(f"{NAME}: w_q needs a contiguous last dim and scale "
                         f"a contiguous vector; got strides {w_q.stride()}, "
                         f"{scale.stride()}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec, vec_x = alignment(x, w_q)
    lib = build.load(NAME)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_matmul_fwd(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, N, K, x.stride(0), x.stride(1), w_q.stride(0), scale.numel(),
            int(x.dtype == torch.bfloat16), int(w_q.dtype == torch.uint8),
            int(transposed), int(vec), int(vec_x), stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out
