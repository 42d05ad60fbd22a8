"""The kernels' work, and the one record of a program's kernel calls and
collectives.

Each ``*_work`` gives (FLOP, bytes) of one call: the operations the
function must do on this call's inputs, and the bytes it must move, each
input read once and each output written once. ``chip_smoke.py`` divides
them by the H100's peak rates for a kernel's bound; ``launch/
op_analysis.py`` adds them up as one unit a call (the reference's
``KERNEL_`` scopes), never the plain version's internals.

While a ``recording`` is open, ``kernels/dispatch.py::call`` records each
kernel op's ``kernel_work`` and runs the implementation ``opaque`` (what
it does inside, the plain version's ops on the CPU, is not counted); on
the ``meta`` device (the dry run's tensors, ``launch/dryrun.py``) a
wrapper returns outputs of the right shape. The two backward kernels,
which no dispatch op reaches, record their work in their meta branch.
``distributed/sharding.py::record`` adds each collective to the same
record.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

_LOGS: list = []        # open ``recording`` logs
_OPAQUE = [0]           # depth of ``opaque`` blocks


@dataclasses.dataclass
class Log:
    """What a ``recording`` saw, in order: ``kernels`` (name, FLOP, bytes)
    a call, ``collectives`` (kind, group size, result bytes) a call."""
    kernels: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)


def recording_open() -> bool:
    return bool(_LOGS)


@contextlib.contextmanager
def opaque():
    """A kernel call's inside: ``launch/op_analysis.py`` counts none of
    its ops (the call is one unit, its ``kernel_work``)."""
    _OPAQUE[0] += 1
    try:
        yield
    finally:
        _OPAQUE[0] -= 1


def is_opaque() -> bool:
    return _OPAQUE[0] > 0


def record(name: str, flops: float, nbytes: float) -> None:
    """One kernel call's work, appended to every open ``recording``."""
    for log in _LOGS:
        log.kernels.append((name, float(flops), float(nbytes)))


def record_collective(kind: str, size: int, nbytes: int) -> None:
    """One collective over ``size`` ranks whose result is ``nbytes``,
    appended to every open ``recording``."""
    for log in _LOGS:
        log.collectives.append((kind, size, nbytes))


@contextlib.contextmanager
def recording():
    """A ``Log`` of every kernel call and collective in the block."""
    log = Log()
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def attention_work(B, T, H, K, hd, S=None, causal=True, elem=2,
                   with_lse=False):
    """(FLOP, bytes) of attention of T queries over S keys (S = T): the two
    products over the pairs that attend (the causal ones: T (T + 1) / 2 a
    head), and q, k, v and o moved once (``elem`` bytes an element), the
    f32 LSE written with ``with_lse``."""
    S = T if S is None else S
    pairs = T * (T + 1) if causal else 2 * T * S
    flops = 2 * B * H * hd * pairs
    nbytes = elem * (2 * B * T * H * hd + 2 * B * S * K * hd)
    return flops, nbytes + (4 * B * H * T if with_lse else 0)


def attention_bwd_work(B, T, H, K, hd, elem=2):
    """(FLOP, bytes) of the causal attention backward: the four products
    over the causal pairs (dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T
    Q), q, k, v, o, do and the f32 lse read and dq, dk, dv written once."""
    flops = 4 * B * H * hd * T * (T + 1)
    nbytes = elem * (4 * B * T * H * hd + 4 * B * T * K * hd) + 4 * B * H * T
    return flops, nbytes


def decode_work(B, L, H, K, hd, elem=2, with_lse=False):
    """(FLOP, bytes) of one-token decode attention whose newest valid
    index is L (L + 1 positions attend; none at L = -1): 4 FLOP an element
    of the filled K/V prefix read, q read and o written once, and with
    ``with_lse`` o written in f32 and each row's f32 log-sum-exp."""
    n = max(L + 1, 0)
    flops = 4 * B * H * hd * n
    nbytes = elem * (2 * B * n * K * hd + B * H * hd) + \
        (4 if with_lse else elem) * B * H * hd
    return flops, nbytes + (4 * B * H if with_lse else 0)


def ssd_work(B, T, H, P, N, G, Q, elem):
    """(FLOP, bytes) the SSD function needs: per (b, h) and chunk of q
    steps, C.B^T (2 q^2 N), the masked product with x (2 q^2 P), the
    carried state's term (2 q P N) and the state update (2 q P N); x read
    and y written in the input type, dt read and h_last written in f32, B_
    and C read once per group."""
    flops = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        flops += B * H * (2 * q * q * (N + P) + 4 * q * P * N)
    nbytes = (2 * B * T * H * P * elem + 4 * B * T * H
              + 2 * B * T * G * N * elem + 4 * B * H * P * N)
    return flops, nbytes


def ssd_bwd_work(B, T, H, P, N, G, Q, elem):
    """(FLOP, bytes) of the chunked SSD backward in chunks of Q steps: per
    (b, h) and chunk of q steps, over its q (q + 1) / 2 causal pairs C B^T,
    dy x^T, (S o L)^T dy, dS B and dS^T C (2 (3 N + 2 P) a pair), and five
    state products of 2 q P N (B dh^T, x dh, dy h_prev, dh_prev and the
    recomputed state); x, dt, B_ and C (once a group) and dy read, dx, ddt,
    dB_ and dC (dense over heads) and dA written once."""
    flops = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        flops += B * H * (q * (q + 1) * (3 * N + 2 * P) + 10 * q * P * N)
    nbytes = (3 * B * T * H * P * elem + 4 * 2 * B * T * H
              + 2 * B * T * G * N * elem + 2 * B * T * H * N * elem + 4 * H)
    return flops, nbytes


def quant_matmul_work(M, K, N, int4=False, transposed=False, elem=2):
    """(FLOP, bytes) of x (M, K) times a quantised (K, N) weight: 2 M K N,
    x read and the product written in ``elem`` bytes, the weight at one
    byte an element (half packed) and its f32 scale (over K when
    ``transposed``, else over N) read once."""
    wbytes = K * N // 2 if int4 else K * N
    nbytes = elem * M * K + wbytes + 4 * (K if transposed else N) + \
        elem * M * N
    return 2 * M * K * N, nbytes


def gae_work(B, T):
    """(FLOP, bytes) of GAE over (B, T): 8 a step; rewards, values (f32),
    dones (a byte) read and advantages written, last_value read."""
    return 8 * B * T, (4 + 4 + 1 + 4) * B * T + 4 * B


def kernel_work(op: str, args, kwargs):
    """(FLOP, bytes) of one call of dispatch op ``op`` with these
    arguments, by the formulas above; a decode's length is read off its
    tensor (a meta one counts the full cache)."""
    if op == "flash_attention":
        q, k = args[0], args[1]
        B, T, H, hd = q.shape
        # the forward keeps its LSE where autograd will take the backward
        lse = torch.is_grad_enabled() and any(t.requires_grad
                                              for t in args[:3])
        return attention_work(B, T, H, k.shape[2], hd, k.shape[1],
                              kwargs.get("causal", True), q.element_size(),
                              lse)
    if op == "flash_decode":
        q, k, _, length = args[:4]
        B, H, hd = q.shape
        S, K = k.shape[1], k.shape[2]
        L = S - 1 if length.device.type == "meta" else \
            min(int(length), S - 1)
        return decode_work(B, L, H, K, hd, q.element_size(),
                           kwargs.get("with_lse", False))
    if op == "ssd":
        x, B_ = args[0], args[3]
        Bb, T, H, hd = x.shape
        G = 1 if B_.stride(2) == 0 else H
        return ssd_work(Bb, T, H, hd, B_.shape[-1], G,
                        kwargs.get("chunk", 128), x.element_size())
    if op == "quant_matmul":
        from repro_torch.kernels.ref import last_len
        x, w, scale = args[:3]
        tr = kwargs.get("transposed", False)
        N = w.shape[0] if tr else last_len(w, scale)
        return quant_matmul_work(x.shape[0], x.shape[1], N,
                                 w.element_size() == 1 and not
                                 w.dtype.is_signed, tr, x.element_size())
    if op == "gae":
        return gae_work(*args[0].shape)
    if op == "pack":
        leaves = args[0]
        return pack_work(leaves[0].shape[0], [t.shape[1] for t in leaves])
    raise KeyError(f"no work formula for kernel op {op!r}")


def pack_work(B, widths):
    """(FLOP, bytes) of the byte pack of B rows of leaves ``widths`` bytes
    wide: each byte read once and written once."""
    return 0, 2 * B * sum(widths)
