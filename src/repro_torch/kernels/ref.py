"""Plain PyTorch versions of the ported kernels.

Same contracts as ``repro/kernels/ref.py``. They are the CPU execution path
and, on the card, the yardstick each CUDA kernel is held against. The int4
helpers (``pack_int4``, ``unpack_int4``, ``last_len``) follow the layout
stated in ``kernels/quant_matmul.py``.
"""
from __future__ import annotations

import math

import torch


def _scores(q, k, causal: bool, scale: float):
    """The scaled scores (B, K, G, T, S) in f32, -1e30 where the causal
    mask ``row >= col`` (aligned at 0) hides them."""
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, K, H // K, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    return s


def flash_attention(q, k, v, causal: bool = True, scale: float = None):
    """q: (B,T,H,hd); k,v: (B,S,K,hd) with H = K*G (GQA). f32 softmax;
    causal mask ``row >= col`` aligned at 0. Returns (B,T,H,hd) in q.dtype."""
    B, T, H, hd = q.shape
    w = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return o.reshape(B, T, H, hd).to(q.dtype)


def flash_attention_lse(q, k, causal: bool = True, scale: float = None):
    """The rows' natural log-sum-exp of the scaled, masked scores of
    ``flash_attention``, f32 (B, H, T): what the forward kernel writes for
    its backward."""
    B, T, H, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal, scale),
                           dim=-1).reshape(B, H, T)


def flash_attention_bwd(q, k, v, do, causal: bool = True,
                        scale: float = None):
    """(dq, dk, dv) of ``flash_attention`` at output gradient ``do``, by
    ``torch.autograd.grad`` of the plain forward, in the inputs' dtype (pass
    f32 copies for an f32 yardstick of bf16 inputs). The plain version of
    ``csrc/flash_attention_bwd.cu``; dk and dv sum over a KV head's query
    heads."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = flash_attention(q, k, v, causal=causal, scale=scale)
        return torch.autograd.grad(o, (q, k, v), do)


def flash_decode(q, k, v, length, with_lse: bool = False):
    """One-token decode attention. q: (B,H,hd); k,v: (B,S,K,hd);
    length: () int32 tensor — newest valid cache index (positions
    ``<= length`` attend), in [-1, S): -1 means no filled position, and
    the output is 0. Returns (B,H,hd) in q.dtype; with ``with_lse`` the
    output unrounded in f32, and each (b, h) row's log-sum-exp of the
    scaled scores (B,H) f32, -inf where nothing is filled (a
    context-parallel rank's empty slice)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) \
        / math.sqrt(hd)
    valid = torch.arange(S, device=q.device) <= length
    w = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, v.float())
    o = torch.where(length >= 0, o, 0.0).reshape(B, H, hd)
    if not with_lse:
        return o.to(q.dtype)
    lse = torch.logsumexp(s.masked_fill(~valid, float("-inf")), dim=-1)
    return o, lse.reshape(B, H)


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation, a reverse loop over time on (B,)
    slices (the recurrence of ``repro/kernels/ref.py::gae``).

    rewards, values, dones: (B, T); last_value: (B,). ``dones[:, t]`` marks
    that the episode ended at step t (no bootstrap across it). Returns the
    advantages (B, T) in f32."""
    rewards, values, last_value = (x.float() for x in
                                   (rewards, values, last_value))
    nonterm = 1.0 - dones.float()
    adv_next, v_next = torch.zeros_like(last_value), last_value
    out = [None] * rewards.shape[1]
    for t in reversed(range(rewards.shape[1])):
        nt = nonterm[:, t]
        delta = rewards[:, t] + gamma * v_next * nt - values[:, t]
        adv_next = delta + gamma * lam * nt * adv_next
        v_next = values[:, t]
        out[t] = adv_next
    if not out:
        return torch.zeros_like(rewards)
    return torch.stack(out, dim=1)


def ssd(x, dt, A, B_, C, h0=None, step_dtype=torch.float64):
    """Mamba2 selective-state recurrence, the step-by-step oracle of
    ``repro/kernels/ref.py::ssd``, carried in ``step_dtype``.

    x: (B,T,H,hd); dt: (B,T,H) positive step sizes (post-softplus); A: (H,)
    negative decay rates; B_, C: (B,T,H,ds) head-expanded gates; h0:
    optional (B,H,hd,ds) initial state. Returns y (B,T,H,hd) in x.dtype and
    h_last (B,H,hd,ds) in f32. The reference steps in f32; the port's
    oracle steps in f64 because in f32 its rounding over 48 Mamba2 layers
    moved a full-width mamba2 gradient 1.1e-3 from an f64 one, 13x as far
    as the CUDA kernels' (tools/lm_gate_spread.py on an H100)."""
    Bb, T, H, hd = x.shape
    ds = B_.shape[-1]
    in_dtype = x.dtype
    x, dt, B_, C, A = (t.to(step_dtype) for t in (x, dt, B_, C, A))
    h = h0.to(step_dtype) if h0 is not None else torch.zeros(
        (Bb, H, hd, ds), dtype=step_dtype, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A[None])                     # (B,H)
        upd = dt[:, t, :, None, None] * x[:, t, :, :, None] \
            * B_[:, t, :, None, :]                                # (B,H,hd,ds)
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhds,bhs->bhd", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((Bb, 0, H, hd))
    return y.to(in_dtype), h.float()


def ssd_bwd(x, dt, A, B_, C, dy, dh_last=None):
    """(dx, ddt, dA, dB_, dC) of ``ssd`` at the gradients ``dy`` of y and
    ``dh_last`` of h_last (None: h_last unused), by ``torch.autograd.grad``
    of the step-by-step oracle, in the inputs' dtypes. The plain version of
    ``csrc/ssd_bwd.cu``: dB_ and dC are the dense (B, T, H, ds) gradients
    of the head-expanded gates."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (x, dt, A, B_, C))
        y, h = ssd(*ins)
        outs, grads = [y], [dy]
        if dh_last is not None:
            outs.append(h)
            grads.append(dh_last)
        return torch.autograd.grad(outs, ins, grads)


def pack(leaves):
    """Emulation's byte pack: [(B, n_i) uint8] → (B, Σ n_i) uint8, as
    ``repro/kernels/ref.py::pack`` concatenates them."""
    return torch.cat(list(leaves), dim=-1)


def pack_int4(q):
    """(..., n) integers in [-8, 7] → (..., ceil(n / 2)) uint8: two values
    per byte along the last axis, the even index in the low nibble; an odd
    n leaves the last byte's high nibble 0."""
    q = q.to(torch.int8)
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    u = q.contiguous().view(torch.uint8) & 0xF
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p, n: int):
    """(..., ceil(n / 2)) uint8 from ``pack_int4`` → (..., n) int8,
    sign-extended."""
    s = p.contiguous().view(torch.int8)
    lo = (p << 4).view(torch.int8) >> 4
    return torch.stack([lo, s >> 4], dim=-1).flatten(-2)[..., :n]


def last_len(w_q, scale) -> int:
    """Logical length of the stored last axis of ``w_q``: its size for
    int8; for packed int4 (uint8) the scale's length when the bytes hold
    exactly that many values (2·bytes or 2·bytes − 1), else 2·bytes, which
    the scale then tiles."""
    if w_q.dtype != torch.uint8:
        return w_q.shape[-1]
    n2, s = 2 * w_q.shape[-1], scale.numel()
    return s if s in (n2 - 1, n2) else n2


def quant_matmul(x, w_q, scale, transposed: bool = False):
    """x (M, K) times the dequantised weight, f32 products, in x.dtype.

    ``w_q`` (K, N), or (N, K) with ``transposed``: int8, or int4 packed by
    ``pack_int4``; ``scale`` f32 over the stored last axis, tiled when
    shorter. The plain version of ``repro/kernels/ref.py::quant_matmul``:
    ``x @ (w_q · scale)`` (``x @ (w_q · scale).T`` with ``transposed``)."""
    n = last_len(w_q, scale)
    w = unpack_int4(w_q, n) if w_q.dtype == torch.uint8 else w_q
    w = w.float() * scale.float().repeat(n // scale.numel())
    return (x.float() @ (w.t() if transposed else w)).to(x.dtype)
