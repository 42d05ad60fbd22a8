"""Plain PyTorch versions of the ported kernels.

Same contracts as ``repro/kernels/ref.py``. They are the CPU execution path
and, on the card, the yardstick each CUDA kernel is held against. The int4
helpers (``pack_int4``, ``unpack_int4``, ``last_len``) follow the layout
stated in ``kernels/quant_matmul.py``.
"""
from __future__ import annotations

import math

import torch


def flash_attention(q, k, v, causal: bool = True, scale: float = None):
    """q: (B,T,H,hd); k,v: (B,S,K,hd) with H = K*G (GQA). f32 softmax;
    causal mask ``row >= col`` aligned at 0. Returns (B,T,H,hd) in q.dtype."""
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, K, G, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return o.reshape(B, T, H, hd).to(q.dtype)


def flash_decode(q, k, v, length):
    """One-token decode attention. q: (B,H,hd); k,v: (B,S,K,hd);
    length: () int32 tensor — newest valid cache index (positions
    ``<= length`` attend). Returns (B,H,hd) in q.dtype."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) \
        / math.sqrt(hd)
    valid = torch.arange(S, device=q.device) <= length
    s = s.masked_fill(~valid, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


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


def ssd(x, dt, A, B_, C, h0=None):
    """Mamba2 selective-state recurrence, the step-by-step oracle of
    ``repro/kernels/ref.py::ssd``, in f32.

    x: (B,T,H,hd); dt: (B,T,H) positive step sizes (post-softplus); A: (H,)
    negative decay rates; B_, C: (B,T,H,ds) head-expanded gates; h0:
    optional (B,H,hd,ds) initial state. Returns y (B,T,H,hd) in x.dtype and
    h_last (B,H,hd,ds) in f32."""
    Bb, T, H, hd = x.shape
    ds = B_.shape[-1]
    in_dtype = x.dtype
    x, dt, B_, C, A = (t.float() for t in (x, dt, B_, C, A))
    h = h0.float() if h0 is not None else torch.zeros(
        (Bb, H, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A[None])                     # (B,H)
        upd = dt[:, t, :, None, None] * x[:, t, :, :, None] \
            * B_[:, t, :, None, :]                                # (B,H,hd,ds)
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhds,bhs->bhd", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((Bb, 0, H, hd))
    return y.to(in_dtype), h


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
