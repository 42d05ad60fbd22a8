"""Plain PyTorch versions of the ported kernels.

Same contracts as ``repro/kernels/ref.py``. They are the CPU execution path
and, on the card, the yardstick each CUDA kernel is held against.
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
