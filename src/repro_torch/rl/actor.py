"""Acting / serving: the prefill step and the serve (decode) step.

Counterpart of ``repro/rl/actor.py``. The serve step is one token of
autoregressive acting against the caches: the KV cache of each attention
layer, the conv window and state of each Mamba2 (SSM) layer. As in JAX, the
prefill step samples at temperature 1 whatever ``temperature`` says, and
the serve step divides the logits by it. Random draws come from an explicit
``torch.Generator`` on the logits' device; they cannot reproduce JAX's
threefry stream, so the two packages agree in distribution, not draw for
draw.
"""
from __future__ import annotations

import torch


def categorical(logits, generator: torch.Generator):
    """Draw one index per row of ``logits`` (…, V) by the Gumbel-max trick,
    as ``jax.random.categorical`` does. Returns int32 (…,)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def make_prefill_step(policy, max_len: int):
    def prefill_step(tokens, generator):
        logits, value, caches = policy.prefill(tokens, max_len)
        tok = categorical(logits, generator)
        return tok[:, None], value, caches
    return prefill_step


def make_serve_step(policy, temperature: float = 1.0, greedy: bool = False):
    def serve_step(tokens, caches, generator):
        logits, value, caches = policy.decode(tokens, caches)
        if greedy:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            tok = categorical(logits / temperature, generator)
        return tok[:, None], value, caches
    return serve_step


def generate(policy, prompt, num_tokens: int, generator: torch.Generator,
             max_len: int = 0, temperature: float = 1.0):
    """Batched autoregressive generation: one prefill, then
    ``num_tokens - 1`` serve steps. prompt: (B, Tp) int. Returns
    (B, num_tokens) int32 on the prompt's device, without a host sync."""
    B, Tp = prompt.shape
    max_len = max_len or (Tp + num_tokens)
    prefill = make_prefill_step(policy, max_len)
    serve = make_serve_step(policy, temperature)
    tok, _, caches = prefill(prompt, generator)
    out = [tok]
    for _ in range(num_tokens - 1):
        tok, _, caches = serve(tok, caches, generator)
        out.append(tok)
    return torch.cat(out, dim=1)
