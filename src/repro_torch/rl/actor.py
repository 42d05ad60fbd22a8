"""Acting / serving: the prefill step and the serve (decode) step.

Counterpart of ``repro/rl/actor.py``. The serve step is one token of
autoregressive acting against the caches: the KV cache of each attention
layer, the conv window and state of each Mamba2 (SSM) layer. As in JAX, the
prefill step samples at temperature 1 whatever ``temperature`` says, and
the serve step divides the logits by it. Random draws come from an explicit
``torch.Generator`` on the logits' device; they cannot reproduce JAX's
threefry stream, so the two packages agree in distribution, not draw for
draw.

On a mesh (``policy.plan``) every rank calls the steps with the global
tokens and its own caches: a step takes its data rank's rows (all of them
under ``context_parallel``, B 1), gathers its vocab-parallel logits over
``model``, draws the uniforms of the global batch from the generator (the
same seed on every rank) and keeps its rows, then gathers the tokens over
``data``. So every rank returns the same global tokens, and they are the
one-device step's for the same generator and the same logits.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import plan as _plan


def categorical(logits, generator: torch.Generator, rows=None):
    """Draw one index per row of ``logits`` (…, V) by the Gumbel-max trick,
    as ``jax.random.categorical`` does. Returns int32 (…,). ``rows`` =
    (first, total): ``logits`` are rows [first, first + n) of a (total, V)
    batch, whose uniforms are drawn and cut to them."""
    tiny = torch.finfo(torch.float32).tiny
    shape = logits.shape if rows is None else (rows[1],) + logits.shape[1:]
    u = torch.rand(shape, generator=generator, device=logits.device)
    if rows is not None:
        u = u[rows[0]:rows[0] + logits.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def _sample(policy, logits, generator, temperature: float = 1.0,
            greedy: bool = False, context_parallel: bool = False):
    """(B, 1) int32 tokens of the global batch from this rank's logits."""
    plan = getattr(policy, "plan", None)
    if plan is None:
        tok = torch.argmax(logits, dim=-1).to(torch.int32) if greedy else \
            categorical(logits / temperature, generator)
        return tok[:, None]
    with _plan.scope(plan):
        logits = _plan.gather_nograd(logits, -1, "model")
        n = logits.shape[0]
        split = not context_parallel and plan.dp > 1
        # ``split`` is a host bool of the plan's layout, not a tensor
        rows = (plan.dp_index * n, plan.dp * n) if split else None  # repro_torch: noqa[HOST-SYNC]
        tok = torch.argmax(logits, dim=-1).to(torch.int32) if greedy else \
            categorical(logits / temperature, generator, rows)
        if split:  # repro_torch: noqa[HOST-SYNC] — a host bool, as above
            tok = _plan.gather_nograd(tok, 0, "data")
        return tok[:, None]


def make_prefill_step(policy, max_len: int):
    def prefill_step(tokens, generator, prefix=None):
        logits, value, caches = policy.prefill(
            _rows(policy, tokens), max_len,
            prefix=None if prefix is None else _rows(policy, prefix))
        return _sample(policy, logits, generator), value, caches
    return prefill_step


def make_serve_step(policy, temperature: float = 1.0,
                    context_parallel: bool = False, greedy: bool = False):
    def serve_step(tokens, caches, generator):
        logits, value, caches = policy.decode(
            _rows(policy, tokens, context_parallel), caches,
            context_parallel=context_parallel)
        tok = _sample(policy, logits, generator, temperature, greedy,
                      context_parallel)
        return tok, value, caches
    return serve_step


def _rows(policy, tokens, context_parallel=False):
    return tokens if getattr(policy, "plan", None) is None else \
        policy.rows(tokens, context_parallel)


def generate(policy, prompt, num_tokens: int, generator: torch.Generator,
             max_len: int = 0, temperature: float = 1.0):
    """Batched autoregressive generation: one prefill, then
    ``num_tokens - 1`` serve steps. prompt: (B, Tp) int. Returns
    (B, num_tokens) int32 on the prompt's device, without a host sync; on
    a mesh every rank returns the global tokens."""
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
