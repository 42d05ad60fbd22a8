"""Synthetic LM rollout batches (the data pipeline for backbone PPO).

The counterpart of ``repro/data/buffer.py``. Real deployments stream
rollouts from the actor fleet; here the same batch contract
(``rl.learner.lm_batch_fields``) is filled with ``device="meta"`` tensors
(shapes only) or random data drawn from an explicit generator, on its
device, by the reference's value rules. ``RingBuffer`` is the host-side
double-buffered handoff of the pool (paper §3.3, learner side).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.rl.learner import lm_batch_fields


def abstract_batch(cfg: ModelConfig, batch_size: int, seq_len: int):
    """The batch's fields as ``device="meta"`` tensors: shapes and dtypes,
    no storage."""
    return {k: torch.empty(sh, dtype=dt, device="meta")
            for k, (sh, dt) in lm_batch_fields(cfg, batch_size,
                                               seq_len).items()}


def random_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                 generator: torch.Generator):
    """Random values by the reference's rules, on the generator's device:
    integers uniform over the vocab, dones Bernoulli(0.02), every float
    field normal × 0.1 (cast to its dtype first, as the reference casts),
    and ``old_logprob = -|·| - 1``. The numbers differ from JAX's: the two
    packages' generators differ."""
    dev = generator.device
    out = {}
    for k, (sh, dt) in lm_batch_fields(cfg, batch_size, seq_len).items():
        if dt == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, sh, generator=generator,
                                   device=dev, dtype=dt)
        elif dt == torch.bool:
            out[k] = torch.rand(sh, generator=generator, device=dev) < 0.02
        else:
            out[k] = torch.randn(sh, generator=generator, device=dev).to(
                dt) * 0.1
    out["old_logprob"] = -out["old_logprob"].abs() - 1.0
    return out


class RingBuffer:
    """Double-buffered batch handoff (paper §3.3, learner side)."""

    def __init__(self, slots: int = 2):
        self._slots = [None] * slots
        self._w = self._r = 0

    def put(self, batch):
        self._slots[self._w % len(self._slots)] = batch
        self._w += 1

    def get(self):
        if self._r >= self._w:
            raise IndexError("ring buffer empty")
        b = self._slots[self._r % len(self._slots)]
        self._r += 1
        return b
