"""Policies in the paper's ``encode → recurrent → decode`` format.

``BackbonePolicy`` wraps an LM architecture as a token-level policy: actions
are next-token choices and the critic reads the same final hidden state;
the "recurrent cell" is the KV cache used by the serve step. It is the
counterpart of ``repro/models/policy.py::BackbonePolicy`` as an
``nn.Module`` that owns its parameters. ``OceanPolicy`` comes with the Ocean
PPO slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import ParamSpec, Params, init_params


class BackbonePolicy(nn.Module):
    """The kernels' backend is the dispatch registry's choice (the CUDA
    kernels on the card); ``kernels.dispatch.using("ref")`` forces the plain
    versions.

    Parameters are drawn from ``generator`` (default: a new generator on
    ``device`` seeded with 0), in ``dtype`` (default ``cfg.param_dtype``).
    ``device=None`` means CUDA and raises without a Hopper card."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: torch.Generator = None, dtype=None):
        super().__init__()
        dev = _device.resolve(device)
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        tree = init_params(self.spec(), generator,
                           dtype_of(dtype or cfg.param_dtype), dev)
        self.backbone = Params(tree["backbone"])
        if cfg.value_head:
            self.value = nn.Parameter(tree["value"], requires_grad=False)

    def spec(self):
        s = {"backbone": tr.transformer_spec(self.cfg)}
        if self.cfg.value_head:
            s["value"] = ParamSpec((self.cfg.d_model, 1),
                                   fan_in=self.cfg.d_model)
        return s

    def _value(self, hidden):
        if not self.cfg.value_head:
            return torch.zeros(hidden.shape[:-1], device=hidden.device)
        # dot in hidden.dtype, upcast after
        return (hidden @ self.value.to(hidden.dtype))[..., 0].float()

    def seq(self, tokens):
        """Full-sequence forward. tokens: (B, T). Returns (logits (B,T,V),
        values (B,T), aux)."""
        hidden, aux = tr.forward(self.backbone, tokens, self.cfg)
        logits = tr.logits_from_hidden(self.backbone, hidden, self.cfg)
        return logits, self._value(hidden), aux

    @torch.no_grad()
    def prefill(self, tokens, max_len: int):
        """tokens: (B, T). Returns (last-token logits (B,V), value (B,),
        caches)."""
        hidden, caches = tr.prefill(self.backbone, tokens, self.cfg,
                                    max_len=max_len)
        last = hidden[:, -1:]
        logits = tr.logits_from_hidden(self.backbone, last, self.cfg)
        return logits[:, 0], self._value(last)[:, 0], caches

    @torch.no_grad()
    def decode(self, tokens, caches):
        """tokens: (B, 1) — one serve step against ``caches`` (updated in
        place). Returns (logits (B,V), value (B,), caches)."""
        hidden, caches = tr.decode(self.backbone, tokens, self.cfg, caches)
        logits = tr.logits_from_hidden(self.backbone, hidden, self.cfg)
        return logits[:, 0], self._value(hidden)[:, 0], caches

    def init_caches(self, batch: int, max_len: int):
        return tr.init_caches(self.cfg, batch, max_len,
                              device=self.backbone["final_norm"].device)
