"""Policies in the paper's ``encode → recurrent → decode`` format.

``OceanPolicy`` is an MLP encoder with an optional LSTM cell and an optional
3×3 conv frontend; ``BackbonePolicy`` wraps an LM architecture as a
token-level policy: actions are next-token choices and the critic reads the
same final hidden state; the "recurrent cell" is the KV cache used by the
serve step. Both are the counterparts of ``repro/models/policy.py``.

``OceanPolicy`` is trained, so it keeps the reference's functional form: its
methods take the parameter dict (``init`` makes one), and the learner
differentiates through them and updates the dict with AdamW.
``BackbonePolicy`` serves, and owns its parameters.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import ParamSpec, Params, init_params


# -- LSTM cell ----------------------------------------------------------------

def lstm_spec(in_dim: int, hidden: int):
    return {
        "wi": ParamSpec((in_dim, 4 * hidden), fan_in=in_dim),
        "wh": ParamSpec((hidden, 4 * hidden), fan_in=hidden),
        "b": ParamSpec((4 * hidden,), init="zeros"),
    }


def lstm_step(params, x, carry):
    """The reference's cell: gates ``i, f, g, o`` from one ``(in, 4h)``
    product, one bias, and a forget bias of +1 (not ``nn.LSTMCell``, whose
    weights are transposed and which has two biases and no +1)."""
    c, h = carry
    gates = x @ params["wi"] + h @ params["wh"] + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (c, h)


# -- Ocean policy ---------------------------------------------------------------

class OceanPolicy(nn.Module):
    """MLP encoder (+ optional LSTM) + multidiscrete/value heads. The default
    architecture of the paper's model zoo: "an MLP sized to the flat
    observation and action spaces".

    ``conv_shape=(H, W)`` enables the CNN frontend for pixel-grid envs: the
    flat emulated observation is restored to its 2D layout and passed
    through one SAME-padded 3×3 conv with 8 filters before the MLP. Its
    kernel is stored OIHW ``(8, 1, 3, 3)`` (the reference stores HWIO)."""

    CONV_FILTERS = 8

    def __init__(self, obs_dim: int, nvec: tuple = (), hidden: int = 128,
                 recurrent: bool = False, num_outputs: int = 0,
                 conv_shape: Optional[tuple] = None):
        super().__init__()
        self.obs_dim, self.nvec, self.hidden = obs_dim, tuple(nvec), hidden
        self.recurrent = recurrent
        self.conv_shape = tuple(conv_shape) if conv_shape else None
        if self.conv_shape and self.conv_shape[0] * self.conv_shape[1] \
                != obs_dim:
            raise ValueError(f"conv_shape {self.conv_shape} does not hold "
                             f"{obs_dim} observation elements")
        # num_outputs overrides for continuous heads (mean ++ log_std)
        self.num_actions = num_outputs or sum(self.nvec)

    @property
    def enc_in(self) -> int:
        if self.conv_shape:
            return self.obs_dim * self.CONV_FILTERS
        return self.obs_dim

    def spec(self):
        h = self.hidden
        s = {
            "enc1": ParamSpec((self.enc_in, h), fan_in=self.enc_in),
            "b1": ParamSpec((h,), init="zeros"),
            "enc2": ParamSpec((h, h), fan_in=h),
            "b2": ParamSpec((h,), init="zeros"),
            "act": ParamSpec((h, self.num_actions), fan_in=h),
            "b_act": ParamSpec((self.num_actions,), init="zeros"),
            "val": ParamSpec((h, 1), fan_in=h),
            "b_val": ParamSpec((1,), init="zeros"),
        }
        if self.recurrent:
            s["lstm"] = lstm_spec(h, h)
        if self.conv_shape:
            s["conv"] = ParamSpec((self.CONV_FILTERS, 1, 3, 3), fan_in=9)
            s["b_conv"] = ParamSpec((self.CONV_FILTERS,), init="zeros")
        return s

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        """A parameter dict drawn from ``generator``, on its device."""
        return init_params(self.spec(), generator, dtype)

    def initial_carry(self, batch: int, device=None):
        if not self.recurrent:
            return None
        return (torch.zeros((batch, self.hidden), device=device),
                torch.zeros((batch, self.hidden), device=device))

    # paper §3.4 split ---------------------------------------------------------
    def _conv_frontend(self, params, obs):
        """(…, H·W) flat obs → (…, H·W·filters): restore the 2D layout, run
        the conv, and flatten in the reference's NHWC (h, w, filter) order."""
        H, W = self.conv_shape
        lead = tuple(obs.shape[:-1])
        x = F.conv2d(obs.reshape(-1, 1, H, W), params["conv"], padding=1)
        x = torch.tanh(x + params["b_conv"][:, None, None])
        return x.permute(0, 2, 3, 1).reshape(
            lead + (H * W * self.CONV_FILTERS,))

    def encode(self, params, obs):
        if self.conv_shape:
            obs = self._conv_frontend(params, obs)
        h = torch.tanh(obs @ params["enc1"] + params["b1"])
        return torch.tanh(h @ params["enc2"] + params["b2"])

    def recurrent_cell(self, params, h, carry, reset=None):
        """Zeroes the carry where ``reset`` before the step."""
        if not self.recurrent:
            return h, None
        if reset is not None:
            m = 1.0 - reset.float()[:, None]
            carry = (carry[0] * m, carry[1] * m)
        return lstm_step(params["lstm"], h, carry)

    def decode(self, params, h):
        logits = h @ params["act"] + params["b_act"]
        value = (h @ params["val"] + params["b_val"])[..., 0]
        return logits, value

    # ---------------------------------------------------------------------------
    def step(self, params, obs, carry, reset=None):
        h = self.encode(params, obs)
        h, carry = self.recurrent_cell(params, h, carry, reset)
        logits, value = self.decode(params, h)
        return logits, value, carry

    forward = step

    def seq(self, params, obs_seq, carry, resets):
        """obs_seq: (T, B, obs); resets: (T, B). Runs the cell over time,
        resetting the carry at episode starts."""
        if not self.recurrent:
            h = self.encode(params, obs_seq)
            logits, value = self.decode(params, h)
            return logits, value, carry
        logits, values = [], []
        for t in range(obs_seq.shape[0]):
            lg, v, carry = self.step(params, obs_seq[t], carry, resets[t])
            logits.append(lg)
            values.append(v)
        return torch.stack(logits), torch.stack(values), carry


# -- LM backbone policy ---------------------------------------------------------


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
