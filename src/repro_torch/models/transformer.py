"""Backbone assembler: dense, MoE, SSM and hybrid stacks from one config.

Counterpart of ``repro/models/transformer.py``. JAX scans a stacked
``(n_periods, …)`` parameter tree; the port keeps one parameter tree per
layer (``layers.0`` … ``layers.{L-1}``) and runs a Python loop over layers.
Each layer's mixer is attention or a Mamba2 block by
``cfg.is_attn_layer(i)``, and its FFN a gated MLP, an MoE
(``models/moe.py``) where ``cfg.is_moe_layer(i)``, or none (``d_ff`` 0 on
a layer without experts).

Three entry points: ``forward`` (full sequence; differentiable, the
training path), ``prefill`` (build caches), ``decode`` (one token against
caches). ``forward`` and ``prefill`` take an optional ``prefix`` (B, P, d)
of precomputed frontend embeddings (``models/frontends.py``), cast to
``cfg.dtype`` and put before the token embeddings; ``decode`` takes none,
as in the reference. ``forward`` sums the MoE layers' aux losses into
``moe_aux``; ``prefill`` and ``decode`` drop them. Under autograd
``forward`` runs each layer as ``cfg.remat`` says, as the reference's
``_remat`` does: ``"full"`` under ``torch.utils.checkpoint`` (nothing of
the layer saved, its forward run again in the backward, under the kernel
backend the forward ran with: ``dispatch.recompute_context``), ``"dots"``
under the same checkpoint with a selective policy that saves the outputs
of the matrix products (``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``,
what ``@`` and ``einsum`` lower to) and recomputes everything else, the
attention and SSD kernels included, as ``dots_saveable`` saves
``dot_general``s and not a ``pallas_call``; ``"none"`` plainly.

``tp`` pads the head counts (``attention.attention_spec``); under a plan
(``distributed/plan.py``) every layer runs on this rank's heads, experts
and vocab block, their counts read off the local parameters. Serving on a
mesh: ``init_caches(..., tp=)`` gives a rank's caches (``cache_pspecs``:
its batch rows, KV heads, SSM heads and block of the conv channels, or
under ``context_parallel`` its slice of the KV sequence); ``prefill`` and
``decode`` take the rank's rows of the batch (all of it, B 1, under
``context_parallel``) and return its vocab block of the logits.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import plan as _plan
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import ParamSpec


def layer_kinds(cfg: ModelConfig, i: int):
    mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
    if cfg.d_ff == 0 and not cfg.is_moe_layer(i):
        ffn = None
    else:
        ffn = "moe" if cfg.is_moe_layer(i) else "mlp"
    return mixer, ffn


def _norm_spec(cfg: ModelConfig) -> ParamSpec:
    return L.rms_norm_spec(cfg.d_model)


def transformer_spec(cfg: ModelConfig, tp: int = 1):
    layers = {}
    for i in range(cfg.num_layers):
        mixer, ffn = layer_kinds(cfg, i)
        l = {"ln_mix": _norm_spec(cfg)}
        if mixer == "attn":
            l["attn"] = attn.attention_spec(cfg, tp)
        else:
            l["ssm"] = ssm_mod.ssm_spec(cfg)
        if ffn == "mlp":
            l["ln_ffn"] = _norm_spec(cfg)
            l["mlp"] = L.make_mlp_spec(cfg)
        elif ffn == "moe":
            l["ln_ffn"] = _norm_spec(cfg)
            l["moe"] = moe_mod.moe_spec(cfg)
        layers[str(i)] = l
    spec = {"embedding": L.embedding_spec(cfg), "layers": layers,
            "final_norm": _norm_spec(cfg)}
    spec.update(L.unembed_spec(cfg))
    return spec


def _ffn(p, x, cfg: ModelConfig, aux: bool = True):
    """The layer's FFN with its residual: (x, MoE aux loss or None; None
    without ``aux``, serving's)."""
    if "ln_ffn" not in p:
        return x, None
    h = L.norm(p, "ln_ffn", x, cfg)
    if "moe" in p:
        y, a = moe_mod.moe_apply(p["moe"], h, cfg, aux=aux)
        return x + y, a
    return x + L.mlp_apply(p["mlp"], h, cfg), None


def _layer(p, x, cfg: ModelConfig):
    h = L.norm(p, "ln_mix", x, cfg)
    if "attn" in p:
        x = x + attn.attend_full(p["attn"], h, cfg)
    else:
        x = x + ssm_mod.ssm_apply(p["ssm"], h, cfg)
    return _ffn(p, x, cfg)


def _embed_inputs(params, tokens, cfg: ModelConfig, prefix=None):
    """tokens (B, Tt) and an optional prefix (B, P, d) → (B, P + Tt, d)."""
    x = L.embed_tokens(params["embedding"], tokens, cfg)
    if prefix is not None:     # vlm / audio stub frontend
        x = torch.cat([prefix.to(L.dtype_of(cfg.dtype)), x], dim=1)
    return x


# the matrix products "dots" saves: what ``@``, ``matmul`` and ``einsum``
# lower to on both devices
DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
        torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def dots_context():
    """``context_fn`` of ``remat="dots"``: the selective policy's pair of
    contexts, each also under the kernel backend the forward ran with
    (``dispatch.recompute_context``)."""
    fwd, rec = create_selective_checkpoint_contexts(_save_dots)
    dfwd, drec = dispatch.recompute_context()
    return _both(fwd, dfwd), _both(rec, drec)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


REMAT_CONTEXT = {"full": dispatch.recompute_context, "dots": dots_context}


def forward(params, tokens, cfg: ModelConfig, prefix=None):
    """Full-sequence forward. tokens: (B, Tt); prefix: (B, P, d) or None.
    Returns (hidden (B, P + Tt, d), {"moe_aux": () f32})."""
    remat = torch.is_grad_enabled() and cfg.remat != "none"
    if remat and cfg.remat not in REMAT_CONTEXT:
        raise ValueError(f"remat={cfg.remat!r}: one of 'full', 'dots', "
                         f"'none'")
    x = _embed_inputs(params, tokens, cfg, prefix)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.num_layers):
        p = params["layers"][str(i)]
        x, a = (checkpoint(_layer, p, x, cfg, use_reentrant=False,
                           context_fn=REMAT_CONTEXT[cfg.remat]) if remat
                else _layer(p, x, cfg))
        if a is not None:
            aux = aux + a
    x = L.norm(params, "final_norm", x, cfg)
    return x, {"moe_aux": aux}


def logits_from_hidden(params, x, cfg: ModelConfig):
    """Logits (…, V) f32, the padded vocab masked; under a plan this
    rank's vocab block of them."""
    logits = L.unembed(params, params["embedding"], x, cfg)
    v = cfg.padded_vocab()
    if v != cfg.vocab_size:   # mask the padded vocab
        v0, n = _plan.tp_block(v)
        mask = torch.arange(v0, v0 + n, device=x.device) < cfg.vocab_size
        logits = logits.masked_fill(~mask, -1e30)
    return logits


# -- caches -------------------------------------------------------------------

class Caches(NamedTuple):
    kv: List[Optional[attn.KVCache]]       # per layer; None on SSM layers
    ssm: List[Optional[ssm_mod.SSMCache]]  # per layer; None on attn layers
    length: torch.Tensor                   # () int32 on the device


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None, tp: int = 1, split: int = 1) -> Caches:
    """Zero caches of ``batch`` rows and ``max_len`` positions: whole with
    ``tp`` 1 (``tp`` only pads the KV heads, as the reference's do), or a
    rank's part of them with ``split`` = tp (a plan's ``model`` size: its
    KV heads, SSM heads and block of the conv channels); ``batch`` and
    ``max_len`` are the rank's own (B/D rows, or S/D positions under
    ``context_parallel``)."""
    kv, ssm = [], []
    for i in range(cfg.num_layers):
        is_attn = layer_kinds(cfg, i)[0] == "attn"
        kv.append(attn.init_cache(cfg, batch, max_len, device=device, tp=tp,
                                  split=split) if is_attn else None)
        ssm.append(None if is_attn else ssm_mod.init_ssm_cache(
            cfg, batch, device=device, tp=split))
    return Caches(kv, ssm, torch.zeros((), dtype=torch.int32, device=device))


def prefill(params, tokens, cfg: ModelConfig, max_len: int = 0,
            prefix=None, tp: int = 1):
    """Forward + cache build. tokens: (B, Tt); prefix: (B, P, d) or None;
    T = P + Tt. Returns (hidden, caches). KV caches are allocated at
    ``max_len`` (default T) and filled; SSM caches are the conv window and
    final state that the scan returns; ``tp`` pads their KV heads. Under a
    plan: this rank's rows, heads and caches."""
    pl = _plan.active()
    split = pl.tp if pl is not None else 1
    x = _embed_inputs(params, tokens, cfg, prefix)
    B, T, _ = x.shape
    kv, ssm = [], []
    for i in range(cfg.num_layers):
        p = params["layers"][str(i)]
        h = L.norm(p, "ln_mix", x, cfg)
        if "attn" in p:
            cache = attn.init_cache(cfg, B, max_len or T, device=x.device,
                                    tp=tp, split=split)
            y, c = attn.attend_prefill(p["attn"], h, cfg, cache)
            kv.append(c)
            ssm.append(None)
        else:
            y, c = ssm_mod.ssm_apply(p["ssm"], h, cfg, return_cache=True)
            kv.append(None)
            ssm.append(c)
        x, _ = _ffn(p, x + y, cfg, aux=False)
    x = L.norm(params, "final_norm", x, cfg)
    return x, Caches(kv, ssm, torch.full((), T, dtype=torch.int32,
                                         device=x.device))


def decode(params, tokens, cfg: ModelConfig, caches: Caches,
           context_parallel: bool = False):
    """One-token step. tokens: (B, 1). Returns (hidden, caches). As in JAX,
    each attention layer attends at the global ``caches.length``; the
    per-layer lengths come back zeroed and the global one is incremented.
    SSM layers step their conv window and state (the state in place).
    ``context_parallel`` (long_500k): the KV caches hold this rank's slice
    of the sequence (``attention.attend_decode``); the SSM layers run the
    same step on every data rank, their caches replicated over the data
    axes, as the reference's ``cache_pspecs`` imply."""
    x = L.embed_tokens(params["embedding"], tokens, cfg)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    kv, ssm = [], []
    for i in range(cfg.num_layers):
        p = params["layers"][str(i)]
        h = L.norm(p, "ln_mix", x, cfg)
        if "attn" in p:
            y, c = attn.attend_decode(
                p["attn"], h, cfg, caches.kv[i]._replace(length=caches.length),
                context_parallel=context_parallel)
            kv.append(c._replace(length=zero))
            ssm.append(None)
        else:
            y, c = ssm_mod.ssm_decode(p["ssm"], h, cfg, caches.ssm[i])
            kv.append(None)
            ssm.append(c)
        x, _ = _ffn(p, x + y, cfg, aux=False)
    x = L.norm(params, "final_norm", x, cfg)
    return x, Caches(kv, ssm, caches.length + 1)
