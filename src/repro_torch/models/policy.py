"""Policies in the paper's ``encode → recurrent → decode`` format.

``OceanPolicy`` is an MLP encoder with an optional LSTM cell and an optional
3×3 conv frontend; ``BackbonePolicy`` wraps an LM architecture as a
token-level policy: actions are next-token choices and the critic reads the
same final hidden state; the "recurrent cell" is what the serve step
carries: the KV caches of attention layers and the conv window and state of
Mamba2 (SSM) layers. Both are the counterparts of ``repro/models/policy.py``.

``OceanPolicy`` is trained, so it keeps the reference's functional form: its
methods take the parameter dict (``init`` makes one), and the learner
differentiates through them and updates the dict with AdamW.
``BackbonePolicy`` serves from the parameters it owns, and trains in the
same functional form: ``params()`` gives its parameters as a plain tree
(``models/convert.py::backbone_tree_from_jax`` gives the reference's),
and ``seq(params, tokens)`` and ``_value(params, hidden)`` read such a tree.
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
from repro_torch.distributed.plan import scope as _plan_scope
from repro_torch.models.attention import KVCache as attn_cache
from repro_torch.models.params import (QMAX, ParamSpec, Params, init_params,
                                       param_pspecs, quantize_spec, stored,
                                       use_quantized, use_weight)


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

    def abstract(self, device=None, dtype=torch.float32) -> dict:
        """A parameter dict of the policy's shapes, uninitialised, on
        ``device`` — the ``like`` template of checkpoint and PolicyStore
        restores (its values are never read)."""
        def like(spec):
            if isinstance(spec, dict):
                return {k: like(v) for k, v in spec.items()}
            return torch.empty(spec.shape, dtype=spec.dtype or dtype,
                               device=device)
        return like(self.spec())

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
            m = 1.0 - reset.float()[..., None]
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

    def step_stacked(self, params, obs, carry, reset=None):
        """``step`` of K param sets stacked on a leading axis, each over its
        own rows: ``obs`` (K, R, obs), ``carry`` (K, R, hidden) pairs and
        ``reset`` (K, R). One batched product a layer (the arena's opponent
        pool), where K ``step`` calls would take K."""
        p = _bias_rows(params)
        if self.conv_shape:
            obs = self._conv_stacked(params, obs)
        h = torch.tanh(obs @ p["enc1"] + p["b1"])
        h = torch.tanh(h @ p["enc2"] + p["b2"])
        h, carry = self.recurrent_cell(p, h, carry, reset)
        logits, value = self.decode(p, h)
        return logits, value, carry

    def _conv_stacked(self, params, obs):
        """The conv frontend of K stacked param sets as one grouped conv:
        (K, R, H·W) → (K, R, H·W·filters), each set over its own rows."""
        H, W = self.conv_shape
        K, R, F_ = obs.shape[0], obs.shape[1], self.CONV_FILTERS
        x = obs.permute(1, 0, 2).reshape(R, K, H, W)
        w = params["conv"].reshape(K * F_, 1, 3, 3)
        x = F.conv2d(x, w, padding=1, groups=K).reshape(R, K, F_, H, W)
        x = torch.tanh(x + params["b_conv"].reshape(1, K, F_, 1, 1))
        return x.permute(1, 0, 3, 4, 2).reshape(K, R, H * W * F_)

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


def _bias_rows(params: dict) -> dict:
    """Stacked params with a row axis on every bias, (K, n) → (K, 1, n),
    so that ``x @ w + b`` broadcasts over each set's rows."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _bias_rows(v)
        elif k.startswith("b") and k != "b_conv":
            out[k] = v[:, None]
        else:
            out[k] = v
    return out


# -- LM backbone policy ---------------------------------------------------------


def policy_spec(cfg: ModelConfig, tp: int = 1,
                quantize: Optional[str] = None):
    """``BackbonePolicy``'s spec tree without a policy: the backbone at
    ``tp`` and the value head, quantised where ``quantize`` says."""
    s = {"backbone": tr.transformer_spec(cfg, tp)}
    if cfg.value_head:
        s["value"] = ParamSpec((cfg.d_model, 1), fan_in=cfg.d_model,
                               axes=("embed", "null"))
    return quantize_spec(s, quantize) if quantize else s


class BackbonePolicy(nn.Module):
    """The kernels' backend is the dispatch registry's choice (the CUDA
    kernels on the card); ``kernels.dispatch.using("ref")`` forces the plain
    versions.

    Parameters are drawn from ``generator`` (default: a new generator on
    ``device`` seeded with 0), in ``dtype`` (default ``cfg.param_dtype``).
    ``device=None`` means CUDA and raises without a Hopper card;
    ``device="meta"`` draws nothing and allocates nothing (shapes only, the
    dry run's: ``launch/dryrun.py``).
    ``quantize="int8"`` or ``"int4"`` draws the same float parameters and
    quantises each as it is drawn (``params.init_params(..., quantize=)``,
    bitwise ``params.quantize_params`` of the float tree), so that only the
    quantised tree and one leaf's draw are ever held: every matmul weight
    then goes through ``quant_matmul``.

    ``tp`` pads the head counts to the tensor-parallel size, as the
    reference's ``BackbonePolicy(cfg, tp)`` does. ``mesh`` (a
    ``launch.mesh.Mesh`` of the process group, or a ``distributed.plan.
    Plan``) lays the policy out on it: this rank holds its block of every
    leaf (``pspecs(self.rules())``), drawn leaf by leaf from the same
    stream as the whole tree (quantised whole, then cut), and ``tp`` is
    the mesh's ``model`` size. On a mesh it trains (``seq``,
    ``rl.learner.make_lm_train_step``) and serves: ``prefill`` and
    ``decode`` take this rank's rows of the batch (all of it under
    ``context_parallel``) and return its vocab block of the logits
    (``rl/actor.py`` gathers and samples them); ``init_caches`` gives its
    part of the caches, ``shard_caches`` its part of global ones. int4 on
    a mesh replicates the ``embed`` dims over the data axes, as the
    reference's dry run does (``repro/launch/dryrun.py:143-147``): the
    weights are then gathered over no axis but ``model``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: torch.Generator = None, dtype=None,
                 quantize: Optional[str] = None, tp: Optional[int] = None,
                 mesh=None):
        super().__init__()
        if quantize not in (None, *QMAX):
            raise ValueError(f"quantize must be None or one of {tuple(QMAX)}"
                             f", got {quantize!r}")
        self.plan = None
        if mesh is not None:
            from repro_torch.distributed import plan as _plan
            self.plan = mesh if isinstance(mesh, _plan.Plan) else \
                _plan.Plan(mesh)
            if quantize == "int4":
                self.plan = self.plan.with_embed(())
            if tp is not None and tp != self.plan.tp:
                raise ValueError(f"tp {tp} is not the mesh's model size "
                                 f"{self.plan.tp}")
            tp = self.plan.tp
        # "meta": shapes only, nothing drawn (the dry run's,
        # launch/dryrun.py); else a device the entry points take
        dev = torch.device("meta") if str(device) == "meta" else \
            _device.resolve(device)
        self.cfg, self.quantize, self.tp = cfg, quantize, tp or 1
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        pspecs = None
        if self.plan is not None:
            pspecs = self.pspecs(self.rules())
        tree = init_params(self._float_spec(), generator,
                           dtype_of(dtype or cfg.param_dtype), dev,
                           quantize=quantize, pspecs=pspecs, plan=self.plan)
        self.backbone = Params(tree["backbone"])
        for k in ("value", "value_scale"):
            if k in tree:
                setattr(self, k, nn.Parameter(tree[k], requires_grad=False))

    def _float_spec(self):
        return policy_spec(self.cfg, self.tp)

    def spec(self):
        return policy_spec(self.cfg, self.tp, self.quantize)

    def pspecs(self, rules=None):
        """The ``PartitionSpec`` of every leaf under ``rules`` (default
        ``params.DEFAULT_RULES``)."""
        return param_pspecs(self.spec(), rules)

    def rules(self) -> dict:
        """The mesh's rules table (``sharding.make_rules``), ``embed``
        replicated for int4 (``repro/launch/dryrun.py:143-147``)."""
        from repro_torch.distributed import sharding as shd
        rules = shd.make_rules(self.plan.mesh)
        return dict(rules, embed=None) if self.quantize == "int4" else rules

    def cache_pspecs(self, context_parallel: bool = False):
        from repro_torch.distributed import sharding as shd
        return shd.cache_pspecs(self.cfg, self.rules(), context_parallel)

    def _own(self) -> dict:
        """The policy's own parameters as the tree ``seq`` and ``_value``
        read (the backbone as its module, which reads like a dict)."""
        own = {"backbone": self.backbone}
        for k in ("value", "value_scale"):
            if hasattr(self, k):
                own[k] = getattr(self, k)
        return own

    def params(self) -> dict:
        """The parameters as a plain nested dict of detached tensors (the
        policy's own storage): the tree the learner trains
        (``rl.learner.init_train_state``)."""
        def plain(node):
            if isinstance(node, Params):
                return {k: plain(v) for k, v in
                        [*node._parameters.items(), *node._modules.items()]}
            return node.detach()
        return {k: plain(v) for k, v in self._own().items()}

    def bind(self, params: dict) -> None:
        """Make the tensors of the tree ``params`` (as ``params()`` gives it,
        say a training step's output) the policy's own, without a copy: it
        then serves them, and the tensors it held before are freed once
        nothing else holds them."""
        def walk(node, tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(node[k], v)
                else:
                    node[k].data = v
        walk(self._own(), params)

    def _value(self, params, hidden):
        """The critic on ``hidden`` with the head of the tree ``params``."""
        if not self.cfg.value_head:
            return torch.zeros(hidden.shape[:-1], device=hidden.device)
        # A quantised head is read as its raw integers without value_scale,
        # as the reference reads it (repro/models/policy.py:220-221).
        w, scale = params["value"], params.get("value_scale")
        if scale is None:
            w = use_weight(w, ("embed", "null"))
        else:
            w, _ = use_quantized(w, None, ("embed", "null"))
        w = stored(w, scale)
        # dot in hidden.dtype, upcast after
        return (hidden @ w.to(hidden.dtype))[..., 0].float()

    def seq(self, params, tokens=None, prefix=None):
        """Full-sequence forward, the training path. ``seq(params, tokens)``
        reads the tree ``params`` (``params()``, or one being trained);
        ``seq(tokens)`` the policy's own parameters. tokens: (B, Tt);
        prefix: (B, P, d) frontend embeddings or None; T = P + Tt. Returns
        (logits (B,T,V), values (B,T), aux)."""
        if tokens is None:
            params, tokens = self._own(), params
        with _plan_scope(self.plan):
            hidden, aux = tr.forward(params["backbone"], tokens, self.cfg,
                                     prefix=prefix)
            logits = tr.logits_from_hidden(params["backbone"], hidden,
                                           self.cfg)
            return logits, self._value(params, hidden), aux

    @torch.no_grad()
    def prefill(self, tokens, max_len: int, prefix=None):
        """tokens: (B, Tt); prefix: (B, P, d) or None. Returns (last-token
        logits (B,V), value (B,), caches of P + Tt positions). On a mesh B
        is this rank's rows and V its vocab block."""
        with _plan_scope(self.plan):
            hidden, caches = tr.prefill(self.backbone, tokens, self.cfg,
                                        max_len=max_len, prefix=prefix,
                                        tp=self.tp)
            last = hidden[:, -1:]
            logits = tr.logits_from_hidden(self.backbone, last, self.cfg)
            return logits[:, 0], self._value(self._own(), last)[:, 0], \
                caches

    @torch.no_grad()
    def decode(self, tokens, caches, context_parallel: bool = False):
        """tokens: (B, 1) — one serve step against ``caches`` (KV caches and
        SSM states updated in place). Returns (logits (B,V), value (B,),
        caches). ``context_parallel`` (long_500k, on a mesh): the KV caches
        hold this rank's slice of the sequence."""
        with _plan_scope(self.plan):
            hidden, caches = tr.decode(self.backbone, tokens, self.cfg,
                                       caches,
                                       context_parallel=context_parallel)
            logits = tr.logits_from_hidden(self.backbone, hidden, self.cfg)
            return logits[:, 0], self._value(self._own(), hidden)[:, 0], \
                caches

    def init_caches(self, batch: int, max_len: int,
                    context_parallel: bool = False):
        """Zero caches for ``batch`` sequences of ``max_len`` positions: on
        a mesh this rank's part (``cache_pspecs``: its B/D rows, or under
        ``context_parallel`` its S/D positions, and its heads)."""
        dev = self.backbone["final_norm"].device
        if self.plan is None:
            return tr.init_caches(self.cfg, batch, max_len, device=dev,
                                  tp=self.tp)
        b, s = self._local_extent(batch, max_len, context_parallel)
        return tr.init_caches(self.cfg, b, s, device=dev, tp=self.tp,
                              split=self.plan.tp)

    def _local_extent(self, batch: int, max_len: int, cp: bool):
        """(rows, positions) of this rank's caches; raises where the data
        size does not divide them."""
        D = self.plan.dp
        n = max_len if cp else batch
        if n % D:
            raise ValueError(f"{'max_len' if cp else 'batch'} {n} is not "
                             f"divisible by the mesh's data size {D}")
        return (batch, max_len // D) if cp else (batch // D, max_len)

    def shard_caches(self, caches, context_parallel: bool = False):
        """This rank's blocks of the global ``caches`` (KV heads padded to
        ``tp``), laid out by ``cache_pspecs``. No mesh: ``caches``."""
        if self.plan is None:
            return caches
        from repro_torch.distributed.plan import shard
        ps = self.cache_pspecs(context_parallel)
        kv = [None if c is None else attn_cache(
            shard(c.k, p.k, self.plan), shard(c.v, p.v, self.plan), c.length)
            for c, p in zip(caches.kv, ps.kv)]
        ssm = [None if c is None else type(c)(
            shard(c.conv, p.conv, self.plan),
            shard(c.state, p.state, self.plan))
            for c, p in zip(caches.ssm, ps.ssm)]
        return tr.Caches(kv, ssm, caches.length)

    def rows(self, x, context_parallel: bool = False):
        """This rank's rows of a global batch ``x`` (B, ...): its data
        rank's B/D, all of them under ``context_parallel`` or with no
        mesh."""
        if self.plan is None or context_parallel:
            return x
        b, _ = self._local_extent(x.shape[0], 1, False)
        return x[self.plan.dp_index * b:(self.plan.dp_index + 1) * b]
