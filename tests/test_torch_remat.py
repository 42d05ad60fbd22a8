"""``remat="dots"``: the layers under ``torch.utils.checkpoint`` with a
selective policy that saves the matrix products' outputs.

* every gradient leaf of a scalar of ``BackbonePolicy.seq`` (the mean
  log-sum-exp of the logits, the mean squared value, the MoE aux loss)
  against ``jax.grad`` of the reference with ``cfg.remat="dots"`` from the
  same params and tokens, within 1e-5 (qwen3: attention; jamba: SSM,
  attention and MoE; smoke size, 2 layers, f32);
* the same gradients under the port's ``"none"`` and ``"full"`` within
  1e-6;
* a ``TorchDispatchMode`` counting ``transformer.DOTS`` in the backward:
  against ``"none"``, ``"dots"`` runs no product again and ``"full"`` every
  product of the layers' forwards (counted with the checkpoint's early
  stop off, with which ``"full"`` may skip a layer's last products, whose
  outputs nothing saves).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.policy import BackbonePolicy

torch.set_num_threads(2)
B, T = 2, 16


class _Dots(TorchDispatchMode):
    """Counts the matrix products dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in tr.DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _cfg(arch, remat):
    return jax_with_overrides(jax_smoke_config(arch), dtype="float32",
                              param_dtype="float32", num_layers=2,
                              remat=remat)


def _grads(pol, params, toks):
    """({name: gradient}, products in the forward, in the backward)."""
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    tree = {}
    for name, x in leaves.items():
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = x
    fwd, bwd = _Dots(), _Dots()
    with fwd:
        logits, v, aux = pol.seq(tree, torch.from_numpy(toks))
        loss = logits.logsumexp(-1).mean() + v.square().mean() + \
            aux["moe_aux"]
    with bwd:
        g = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, g)), fwd.n, bwd.n


@pytest.fixture(scope="module", params=["qwen3-0.6b", "jamba-v0.1-52b"])
def runs(request):
    arch = request.param
    jcfg = _cfg(arch, "dots")
    jpol = JaxPolicy(jcfg, tp=1, kernel="ref")
    jp = jpol.init(jax.random.PRNGKey(9))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, T))

    def jloss(p):
        logits, v, aux = jpol.seq(p, {"tokens": jnp.asarray(toks)})
        return jax.nn.logsumexp(logits, -1).mean() + jnp.square(v).mean() \
            + aux["moe_aux"]

    jg = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(
        jp)))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = ModelConfig(**dataclasses.asdict(_cfg(arch, remat)))
        pol = BackbonePolicy(cfg, device="cpu")
        out[remat] = _grads(pol, params, toks)
        with set_checkpoint_early_stop(False):
            out[remat, "no early stop"] = _grads(pol, params, toks)
    return arch, jg, out


def test_dots_gradients_match_jax_grad_of_the_reference(runs):
    arch, jg, out = runs
    got = out["dots"][0]
    assert got.keys() == jg.keys()
    for name, want in jg.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   atol=1e-5, rtol=0,
                                   err_msg=f"{arch} {name}")


@pytest.mark.parametrize("other", ["none", "full"])
def test_dots_gradients_match_none_and_full(runs, other):
    arch, _, out = runs
    for name, g in out["dots"][0].items():
        np.testing.assert_allclose(g.numpy(), out[other][0][name].numpy(),
                                   atol=1e-6, rtol=0,
                                   err_msg=f"{arch} {name} vs {other}")


def test_dots_recomputes_no_product_and_full_every_one(runs):
    arch, _, out = runs
    _, fwd, none = out["none", "no early stop"]
    # the products outside the layers: the unembed and the value head
    layer_products = fwd - 2
    assert out["dots"][1] == out["full"][1] == fwd
    assert out["dots"][2] - out["none"][2] == 0
    assert out["dots", "no early stop"][2] - none == 0
    assert out["full", "no early stop"][2] - none == layer_products
    # with the early stop on, "full" may skip a layer's last products
    assert 0 < out["full"][2] - out["none"][2] <= layer_products


def test_remat_takes_only_full_dots_and_none():
    cfg = ModelConfig(**dataclasses.asdict(_cfg("qwen3-0.6b", "all")))
    pol = BackbonePolicy(cfg, device="cpu")
    with pytest.raises(ValueError, match="remat='all'"):
        with torch.enable_grad():
            pol.seq(torch.zeros((1, 4), dtype=torch.int32))
