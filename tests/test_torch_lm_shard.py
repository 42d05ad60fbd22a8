"""The LM FSDP/TP plan against the JAX package and against itself.

* the specs: ``make_pspec`` (the cases of ``tests/test_sharding.py``), the
  rules tables, ``padded_heads``/``padded_kv_heads``, and for every arch's
  smoke config at tp 1, 2 and 4 on a ``(data, model)`` and a ``(pod, data,
  model)`` mesh ``param_pspecs``, ``train_state_pspecs``,
  ``lm_batch_pspecs`` and ``cache_pspecs``, equal to the reference's as
  tuples (a port leaf of layer i against the reference's stacked leaf of
  ``l{i % period}`` without its ``periods`` entry). The reference's
  ``make_rules`` reads only ``mesh.axis_names``, so a stub mesh serves;
* one spawned group of 4 gloo ranks on a 2 x 2 mesh (``RANKS``, one
  subprocess; the JAX values are computed in this process and handed over
  as ``.npz``, so the ranks import torch only): one f32 train step of
  qwen3, llama4-maverick (MoE) and jamba (SSM + MoE), smoke size, 2
  layers, against the reference's one-device step with
  ``BackbonePolicy(cfg, tp=2)`` from the same params and batch — loss,
  grad_norm and the metrics within 1e-5 relative, the gathered params
  within 1e-5 and the moments within 1e-4 of their leaf's largest (the
  one-device tests' scale: a moment's smallest entries are sums of
  gradient parts that cancel, and the ranks add them in another order);
  the
  collectives a step as ``design_collectives`` states them; a sharded
  checkpoint restored here at 1 x 1 bit for bit equal to the gathered
  state; a whole-array checkpoint restored onto 2 x 2 bit for bit; a
  2 x 2 checkpoint restored onto 1 x 4 (mamba2, whose shapes do not depend
  on tp); a run stopped after step 1 and resumed bit for bit equal to an
  uninterrupted 2-step run;
* one rank with ``tp`` 4 (padded heads, all local): ``seq``, ``prefill``
  and one ``decode`` step against the reference's at tp 4, within 1e-5;
* the plan at world size 1 (gloo, this process) bit for bit the unsharded
  step through the launcher, quantised serving at 1 x 1 bit for bit the
  unsharded, and the errors: a gradient through quantised weights on a
  mesh, a batch the data size does not divide, a mesh of the wrong size.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.distributed import sharding as jshd
from repro.models import params as jprm
from repro.models import transformer as jtr
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro.rl import learner as jlearner
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.models import params as tprm
from repro_torch.models import transformer as tr
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.policy import BackbonePolicy
from repro_torch.optim.adamw import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
B, T, CHUNK = 4, 16, 8
GROUP_ARCHS = ("qwen3-0.6b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b")
TK = dict(warmup_steps=0, adam_eps=1e-6)
STEP_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
             "clipfrac", "moe_aux", "grad_norm", "lr")
torch.set_num_threads(2)


def _f32(arch):
    return jax_with_overrides(jax_smoke_config(arch), dtype="float32",
                              param_dtype="float32", num_layers=2)


def _port(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# -- specs ----------------------------------------------------------------------

def test_make_pspec_cases_and_rules_match_the_reference():
    assert tprm.DEFAULT_RULES == jprm.DEFAULT_RULES
    assert tprm.USE_RULES == jprm.USE_RULES
    multi = dict(tprm.DEFAULT_RULES, embed=("pod", "data"))
    cases = [(("embed", "mlp"), tprm.DEFAULT_RULES),
             (("vocab", "embed"), tprm.DEFAULT_RULES),
             (("periods", "embed", "heads", "null"), tprm.DEFAULT_RULES),
             (("expert", "embed", "mlp"), tprm.DEFAULT_RULES),
             (("embed", "mlp"), multi),
             (("batch", "embed"), dict(multi, batch=("pod", "data")))]
    for axes, rules in cases:
        got = tprm.make_pspec(axes, rules)
        assert isinstance(got, tuple)
        assert tuple(got) == tuple(jprm.make_pspec(axes, rules)), axes
    with pytest.raises(ValueError):
        tprm.ParamSpec((2, 3), axes=("embed",))


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_heads_match_the_reference(arch):
    for get_t, get_j in ((get_config, None), (get_smoke_config,
                                               jax_smoke_config)):
        cfg = get_t(arch)
        jcfg = get_j(arch) if get_j else _jax_full(arch)
        for tp in (1, 2, 4):
            assert cfg.padded_heads(tp) == jcfg.padded_heads(tp)
            assert cfg.padded_kv_heads(tp) == jcfg.padded_kv_heads(tp)


def _jax_full(arch):
    from repro.configs import get_config as jget
    return jget(arch)


def _stub_mesh(axes):
    return types.SimpleNamespace(axis_names=axes,
                                 shape={a: 2 for a in axes})


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, tp):
    jcfg = jax_smoke_config(arch)
    cfg = _port(jcfg)
    pol = BackbonePolicy(cfg, device="cpu", tp=tp)
    jpol = JaxPolicy(jcfg, tp=tp)
    period = jtr.stack_period(jcfg)
    for axes in (("data", "model"), ("pod", "data", "model")):
        mesh = _stub_mesh(axes)
        rules, jrules = shd.make_rules(mesh), jshd.make_rules(mesh)
        assert rules == jrules
        # params, and the train state laid out like them
        got = shd.train_state_pspecs(pol, rules)
        want = jshd.train_state_pspecs(jpol, jrules)
        assert tuple(got.step) == tuple(want.step) == ()
        assert tuple(got.opt.step) == tuple(want.opt.step) == ()
        for g, w in ((got.params, want.params), (got.opt.m, want.opt.m),
                     (got.opt.v, want.opt.v)):
            g, w = _named(g), _named(w)
            assert {k for k in g if ".layers." not in k} == \
                {k for k in w if ".layers." not in k}
            for name, p in g.items():
                if ".layers." in name:
                    pre, i, rest = name.split(".layers.")[0], \
                        int(name.split(".layers.")[1].split(".")[0]), \
                        name.split(".layers.")[1].split(".", 1)[1]
                    ref = w[f"{pre}.layers.l{i % period}.{rest}"]
                    assert tuple(p) == tuple(ref)[1:], (name, p, ref)
                else:
                    assert tuple(p) == tuple(w[name]), name
        assert got.params == pol.pspecs(rules)
        # batches
        gb, wb = shd.lm_batch_pspecs(cfg, rules), jshd.lm_batch_pspecs(
            jcfg, jrules)
        assert gb.keys() == wb.keys()
        for k in gb:
            assert tuple(gb[k]) == tuple(wb[k]), k
        # caches, at decode and context-parallel
        for cp in (False, True):
            gc = shd.cache_pspecs(cfg, rules, context_parallel=cp)
            wc = jshd.cache_pspecs(jcfg, jrules, context_parallel=cp)
            assert tuple(gc.length) == tuple(wc.length) == ()
            for i in range(cfg.num_layers):
                j = f"l{i % period}"
                if gc.kv[i] is not None:
                    for f in ("k", "v", "length"):
                        assert tuple(getattr(gc.kv[i], f)) == tuple(
                            getattr(wc.kv[j], f))[1:], (i, f)
                    assert gc.ssm[i] is None
                else:
                    for f in ("conv", "state"):
                        assert tuple(getattr(gc.ssm[i], f)) == tuple(
                            getattr(wc.ssm[j], f))[1:], (i, f)
    # the abstract state and caches: the global shapes, nothing allocated
    ab = shd.abstract_train_state(pol, "float32")
    assert all(x.device.type == "meta" for x in tree_leaves(ab.params))
    gshapes = {k: tuple(v.shape) for k, v in _named(ab.params).items()}
    assert gshapes == {k: tuple(v.shape) for k, v in
                       _named(pol.params()).items()}
    caches = shd.abstract_caches(cfg, tp, 2, 8)
    for c in caches.kv:
        if c is not None:
            assert c.k.device.type == "meta"
            assert c.k.shape[2] == cfg.padded_kv_heads(tp)


# -- the 2 x 2 group ---------------------------------------------------------------

RANKS = r'''
import datetime, os, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def worker(rank, port, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.convert import gather_tree, nest, shard_tree
    from repro_torch.models.policy import BackbonePolicy
    from repro_torch.optim.adamw import tree_map
    from repro_torch.rl import learner
    import json
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    out = {}

    def load(arch):
        z = np.load(os.path.join(d, f"{arch}.npz"))
        cfg = ModelConfig(**json.loads(str(z["cfg"])))
        pol = BackbonePolicy(cfg, device="cpu", mesh=mesh)
        ps = pol.pspecs(shd.make_rules(mesh))
        params = shard_tree(nest({k[2:]: torch.from_numpy(z[k])
                                  for k in z.files if k.startswith("p:")}),
                            ps, pol.plan)
        batch = {k[2:]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("b:")}
        return cfg, pol, ps, params, batch

    tk = TrainConfig(warmup_steps=0, adam_eps=1e-6)
    for arch in sys.argv[2].split(","):
        cfg, pol, ps, params, batch = load(arch)
        st = learner.init_train_state(params)
        step = learner.make_lm_train_step(pol, tk, total_steps=50,
                                          loss_chunk=8)
        shd.reset_collectives()
        st1, m = step(st, batch)
        coll = dict(shd.COLLECTIVES)
        sh = shd.named(mesh, shd.train_state_pspecs(
            pol, shd.make_rules(mesh)))
        ckpt.save(os.path.join(d, f"ck-{arch}"), st1, step=1,
                  shardings=sh)
        g = {"params": gather_tree(st1.params, ps, pol.plan),
             "m": gather_tree(st1.opt.m, ps, pol.plan),
             "v": gather_tree(st1.opt.v, ps, pol.plan)}
        out[arch] = {"metrics": {k: float(v) for k, v in m.items()},
                     "coll": coll, "state": g}
        if arch == "qwen3-0.6b":
            # a whole-array checkpoint of the initial state onto 2 x 2
            back = ckpt.restore(os.path.join(d, "whole"), st, sh)
            same = all(torch.equal(a, b) for a, b in zip(
                shd.tree_leaves(back), shd.tree_leaves(st)))
            # stopped after step 1, resumed: equal to 2 steps in a row
            b2 = {k: v.flip(0) for k, v in batch.items()}
            st2, _ = step(st1, b2)
            res = ckpt.restore(os.path.join(d, f"ck-{arch}"), st1, sh)
            st2r, _ = step(res, b2)
            resumed = all(torch.equal(a, b) for a, b in zip(
                shd.tree_leaves(st2r), shd.tree_leaves(st2)))
            flags = torch.tensor([float(same), float(resumed)])
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
            out["whole_onto_2x2"], out["resume"] = [bool(f) for f in flags]
    # a 2 x 2 checkpoint onto 1 x 4 (mamba2: no shape depends on tp)
    cfg, pol, ps, params, batch = load("mamba2-1.3b")
    st = learner.init_train_state(params)
    sh = shd.named(mesh, shd.train_state_pspecs(pol, shd.make_rules(mesh)))
    ckpt.save(os.path.join(d, "ck-mamba"), st, step=0, shardings=sh)
    glob = gather_tree(st.params, ps, pol.plan)
    mesh4 = tmesh.make_mesh((1, 4), ("data", "model"))
    pol4 = BackbonePolicy(cfg, device="cpu", mesh=mesh4)
    rules4 = shd.make_rules(mesh4)
    ps4 = pol4.pspecs(rules4)
    like = learner.init_train_state(pol4.params())
    got = ckpt.restore(os.path.join(d, "ck-mamba"), like, shd.named(
        mesh4, shd.train_state_pspecs(pol4, rules4)))
    want = shard_tree(glob, ps4, pol4.plan)
    same = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), got.params, want)
    ok = torch.tensor(float(all(same)))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    out["onto_1x4"] = bool(ok)
    if rank == 0:
        torch.save(out, os.path.join(d, "out.pt"))
    dist.destroy_process_group()

if __name__ == "__main__":
    s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, port, sys.argv[1]))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=200)
    for p in procs:
        if p.is_alive():
            p.kill()
    sys.exit(max(abs(p.exitcode or 0) for p in procs)
             if all(p.exitcode is not None for p in procs) else 1)
'''


def _np_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    return {
        "tokens": rng.integers(0, v, (B, T)).astype(np.int32),
        "actions": rng.integers(0, v, (B, T)).astype(np.int32),
        "old_logprob": (-np.abs(rng.standard_normal((B, T)) * 0.1) - 1.0)
        .astype(np.float32),
        "old_values": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
        "rewards": (rng.standard_normal((B, T)) * 0.1).astype(np.float32),
        "dones": rng.random((B, T)) < 0.2,
        "last_value": (rng.standard_normal(B) * 0.1).astype(np.float32),
    }


def _state_by_name(jstate):
    s = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    return {"params": _named(s.params), "m": _named(s.opt.m),
            "v": _named(s.opt.v)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Writes each arch's JAX params and batch, starts the 4 ranks, runs the
    reference's steps while they run, and returns (dir, rank 0's results,
    {arch: (JAX metrics, JAX state by name, initial port state)})."""
    import json
    d = tmp_path_factory.mktemp("lm_ranks")
    init = {}
    for arch in GROUP_ARCHS + ("mamba2-1.3b",):
        jcfg = _f32(arch)
        jpol = JaxPolicy(jcfg, tp=2, kernel="ref")
        jstate = jlearner.init_train_state(jpol.init(jax.random.PRNGKey(7)))
        nb = _np_batch(jcfg, 100)
        flat = {f"p:{k}": v.numpy() for k, v in
                params_from_jax(jax.tree.map(np.asarray,
                                             jstate.params)).items()}
        np.savez(d / f"{arch}.npz", cfg=json.dumps(dataclasses.asdict(jcfg)),
                 **flat, **{f"b:{k}": v for k, v in nb.items()})
        init[arch] = (jpol, jstate, nb)
    whole = train_state_from_jax(jax.tree.map(np.asarray,
                                              init["qwen3-0.6b"][1]))
    ckpt.save(str(d / "whole"), whole, step=0)
    (d / "ranks.py").write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(d / "ranks.py"), str(d),
                             ",".join(GROUP_ARCHS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    ref = {}
    try:
        for arch in GROUP_ARCHS:
            jpol, jstate, nb = init[arch]
            jstep = jax.jit(jlearner.make_lm_train_step(
                jpol, JaxTrainConfig(**TK), total_steps=50, gae_mode="ref",
                loss_chunk=CHUNK))
            js, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
            ref[arch] = ({k: float(v) for k, v in jm.items()},
                         _state_by_name(js))
    finally:
        out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-4000:]
    return d, torch.load(d / "out.pt", weights_only=False), ref


@pytest.mark.parametrize("arch", GROUP_ARCHS)
def test_2x2_step_matches_the_reference_at_tp2(group, arch):
    _, res, ref = group
    got, (jm, jstate) = res[arch], ref[arch]
    for k in STEP_KEYS:
        np.testing.assert_allclose(got["metrics"][k], jm[k], rtol=1e-5,
                                   atol=1e-7, err_msg=f"{arch} {k}")
    assert (got["metrics"]["moe_aux"] > 0) == (arch != "qwen3-0.6b")
    for which in ("params", "m", "v"):
        g = _named(got["state"][which])
        assert g.keys() == jstate[which].keys()
        for name, w in jstate[which].items():
            w = w.numpy()
            tol = 1e-5 if which == "params" else \
                1e-4 * max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(g[name].numpy(), w, atol=tol, rtol=0,
                                       err_msg=f"{arch} {which} {name}")


def design_collectives(cfg, tp: int, n_chunks: int) -> dict:
    """The collectives of one train step under remat "full", as the design
    issues them (``distributed/plan.py``, the layers' docstrings):

    all_gather: each FSDP weight use (every leaf whose axes hold
    ``embed``) and, at tp > 1, the model gathers (MLP ``wi``, SSM
    ``in_proj`` and ``conv_w``, the router), once in a layer's forward and
    once in its recomputation; the embedding, final norm and value head
    once; the unembed in each loss chunk's forward and recomputation; one
    for ``normalize_adv``. reduce_scatter: each gather whose backward sums
    (all but the router's model gather), once (the recomputation's
    backward). all_reduce: in a layer each ``enter`` once (backward), each
    ``leave`` in the forward and again in the recomputation, but the
    layer's last (its output is saved by nothing, so the recomputation
    stops before it), the gated norm's ``reduce`` twice forward and once
    backward, each ``data_mean`` twice; the embedding's ``leave`` once; a
    loss chunk's ``enter`` once and, at tp > 1, its four vocab reductions
    twice; the learner's one for the gradients and metrics over ``data``
    and one for the norm."""
    ag = rs = ar = 0
    for i in range(cfg.num_layers):
        mixer, ffn = tr.layer_kinds(cfg, i)
        fsdp = 1 + (4 if mixer == "attn" else 2)        # ln_mix + mixer
        model = 0 if mixer == "attn" else 2
        enter = 1 + (2 if mixer == "attn" and cfg.qk_norm else 0)
        leaves, reduces, means = 1, int(mixer == "ssm"), 0
        if ffn is not None:
            fsdp += 1 + (3 if ffn == "moe" else 2)      # ln_ffn + ffn
            model += 1
            enter += 2 if ffn == "moe" else 1
            leaves += 1
            means += 2 if ffn == "moe" else 0
        model = model if tp > 1 else 0
        slice_back = int(ffn == "moe" and tp > 1)       # the router's
        ag += 2 * (fsdp + model)
        rs += fsdp + model - slice_back
        ar += enter + 2 * leaves - 1 + 3 * reduces + 2 * means
    ag += 3 + 2 * n_chunks + 1
    rs += 3 + n_chunks
    ar += 1 + n_chunks * (1 + (8 if tp > 1 else 0)) + 2
    return {"all_reduce": ar, "all_gather": ag, "broadcast": 0,
            "reduce_scatter": rs}


@pytest.mark.parametrize("arch", GROUP_ARCHS)
def test_2x2_collectives_as_designed(group, arch):
    _, res, _ = group
    cfg = _port(_f32(arch))
    assert res[arch]["coll"] == design_collectives(cfg, 2, T // CHUNK)


@pytest.mark.parametrize("arch", GROUP_ARCHS)
def test_2x2_checkpoint_restores_at_1x1_bit_for_bit(group, arch):
    d, res, _ = group
    st = res[arch]["state"]
    like = train_state_like(st)
    got = ckpt.restore(str(d / f"ck-{arch}"), like)
    assert int(got.step) == 1 and int(got.opt.step) == 1
    for which, tree in (("params", got.params), ("m", got.opt.m),
                        ("v", got.opt.v)):
        want = _named(st[which])
        for name, x in _named(tree).items():
            assert torch.equal(x, want[name]), (arch, which, name)


def train_state_like(st):
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.rl.learner import TrainState
    z = torch.zeros((), dtype=torch.int32)
    return TrainState(st["params"], AdamWState(z, st["m"], st["v"]), z)


def test_whole_array_checkpoint_restores_onto_2x2(group):
    assert group[1]["whole_onto_2x2"]


def test_2x2_checkpoint_restores_onto_1x4(group):
    assert group[1]["onto_1x4"]


def test_stopped_and_resumed_equals_uninterrupted_bit_for_bit(group):
    assert group[1]["resume"]


# -- one rank, tp 4 ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b"])
def test_tp4_on_one_rank_matches_the_reference(arch):
    """Padded heads (the 2 KV heads become 4), every head local; jamba's
    smoke stack holds an SSM, an attention and an MoE layer."""
    jcfg = _f32(arch)
    jpol = JaxPolicy(jcfg, tp=4, kernel="ref")
    jp = jpol.init(jax.random.PRNGKey(5))
    pol = BackbonePolicy(_port(jcfg), device="cpu", tp=4)
    pol.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)),
                        strict=True)
    assert pol.backbone["layers"]["1"]["attn"]["wk"].shape[1] == \
        jcfg.padded_kv_heads(4)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 9))
    tol = dict(atol=1e-5, rtol=1e-5)
    jl, jv, _ = jpol.seq(jp, {"tokens": jnp.asarray(toks[:, :8])})
    tl, tv, _ = pol.seq(torch.from_numpy(toks[:, :8]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    jl, jv, jc = jpol.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, 9)
    tl, tv, tc = pol.prefill(torch.from_numpy(toks[:, :8]), 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    jl, jv, _ = jpol.decode(jp, jnp.asarray(toks[:, 8:]), jc)
    tl, tv, _ = pol.decode(torch.from_numpy(toks[:, 8:]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)


# -- world size 1, and the errors ------------------------------------------------------

def test_mesh_1x1_launcher_run_is_the_unsharded_one_bit_for_bit(capsys):
    argv = ["--arch", "jamba-v0.1-52b", "--smoke", "--batch", "2", "--seq",
            "16", "--steps", "2", "--device", "cpu"]
    plain = launch_train.main(argv)
    sharded = launch_train.main(argv + ["--mesh", "1x1"])
    out = capsys.readouterr().out
    assert "world_size=1 mesh=1x1 dp=1 tp=1 collectives=" in out
    assert sharded.policy.plan is not None and plain.policy.plan is None
    for a, b in zip(tree_leaves(plain.state.params) +
                    tree_leaves(plain.state.opt.m),
                    tree_leaves(sharded.state.params) +
                    tree_leaves(sharded.state.opt.m)):
        assert torch.equal(a, b)
    assert all(float(plain.metrics[k]) == float(sharded.metrics[k])
               for k in plain.metrics)


@pytest.fixture
def mesh1():
    own = tmesh.init_process_group(torch.device("cpu"))
    yield tmesh.make_mesh((1, 1), ("data", "model"))
    if own:
        torch.distributed.destroy_process_group()


def test_the_plan_refuses_what_it_cannot_take(mesh1, capsys):
    """Quantised weights and serving on a mesh run (at 1 x 1 the unsharded
    policy's values bit for bit; many ranks: tests/test_torch_serve_shard.py);
    what the plan cannot take raises: a gradient through quantised weights
    on a mesh, a wrong tp, a batch or mesh that does not divide."""
    cfg = get_smoke_config("qwen3-0.6b")
    q = BackbonePolicy(cfg, device="cpu", quantize="int8", mesh=mesh1)
    one = BackbonePolicy(cfg, device="cpu", quantize="int8")
    toks = torch.arange(8, dtype=torch.int32).view(2, 4)
    got, want = q.prefill(toks, 8), one.prefill(toks, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    caches = q.init_caches(2, 8)
    assert caches.kv[0].k.shape == one.init_caches(2, 8).kv[0].k.shape
    tree = q.params()
    tree["backbone"]["layers"]["0"]["ln_mix"].requires_grad_()
    with pytest.raises(NotImplementedError, match="serve only"):
        q.seq(tree, toks.long())
    with pytest.raises(ValueError, match="tp 2"):
        BackbonePolicy(cfg, device="cpu", mesh=mesh1, tp=2)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh((2, 2), ("data", "model"))
    base = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--seq",
            "8", "--steps", "1"]
    with pytest.raises(SystemExit):          # 3 rows over 2 data ranks
        launch_train.main(base + ["--mesh", "2x1", "--batch", "3"])
    assert "not divisible by the mesh's data size 2" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit):          # 4 ranks asked of 1
        launch_train.main(base + ["--mesh", "2x2", "--batch", "2"])
    assert "needs 4 ranks" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        launch_train.main(base + ["--devices", "2"])
    assert "pass one" in capsys.readouterr().err


# -- the gloo reduce-scatter leaves its input as it was ----------------------------

REDUCE_SCATTER = r'''
import datetime, sys
import torch
import torch.distributed as dist

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.distributed import plan
ok = True
for dim in (0, 1):
    g = torch.arange(24, dtype=torch.float32).view(4, 6) * (rank + 1)
    if dim == 1:
        g = g.T.contiguous()
    before = g.clone()
    out = plan._reduce_scatter(g, dim, dist.group.WORLD)
    want = (torch.arange(24, dtype=torch.float32).view(4, 6) * 3)
    want = want.chunk(2)[rank] if dim == 0 else want.T.chunk(2, dim=1)[rank]
    ok &= torch.equal(g, before) and torch.equal(out, want.contiguous())
dist.destroy_process_group()
sys.exit(0 if ok else 3)
'''


def test_gloo_reduce_scatter_leaves_its_input_unchanged(tmp_path):
    """``plan._reduce_scatter`` on 2 gloo ranks, the gradient split along dim
    0 (where ``movedim(0, 0).contiguous()`` is the tensor itself) and dim 1:
    each rank's block of the sum, and the incoming tensor unchanged."""
    import socket
    script = tmp_path / "rs.py"
    script.write_text(REDUCE_SCATTER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs
