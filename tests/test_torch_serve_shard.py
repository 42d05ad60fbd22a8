"""Sharded serving on the LM plan against the JAX package and the port.

One spawned group of 4 gloo ranks (``RANKS``, one subprocess; the JAX
values are computed in this process and handed over as ``.npz``, so the
ranks import torch only) runs every case:

* on a 2 x 2 mesh (data 2, model 2), smoke qwen3, mamba2 and jamba (2
  layers, f32) in f32, int8 and int4: the JAX params (quantised by JAX's
  ``quantize_params``, every scale rounded to a power of two, where both
  packages compute the same products: ``tests/test_torch_quant.py``) cut
  into each rank's blocks by ``pspecs(policy.rules())``, a prefill of B 4
  and 3 teacher-forced decode steps; the gathered logits and values
  against the reference's ``prefill``/``decode`` at tp 2 within 1e-5
  (f32) and the stack tolerance (quantised); the tokens of ``generate``
  equal on every rank and equal to the one-device port's for the same
  generator; the conv_w caveat pinned: doubling the quantised
  ``conv_w_scale`` changes no bit (the reference reads the raw integers);
* on a 4 x 1 mesh (data 4), the context-parallel decode: qwen3 and jamba,
  B 1, a cache of S 64 (16 positions a rank), then 3 decode steps from
  lengths 15 (a rank boundary), 30 (crossing one) and 61 (the last step
  fills the cache); every step has
  ranks whose slice is empty but at 63. The logits and values against the
  reference's ``decode(context_parallel=True)`` within 1e-5, and the
  merge's collectives counted (two all-reduces an attention layer). The
  caches are drawn from the seed (the filled prefix; zeros past it). Then
  the same in bf16 (activations and caches; f32 params) from lengths 30
  and 61: the logits and values against the one-device port's bf16
  decode of the same caches within ``CP_BF16_TOL`` (the ranks merge in
  f32 and round once, as one device does: they measured equal), and
  against the reference's bf16 decode within the bf16 gate, 2e-2: the
  values elementwise, the logits as each step's relative L2 error (the
  two packages' bf16 products round differently, and single logits move
  by a few bf16 units: up to 0.039 apart, 1.04e-2 in relative L2).

The reference's programs run under ``jax.jit``, one compile a case.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import with_overrides as jax_with_overrides
from repro.models.params import quantize_params as jquantize_params
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import actor

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "mamba2-1.3b", "jamba-v0.1-52b")
CP_ARCHS = ("qwen3-0.6b", "jamba-v0.1-52b")
QUANT = (None, "int8", "int4")
B, TP, STEPS, S = 4, 9, 3, 16
CP_S, CP_STARTS = 64, (15, 30, 61)
CP_BF16_STARTS = (30, 61)
TOL = dict(atol=1e-5, rtol=1e-5)
CP_BF16_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_GATE = 2e-2        # the kernels' bf16 gate
STACK_TOL = dict(atol=3e-4, rtol=1e-3)       # tests/test_torch_quant.py
GEN_SEED, GEN_NEW = 11, 4
torch.set_num_threads(2)


def _f32(arch, dtype="float32"):
    """Smoke ``arch`` at 2 layers, f32 params, ``dtype`` activations."""
    return jax_with_overrides(jax_smoke_config(arch), dtype=dtype,
                              param_dtype="float32", num_layers=2)


def _pow2(tree):
    return {k: _pow2(v) if isinstance(v, dict) else
            (jnp.asarray(2.0 ** np.round(np.log2(np.asarray(v))),
                         jnp.float32) if k.endswith("_scale") else v)
            for k, v in tree.items()}


_FLOAT: dict = {}


def _params(arch, q, seed=5, dtype="float32"):
    """(JAX policy, JAX params) at tp 2; quantised with pow2 scales."""
    jcfg = _f32(arch, dtype)
    fpol = JaxPolicy(jcfg, tp=2, kernel="ref")
    if (arch, seed) not in _FLOAT:
        _FLOAT[arch, seed] = jax.jit(fpol.init)(jax.random.PRNGKey(seed))
    jp = _FLOAT[arch, seed]
    if q is None:
        return fpol, jp
    jq = jax.jit(lambda p: jquantize_params(
        p, fpol.spec(), jnp.int4 if q == "int4" else jnp.int8))(jp)
    return JaxPolicy(jcfg, tp=2, kernel="ref", quantize=q), _pow2(jq)


def _random_caches(jpol, rng, length):
    """The reference's caches for B 1 and ``CP_S`` positions, drawn from
    ``rng``, ``length`` of them filled (KV past it zero, as a prefill
    leaves them), each in its cache's dtype."""
    jc = jpol.init_caches(1, CP_S)

    def draw(x, keep=None):
        a = rng.standard_normal(x.shape).astype(np.float32)
        if keep is not None:
            a[..., keep:, :, :] = 0.0       # (periods, B, S, K, hd)
        return jnp.asarray(a).astype(x.dtype)

    kv = {k: c._replace(k=draw(c.k, length), v=draw(c.v, length))
          for k, c in jc.kv.items()}
    ssm = {k: c._replace(conv=draw(c.conv), state=draw(c.state) * 0.1)
           for k, c in jc.ssm.items()}
    return jc._replace(kv=kv, ssm=ssm,
                       length=jnp.asarray(length, jnp.int32))


def _flat_caches(jc, cfg):
    """The reference's stacked caches as the port's per-layer arrays, in
    f32 (bf16 values exactly; the ranks' ``caches`` casts them back)."""
    period = len(jc.kv) + len(jc.ssm)
    out = {}

    def f32(x):
        return np.asarray(x.astype(jnp.float32))

    for i in range(cfg.num_layers):
        key, p = f"l{i % period}", i // period
        if cfg.is_attn_layer(i):
            out[f"c:{i}:k"] = f32(jc.kv[key].k[p])
            out[f"c:{i}:v"] = f32(jc.kv[key].v[p])
        else:
            out[f"c:{i}:conv"] = f32(jc.ssm[key].conv[p])
            out[f"c:{i}:state"] = f32(jc.ssm[key].state[p])
    out["c:length"] = np.asarray(jc.length)
    return out


RANKS = r'''
import datetime, json, os, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def worker(rank, port, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import plan as P
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tr
    from repro_torch.models.convert import nest, shard_tree
    from repro_torch.models.policy import BackbonePolicy
    from repro_torch.rl import actor
    cases = json.loads(open(os.path.join(d, "cases.json")).read())
    out = {}

    def policy(name, mesh, q):
        z = np.load(os.path.join(d, f"{name}.npz"))
        cfg = ModelConfig(**json.loads(str(z["cfg"])))
        pol = BackbonePolicy(cfg, device="cpu", mesh=mesh, quantize=q)
        tree = nest({k[2:]: torch.from_numpy(z[k]) for k in z.files
                     if k.startswith("p:")})
        pol.bind(shard_tree(tree, pol.pspecs(pol.rules()), pol.plan))
        pol.tree = tree
        return cfg, pol, z

    def whole(pol, logits, value, cp=False):
        with P.scope(pol.plan):
            lg = P.gather_nograd(logits, -1, "model")
            if not cp:
                lg = P.gather_nograd(lg, 0, "data")
                value = P.gather_nograd(value, 0, "data")
        return lg.float().numpy(), value.float().numpy()

    def global_caches(z, cfg):
        """The global caches of ``z``: K/V and the conv window in the
        config's dtype, the state in f32."""
        dt = getattr(torch, cfg.dtype)

        def get(key, dtype=dt):
            return torch.from_numpy(z[key]).to(dtype)

        return tr.Caches(
            [attn.KVCache(get(f"c:{i}:k"), get(f"c:{i}:v"), None)
             if f"c:{i}:k" in z.files else None
             for i in range(cfg.num_layers)],
            [ssm_mod.SSMCache(get(f"c:{i}:conv"),
                              get(f"c:{i}:state", torch.float32))
             if f"c:{i}:conv" in z.files else None
             for i in range(cfg.num_layers)],
            torch.from_numpy(z["c:length"]))

    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    for name, arch, q in cases["mesh"]:
        cfg, pol, z = policy(name, mesh, q)
        toks = torch.from_numpy(z["tokens"])
        lg, v, caches = pol.prefill(pol.rows(toks[:, :z["tp"]]),
                                    int(z["s"]))
        res = [whole(pol, lg, v)]
        for t in range(int(z["tp"]), toks.shape[1]):
            lg, v, caches = pol.decode(pol.rows(toks[:, t:t + 1]), caches)
            res.append(whole(pol, lg, v))
        o = {"logits": [r[0] for r in res], "values": [r[1] for r in res]}
        if q and cfg.ssm_state:
            # the conv_w caveat: its scale is never read
            lg, v, _ = pol.prefill(pol.rows(toks[:, :z["tp"]]), int(z["s"]))
            for p in pol.backbone["layers"].modules():
                if "conv_w_scale" in p._parameters:
                    p.conv_w_scale.data.mul_(2.0)
            lg2, v2, _ = pol.prefill(pol.rows(toks[:, :z["tp"]]),
                                     int(z["s"]))
            o["conv_scale_unread"] = bool(torch.equal(lg, lg2)
                                          and torch.equal(v, v2))
        if q is None:
            gen = torch.Generator().manual_seed(int(z["gen_seed"]))
            o["tokens"] = actor.generate(pol, toks[:, :z["tp"]],
                                         int(z["gen_new"]), gen).numpy()
            every = [torch.empty_like(torch.from_numpy(o["tokens"]))
                     for _ in range(4)]
            dist.all_gather(every, torch.from_numpy(o["tokens"]))
            o["same_on_every_rank"] = all(torch.equal(e, every[0])
                                          for e in every)
        out[name] = o

    mesh = tmesh.make_mesh((4, 1), ("data", "model"))
    for name, arch, start in cases["cp"]:
        cfg, pol, z = policy(name, mesh, None)
        caches = pol.shard_caches(global_caches(z, cfg),
                                  context_parallel=True)
        toks = torch.from_numpy(z["tokens"])
        res = []
        shd.reset_collectives()
        for t in range(toks.shape[1]):
            lg, v, caches = pol.decode(toks[:, t:t + 1], caches,
                                       context_parallel=True)
            res.append(whole(pol, lg, v, cp=True))
        out[name] = {"logits": [r[0] for r in res],
                     "values": [r[1] for r in res],
                     "coll": dict(shd.COLLECTIVES),
                     "local_k": tuple(next(
                         c for c in caches.kv if c is not None).k.shape)}
        if cfg.dtype != "float32" and rank == 0:
            # the one-device port's decode of the same caches
            one = BackbonePolicy(cfg, device="cpu")
            one.bind(pol.tree)
            caches, res = global_caches(z, cfg), []
            for t in range(toks.shape[1]):
                lg, v, caches = one.decode(toks[:, t:t + 1], caches)
                res.append((lg.float().numpy(), v.float().numpy()))
            out[name]["one_device"] = res
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


def _name(arch, q):
    return f"{arch}-{q or 'f32'}"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Writes each case's params and inputs, starts the 4 ranks, computes
    the reference's values while they run; returns (rank 0's results,
    {case: reference values}, {case: one-device port tokens})."""
    d = tmp_path_factory.mktemp("serve_ranks")
    cases = {"mesh": [], "cp": []}
    todo = {}
    rng = np.random.default_rng(3)
    for arch in ARCHS:
        for q in QUANT:
            jpol, jp = _params(arch, q)
            toks = rng.integers(0, jpol.cfg.vocab_size, (B, TP + STEPS))
            flat = {f"p:{k}": v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, jp)).items()}
            name = _name(arch, q)
            np.savez(d / f"{name}.npz",
                     cfg=json.dumps(dataclasses.asdict(jpol.cfg)), tokens=toks,
                     tp=TP, s=S, gen_seed=GEN_SEED, gen_new=GEN_NEW, **flat)
            cases["mesh"].append((name, arch, q))
            todo[name] = ("mesh", jpol, jp, toks, None)
    for arch, dtype, starts in [(a, "float32", CP_STARTS) for a in CP_ARCHS] \
            + [(a, "bfloat16", CP_BF16_STARTS) for a in CP_ARCHS]:
        jpol, jp = _params(arch, None, seed=9, dtype=dtype)
        for start in starts:
            toks = rng.integers(0, jpol.cfg.vocab_size, (1, start + STEPS))
            jc = _random_caches(jpol, rng, start)
            flat = {f"p:{k}": v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, jp)).items()}
            name = f"cp-{arch}-{start}" + ("" if dtype == "float32"
                                           else "-bf16")
            np.savez(d / f"{name}.npz",
                     cfg=json.dumps(dataclasses.asdict(jpol.cfg)),
                     tokens=toks[:, start:], **flat,
                     **_flat_caches(jc, jpol.cfg))
            cases["cp"].append((name, arch, start))
            todo[name] = ("cp", jpol, jp, toks[:, start:], jc)
    (d / "cases.json").write_text(json.dumps(cases))
    (d / "ranks.py").write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(d / "ranks.py"), str(d)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ref, tokens, decoders = {}, {}, {}
    try:
        for name, (kind, jpol, jp, toks, jc) in todo.items():
            res = []
            if kind == "mesh":
                lg, v, jc = jax.jit(lambda p, t: jpol.prefill(
                    p, {"tokens": t}, S))(jp, jnp.asarray(toks[:, :TP]))
                res.append((np.asarray(lg), np.asarray(v)))
                steps = range(TP, toks.shape[1])
            else:
                steps = range(toks.shape[1])
            key = (kind, name if kind == "mesh" else
                   (jpol.cfg.name, jpol.cfg.dtype))
            if key not in decoders:
                decoders[key] = jax.jit(
                    lambda p, t, c, pol=jpol, cp=kind == "cp": pol.decode(
                        p, t, c, context_parallel=cp))
            for t in steps:
                lg, v, jc = decoders[key](jp, jnp.asarray(toks[:, t:t + 1]),
                                          jc)
                res.append((np.asarray(lg), np.asarray(v)))
            ref[name] = res
            if kind == "mesh" and name.endswith("-f32"):
                pol = BackbonePolicy(ModelConfig(**dataclasses.asdict(
                    jpol.cfg)), device="cpu", tp=2)
                pol.load_state_dict(params_from_jax(
                    jax.tree.map(np.asarray, jp)), strict=True)
                gen = torch.Generator().manual_seed(GEN_SEED)
                tokens[name] = actor.generate(
                    pol, torch.from_numpy(toks[:, :TP]), GEN_NEW, gen).numpy()
    finally:
        out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-4000:]
    return torch.load(d / "out.pt", weights_only=False), ref, tokens


@pytest.mark.parametrize("q", QUANT, ids=lambda q: q or "f32")
@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_prefill_and_decode_match_the_reference(group, arch, q):
    got, ref, _ = group
    name = _name(arch, q)
    tol = TOL if q is None else STACK_TOL
    res = got[name]
    assert len(res["logits"]) == len(ref[name]) == 1 + STEPS
    for step, (lg, v) in enumerate(ref[name]):
        np.testing.assert_allclose(res["logits"][step], lg, **tol,
                                   err_msg=f"{name} step {step}")
        np.testing.assert_allclose(res["values"][step], v, **tol,
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_tokens_match_the_one_device_port(group, arch):
    got, _, tokens = group
    name = _name(arch, None)
    assert got[name]["same_on_every_rank"]
    assert got[name]["tokens"].shape == (B, GEN_NEW)
    np.testing.assert_array_equal(got[name]["tokens"], tokens[name])


@pytest.mark.parametrize("q", ["int8", "int4"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_quantised_conv_w_is_read_without_its_scale_on_a_mesh(group, arch,
                                                              q):
    assert group[0][_name(arch, q)]["conv_scale_unread"]


@pytest.mark.parametrize("start", CP_STARTS)
@pytest.mark.parametrize("arch", CP_ARCHS)
def test_context_parallel_decode_matches_the_reference(group, arch, start):
    got, ref, _ = group
    name = f"cp-{arch}-{start}"
    res = got[name]
    assert res["local_k"][:2] == (1, CP_S // 4)
    for step, (lg, v) in enumerate(ref[name]):
        np.testing.assert_allclose(res["logits"][step], lg, **TOL,
                                   err_msg=f"{name} step {step}")
        np.testing.assert_allclose(res["values"][step], v, **TOL,
                                   err_msg=f"{name} step {step}")
    # each attention layer's merge: one all-reduce of the max, one of the
    # rescaled sums, a step
    cfg = _f32(arch)
    attn_layers = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    assert res["coll"]["all_reduce"] >= 2 * attn_layers * STEPS


@pytest.mark.parametrize("start", CP_BF16_STARTS)
@pytest.mark.parametrize("arch", CP_ARCHS)
def test_context_parallel_decode_in_bf16(group, arch, start):
    """bf16 caches over 4 ranks: each rank's attention stays f32 until the
    merge, so the ranks' logits and values are the one-device port's
    within ``CP_BF16_TOL``, and the reference's within ``BF16_GATE``."""
    got, ref, _ = group
    name = f"cp-{arch}-{start}-bf16"
    res = got[name]
    assert len(res["logits"]) == len(res["one_device"]) == len(ref[name])
    for step, ((lg1, v1), (lg, v)) in enumerate(zip(res["one_device"],
                                                    ref[name])):
        np.testing.assert_allclose(res["logits"][step], lg1, **CP_BF16_TOL,
                                   err_msg=f"{name} step {step}")
        np.testing.assert_allclose(res["values"][step], v1, **CP_BF16_TOL,
                                   err_msg=f"{name} step {step}")
        lg = np.asarray(lg, np.float32)
        rel = np.linalg.norm(res["logits"][step] - lg) / np.linalg.norm(lg)
        assert rel <= BF16_GATE, f"{name} step {step} logits: {rel}"
        np.testing.assert_allclose(res["values"][step],
                                   np.asarray(v, np.float32),
                                   atol=BF16_GATE, rtol=BF16_GATE,
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_int4_split_on_half_bytes_raises_naming_the_leaf_and_mesh(device):
    """A packed int4 leaf whose last dim the mesh splits into odd parts
    would share a byte between ranks: the init raises (rank 0's view of a
    1x16 mesh; smoke mamba2's in_proj of 560 columns gives parts of
    35)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.plan import Plan
    from repro_torch.launch.mesh import Mesh
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), num_layers=1)
    plan = Plan.virtual(Mesh(("data", "model"), (1, 16)))
    with pytest.raises(ValueError, match=r"in_proj .*'model': 16"):
        BackbonePolicy(cfg, device=device, quantize="int4", mesh=plan)
    # int8 takes any split
    BackbonePolicy(cfg, device="meta", quantize="int8", mesh=plan)
