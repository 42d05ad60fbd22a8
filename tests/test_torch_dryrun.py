"""The port's dry run (``launch/dryrun.py``) and op counter
(``launch/op_analysis.py``) against the JAX package's.

* ``model_flops`` equal to the reference's for all 10 archs x 4 shapes;
* ``input_specs`` shapes and dtypes equal to the reference's (the caches
  a layer each against the reference's stacked ones), and the same cells
  skipped;
* each rank's argument bytes equal the sum over the reference's own
  pspec trees (``repro.distributed.sharding.make_rules`` on a stub mesh,
  ``param_pspecs``, ``train_state_pspecs``, ``lm_batch_pspecs``,
  ``cache_pspecs`` and its abstract shapes), by pure-Python arithmetic,
  no jit: every arch x shape on 16 x 16 and 2 x 16 x 16, quantised
  (int8, int4) and not. The one rule of the port's own: int4 is stored
  two to a byte along the last dim, rounded up (the value head's (d, 1)
  takes d bytes where XLA's s4 takes d / 2);
* on a virtual 2 x 2 plan at smoke size, the dry run's collectives (kind,
  count, result bytes) equal those a real 2 x 2 gloo run of the same cell
  records (one spawned group of 4 ranks runs the same ``build_program``
  on CPU tensors: a train step, a prefill and a decode of qwen3 and jamba),
  and the decode's and prefill's FLOPs equal ``op_analysis`` over rank 0's
  real run (a kernel call counted by its work formula on both: the meta
  path and ``dispatch.call``);
* ``op_analysis`` on 15 products of 128^3 counts 15 · 2 · 128^3 (the
  counterpart of ``test_hlo_analysis_known_costs``);
* ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
  decode_32k`` prints one line with the reference's keys.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeNotApplicable as JNotApplicable
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.models import transformer as jtr
from repro.models.policy import BackbonePolicy as JaxPolicy
from repro_torch.configs import ARCHS, SHAPES, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import plan as tplan
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import Mesh

jax.devices()               # JAX's backend before the reference's dry run
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ROOT = Path(__file__).resolve().parents[1]
REF_LINE_KEYS = ("arch", "shape", "mesh", "status", "bottleneck",
                 "t_compute_s", "t_memory_s", "t_collective_s",
                 "roofline_fraction", "compile_s")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def test_model_flops_match_the_reference():
    assert ARCHS == JARCHS and tuple(SHAPES) == tuple(JSHAPES)
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            want = jdryrun.model_flops(jget_config(arch), JSHAPES[name])
            assert dryrun.model_flops(dryrun.get_config(arch), shape) == \
                want, (arch, name)


def _port_caches_as_stacked(caches, cfg):
    """The port's per-layer caches grouped as the reference stacks them:
    {(kind, l{i % period}, field): ((periods, ...), dtype)}."""
    period = jtr.stack_period(cfg)
    seen, out = {}, {}
    for i in range(cfg.num_layers):
        key = f"l{i % period}"
        for kind, c in (("kv", caches.kv[i]), ("ssm", caches.ssm[i])):
            if c is None:
                continue
            for f in c._fields:
                t = getattr(c, f)
                if t is None or t.dim() == 0:
                    continue
                k = (kind, key, f)
                seen[k] = seen.get(k, 0) + 1
                out[k] = ((seen[k],) + tuple(t.shape),
                          str(t.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    for name in SHAPES:
        try:
            want = jdryrun.input_specs(arch, name, tp=16)
        except JNotApplicable:
            with pytest.raises(dryrun.ShapeNotApplicable):
                dryrun.input_specs(arch, name, tp=16)
            continue
        got = dryrun.input_specs(arch, name, tp=16)
        assert set(got) == set(want), name
        for k in got:
            if k == "caches":
                continue
            assert (tuple(got[k].shape), str(got[k].dtype)[6:]) == \
                (tuple(want[k].shape), str(want[k].dtype)), (name, k)
        if "caches" in got:
            jc = want["caches"]
            cfg = jget_config(arch)
            stacked = _port_caches_as_stacked(got["caches"], cfg)
            ref = {}
            for kind in ("kv", "ssm"):
                for key, c in getattr(jc, kind).items():
                    for f in c._fields:
                        t = getattr(c, f)
                        if len(t.shape) > 1:
                            ref[(kind, key, f)] = (tuple(t.shape),
                                                   str(t.dtype))
            assert stacked == ref, name


# -- argument bytes against the reference's pspec arithmetic -----------------

def _stub(axes, sizes):
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, sizes)))


def _local(shape, spec, sizes):
    out = []
    for n, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        if part is None:
            out.append(n)
            continue
        k = math.prod(sizes[a] for a in (part if isinstance(part, tuple)
                                         else (part,)))
        assert n % k == 0, (shape, spec)
        out.append(n // k)
    return out


def _tree_bytes(abstract, pspecs, sizes):
    total = 0
    for x, spec in zip(jax.tree.leaves(abstract),
                       jax.tree.leaves(pspecs, is_leaf=lambda p: isinstance(
                           p, jax.sharding.PartitionSpec))):
        loc = _local(x.shape, spec, sizes)
        if x.dtype == jnp.int4:             # two to a byte, rounded up
            total += math.prod(loc[:-1]) * -(-loc[-1] // 2)
        else:
            total += math.prod(loc) * x.dtype.itemsize
    return total


def _reference_bytes(arch, name, axes, sizes, quantize):
    cfg, shape = jget_config(arch), JSHAPES[name]
    mesh = _stub(axes, sizes)
    sz = dict(zip(axes, sizes))
    tp = sz["model"]
    rules = jshd.make_rules(mesh)
    q = quantize if (quantize != "off" and shape.kind != "train") else False
    if q == "int4":
        rules = dict(rules, embed=None)
    pol = JaxPolicy(cfg, tp=tp, quantize=q)
    P = jax.sharding.PartitionSpec
    if shape.kind == "train":
        state = jshd.abstract_train_state(pol, "bfloat16")
        batch = jdryrun.input_specs(arch, name, tp)
        return (_tree_bytes(state, jshd.train_state_pspecs(pol, rules), sz)
                + _tree_bytes(batch, jshd.lm_batch_pspecs(cfg, rules), sz))
    params = _tree_bytes(pol.abstract(), pol.pspecs(rules), sz)
    if shape.kind == "prefill":
        ins = jdryrun.input_specs(arch, name, tp)
        return params + _tree_bytes(ins, {k: P(rules["batch"], *([None] * (
            len(v.shape) - 1))) for k, v in ins.items()}, sz)
    cp = name == "long_500k"
    caches = jshd.abstract_caches(cfg, tp, shape.global_batch,
                                  shape.seq_len)
    tok = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
    return (params
            + _tree_bytes(caches, jshd.cache_pspecs(cfg, rules, cp), sz)
            + _tree_bytes(tok, P(None if cp else rules["batch"], None), sz))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_the_reference_pspecs(arch, mesh):
    axes, sizes = MESHES[mesh]
    plan = dryrun.virtual_plan(multi_pod=len(axes) == 3)
    assert plan.mesh.axis_names == axes and plan.mesh.sizes == sizes
    for name in SHAPES:
        for q in ("off", "int8", "int4"):
            if name == "train_4k" and q != "off":
                continue
            try:
                _, meta = dryrun.build_program(arch, name, plan, quantize=q)
            except dryrun.ShapeNotApplicable:
                continue
            want = _reference_bytes(arch, name, axes, sizes, q)
            assert meta["argument_bytes"] == want, (arch, name, mesh, q)


# -- the virtual plan against a real 2 x 2 gloo run ----------------------------

SMOKE_ARCHS = ("qwen3-0.6b", "jamba-v0.1-52b")
SMOKE_SHAPES = {"train": ShapeConfig("train_smoke", "train", 16, 4),
                "prefill": ShapeConfig("prefill_smoke", "prefill", 16, 4),
                "decode": ShapeConfig("decode_smoke", "decode", 32, 4)}
KW = dict(remat="full", loss_chunk=8)


def _smoke(arch):
    return dataclasses.replace(get_smoke_config(arch), num_layers=2)


RANKS = r'''
import dataclasses, datetime, json, os, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def worker(rank, port, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch import mesh as tmesh
    cases = json.loads(open(os.path.join(d, "cases.json")).read())
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, shape in cases["cells"]:
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=2)
        run, _ = dryrun.build_program(arch, shape[0], mesh, cfg=cfg,
                                      shape=ShapeConfig(*shape),
                                      device="cpu", **cases["kw"])
        shd.reset_collectives()
        a = op_analysis.analyze(run)
        out[arch, shape[0]] = {"counts": dict(shd.COLLECTIVES),
                               "log": a["log"].collectives,
                               "flops": a["flops"],
                               "kernels": a["kernels"]}
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


@pytest.fixture(scope="module")
def real_2x2(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ranks")
    cells = [(a, dataclasses.astuple(s)) for a in SMOKE_ARCHS
             for s in SMOKE_SHAPES.values()]
    (d / "cases.json").write_text(json.dumps({"cells": cells, "kw": KW}))
    (d / "ranks.py").write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(d / "ranks.py"), str(d)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return torch.load(d / "out.pt", weights_only=False)


@pytest.mark.parametrize("kind", SMOKE_SHAPES)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_virtual_2x2_collectives_equal_a_real_run(real_2x2, arch, kind):
    shape = SMOKE_SHAPES[kind]
    plan = tplan.Plan.virtual(Mesh(("data", "model"), (2, 2)))
    run, _ = dryrun.build_program(arch, shape.name, plan, cfg=_smoke(arch),
                                  shape=shape, **KW)
    shd.reset_collectives()
    a = op_analysis.analyze(run)
    real = real_2x2[arch, shape.name]
    assert dict(shd.COLLECTIVES) == real["counts"]
    # kind, group size and result bytes of every call, in order
    assert a["log"].collectives == real["log"]
    assert sum(real["counts"].values()) > 0
    if kind != "train":     # the real backward is the plain one's autograd
        assert a["flops"] == real["flops"]
        assert a["kernels"] == real["kernels"]


# -- op_analysis and the CLI ---------------------------------------------------

def test_op_analysis_counts_known_products():
    """15 products of 128^3: exactly 15 · 2 · 128^3 FLOPs, and each
    product's operands and result in bytes."""
    ws = [torch.empty((128, 128), device="meta") for _ in range(16)]

    def chain():
        x = ws[0]
        for w in ws[1:]:
            x = x @ w
        return x
    a = op_analysis.analyze(chain)
    assert a["flops"] == 15 * 2 * 128 ** 3
    assert a["bytes"] == 15 * 3 * 128 * 128 * 4
    assert a["collective_bytes"] == 0 and a["kernels"] == {}
    assert op_analysis.ring_factor("all_reduce", 4) == \
        jdryrun.__dict__.get("_COLLECTIVE_FACTOR", {}).get("all-reduce",
                                                           2.0) * 3 / 4


def test_cli_prints_one_line_with_the_reference_keys():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "qwen3-0.6b", "--shape", "decode_32k"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(REF_LINE_KEYS) <= set(line)
    assert line["status"] == "ok" and line["mesh"] == "16x16"
    assert line["bottleneck"] in ("compute", "memory", "collective")
