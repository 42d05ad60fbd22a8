"""Dry run: every (architecture x shape x mesh) cell's program for one rank,
with its roofline terms and its bytes a device, without a card.

The counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell's jitted program over 256 or 512 placeholder devices and
reads the HLO. The port has no compiler to ask: it runs rank 0's program
of the cell, eagerly, on ``meta`` tensors (nothing allocated, nothing
drawn), under a *virtual* plan (``distributed/plan.py::Plan.virtual``:
rank 0's coordinates and no process group; every collective records its
kind, group size and bytes and returns an output of the right shape), and
counts what it issues (``launch/op_analysis.py``: matrix products, each
kernel call by its work formula through its meta path, bytes,
collectives).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out f.json]

Each line has the reference's keys. ``lower_s`` is the seconds of the meta
run and ``compile_s`` 0.0: the port compiles nothing ahead of time (its
kernels are built once, at first use, by ``kernels/build.py``).
``argument_bytes`` is the rank's arguments exactly, from the local shapes
(params, AdamW state and batch for train; params, tokens, prefix and
caches for serving; a generator's key holds no tensor);
``bytes_per_device`` the peak of the live tensors the program made above
them, as eager torch would hold them (not XLA's temp size); ``fits`` whether
the two together fit one H100's 80 GB. A cell whose dims the mesh does not
divide reports ``status: "error"`` and why, and the sweep goes on.

Roofline constants: one H100 SXM by NVIDIA's data sheet, 989 TFLOP/s bf16
dense, 3.35 TB/s of HBM, NVLink 450 GB/s each way to the other cards of
an 8-card host. A collective over a group larger than 8 crosses hosts: it
is taken at 50 GB/s a card, one 400 Gb/s InfiniBand NDR port a GPU (the
DGX H100 layout), an assumption, not a measurement. The production meshes
are (16, 16) and (2, 16, 16) as in the reference: every ``model`` group
(16 ranks) and every ``data`` group span hosts.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import (ARCHS, SHAPES, ShapeNotApplicable,
                                 check_applicable, get_config,
                                 with_overrides)
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.buffer import abstract_batch, random_batch
from repro_torch.distributed import plan as _plan
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import Mesh, mesh_config
from repro_torch.models.params import param_count
from repro_torch.models.policy import BackbonePolicy, policy_spec
from repro_torch.rl import actor
from repro_torch.rl.learner import init_train_state, make_lm_train_step

# one H100 SXM (NVIDIA's data sheet)
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # B/s
NVLINK_BW = 450e9            # B/s each way, within an 8-card host
NET_BW = 50e9                # B/s a card across hosts: assumed, see above
HOST_CARDS = 8
DEVICE_BYTES = 80e9
LINE_KEYS = ("arch", "shape", "mesh", "status", "bottleneck", "t_compute_s",
             "t_memory_s", "t_collective_s", "roofline_fraction",
             "compile_s")


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for
    inference (D = tokens processed this step). A copy of the
    reference's."""
    n_total = param_count(policy_spec(cfg, 1))
    if cfg.num_experts:
        moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        per_expert = 3 * cfg.d_model * cfg.expert_d_ff
        n_active = n_total - moe_layers * (cfg.num_experts - cfg.top_k) \
            * per_expert
    else:
        n_active = n_total
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch     # decode: one token/seq


def input_specs(arch: str, shape_name: str, tp: int = 16):
    """``meta`` stand-ins for every model input of one cell, global shapes:

    train_*  -> the PPO rollout batch (tokens, actions, logprobs, rewards,
                dones, values[, prefix for vlm/audio stubs])
    prefill_* -> {"tokens"[, "prefix"]}
    decode_* / long_* -> {"tokens" (B,1), "caches"} for one serve step
    """
    from repro_torch.distributed import sharding as shd
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    check_applicable(cfg, shape)
    if shape.kind == "train":
        return abstract_batch(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return _prefill_inputs(cfg, shape)
    return {"tokens": _meta((shape.global_batch, 1), torch.int32),
            "caches": shd.abstract_caches(cfg, tp, shape.global_batch,
                                          shape.seq_len)}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _prefill_inputs(cfg, shape):
    P = cfg.frontend_prefix if cfg.frontend else 0
    out = {"tokens": _meta((shape.global_batch, shape.seq_len - P),
                           torch.int32)}
    if P:
        out["prefix"] = _meta((shape.global_batch, P, cfg.d_model),
                              torch.bfloat16)
    return out


def virtual_plan(multi_pod: bool = False):
    """Rank 0's view of a production mesh, with no process group."""
    mc = mesh_config(multi_pod=multi_pod)
    return _plan.Plan.virtual(Mesh(tuple(mc.axes), tuple(mc.shape)))


def _leaves(tree):
    """The tensors of nested dicts, lists and tuples (``None`` skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def build_program(arch: str, shape_name: str, plan, *, opt_dtype="bfloat16",
                  remat="full", loss_chunk=256, microbatches=1,
                  quantize="off", cfg=None, shape: ShapeConfig = None,
                  device="meta"):
    """Returns (run, meta): ``run()`` runs rank ``plan.rank``'s program of
    the cell on meta tensors; ``meta`` holds the cell's names, its
    ``model_flops`` and the rank's ``argument_bytes``. ``cfg`` and
    ``shape`` stand in for the registry's (a smoke cell). A decode runs at
    a full cache (length S - 1). With ``device`` "cpu" (and a real plan,
    or a mesh of the process group) the same program runs on real tensors
    drawn from seed 0: the check that the virtual plan's collectives are a
    real run's."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    check_applicable(cfg, shape)
    model_cfg = cfg
    cfg = with_overrides(cfg, remat=remat)
    q = quantize if (quantize != "off" and shape.kind != "train") else None
    gen = None if device == "meta" else torch.Generator(device).manual_seed(0)
    policy = BackbonePolicy(cfg, device=device, mesh=plan, quantize=q,
                            generator=gen)
    plan = policy.plan
    params = policy.params()

    def inputs(specs):
        return specs if device == "meta" else {
            k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}

    if shape.kind == "train":
        odt = getattr(torch, opt_dtype)
        state = init_train_state(params, odt)
        batch = abstract_batch(cfg, shape.global_batch, shape.seq_len) \
            if device == "meta" else random_batch(
                cfg, shape.global_batch, shape.seq_len, gen)
        step = make_lm_train_step(policy, TrainConfig(
            optimizer_state_dtype=opt_dtype), loss_chunk=loss_chunk,
            num_microbatches=microbatches)
        local = {k: policy.rows(v) for k, v in batch.items()}
        args = _nbytes(state) + _nbytes(local)

        def run():
            return step(state, batch)

    elif shape.kind == "prefill":
        given = inputs(_prefill_inputs(cfg, shape))
        pf = actor.make_prefill_step(policy, max_len=shape.seq_len)
        args = _nbytes(params) + sum(_nbytes(policy.rows(v))
                                     for v in given.values())

        def run():
            return pf(given["tokens"], gen, prefix=given.get("prefix"))

    else:  # decode
        cp = shape.name == "long_500k"
        caches = policy.init_caches(shape.global_batch, shape.seq_len,
                                    context_parallel=cp)
        caches = caches._replace(length=torch.full(
            (), shape.seq_len - 1, dtype=torch.int32, device=device))
        tokens = inputs({"t": _meta((shape.global_batch, 1),
                                    torch.int32)})["t"]
        sv = actor.make_serve_step(policy, context_parallel=cp)
        args = _nbytes(params) + _nbytes(caches) + \
            _nbytes(policy.rows(tokens, cp))

        def run():
            return sv(tokens, caches, gen)

    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "mesh": "x".join(map(str, plan.mesh.sizes)),
            "model_flops": model_flops(model_cfg, shape),
            "argument_bytes": args}
    return run, meta


def _link_bw(group: int) -> float:
    return NVLINK_BW if group <= HOST_CARDS else NET_BW


def roofline(meta, analysis, chips: int) -> dict:
    """The three roofline terms of the rank's counts (``op_analysis``),
    the globals = x chips, as the reference reports them."""
    t_coll = sum(nbytes * op_analysis.ring_factor(kind, g) / _link_bw(g)
                 for kind, g, nbytes in analysis["log"].collectives)
    flops, nbytes = analysis["flops"], analysis["bytes"]
    out = dict(meta)
    out.update({
        "hlo_flops": flops * chips,
        "hlo_bytes": nbytes * chips,
        "collective_bytes": analysis["collective_bytes"] * chips,
        "collectives": {k: v * chips
                        for k, v in analysis["collectives"].items()},
        "collective_counts": analysis["collective_counts"],
        "kernels": analysis["kernels"],
        "t_compute_s": flops / PEAK_FLOPS,
        "t_memory_s": nbytes / HBM_BW,
        "t_collective_s": t_coll,
        "xla_raw": None,
        "bytes_per_device": analysis["peak_bytes"],
        "output_bytes": None,
        "useful_flops_ratio": (meta["model_flops"] / (flops * chips)
                               if flops else None),
        "fits": meta["argument_bytes"] + analysis["peak_bytes"]
        <= DEVICE_BYTES,
    })
    terms = {"compute": out["t_compute_s"], "memory": out["t_memory_s"],
             "collective": out["t_collective_s"]}
    out["bottleneck"] = max(terms, key=terms.get)
    worst = max(terms.values())
    out["roofline_fraction"] = (meta["model_flops"] / (chips * PEAK_FLOPS)
                                / worst if worst > 0 else None)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, **kw) -> dict:
    plan = virtual_plan(multi_pod)
    mesh = "x".join(map(str, plan.mesh.sizes))
    chips = plan.mesh.size
    try:
        run, meta = build_program(arch, shape_name, plan, **kw)
    except ShapeNotApplicable as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "skipped", "reason": str(e)}
    except ValueError as e:          # a dim the mesh does not divide
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "error", "reason": str(e)}
    t0 = time.time()
    out = roofline(meta, op_analysis.analyze(run), chips)
    out.update({"status": "ok", "lower_s": round(time.time() - t0, 1),
                "compile_s": 0.0})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--opt-dtype", default="bfloat16")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--loss-chunk", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quantize", default="off",
                    choices=["off", "int8", "int4"],
                    help="quantized weights for prefill/decode cells")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                r = run_cell(a, s, mp, opt_dtype=args.opt_dtype,
                             remat=args.remat, loss_chunk=args.loss_chunk,
                             microbatches=args.microbatches,
                             quantize=args.quantize)
                line = {k: r.get(k) for k in LINE_KEYS}
                line["fits"] = r.get("fits")
                print(json.dumps(line), flush=True)
                results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
