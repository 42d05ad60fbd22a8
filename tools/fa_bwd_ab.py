#!/usr/bin/env python3
"""``flash_attention_bwd`` of another checkout against this one's, and
against the backward of ``scaled_dot_product_attention``, in one process on
one card.

    python3 tools/fa_bwd_ab.py [OLD_DIR] [--shape B,T,H,K,hd] [--rounds N]

Run from the root of the new checkout. OLD_DIR (optional) is another
checkout of the repo (the parent, unpacked with ``git archive``); its
``kernels/build.py`` is loaded as a second module, so its library builds
from its own ``csrc/`` into its own ``_build/``, and its
``kernels/flash_attention.py`` is loaded over that module. At the shape
(default qwen3-0.6b's training shape, B 8, T 256, H 16, K 8, hd 128;
causal, bf16; 4 input sets of 29 MB, past the 50 MB L2 together), each
from this checkout's forward (o and its LSE):

- the new kernel against the plain version in f32 (2e-2 of the largest
  gradient) and against the old kernel, and two new calls bit for bit;
- device ms per call by CUDA-graph replay of 8 calls, in turns: each
  round old, new, new, old; the median of the readings and their range;
- device ms per call from the profiler's kernel events over 20 calls, of
  the new kernel and of SDPA's backward (``torch.autograd.grad`` on one
  retained forward): the like-for-like ratio;
- the bound, as ``chip_smoke.py``'s row counts it: the four products the
  gradient needs over the causal pairs at 989 TFLOP/s, or q, k, v, o, do,
  lse read and dq, dk, dv written once at 3.35 TB/s.

The card's name and power limit come first; the last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as new_fa  # noqa: E402

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def old_wrapper(old: Path):
    kdir = old / "src/repro_torch/kernels"
    old_build = load_module("old_build", kdir / "build.py")
    old_build.build_all(["flash_attention_bwd"])
    mod = load_module("old_flash_attention", kdir / "flash_attention.py")
    mod.build = old_build
    return mod


def graph_ms(fn, arg_sets, calls, replays=5):
    """Device ms per call: ``calls`` calls cycling through ``arg_sets``,
    captured in a CUDA graph and replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def profiled_ms(fn, calls=20):
    """Device ms per call from the profiler's kernel events, and by
    kernel name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            by_name[name] = by_name.get(name, 0.0) + \
                e.device_time_total / 1e3 / calls
    if not by_name:
        raise AssertionError("the profiler saw no device time")
    return sum(by_name.values()), by_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("old", nargs="?", type=Path)
    ap.add_argument("--shape", default="8,256,16,8,128")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fa_bwd_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    B, T, H, K, hd = map(int, args.shape.split(","))
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").to(bf)
    sets = []
    for _ in range(4):
        q, k, v, do = (randn(B, T, H, hd), randn(B, T, K, hd),
                       randn(B, T, K, hd), randn(B, T, H, hd))
        o, lse = new_fa.flash_attention_fwd(q, k, v, True, with_lse=True)
        sets.append((q, k, v, o, lse, do))
    fns = {"new": new_fa.flash_attention_bwd}
    if args.old is not None:
        fns["old"] = old_wrapper(args.old).flash_attention_bwd

    got = new_fa.flash_attention_bwd(*sets[0])
    again = new_fa.flash_attention_bwd(*sets[0])
    q, k, v, o, lse, do = sets[0]
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   do.float())
    top = max(float(w.abs().max()) for w in want)
    err = {n: float((g.float() - w).abs().max()) / top
           for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    line = {"shape": [B, T, H, K, hd], "card": smi,
            "err_over_max_grad": err, "two_calls_equal": same,
            "route": new_fa.bwd_route(bf, hd)}
    if "old" in fns:
        old = fns["old"](*sets[0])
        line["old_vs_new_over_max_grad"] = max(
            float((a.float() - b.float()).abs().max()) / top
            for a, b in zip(old, got))
    print(f"new vs plain f32, max abs err / max |grad|: {err}; two calls "
          f"equal: {same}", flush=True)
    if max(err.values()) > 2e-2 or not same:
        raise AssertionError(f"the new kernel fails its gate: {line}")

    order = (["old", "new", "new", "old"] if "old" in fns else ["new"])
    reps = {n: [] for n in fns}
    for _ in range(args.rounds):
        for n in order:
            reps[n].append(graph_ms(fns[n], sets, 8))
    for n, r in reps.items():
        line[f"{n}_graph_ms"] = statistics.median(r)
        print(f"{n}: graph replay median {statistics.median(r):.4f} ms "
              f"(readings {min(r):.4f}-{max(r):.4f})", flush=True)

    new_prof, new_names = profiled_ms(
        lambda: new_fa.flash_attention_bwd(*sets[0]))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qg.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    do_t = do.transpose(1, 2)
    sdpa_prof, _ = profiled_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do_t, retain_graph=True))
    flops = 4 * B * H * hd * T * (T + 1)
    nbytes = 2 * (4 * B * T * H * hd + 4 * B * T * K * hd) + 4 * B * H * T
    bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    line.update(new_profiler_ms=new_prof, new_profiler_by_kernel=new_names,
                sdpa_bwd_profiler_ms=sdpa_prof,
                new_over_sdpa_profiler=new_prof / sdpa_prof,
                new_graph_over_sdpa_profiler=line["new_graph_ms"] / sdpa_prof,
                bound_ms=bound, flops=flops, bytes=nbytes)
    print(f"profiler device ms over 20 calls: new {new_prof:.4f} ("
          + ", ".join(f"{n} {t:.4f}" for n, t in sorted(new_names.items()))
          + f"), SDPA's "
          f"backward {sdpa_prof:.4f} (ratio {new_prof / sdpa_prof:.3f}); "
          f"graph replay / SDPA profiler {line['new_graph_ms'] / sdpa_prof:.3f}"
          f"; bound {bound:.4f} ms ({flops:.4g} FLOP, {nbytes:.4g} B)",
          flush=True)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
