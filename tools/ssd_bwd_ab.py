#!/usr/bin/env python3
"""``ssd_bwd`` of another checkout against this one's, in one process on one
card.

    python3 tools/ssd_bwd_ab.py [OLD_DIR] [--shape B,T,H,P,N] [--rounds N]

Run from the root of the new checkout. OLD_DIR (optional) is another
checkout of the repo (the parent, unpacked with ``git archive``); its
``kernels/build.py`` is loaded as a second module, so its library builds
from its own ``csrc/`` into its own ``_build/``, and its ``kernels/ssd.py``
is loaded over that module. At the shape (default mamba2-1.3b's training
shape, B 8, T 256, H 64, P 64, N 128, one group; bf16; x a view of the
conv-output buffer and B_/C stride-0 over heads, as ``models/ssm.py`` hands
them over; 2 input sets of 60 MB, past the 50 MB L2 together):

- the new kernel against the plain version in f32 (2e-2 of each
  gradient's largest), against the old kernel, and two new calls bit for
  bit, with the route ``ssd.bwd_route`` names as the launcher counted it;
- device ms per call by CUDA-graph replay of 4 calls, in turns: each
  round old, new, new, old; the median of the readings and their range;
- device ms per call from the profiler's kernel events over 20 calls of
  each, by kernel name;
- the bound, as ``chip_smoke.py``'s row counts it: the chunked backward's
  products over the causal pairs of 64-step chunks and its five state
  products at 989 TFLOP/s, or x, dt, B_, C (once a group) and dy read and
  dx, ddt, dB_, dC written once at 3.35 TB/s.

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
from repro_torch.kernels import ssd as new_ssd  # noqa: E402

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def old_wrapper(old: Path):
    kdir = old / "src/repro_torch/kernels"
    old_build = load_module("old_build", kdir / "build.py")
    old_build.build_all(["ssd_bwd"])
    mod = load_module("old_ssd", kdir / "ssd.py")
    mod.build = old_build
    return mod


def inputs(gen, B, T, H, P, N):
    """x a view of one (B, T, H*P + 2*N) bf16 buffer, B_ and C its last
    columns expanded over heads (stride 0), dt = softplus(normal), A =
    -exp(0.3 normal), dy normal."""
    bf = torch.bfloat16
    buf = (torch.randn((B, T, H * P + 2 * N), generator=gen, device="cuda")
           * 0.5).to(bf)
    x = buf[..., :H * P].unflatten(-1, (H, P))
    B_, C = (buf[..., H * P + i * N:H * P + (i + 1) * N].unsqueeze(-2)
             .expand(B, T, H, N) for i in range(2))
    dt = F.softplus(torch.randn((B, T, H), generator=gen, device="cuda"))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device="cuda"))
    dy = torch.randn((B, T, H, P), generator=gen, device="cuda").to(bf)
    return x, dt, A, B_, C, dy


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


def work(B, T, H, P, N, Q=new_ssd.BWD_CHUNK):
    """(FLOP, bytes) of the chunked backward, as ``chip_smoke.py``'s
    ``ssd_bwd_work`` counts them (bf16, one group)."""
    flops = sum(B * H * (q * (q + 1) * (3 * N + 2 * P) + 10 * q * P * N)
                for q in (min(Q, T - c0) for c0 in range(0, T, Q)))
    nbytes = (3 * B * T * H * P * 2 + 4 * 2 * B * T * H + 2 * B * T * N * 2
              + 2 * B * T * H * N * 2 + 4 * H)
    return flops, nbytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("old", nargs="?", type=Path)
    ap.add_argument("--shape", default="8,256,64,64,128")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    B, T, H, P, N = map(int, args.shape.split(","))
    gen = torch.Generator(device="cuda").manual_seed(0)
    sets = [inputs(gen, B, T, H, P, N) for _ in range(2)]
    fns = {"new": new_ssd.ssd_bwd}
    if args.old is not None:
        fns["old"] = old_wrapper(args.old).ssd_bwd

    x, dt, A, B_, C, dy = sets[0]
    build.load(new_ssd.BWD)
    build.routes(new_ssd.BWD, reset=True)
    got = new_ssd.ssd_bwd(*sets[0])
    again = new_ssd.ssd_bwd(*sets[0])
    taken = build.routes(new_ssd.BWD)
    want = ref.ssd_bwd(x.float(), dt, A, B_.float(), C.float(), dy.float())
    names = ("dx", "ddt", "dA", "dB_", "dC")
    err = {n: float((g.float() - w).abs().max() / w.abs().max())
           for n, g, w in zip(names, got, want)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    route = new_ssd.bwd_route(x.dtype, P, N, new_ssd.alignment(x, B_, C))
    line = {"shape": [B, T, H, P, N], "card": smi, "route": route,
            "routes_taken": taken, "err_over_max_grad": err,
            "two_calls_equal": same}
    if "old" in fns:
        old = fns["old"](*sets[0])
        line["old_vs_new_over_max_grad"] = {
            n: float((a.float() - b.float()).abs().max() / w.abs().max())
            for n, a, b, w in zip(names, old, got, want)}
    print(f"new vs plain f32, max abs err / max |grad|: {err}; two calls "
          f"equal: {same}; route {route}, taken {taken}", flush=True)
    if max(err.values()) > 2e-2 or not same or taken[route] != 2:
        raise AssertionError(f"the new kernel fails its gate: {line}")

    order = ["old", "new", "new", "old"] if "old" in fns else ["new"]
    reps = {n: [] for n in fns}
    for _ in range(args.rounds):
        for n in order:
            reps[n].append(graph_ms(fns[n], sets, 4))
    for n, r in reps.items():
        line[f"{n}_graph_ms"] = statistics.median(r)
        print(f"{n}: graph replay median {statistics.median(r):.4f} ms "
              f"(readings {min(r):.4f}-{max(r):.4f})", flush=True)
    for n, fn in fns.items():
        ms, by_name = profiled_ms(lambda: fn(*sets[0]))
        line[f"{n}_profiler_ms"], line[f"{n}_profiler_by_kernel"] = \
            ms, by_name
        print(f"{n}: profiler device ms over 20 calls {ms:.4f} (" + ", ".join(
            f"{k} {t:.4f}" for k, t in sorted(by_name.items())) + ")",
            flush=True)
    flops, nbytes = work(B, T, H, P, N)
    bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    line.update(bound_ms=bound, flops=flops, bytes=nbytes)
    print(f"bound {bound:.4f} ms ({flops:.4g} FLOP, {nbytes:.4g} B); new at "
          f"{flops / line['new_graph_ms'] / 1e9:.1f} TFLOP/s", flush=True)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
