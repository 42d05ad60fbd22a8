#!/usr/bin/env python3
"""Where ``ssd_bwd``'s tensor-core kernel spends its time: this checkout's
``csrc/ssd_bwd.cu`` built again with one part of the kernel cut out at a
time, each variant timed by CUDA-graph replay at mamba2-1.3b's training
shape, in turns, beside the kernel whole, on one card.

    python3 tools/ssd_bwd_parts.py [--rounds N]

The cut variants compute wrong gradients; only their times mean anything.
A part's time is not what its removal saves when the two roles of the
kernel share the sub-partitions: the savings do not add up. Each
variant's ptxas registers and spills are printed beside its time (a
variant that spills times the spills too). The parts, cut between two
markers of the source (a missing marker stops the tool):

- ``j_dB``: rows j's dB pass (w x dh, dS^T C);
- ``j_u_blocks``: rows j's column blocks of the u pass (S^T, dS^T, M, u);
- ``j_all``: rows j's products whole (both passes);
- ``i_dC``: rows i's dC (dy h_prev, dS B) and dl's second sum's terms;
- ``i_dh``: rows i's dh_prev product;
- ``tail``: dl's direct sums, ddt and the dA partials;
- ``fwd``: the forward steps' state product and scratch writes.

The card's name and power limit come first; the last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
# part -> (start marker, end marker, keep the end marker)
PARTS = {
    "j_dB": ("      // pass 2: dB = w_j x_j dh",
             "      block_sync();                // M, e, f, xu", True),
    "j_u_blocks": ("        for (int ib = warp - NI; ib < QB / 16; ++ib) {\n"
                   "          uint32_t sh[4], sl[4], dsh[4], dsl[4];",
                   "        float q0 = 0.f, q1 = 0.f;", True),
    "j_all": ("      // pass 1: u = v_j B dh^T",
              "      block_sync();                // M, e, f, xu", True),
    "i_dC": ("        // dC = e^{cum_i} dy_i h_prev",
             "        // dy_i e^{cum_i} as bf16 hi + lo", True),
    "i_dh": ("        // dh_prev = e^{cum_Q} dh",
             "        if (warp == 0 && nx.item < BH) scan(nx, dn, s ^ 1);\n"
             "        block_sync();", True),
    "tail": ("      // dl by direct sums: each row",
             "      if (tt == 0) dA_acc += sm.red[0] + sm.red[1];\n", False),
    "fwd": ("    const float eq = ex2(cq);\n    const int mt = warp & 3",
            "  };\n\n  const Step first", True),
}


def cut(src: str, start: str, end: str, keep_end: bool) -> str:
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + src[j if keep_end else j + len(end):]


def inputs(gen, B, T, H, P, N):
    """As tools/ssd_bwd_ab.py: x a view of a conv-output buffer, B_ and C
    stride-0 over heads, bf16."""
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_bwd_parts: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src = (CSRC / "ssd_bwd.cu").read_text()
    variants = {"whole": src}
    variants.update({k: cut(src, *v) for k, v in PARTS.items()})
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        f = CSRC / f"_parts_{name}.cu"    # beside common.cuh, for includes
        f.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"{name}.so"), str(f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "ssd_bwd_tc_kernel" in line and "properties" in line:
                    regs[name] = " ".join(
                        x.strip() for x in lines[i + 1:i + 3])
            lib = ctypes.CDLL(str(out / f"{name}.so"))
            fn, argtypes = build.SIGNATURES["ssd_bwd"]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            lib.ssd_bwd_routes.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ssd_bwd_routes.restype = None
            libs[name] = lib
    finally:
        for name in variants:
            (CSRC / f"_parts_{name}.cu").unlink(missing_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sets = [inputs(gen, 8, 256, 64, 64, 128) for _ in range(2)]
    ms = {name: [] for name in libs}
    saved = build._LIBS.get("ssd_bwd")
    try:
        for _ in range(args.rounds):
            for name, lib in libs.items():
                build._LIBS["ssd_bwd"] = lib
                ms[name].append(graph_ms(ssd_mod.ssd_bwd, sets, 4))
    finally:
        if saved is None:
            build._LIBS.pop("ssd_bwd", None)
        else:
            build._LIBS["ssd_bwd"] = saved
    whole = statistics.median(ms["whole"])
    line = {"card": smi, "shape": [8, 256, 64, 64, 128], "ms": {}}
    for name, r in ms.items():
        med = statistics.median(r)
        line["ms"][name] = med
        print(f"{name}: {med:.4f} ms (readings {min(r):.4f}-{max(r):.4f}), "
              f"{100 * (1 - med / whole):+.1f}% saved; ptxas: "
              f"{regs.get(name, 'not reported')}", flush=True)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
