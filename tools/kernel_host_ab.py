#!/usr/bin/env python3
"""The parent's kernel wrappers against this checkout's, in one process on
one card: host microseconds per wrapper call and device milliseconds per
kernel call.

    python3 tools/kernel_host_ab.py OLD_DIR [--only SECTIONS]

Run from the root of the new checkout. OLD_DIR is another checkout of the
repo (the parent, unpacked with ``git archive``). Its ``kernels/build.py``
is loaded as a second module, so its libraries build from its own
``csrc/`` into its own ``_build/`` with its own C signatures, and its
``ssd.py``, ``gae.py``, ``pack.py`` and ``flash_decode.py`` are loaded over
that module. ``--only`` names the sections to run, comma-separated, of
ssd, gae, pack, flash_decode and decode (all by default). Both checkouts'
wrappers then run on the same tensors:

- device ms per call of ``ssd`` by CUDA-graph replay at mamba2-1.3b's
  serve shape (B 8, T 512, H 64, hd 64, ds 128, one group, chunk 128, bf16,
  x, B_ and C views of one conv-output buffer) and at T 2048, and of
  ``gae`` at the full-size update (4096 envs x 64 steps, (B, T) views of
  (T, B) tensors), with no control (no PyTorch call computes either);
- host µs per call of each wrapper, and of ``torch.cat`` and
  ``scaled_dot_product_attention`` on the same inputs (controls that no
  checkout touches: they read the host's own speed), over back-to-back
  calls;
- device ms per call by CUDA-graph replay, at the host tier's act shape
  and a full-size trajectory for ``pack``, and at qwen3-0.6b's last serve
  step (B 8, S 576, L 574, H 16, K 8, hd 128, bf16) and a cache past the
  L2 (S 8192) for ``flash_decode``.

Each measurement runs in turns: 5 rounds, each calling old, new and the
control in order and then in reverse; it prints the median of the 10
readings and their range.

Then qwen3-0.6b at full width (random weights from seed 0, batch 8,
prompt 512), in bf16 and with int8 weights: a prefill and 63 decode steps,
the old and the new ``flash_decode`` registered with the dispatcher in
turns (old, new, new, old, 3 rounds) in this one process, so the host's
speed falls on both alike: decode wall ms a token, and the device ms of a
decode step from the profiler.

The card's name and power limit come first; then one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import flash_decode as new_fd  # noqa: E402
from repro_torch.kernels import gae as new_gae  # noqa: E402
from repro_torch.kernels import pack as new_pack  # noqa: E402
from repro_torch.kernels import ssd as new_ssd  # noqa: E402

BF = torch.bfloat16


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WRAPPED = ("ssd", "gae", "pack", "flash_decode")


def old_wrappers(old: Path):
    """OLD_DIR's wrapper modules, bound to its own build."""
    kdir = old / "src/repro_torch/kernels"
    old_build = load_module("old_build", kdir / "build.py")
    old_build.build_all(WRAPPED)
    mods = {}
    for name in WRAPPED:
        mods[name] = load_module(f"old_{name}", kdir / f"{name}.py")
        mods[name].build = old_build
    return mods


def host_us(fn, calls=3000):
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


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


def in_turns(fns, rounds=5):
    """{name: (median, min, max)} over ``rounds`` rounds of calling each of
    ``fns`` (name -> zero-argument timer) in the given order, then
    reversed."""
    got = {k: [] for k in fns}
    for _ in range(rounds):
        order = list(fns) + list(reversed(fns))
        for k in order:
            got[k].append(fns[k]())
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


def device_ms(fn, steps):
    """Device ms per call of ``fn`` from the profiler's kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / steps


def decode_turns(mods, gen, rounds=3, new_tokens=64):
    """qwen3-0.6b decode with the old and the new flash_decode in turns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.policy import BackbonePolicy
    from repro_torch.rl import actor
    impl = {"old": mods["flash_decode"].flash_decode,
            "new": new_fd.flash_decode}
    cfg = get_config("qwen3-0.6b")
    out = {}
    for quantize in (None, "int8"):
        policy = BackbonePolicy(cfg, generator=gen, quantize=quantize)
        prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                               device="cuda")
        prefill = actor.make_prefill_step(policy, 512 + new_tokens)
        serve = actor.make_serve_step(policy)
        wall = {"old": [], "new": []}
        dev = {"old": [], "new": []}
        try:
            for _ in range(rounds):
                for name in ("old", "new", "new", "old"):
                    dispatch.register("flash_decode",
                                      dispatch.CUDA)(impl[name])
                    state = list(prefill(prompt, gen))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(new_tokens - 1):
                        state[0], _, state[2] = serve(state[0], state[2],
                                                      gen)
                    torch.cuda.synchronize()
                    wall[name].append((time.perf_counter() - t0) * 1e3 /
                                      (new_tokens - 1))
                    state = list(prefill(prompt, gen))

                    def step():
                        state[0], _, state[2] = serve(state[0], state[2],
                                                      gen)
                    dev[name].append(device_ms(step, 8))
        finally:
            dispatch.register("flash_decode", dispatch.CUDA)(
                new_fd.flash_decode)
        out[quantize or "bf16"] = {
            "decode wall ms/token": {k: (statistics.median(v), min(v),
                                         max(v)) for k, v in wall.items()},
            "decode device ms/step": {k: (statistics.median(v), min(v),
                                          max(v)) for k, v in dev.items()}}
        del policy, state
        torch.cuda.empty_cache()
    return out


def ssd_inputs(gen, B, T, H, P, N, G):
    """x, dt, A, B_, C as models/ssm.py hands them over: x, B_ and C slices
    of one (B, T, H*P + 2*G*N) bf16 conv-output buffer, B_/C expanded over
    heads."""
    buf = torch.randn((B, T, H * P + 2 * G * N), generator=gen,
                      device="cuda").to(BF) * 0.5
    x = buf[..., :H * P].unflatten(-1, (H, P))
    bc = [buf[..., H * P + i * G * N:H * P + (i + 1) * G * N]
          .unflatten(-1, (G, N)).unsqueeze(-2).expand(B, T, G, H // G, N)
          .flatten(-3, -2) for i in range(2)]
    dt = F.softplus(torch.randn((B, T, H), generator=gen, device="cuda"))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device="cuda"))
    return x, dt, A, bc[0], bc[1]


def kernel_turns(mods, gen, only):
    """ssd and gae, old against new, device ms by graph replay."""
    out = {}
    if "ssd" in only:
        for T, nsets, calls in ((512, 3, 12), (2048, 1, 4)):
            sets = [ssd_inputs(gen, 8, T, 64, 64, 128, 1)
                    for _ in range(nsets)]
            out[f"ssd device ms, T {T}"] = in_turns({
                "old": lambda: graph_ms(mods["ssd"].ssd, sets, calls),
                "new": lambda: graph_ms(new_ssd.ssd, sets, calls)})
            del sets
            torch.cuda.empty_cache()
    if "gae" in only:
        B, T = 4096, 64
        sets = []
        for _ in range(24):         # 57 MB, past the L2
            r, v = (torch.randn((T, B), generator=gen, device="cuda")
                    for _ in range(2))
            d = torch.rand((T, B), generator=gen, device="cuda") < 0.1
            lv = torch.randn(B, generator=gen, device="cuda")
            sets.append((r.T, v.T, d.T, lv))
        out["gae device ms, (4096, 64)"] = in_turns({
            "old": lambda: graph_ms(
                lambda *a: mods["gae"].gae(*a, 0.95, 0.95), sets, 96),
            "new": lambda: graph_ms(lambda *a: new_gae.gae(*a, 0.95, 0.95),
                                    sets, 96)})
    return out


def host_tier_turns(mods, gen, only):
    """pack and flash_decode, old against new, with their controls; then
    qwen3-0.6b decode with the two flash_decodes in turns."""

    def u8(B, n):
        return torch.randint(0, 256, (B, n), generator=gen, device="cuda",
                             dtype=torch.uint8)

    out = {}
    if "pack" in only:
        out.update(pack_turns(mods, u8))
    if "flash_decode" in only:
        out.update(flash_decode_turns(mods, gen))
    if "decode" in only:
        out["qwen3-0.6b decode, flash_decode old and new in turns"] = \
            decode_turns(mods, gen)
    return out


def pack_turns(mods, u8):
    """pack at the host tier's act shape and a full-size trajectory."""
    out = {}
    # the host tier's act shape (B 64, leaves of 4, 4 and 4 bytes)
    act = [(u8(64, 4), u8(64, 4), u8(64, 4)) for _ in range(16)]
    big = [(u8(262144, 16), u8(262144, 36)) for _ in range(4)]
    leaves = act[0]
    out["pack host us"] = in_turns({
        "old": lambda: host_us(lambda: mods["pack"].pack(leaves)),
        "new": lambda: host_us(lambda: new_pack.pack(leaves)),
        "torch.cat": lambda: host_us(lambda: torch.cat(leaves, dim=-1))})
    for label, sets, calls in (("act", act, 64), ("262144 rows", big, 8)):
        out[f"pack device ms, {label}"] = in_turns({
            "old": lambda: graph_ms(lambda *l: mods["pack"].pack(l), sets,
                                    calls),
            "new": lambda: graph_ms(lambda *l: new_pack.pack(l), sets,
                                    calls),
            "torch.cat": lambda: graph_ms(lambda *l: torch.cat(l, dim=-1),
                                          sets, calls)})
    return out


def flash_decode_turns(mods, gen):
    """flash_decode at qwen3-0.6b's last serve step, then a cache past the
    L2, with SDPA as the control."""
    out = {}
    B, H, K, hd = 8, 16, 8, 128
    for S, nsets, calls in ((576, 6, 64), (8192, 2, 8)):
        L = S - 2
        length = torch.tensor(L, dtype=torch.int32, device="cuda")
        sets = [(torch.randn((B, H, hd), generator=gen, device="cuda")
                 .to(BF),
                 torch.randn((B, S, K, hd), generator=gen, device="cuda")
                 .to(BF),
                 torch.randn((B, S, K, hd), generator=gen, device="cuda")
                 .to(BF), length) for _ in range(nsets)]

        def sdpa(q, k, v, n, L=L):
            return F.scaled_dot_product_attention(
                q[:, :, None], k[:, :L + 1].transpose(1, 2),
                v[:, :L + 1].transpose(1, 2), enable_gqa=True)

        if S == 576:
            q, k, v, n = sets[0]
            out["flash_decode host us"] = in_turns({
                "old": lambda: host_us(
                    lambda: mods["flash_decode"].flash_decode(q, k, v, n)),
                "new": lambda: host_us(
                    lambda: new_fd.flash_decode(q, k, v, n)),
                "SDPA": lambda: host_us(lambda: sdpa(q, k, v, n))})
        out[f"flash_decode device ms, S {S}"] = in_turns({
            "old": lambda: graph_ms(mods["flash_decode"].flash_decode, sets,
                                    calls),
            "new": lambda: graph_ms(new_fd.flash_decode, sets, calls),
            "SDPA": lambda: graph_ms(sdpa, sets, calls)})
        del sets
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("--only", default="ssd,gae,pack,flash_decode,decode")
    args = ap.parse_args()
    old = Path(args.old).resolve()
    only = set(args.only.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    mods = old_wrappers(old)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi}
    out.update(kernel_turns(mods, gen, only))
    if only & {"pack", "flash_decode", "decode"}:
        out.update(host_tier_turns(mods, gen, only))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
