"""Build the CUDA C++ kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes); the
backward kernels ``flash_attention_bwd`` and ``ssd_bwd`` have files of their
own, so that they build beside the others:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

at first use, into ``kernels/_build/`` (listed in ``.gitignore``). The file
name carries a hash of the sources and flags, so an edited source is never
served by a stale library. ``build_all()`` starts one nvcc per source, all
at once, and waits for them together.

Every exported launcher returns its ``cudaError_t`` (``cudaGetLastError``
after the launch); ``check`` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> (C function, argtypes); pointers and the stream are c_void_p
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "flash_attention": ("flash_attention_fwd", [
        P, P, P, P, P,              # q, k, v, o, lse (f32 (B, H, T) or null)
        I, I, I, I, I, I,           # B, T, S, H, K, hd
        L, L, L, L, L, L, L, L, L,  # q/k/v strides (batch, seq, head)
        I, I, F, P]),               # is_bf16, causal, scale, stream
    "flash_decode": ("flash_decode_fwd", [
        P, P, P, P, P, P, P,        # q, k, v, length (device int32), o,
                                    # lse (f32 (B, H) or null), workspace
                                    # (f32, or null with one cluster a pair)
        I, I, I, I, I,              # B, S, H, K, hd
        L, L, L, L, L, L, L, L,     # q (batch, head), k/v (batch, seq, head)
        I, F, I, I, I, P]),         # is_bf16, scale, split, n_split,
                                    # blocks a cluster, stream
    "gae": ("gae_fwd", [
        P, P, P, P, P,              # rewards, values, dones (u8), last, out
        I, I,                       # B, T
        L, L, L, L, L, L,           # r/v/dones strides (env, time)
        L, L, L,                    # last_value stride, out (env, time)
        F, F, P]),                  # gamma, lam, stream
    "ssd": ("ssd_fwd", [
        P, P, P, P, P, P, P,        # x, dt, A, B_, C, y, h_last
        I, I, I, I, I, I,           # B, T, H, hd, ds, chunk (any T)
        L, L, L, L, L, L, L, L,     # x (batch, seq, head, elem), dt (b, s, h), A
        L, L, L, L, L, L, L, L,     # B_ and C (batch, seq, head, elem)
        I, P]),                     # is_bf16, stream
    "quant_matmul": ("quant_matmul_fwd", [
        P, P, P, P,                 # x, w_q, scale, out
        I, I, I,                    # M, N, K
        L, L, L,                    # x strides (row, col), w_q row (bytes)
        I, I, I, I, I, I, P]),      # scale length, is_bf16, is_int4,
                                    # transposed, vec16 (w, x), stream
    "flash_attention_bwd": ("flash_attention_bwd", [
        P, P, P, P, P, P,           # q, k, v, o, lse, do
        P, P, P, P,                 # dq, dk, dv, D (f32 scratch, 2 B H Tp)
        I, I, I, I, I, I,           # B, T, S, H, K, hd
        L, L, L, L, L, L, L, L, L,  # q/k/v strides (batch, seq, head)
        L, L, L, L, L, L,           # o/do strides (batch, seq, head)
        I, I, F, P]),               # is_bf16, causal, scale, stream
    "ssd_bwd": ("ssd_bwd", [
        P, P, P, P, P, P, P,        # x, dt, A, B_, C, dy, dh_last (or null)
        P, P, P, P, P,              # dx, ddt, dA, dB_, dC
        P, P,                       # f64 scratch: yd (B, H, T), dA (B, H)
        P,                          # f32 scratch: states (B, H, nc - 1, hd,
                                    # ds), the tensor cores' (or null)
        I, I, I, I, I,              # B, T, H, hd, ds
        L, L, L, L, L, L, L, L,     # x (b, s, h, elem), dt (b, s, h), A
        L, L, L, L, L, L, L, L,     # B_ and C (batch, seq, head, elem)
        L, L, L, L,                 # dy (batch, seq, head, elem)
        I, I, P]),                  # is_bf16, cuda_core (force), stream
    "pack": ("pack_fwd", [
        P, I,                       # K x (address, row stride, width,
                                    # column) as one host array, K
        P, L, L, P]),               # out, B, out row stride, stream
}

# launches per kernel: each wrapper adds one where it launches its kernel
LAUNCHES = {name: 0 for name in SIGNATURES}
# a kernel with several paths counts its launches by path in its library:
# kernel name -> (C function that copies out, and with reset zeroes, the
# counts, path names in its order); ``routes`` reads them
ROUTES = {"quant_matmul": ("quant_matmul_routes", ("decode", "wgmma", "fma")),
          "flash_attention": ("flash_attention_routes",
                              ("wgmma", "mma_sync", "cuda_core")),
          "ssd": ("ssd_routes", ("tensor_core", "cuda_core")),
          "flash_decode": ("flash_decode_routes", ("out", "lse")),
          "flash_attention_bwd": ("flash_attention_bwd_routes",
                                  ("wgmma", "cuda_core")),
          "ssd_bwd": ("ssd_bwd_routes", ("tensor_core", "cuda_core"))}

_LIBS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in ROUTES:
        routes(name, reset=True)


def routes(name: str, reset: bool = False) -> dict:
    """Launches of ``name`` by path since the last reset, as its launcher
    counted them (all 0 while its library is not loaded); ``reset`` zeroes
    them after reading."""
    fn, paths = ROUTES[name]
    counts = (ctypes.c_ulonglong * len(paths))()
    lib = _LIBS.get(name)
    if lib is not None:
        getattr(lib, fn)(counts, int(reset))
    return dict(zip(paths, counts))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine with the card")
    return nvcc


def _sources(name: str) -> list:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process, tmp, out) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)        # atomic: concurrent builders agree


def build_all(names=None) -> dict:
    """Build every kernel (or ``names``) in parallel; return their paths."""
    names = tuple(names or SIGNATURES)
    jobs = {n: _start(n) for n in names}
    try:
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        fn, argtypes = SIGNATURES[name]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        if name in ROUTES:
            getattr(lib, ROUTES[name][0]).argtypes = [P, I]
            getattr(lib, ROUTES[name][0]).restype = None
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
