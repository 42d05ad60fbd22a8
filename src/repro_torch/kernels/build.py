"""Build the CUDA C++ kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

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
        P, P, P, P,                 # q, k, v, o
        I, I, I, I, I, I,           # B, T, S, H, K, hd
        L, L, L, L, L, L, L, L, L,  # q/k/v strides (batch, seq, head)
        I, I, F, P]),               # is_bf16, causal, scale, stream
    "flash_decode": ("flash_decode_fwd", [
        P, P, P, P, P,              # q, k, v, length (device int32), o
        I, I, I, I, I,              # B, S, H, K, hd
        L, L, L, L, L, L, L, L,     # q (batch, head), k/v (batch, seq, head)
        I, F, P]),                  # is_bf16, scale, stream
    "gae": ("gae_fwd", [
        P, P, P, P, P,              # rewards, values, dones (u8), last, out
        I, I,                       # B, T
        L, L, L, L, L, L,           # r/v/dones strides (env, time)
        L, L, L,                    # last_value stride, out (env, time)
        F, F, P]),                  # gamma, lam, stream
    "ssd": ("ssd_fwd", [
        P, P, P, P, P, P, P,        # x, dt, A, B_, C, y, h_last
        I, I, I, I, I, I,           # B, T, H, hd, ds, chunk
        L, L, L, L, L, L, L, L,     # x (batch, seq, head, elem), dt (b, s, h), A
        L, L, L, L, L, L, L, L,     # B_ and C (batch, seq, head, elem)
        I, P]),                     # is_bf16, stream
    "quant_matmul": ("quant_matmul_fwd", [
        P, P, P, P,                 # x, w_q, scale, out
        I, I, I,                    # M, N, K
        L, L, L,                    # x strides (row, col), w_q row (bytes)
        I, I, I, I, I, I, P]),      # scale length, is_bf16, is_int4,
                                    # transposed, vec16 (w, x), stream
    "pack": ("pack_fwd", [
        P, P, P, P, I,              # leaf pointers, row strides, widths,
                                    # column offsets (host arrays), K
        P, L, L, P]),               # out, B, out row stride, stream
}

# launches per kernel: each wrapper adds one where it launches its kernel
LAUNCHES = {name: 0 for name in SIGNATURES}

_LIBS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
