"""Port kernels (repro_torch.kernels) against the JAX package's kernels.

The same inputs, made with numpy from a seed, go through the JAX op (the
Pallas body in interpret mode, and the pure-jnp ``ref``) and through the
port's wrapper. On the CPU the wrapper runs its plain PyTorch version;
tests/test_torch_cuda.py holds the CUDA kernels against it on the card.
Tolerances are those of tests/test_kernels.py: f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.convert import to_torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (bit-exact)."""
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
    return a, to_torch(np.asarray(a))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


FA_SHAPES = [                      # tests/test_kernels.py sweep
    (1, 32, 2, 2, 16, 16, 16),     # MHA
    (2, 64, 4, 2, 32, 32, 32),     # GQA 2:1
    (1, 128, 8, 2, 64, 128, 64),   # GQA 4:1, uneven blocks
    (2, 64, 4, 1, 32, 16, 64),     # MQA
]
FD_SHAPES = [
    (2, 4, 2, 32, 64, 16),         # GQA 2:1
    (1, 8, 2, 64, 128, 32),        # GQA 4:1
    (3, 4, 4, 16, 64, 64),         # MHA, single block
    (2, 4, 1, 32, 96, 32),         # MQA
]


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,K,hd,bq,bk", FA_SHAPES)
def test_flash_attention_matches_jax(B, T, H, K, hd, bq, bk, dtype,
                                     jax_mode):
    rng = np.random.default_rng(B * T + H)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, T, H, hd), (B, T, K, hd), (B, T, K, hd)))
    want = jops.flash_attention(qj, kj, vj, causal=True, mode=jax_mode,
                                block_q=bq, block_k=bk)
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)
    _close(tops.flash_attention(q, k, v), want, dtype)


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("B,H,K,hd,S,bs", FD_SHAPES)
def test_flash_decode_matches_jax(B, H, K, hd, S, bs, frac, dtype, jax_mode):
    rng = np.random.default_rng(B * S + H)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, dtype) for s in
                                 ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    L = int(frac * (S - 1))
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(L, jnp.int32),
                             mode=jax_mode, block_s=bs)
    length = torch.tensor(L, dtype=torch.int32)
    got = flash_decode(q, k, v, length)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)
    _close(tops.flash_decode(q, k, v, length), want, dtype)


def test_flash_attention_ragged_tail_and_noncausal():
    """T not a multiple of the 64-row tile, and causal=False."""
    rng = np.random.default_rng(3)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s, "float32") for s in
                                 ((2, 77, 4, 32), (2, 77, 2, 32),
                                  (2, 77, 2, 32)))
    from repro.kernels import ref as jref
    for causal in (True, False):
        _close(flash_attention(q, k, v, causal=causal),
               jref.flash_attention(qj, kj, vj, causal=causal), "float32")


# -- dispatch -----------------------------------------------------------------

def test_dispatch_defaults_to_ref_on_cpu():
    assert dispatch.resolve("flash_attention", torch.device("cpu")) == "ref"
    assert dispatch.resolve("flash_decode", torch.device("cuda")) == "cuda"
    assert set(dispatch.implementations("flash_decode")) == {"ref", "cuda"}
    assert dispatch.OPS == ("flash_attention", "flash_decode",
                            "quant_matmul", "gae", "ssd", "pack")


@pytest.mark.parametrize("how", ["mode", "scope"])
def test_dispatch_cuda_on_cpu_tensors_raises(how):
    q = torch.zeros(1, 8, 2, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        if how == "mode":
            tops.flash_attention(q, k, k, mode="cuda")
        else:
            with dispatch.using("cuda"):
                tops.flash_decode(q[:, 0], k, k, torch.tensor(3))


def test_dispatch_scope_and_errors():
    q = torch.randn(1, 8, 2, 32)
    with dispatch.using("ref"):
        assert dispatch.resolve("flash_attention", q.device) == "ref"
        with pytest.raises(RuntimeError):
            with dispatch.using("cuda"):
                tops.flash_attention(q, q, q)
    with pytest.raises(KeyError):
        tops.flash_attention(q, q, q, mode="pallas")
    with pytest.raises(KeyError):
        dispatch.using("interpret").__enter__()
    assert set(dispatch.implementations("pack")) == {"ref", "cuda"}
    leaf = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(KeyError):
        tops.pack([leaf], mode="interpret")


def test_wrappers_check_arguments():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(TypeError):
        flash_attention(q, k.double(), k)
    with pytest.raises(ValueError, match="group"):
        flash_attention(torch.zeros(1, 8, 3, 32), k, k)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                        torch.zeros(1, 8, 2, 48))
    with pytest.raises(ValueError, match="dims"):
        flash_decode(q, k, k, torch.tensor(0))


def test_build_paths_carry_the_source_hash():
    paths = {n: build.library_path(n) for n in build.SIGNATURES}
    assert set(paths) == {"flash_attention", "flash_decode", "gae",
                          "ssd", "quant_matmul", "pack"}
    for name, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(name + "-")
    assert set(build.LAUNCHES) == set(build.SIGNATURES)
