"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (an H100: the kernels are built for
sm_90a) and skips without one. The file imports torch and the port only, so
it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: bf16 2e-2; f32 1e-4 with TF32 off (the kernels sum in another
order than the plain version's einsum).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build, ops, ref
from repro_torch.models.policy import BackbonePolicy
from repro_torch.rl import actor

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card (H100)")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _randn(rng, shape, dtype):
    x = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device="cuda", dtype=dtype)


def _check(op, got, want, dtype):
    before = build.LAUNCHES[op]
    out = got()
    assert build.LAUNCHES[op] == before + 1
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,K,hd", [(2, 200, 4, 2, 32), (1, 130, 8, 2, 64),
                                        (2, 256, 16, 8, 128),
                                        (2, 64, 4, 1, 16)])
def test_flash_attention_kernel_matches_ref(B, T, H, K, hd, dtype, no_tf32):
    rng = np.random.default_rng(T)
    q, k, v = (_randn(rng, s, dtype) for s in
               ((B, T, H, hd), (B, T, K, hd), (B, T, K, hd)))
    _check("flash_attention", lambda: ops.flash_attention(q, k, v),
           ref.flash_attention(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frac", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("B,H,K,hd,S", [(4, 16, 8, 128, 300),
                                        (2, 8, 2, 64, 100)])
def test_flash_decode_kernel_matches_ref(B, H, K, hd, S, frac, dtype,
                                         no_tf32):
    rng = np.random.default_rng(S)
    q, k, v = (_randn(rng, s, dtype) for s in
               ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    length = torch.tensor(int(frac * (S - 1)), dtype=torch.int32,
                          device="cuda")
    _check("flash_decode", lambda: ops.flash_decode(q, k, v, length),
           ref.flash_decode(q, k, v, length), dtype)


def test_flash_decode_length_must_be_a_device_tensor():
    q = torch.zeros(1, 4, 32, device="cuda")
    k = torch.zeros(1, 8, 2, 32, device="cuda")
    with pytest.raises(TypeError, match="length"):
        ops.flash_decode(q, k, k, torch.tensor(3, dtype=torch.int32))


def test_generate_launches_both_kernels(no_tf32):
    cfg = get_smoke_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pol = BackbonePolicy(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (2, 70), generator=gen,
                           device="cuda")
    build.reset_launches()
    out = actor.generate(pol, prompt, 5, gen)
    torch.cuda.synchronize()
    assert out.shape == (2, 5)
    assert build.LAUNCHES == {"flash_attention": cfg.num_layers,
                              "flash_decode": cfg.num_layers * 4}
