"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (an H100: the kernels are built for
sm_90a) and skips without one. The file imports torch and the port only, so
it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: bf16 2e-2; f32 1e-4 with TF32 off (the kernels sum in another
order than the plain version's einsum); GAE 1e-5 (the kernel contracts
products into FMAs); one whole learn atol 1e-5, rtol 1e-4 (cuBLAS and the
CPU reduce in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.ocean import ocean_tcfg
from repro_torch.envs import ocean
from repro_torch.kernels import build, ops, ref
from repro_torch.models.policy import BackbonePolicy
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl import actor
from repro_torch.rl.engine import METRIC_KEYS, TrainEngine
from repro_torch.rl.learner import epoch_perms
from repro_torch.rl.trainer import Trainer, ocean_policy_stack

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card (H100)")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, "gae": 1e-5}


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
    assert build.LAUNCHES["flash_attention"] == cfg.num_layers
    assert build.LAUNCHES["flash_decode"] == cfg.num_layers * 4
    assert build.LAUNCHES["gae"] == 0


@pytest.mark.parametrize("done_p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("B,T", [(4096, 64), (1000, 37)])
def test_gae_kernel_matches_ref_on_time_major_inputs(B, T, done_p):
    """The learner's call: (B, T) views of (T, B)-stored trajectories."""
    rng = np.random.default_rng(B + T)
    r, v = (_randn(rng, (T, B), torch.float32) for _ in range(2))
    d = torch.from_numpy(rng.random((T, B)) < done_p).cuda()
    lv = _randn(rng, (B,), torch.float32)
    _check("gae", lambda: ops.gae(r.T, v.T, d.T, lv, 0.99, 0.95),
           ref.gae(r.T, v.T, d.T, lv, 0.99, 0.95), "gae")


def test_gae_kernel_raises_on_what_it_does_not_take():
    r = torch.zeros(4, 8, device="cuda")
    d = torch.zeros(4, 8, dtype=torch.bool, device="cuda")
    lv = torch.zeros(4, device="cuda")
    with pytest.raises(TypeError, match="bool"):
        ops.gae(r, r, d.float(), lv, 0.99, 0.95)
    with pytest.raises(TypeError, match="float32"):
        ops.gae(r.double(), r, d, lv, 0.99, 0.95)


def test_trainer_launch_runs_one_gae_kernel_per_update_without_sync():
    tcfg = ocean_tcfg("squared", num_envs=256, unroll_length=16)
    tr = Trainer(ocean.Squared(), tcfg, hidden=64)
    tr.engine.launch(1)                       # warm-up: builds, caches
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ring = tr.engine.launch(3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert build.LAUNCHES["gae"] == 3
    assert build.LAUNCHES["flash_attention"] == 0
    assert build.LAUNCHES["flash_decode"] == 0
    assert bool(torch.isfinite(ring).all())


def _to(x, device):
    """Tensors of a nested NamedTuple / tuple / dict, moved to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [_to(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@pytest.mark.parametrize("name,recurrent", [("bandit", False),
                                            ("memory", True)])
def test_learn_on_the_card_matches_the_cpu(name, recurrent, no_tf32):
    """One whole learn from the same rollout and permutations, on the card
    (GAE kernel, the recurrent branch's carry gathers and ``seq``) and on
    the CPU (plain GAE): the same params, moments and metrics."""
    tcfg = TrainConfig(num_envs=64, unroll_length=16, update_epochs=2,
                       num_minibatches=4, learning_rate=1e-3, gamma=0.95)
    em, dist, pol = ocean_policy_stack(ocean.OCEAN[name](), hidden=32,
                                       recurrent=recurrent)
    eng = TrainEngine(em, pol, tcfg, dist, seed=0, device="cpu")
    rc, _ = eng.update.collect(eng.ts, eng.rc, eng.generator)  # live carry
    _, batch = eng.update.collect(eng.ts, rc, eng.generator)
    assert bool(batch[1].dones.any()), "no episode ends in the data"
    B = eng.vec.batch_size
    n = B if recurrent else tcfg.unroll_length * B
    perms = epoch_perms(eng.generator, n, tcfg.update_epochs,
                        tcfg.num_minibatches)
    cpu_ts, cpu_m = eng.update.learn(eng.ts, *batch, perms=perms)
    build.reset_launches()
    gpu_ts, gpu_m = eng.update.learn(_to(eng.ts, "cuda"), *_to(batch, "cuda"),
                                     perms=perms.cuda())
    torch.cuda.synchronize()
    assert build.LAUNCHES["gae"] == 1
    tol = dict(atol=1e-5, rtol=1e-4)
    for got, want in zip(tree_leaves({"p": gpu_ts.params, "m": gpu_ts.opt.m}),
                         tree_leaves({"p": cpu_ts.params, "m": cpu_ts.opt.m})):
        torch.testing.assert_close(got.cpu(), want, **tol)
    for k in METRIC_KEYS:
        torch.testing.assert_close(gpu_m[k].cpu(), cpu_m[k], msg=k, **tol)
