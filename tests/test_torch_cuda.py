"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (an H100: the kernels are built for
sm_90a) and skips without one. The file imports torch and the port only, so
it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: bf16 2e-2; f32 1e-4 with TF32 off (the kernels sum in another
order than the plain version's einsum or matmul; SSD chunks where the plain
version steps); GAE 1e-5 (the kernel contracts
products into FMAs); one whole learn atol 1e-5, rtol 1e-4 (cuBLAS and the
CPU reduce in another order); pack exactly (it copies bytes).
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import make_host_engine
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.ocean import ocean_tcfg
from repro_torch.envs import ocean
from repro_torch.envs.ocean_host import HostBandit, HostTeam
from repro_torch.kernels import build, ops, ref
from repro_torch.models.policy import BackbonePolicy
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl import actor
from repro_torch.rl.engine import METRIC_KEYS, TrainEngine, act_transfer_spec
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
    assert build.LAUNCHES["ssd"] == 0
    assert build.LAUNCHES["quant_matmul"] == 0
    assert build.LAUNCHES["pack"] == 0


def _ssd_inputs(rng, B, T, H, hd, ds, dtype, layout):
    """SSD inputs as the JAX package's test_ssd_sweep draws them. ``layout``
    "dense"; "view" (x a slice of a wider row, as the conv output gives);
    "g1" (B_/C one group expanded over heads with stride 0); "g2" (two
    groups, head h reading group h // (H/2), copied)."""
    if layout == "view":
        x = (_randn(rng, (B, T, H * hd + 24), dtype) * 0.5)[
            ..., 8:8 + H * hd].unflatten(-1, (H, hd))
        assert not x.is_contiguous()
    else:
        x = _randn(rng, (B, T, H, hd), dtype) * 0.5
    dt = torch.nn.functional.softplus(_randn(rng, (B, T, H), torch.float32))
    A = -torch.exp(_randn(rng, (H,), torch.float32) * 0.3)
    G = {"g1": 1, "g2": 2}.get(layout, H)
    bc = [_randn(rng, (B, T, G, ds), dtype) * 0.5 for _ in range(2)]
    if layout == "g1":
        bc = [t.expand(B, T, H, ds) for t in bc]
    elif G != H:
        bc = [t.repeat_interleave(H // G, dim=2) for t in bc]
    return x, dt, A, bc[0], bc[1]


SSD_EDGES = [  # (B, T, H, hd, ds, chunk, layout)
    (2, 300, 4, 64, 128, 128, "dense"),    # ragged T
    (2, 1, 4, 64, 128, 128, "g1"),         # T = 1
    (3, 50, 4, 16, 16, 128, "view"),       # T < chunk
    (2, 200, 4, 64, 128, 128, "view"),     # non-contiguous x
    (2, 130, 8, 64, 128, 128, "g1"),       # stride-0 B_/C
    (2, 96, 4, 16, 16, 16, "g2"),          # two groups
    (1, 128, 2, 32, 16, 64, "dense"),      # test_ssd_sweep shapes
    (2, 64, 3, 16, 32, 16, "dense"),
    (1, 16, 1, 8, 8, 4, "dense"),
    (1, 70, 2, 128, 128, 128, "dense"),    # largest head dim and state
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,ds,chunk,layout", SSD_EDGES)
def test_ssd_kernel_matches_ref(B, T, H, hd, ds, chunk, layout, dtype,
                                no_tf32):
    rng = np.random.default_rng(T + hd)
    x, dt, A, B_, C = _ssd_inputs(rng, B, T, H, hd, ds, dtype, layout)
    want_y, want_h = ref.ssd(x, dt, A, B_, C)
    before = build.LAUNCHES["ssd"]
    y, h = ops.ssd(x, dt, A, B_, C, chunk=chunk)
    assert build.LAUNCHES["ssd"] == before + 1
    torch.cuda.synchronize()
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)


def test_ssd_kernel_raises_on_what_it_does_not_take():
    x = torch.zeros(1, 8, 2, 16, device="cuda")
    dt = torch.ones(1, 8, 2, device="cuda")
    A = -torch.ones(2, device="cuda")
    b = torch.zeros(1, 8, 2, 16, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        ops.ssd(x, dt.bfloat16(), A, b, b)
    with pytest.raises(TypeError, match="B_"):
        ops.ssd(x, dt, A, b.bfloat16(), b)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd(x, dt, A, b, b, chunk=256)
    big = torch.zeros(1, 8, 2, 256, device="cuda")
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd(x, dt, A, big, big)


def test_mamba2_generate_launches_ssd_once_per_layer():
    cfg = get_smoke_config("mamba2-1.3b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pol = BackbonePolicy(cfg, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (2, 37), generator=gen,
                           device="cuda")
    build.reset_launches()
    out = actor.generate(pol, prompt, 5, gen)
    torch.cuda.synchronize()
    assert out.shape == (2, 5)
    want = {"flash_attention": 0, "flash_decode": 0, "gae": 0,
            "ssd": cfg.num_layers, "quant_matmul": 0, "pack": 0}
    assert {k: build.LAUNCHES[k] for k in want} == want


QMM_EDGES = [  # (M, K, N, transposed, scale length or None, x row pad)
    (1, 1024, 1024, False, None, 0),       # M = 1
    (8, 1024, 2048, False, 128, 0),        # wq: a (hd,) scale tiled over H
    (5, 999, 1001, False, None, 24),       # ragged N, K; strided x
    (37, 1001, 999, True, None, 8),        # (N, K) layout, ragged, strided
    (300, 77, 130, False, None, 0),        # prefill tile, ragged M
    (200, 1024, 2048, False, 128, 0),      # prefill tile, tiled scale
    (17, 3, 5, False, None, 0),            # K and N below every tile
    (8, 4096, 64, False, None, 0),         # K split over a full cluster
    (8, 1024, 4099, True, None, 0),        # the unembed's layout, ragged V
]


def _qmm_inputs(rng, M, K, N, transposed, S, pad, qtype, dtype):
    qmax = 127 if qtype == "int8" else 7
    ints = torch.from_numpy(rng.integers(-qmax, qmax + 1, (N, K) if
                                         transposed else (K, N))
                            .astype(np.int8))
    w = ref.pack_int4(ints) if qtype == "int4" else ints
    S = S or (K if transposed else N)
    s = torch.from_numpy(np.abs(rng.standard_normal(S, np.float32))
                         / (qmax * K ** 0.5))
    x = _randn(rng, (M, K + pad), dtype)[:, pad // 2:pad // 2 + K]
    return x, w.cuda(), s.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", ["int8", "int4"])
@pytest.mark.parametrize("M,K,N,transposed,S,pad", QMM_EDGES)
def test_quant_matmul_kernel_matches_ref(M, K, N, transposed, S, pad, qtype,
                                         dtype, no_tf32):
    rng = np.random.default_rng(M + K + N)
    x, w, s = _qmm_inputs(rng, M, K, N, transposed, S, pad, qtype, dtype)
    _check("quant_matmul",
           lambda: ops.quant_matmul(x, w, s, transposed=transposed),
           ref.quant_matmul(x, w, s, transposed), dtype)


def test_quant_matmul_kernel_raises_on_what_it_does_not_take():
    x = torch.zeros(2, 8, device="cuda")
    w = torch.zeros(8, 6, dtype=torch.int8, device="cuda")
    s = torch.ones(6, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ops.quant_matmul(x, torch.zeros(6, 8, dtype=torch.int8,
                                        device="cuda").t(), s)
    with pytest.raises(ValueError, match="is on"):
        ops.quant_matmul(x, w.cpu(), s)
    with pytest.raises(TypeError, match="float32"):
        ops.quant_matmul(x, w, s.bfloat16())


@pytest.mark.parametrize("arch,qtype", [("qwen3-0.6b", "int8"),
                                        ("qwen3-0.6b", "int4"),
                                        ("mamba2-1.3b", "int8")])
def test_quantised_generate_launches_quant_matmul_on_every_matmul(arch,
                                                                  qtype):
    cfg = get_smoke_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pol = BackbonePolicy(cfg, generator=gen, quantize=qtype)
    prompt = torch.randint(0, cfg.vocab_size, (2, 37), generator=gen,
                           device="cuda")
    build.reset_launches()
    out = actor.generate(pol, prompt, 5, gen)
    torch.cuda.synchronize()
    assert out.shape == (2, 5)
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    mixer = 4 * attn + 2 * (cfg.num_layers - attn)   # wq wk wv wo | in, out
    per_forward = mixer + 2 * cfg.num_layers * (cfg.d_ff > 0) + 1
    want = {"quant_matmul": 5 * per_forward, "flash_attention": attn,
            "flash_decode": 4 * attn, "ssd": cfg.num_layers - attn,
            "gae": 0, "pack": 0}
    assert {k: build.LAUNCHES[k] for k in want} == want


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
    assert build.LAUNCHES["ssd"] == 0
    assert build.LAUNCHES["quant_matmul"] == 0
    assert build.LAUNCHES["pack"] == 0
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


def _pack_cases(rng):
    """Edge shapes: one leaf, 1-byte leaves, odd widths at offsets that are
    not 16-byte aligned, B = 1, empty leaves, a strided row view, a stride-0
    (broadcast) row, and more leaves than one launch holds."""
    def u8(B, n):
        return torch.from_numpy(rng.integers(0, 256, (B, n), dtype=np.uint8)
                                ).cuda()
    base = u8(300, 64)
    return {
        "one leaf": [u8(257, 48)],
        "1-byte leaves": [u8(100, 1) for _ in range(5)],
        "odd widths": [u8(333, 3), u8(333, 17), u8(333, 4), u8(333, 33)],
        "B = 1": [u8(1, 7), u8(1, 16), u8(1, 5)],
        "empty leaf": [u8(9, 4), u8(9, 0), u8(9, 12)],
        "strided view": [base[:, 5:21], base[:, 32:64], u8(300, 2)],
        "stride 0": [u8(1, 16).expand(50, 16), u8(50, 8)],
        "act step": [u8(64, 8), u8(64, 4), u8(64, 4)],
        "many leaves": [u8(70, 1 + i % 5) for i in range(75)],
    }


def test_pack_kernel_matches_ref_exactly():
    from repro_torch.kernels.pack import MAX_LEAVES
    for what, leaves in _pack_cases(np.random.default_rng(0)).items():
        before = build.LAUNCHES["pack"]
        got = ops.pack(leaves)
        nonempty = sum(t.shape[1] > 0 for t in leaves)
        assert build.LAUNCHES["pack"] == before + -(-nonempty // MAX_LEAVES)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, ref.pack(leaves)), \
            what
    empty = ops.pack([torch.zeros((0, 4), dtype=torch.uint8, device="cuda")])
    assert empty.shape == (0, 4)


def test_pack_kernel_raises_on_what_it_does_not_take():
    x = torch.zeros((4, 8), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="last stride"):
        ops.pack([x.t().contiguous().t()[:, :3]])
    with pytest.raises(ValueError, match="is on cpu"):
        ops.pack([x, x.cpu()])
    with pytest.raises(TypeError, match="uint8"):
        ops.pack([x.float()])


def test_host_tier_update_launches_pack_per_act_step_and_gae_once():
    """One host-tier update (bandit, N 8, unroll 8, threads): one pack per
    act step, one gae per update, nothing else; the act step's host arrays
    equal its device tensors byte for byte."""
    tcfg = TrainConfig(num_envs=8, unroll_length=8, update_epochs=1,
                       num_minibatches=2, learning_rate=1e-3, gamma=0.95)
    for env_fn in (HostBandit, HostTeam):
        e = make_host_engine(env_fn, tcfg, hidden=16)
        try:
            obs, _, done, _, ids = e.hvec.recv(timeout=30.0)
            state = e.generator.get_state()
            want = e._act(e.ts.params, torch.from_numpy(obs).cuda(), None,
                          torch.from_numpy(done).cuda(), e.generator)[:3]
            e.generator.set_state(state)
            spec = act_transfer_spec(e.hvec.act_spec)
            staging = torch.empty((e.batch_size, spec.total),
                                  dtype=torch.uint8, pin_memory=True)
            got = e._act_to_host(spec, obs, None, done, staging)[:3]
            for g, w in zip(got, want):
                assert g.tobytes() == w.cpu().numpy().tobytes()
            e.hvec.send(got[0], ids)
            build.reset_launches()
            e.act_steps = 0
            hist, _ = e.run(e.steps_per_update)
            torch.cuda.synchronize()
            assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
            assert build.LAUNCHES["pack"] == e.act_steps >= 8
            assert build.LAUNCHES["gae"] == 1
            assert all(build.LAUNCHES[k] == 0 for k in (
                "flash_attention", "flash_decode", "ssd", "quant_matmul"))
        finally:
            e.close()


def test_pool_tier_update_launches_gae_once_and_no_pack():
    tcfg = ocean_tcfg("squared", num_envs=256, unroll_length=16,
                      engine_backend="pool")
    tr = Trainer(ocean.Squared(), tcfg, hidden=64)
    tr.engine.run(tr.steps_per_update)          # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    hist, _ = tr.engine.run(2 * tr.steps_per_update)
    torch.cuda.synchronize()
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert build.LAUNCHES["gae"] == 2
    assert all(build.LAUNCHES[k] == 0 for k in (
        "pack", "flash_attention", "flash_decode", "ssd", "quant_matmul"))
