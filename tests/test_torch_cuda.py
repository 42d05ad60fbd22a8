"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (an H100: the kernels are built for
sm_90a) and skips without one. The file imports torch and the port only, so
it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: bf16 2e-2; f32 1e-4 with TF32 off (the kernels sum in another
order than the plain version's einsum or matmul; SSD chunks where the plain
version steps); GAE 1e-5 (the kernel contracts products into FMAs and
combines segments of T through their composed maps); one whole learn atol 1e-5, rtol 1e-4 (cuBLAS and the
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
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels import ssd as ssd_mod
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
@pytest.mark.parametrize("B,T,S,H,K,hd,causal", [
    (2, 200, 200, 4, 2, 32, True), (1, 130, 130, 8, 2, 64, True),
    (2, 256, 256, 16, 8, 128, True), (2, 64, 64, 4, 1, 16, True),
    (8, 512, 512, 16, 8, 128, True),     # the serve shape
    (2, 1, 1, 16, 8, 128, True),         # one row
    (2, 65, 65, 16, 8, 128, True),       # one row past a 64-row tile
    (2, 100, 300, 8, 2, 128, True),      # S > T
    (2, 130, 200, 8, 4, 64, False),      # non-causal, S > T
    (2, 200, 70, 4, 4, 32, False),       # non-causal, S < T
    (2, 96, 96, 4, 1, 128, True),        # MQA at hd 128
    (1, 64, 64, 4, 1, 16, False),        # MQA, non-causal, hd 16
    (2, 200, 200, 4, 4, 128, True),      # MHA: one head per wgmma block
    (2, 300, 150, 6, 2, 64, True),       # an odd group (3), S < T
    # head dims 256 (gemma-7b: 64-row K/V tiles) and 160 (stablelm-12b:
    # three TMA halves, the last zero-filled)
    (8, 512, 512, 16, 16, 256, True), (8, 512, 512, 32, 8, 160, True),
    (2, 200, 200, 16, 16, 256, True), (2, 130, 130, 32, 8, 160, True),
    (2, 1, 1, 16, 16, 256, True), (2, 100, 300, 8, 2, 160, True),
    (2, 150, 70, 4, 4, 256, False), (2, 96, 96, 6, 2, 160, True),
    (1, 65, 65, 4, 1, 256, True)])
def test_flash_attention_kernel_matches_ref(B, T, S, H, K, hd, causal, dtype,
                                            no_tf32):
    """Each call on the route ``fwd_route`` names, as the launcher counted
    it."""
    from repro_torch.kernels.flash_attention import NAME, fwd_route
    rng = np.random.default_rng(T * S)
    q, k, v = (_randn(rng, s, dtype) for s in
               ((B, T, H, hd), (B, S, K, hd), (B, S, K, hd)))
    build.routes(NAME, reset=True)
    _check("flash_attention",
           lambda: ops.flash_attention(q, k, v, causal=causal),
           ref.flash_attention(q, k, v, causal=causal), dtype)
    want = fwd_route(dtype, hd)
    assert build.routes(NAME) == {r: int(r == want) for r in
                                  build.ROUTES[NAME][1]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frac", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("B,H,K,hd,S", [(4, 16, 8, 128, 300),
                                        (2, 8, 2, 64, 100),
                                        # gemma-7b's and stablelm-12b's
                                        # caches at the serve shape; one
                                        # pair over a whole cluster (f32 at
                                        # hd 256 held to 5 blocks), G 8
                                        (8, 16, 16, 256, 576),
                                        (8, 32, 8, 160, 576),
                                        (1, 8, 1, 256, 577),
                                        (2, 16, 2, 160, 300)])
def test_flash_decode_kernel_matches_ref(B, H, K, hd, S, frac, dtype,
                                         no_tf32):
    rng = np.random.default_rng(S)
    q, k, v = (_randn(rng, s, dtype) for s in
               ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    length = torch.tensor(int(frac * (S - 1)), dtype=torch.int32,
                          device="cuda")
    _check("flash_decode", lambda: ops.flash_decode(q, k, v, length),
           ref.flash_decode(q, k, v, length), dtype)


def _fd_inputs(rng, B, S, H, K, hd, dtype):
    return tuple(_randn(rng, s, dtype) for s in
                 ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))


def _fd_check(q, k, v, L, dtype):
    length = torch.tensor(L, dtype=torch.int32, device="cuda")
    _check("flash_decode", lambda: ops.flash_decode(q, k, v, length),
           ref.flash_decode(q, k, v, length), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,K", [(8, 576, 8), (2, 100, 2), (1, 577, 1),
                                   (3, 1000, 4), (64, 300, 8)])
def test_flash_decode_kernel_at_the_split_edges(B, S, K, dtype, no_tf32):
    """length at 0, one split less one, one split, one more, and S - 1: the
    split rule's boundaries (S 100, 577 and 1000 are not multiples of 16;
    B 64 x K 8 fills the SMs with fewer splits)."""
    from repro_torch.kernels.flash_decode import plan
    split, n_split = plan(B, K, S)
    q, k, v = _fd_inputs(np.random.default_rng(S + B), B, S, 2 * K, K, 128,
                         dtype)
    for L in sorted({0, split - 1, split, split + 1, S - 1}):
        if L < S:
            _fd_check(q, k, v, L, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 20])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 160, 256])
def test_flash_decode_kernel_over_groups_and_head_dims(G, hd, dtype,
                                                       no_tf32):
    """Query heads a KV head from 1 to 20 (past one 16-head block), at
    every head dim."""
    B, S, K = 2, 200, 2
    q, k, v = _fd_inputs(np.random.default_rng(G * hd), B, S, G * K, K, hd,
                         dtype)
    _fd_check(q, k, v, 150, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_on_strided_views_is_deterministic(dtype,
                                                               no_tf32):
    """Caches laid out (B, K, S, hd) and viewed as (B, S, K, hd) (a head
    stride of S * hd, not hd), q a view of a wider row; two calls give the
    same bits."""
    rng = np.random.default_rng(7)
    B, S, H, K, hd = 4, 576, 16, 8, 128
    k, v = (_randn(rng, (B, K, S, hd), dtype).transpose(1, 2)
            for _ in range(2))
    q = _randn(rng, (B, H, hd + 64), dtype)[..., 32:32 + hd]
    assert k.stride(2) == S * hd and not q.is_contiguous()
    length = torch.tensor(S - 7, dtype=torch.int32, device="cuda")
    _check("flash_decode", lambda: ops.flash_decode(q, k, v, length),
           ref.flash_decode(q, k, v, length), dtype)
    first, again = (ops.flash_decode(q, k, v, length) for _ in range(2))
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [128, 160, 256])
def test_flash_decode_lse_route_matches_ref(hd, dtype, no_tf32):
    """The LSE route (the context-parallel decode's): one launch a call,
    counted on its route, ``out`` in f32 and, rounded to the dtype, bit for
    bit the call without it, within the dtype's tolerance of the plain
    version, ``lse`` within 1e-4 of its magnitude, at local lengths -1
    (nothing filled: 0 and -inf), 0, mid and S - 1."""
    B, S, H, K = 2, 300, 16, 8
    q, k, v = _fd_inputs(np.random.default_rng(hd), B, S, H, K, hd, dtype)
    for L in (-1, 0, S // 2, S - 1):
        length = torch.tensor(L, dtype=torch.int32, device="cuda")
        before = build.LAUNCHES["flash_decode"]
        routes = build.routes("flash_decode")
        out, lse = ops.flash_decode(q, k, v, length, with_lse=True)
        assert build.LAUNCHES["flash_decode"] == before + 1
        assert build.routes("flash_decode") == dict(routes,
                                                    lse=routes["lse"] + 1)
        w_out, w_lse = ref.flash_decode(q, k, v, length, with_lse=True)
        assert out.dtype == w_out.dtype == torch.float32
        assert torch.equal(out.to(dtype), ops.flash_decode(q, k, v, length))
        torch.testing.assert_close(out.float(), w_out.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        if L < 0:
            assert torch.equal(out, torch.zeros_like(out))
            assert bool(torch.isinf(lse).all() and (lse < 0).all())
        else:
            tol = 1e-4 * max(1.0, float(w_lse.abs().max()))
            torch.testing.assert_close(lse, w_lse, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [32_768, 524_288])
def test_flash_decode_over_several_clusters_a_pair(S, dtype, no_tf32):
    """B 1, K 8 (the LSE row's heads; jamba's long_500k length): a (batch,
    KV head) takes two clusters of 8 blocks, the last to finish merging
    both. Both routes against the plain version at lengths S - 1, the
    split's and the clusters' boundaries and one each side, and -1 (out 0,
    lse -inf); two calls bit for bit; the LSE route's out rounded to the
    cache's type is the plain route's."""
    from repro_torch.kernels.flash_decode import cluster, plan
    B, H, K, hd = 1, 16, 8, 128
    split, n_split = plan(B, K, S)
    cl = cluster(n_split)
    assert n_split == 2 * cl
    gen = torch.Generator(device="cuda").manual_seed(S)
    q = (3 * torch.randn((B, H, hd), generator=gen, device="cuda")).to(dtype)
    k, v = (torch.randn((B, S, K, hd), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    lengths = {S - 1, -1} | {e + d for e in (split, cl * split)
                             for d in (-1, 0, 1)}
    for L in sorted(lengths):
        length = torch.tensor(L, dtype=torch.int32, device="cuda")
        got = ops.flash_decode(q, k, v, length)
        out, lse = ops.flash_decode(q, k, v, length, with_lse=True)
        assert torch.equal(got, ops.flash_decode(q, k, v, length))
        assert torch.equal(out.to(dtype), got)
        w_out, w_lse = ref.flash_decode(q, k, v, length, with_lse=True)
        torch.testing.assert_close(out, w_out, atol=TOL[dtype],
                                   rtol=TOL[dtype])
        if L < 0:
            assert not out.any()
            assert bool(torch.isinf(lse).all() and (lse < 0).all())
        else:
            tol = 1e-4 * max(1.0, float(w_lse.abs().max()))
            torch.testing.assert_close(lse, w_lse, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8, 20])
@pytest.mark.parametrize("hd", [64, 128, 160, 256])
def test_flash_decode_several_clusters_over_groups_and_head_dims(G, hd, dtype,
                                                                 no_tf32):
    """B 1, K 1, S 2048: up to 16 clusters a (batch, KV head, head group),
    of 5 or 6 blocks where f32 at hd 256 caps the cluster, at every head
    dim and 1 to 20 query heads (three head groups)."""
    from repro_torch.kernels.flash_decode import cluster, plan
    B, S, K = 1, 2048, 1
    elem = 4 if dtype == torch.float32 else 2
    _, n_split = plan(B, K, S, 132, hd, elem, G)
    assert n_split > cluster(n_split, hd, elem, G)
    q, k, v = _fd_inputs(np.random.default_rng(G + hd), B, S, G * K, K, hd,
                         dtype)
    for L in (1000, S - 1):
        _fd_check(q, k, v, L, dtype)


def _parent_flash_attention():
    """The flash_attention module of the checkout at $REPRO_PARENT (the
    parent, unpacked with ``git archive``), bound to a build of its own
    sources (as tools/fa_bwd_ab.py loads an old tree), or None."""
    import importlib.util
    import os
    from pathlib import Path
    root = os.environ.get("REPRO_PARENT")
    if not root:
        return None
    mods = {}
    for name in ("build", "flash_attention"):
        path = Path(root) / "src/repro_torch/kernels" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mods["flash_attention"].build = mods["build"]
    return mods["flash_attention"]


@pytest.mark.parametrize("hd,H,K", [(64, 24, 24), (128, 16, 8), (160, 32, 8),
                                    (256, 16, 16)])
def test_flash_attention_launch_order_keeps_the_bits(hd, H, K):
    """The wgmma forward's launch order (batch row by batch row) only moves
    blocks: at each arch's prefill (musicgen-medium, qwen3-0.6b,
    stablelm-12b, gemma-7b; B 8 x T 512) out and lse repeat bit for bit and
    hold to the plain version; with $REPRO_PARENT a checkout of the parent
    (whose grid ran heaviest first over the whole launch), they are its
    build's bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    B, T = 8, 512
    gen = torch.Generator(device="cuda").manual_seed(hd)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               .to(torch.bfloat16) for s in ((B, T, H, hd), (B, T, K, hd),
                                             (B, T, K, hd)))

    def bits(mod):
        return (mod.flash_attention(q, k, v),
                *mod.flash_attention_fwd(q, k, v, True, with_lse=True))

    want = bits(fa)
    assert all(torch.equal(a, b) for a, b in zip(bits(fa), want))
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(want[0].float(),
                               ref.flash_attention(q, k, v).float(),
                               atol=tol, rtol=tol)
    parent = _parent_flash_attention()
    if parent is not None:
        assert all(torch.equal(a, b) for a, b in zip(bits(parent), want))


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
    (2, 300, 4, 48, 32, 100, "dense"),     # tensor cores at hd 48, chunk 100
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,ds,chunk,layout", SSD_EDGES)
def test_ssd_kernel_matches_ref(B, T, H, hd, ds, chunk, layout, dtype,
                                no_tf32):
    rng = np.random.default_rng(T + hd)
    x, dt, A, B_, C = _ssd_inputs(rng, B, T, H, hd, ds, dtype, layout)
    want_y, want_h = ref.ssd(x, dt, A, B_, C)
    before = build.LAUNCHES["ssd"]
    build.load("ssd")
    build.routes("ssd", reset=True)
    y, h = ops.ssd(x, dt, A, B_, C, chunk=chunk)
    assert build.LAUNCHES["ssd"] == before + 1
    torch.cuda.synchronize()
    want = ssd_mod.route(dtype, hd, ds, chunk, ssd_mod.alignment(x, B_, C))
    assert build.routes("ssd") == {r: int(r == want) for r in
                                   build.ROUTES["ssd"][1]}
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)


def _conv_inputs(rng, B, T, H, hd, ds, G, view):
    """bf16 SSD inputs as models/ssm.py hands them over: B_ and C slices of
    one (B, T, H*hd + 2*G*ds) conv-output row, head h reading group
    h // (H/G) (stride 0 over heads), and x a slice of the same row
    (``view``) or a dense tensor of its own."""
    bf = torch.bfloat16
    buf = _randn(rng, (B, T, H * hd + 2 * G * ds), bf) * 0.5
    x = buf[..., :H * hd].unflatten(-1, (H, hd)) if view else \
        _randn(rng, (B, T, H, hd), bf) * 0.5
    bc = [buf[..., H * hd + i * G * ds:H * hd + (i + 1) * G * ds]
          .unflatten(-1, (G, ds)).unsqueeze(-2)
          .expand(B, T, G, H // G, ds).flatten(-3, -2) for i in range(2)]
    dt = torch.nn.functional.softplus(_randn(rng, (B, T, H), torch.float32))
    A = -torch.exp(_randn(rng, (H,), torch.float32) * 0.3)
    return x, dt, A, bc[0], bc[1]


@pytest.mark.parametrize("view", [True, False], ids=["x_view", "x_dense"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("T", [1, 15, 127, 128, 129, 300, 2048])
def test_ssd_tensor_core_route_matches_ref(T, G, view):
    """mamba2's head dim, state and chunk on the tensor cores: T below a
    tile, about a chunk, ragged, and 16 chunks; one and two groups; x a view
    of the conv output or dense. The launcher must count the route."""
    rng = np.random.default_rng(T + 10 * G + view)
    args = _conv_inputs(rng, 2, T, 4, 64, 128, G, view)
    x, _, _, B_, C = args
    assert ssd_mod.route(torch.bfloat16, 64, 128, 128,
                         ssd_mod.alignment(x, B_, C)) == "tensor_core"
    build.load("ssd")
    build.routes("ssd", reset=True)
    y, h = ops.ssd(*args, chunk=128)
    torch.cuda.synchronize()
    assert build.routes("ssd") == {"tensor_core": 1, "cuda_core": 0}
    want_y, want_h = ref.ssd(*args)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_is_deterministic(dtype):
    """Two calls give the same bits, on either route."""
    rng = np.random.default_rng(5)
    x, dt, A, B_, C = _conv_inputs(rng, 2, 300, 4, 64, 128, 1, True)
    x, B_, C = x.to(dtype), B_.to(dtype), C.to(dtype)
    (y1, h1), (y2, h2) = (ops.ssd(x, dt, A, B_, C) for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


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
    (16, 1024, 1024, False, None, 0),      # decode: two full m-tiles
    (13, 1000, 2048, False, None, 8),      # ragged m-tile, K not a k-step
    (8, 1024, 777, False, None, 0),        # odd N: int4's last nibble
    (16, 1000, 999, True, None, 8),        # (N, K) decode, two m-tiles
    (8, 1024, 151936, True, None, 0),      # the unembed at decode
    (17, 1024, 1024, False, None, 0),      # the prefill tile's edges
    (65, 1000, 1024, False, None, 0),
    (129, 1024, 1001, False, None, 0),
    (200, 1024, 2048, False, None, 16),    # strided x, 16-byte aligned
    (200, 1024, 2048, False, None, 6),     # strided x, unaligned
    # decode rings reused: more k-steps a warp than the (K, N) ring's
    # slots (split 1 at N 16384; split 8 at K 8192), and K past the
    # (N, K) kernel's staged x * s (2048 / MT values), so it restages
    (8, 1024, 16384, False, None, 0),
    (8, 8192, 1024, False, None, 0),
    (8, 4096, 300, True, None, 0),
    (16, 2500, 300, True, None, 0),
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
    build.reset_launches()
    _check("quant_matmul",
           lambda: ops.quant_matmul(x, w, s, transposed=transposed),
           ref.quant_matmul(x, w, s, transposed), dtype)
    # the launcher took the route the wrapper's rule names
    want = qmm.route(M, dtype, transposed, *qmm.alignment(x, w))
    assert build.routes("quant_matmul") == {
        path: int(path == want) for path in build.ROUTES["quant_matmul"][1]}


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
    # bf16 x: every M = 2 call (4 decode steps, 5 unembeds) on the decode
    # kernel, the prefill's M = 74 matmuls on the wgmma prefill kernel
    assert build.routes("quant_matmul") == {
        "decode": 4 * (per_forward - 1) + 5, "wgmma": per_forward - 1,
        "fma": 0}


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


@pytest.mark.parametrize("done_p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("T", [1, 37, 64, 1000])
@pytest.mark.parametrize("B", [1, 31, 33, 4096, 10000])
def test_gae_kernel_over_envs_and_lengths(B, T, done_p):
    """Envs about a warp and past the card's blocks, T of one step, ragged
    segments, one chunk a segment (64) and streamed segments (1000); two
    calls give the same bits."""
    rng = np.random.default_rng(B + 7 * T + int(10 * done_p))
    r, v = (_randn(rng, (T, B), torch.float32) for _ in range(2))
    d = torch.from_numpy(rng.random((T, B)) < done_p).cuda()
    lv = _randn(rng, (B,), torch.float32)
    got = ops.gae(r.T, v.T, d.T, lv, 0.99, 0.95)
    _check("gae", lambda: ops.gae(r.T, v.T, d.T, lv, 0.99, 0.95),
           ref.gae(r.T, v.T, d.T, lv, 0.99, 0.95), "gae")
    assert torch.equal(got, ops.gae(r.T, v.T, d.T, lv, 0.99, 0.95))


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


def _u8_leaves(rng, B, widths):
    return [torch.from_numpy(rng.integers(0, 256, (B, n), dtype=np.uint8)
                             ).cuda() for n in widths]


@pytest.mark.parametrize("B,widths", [
    # leaf counts about the kernel's table sizes (4, 8, 32) and over one
    # launch (32), a 0-width leaf among them
    (70, [12]), (70, [4, 0, 8]), (70, [1 + i % 5 for i in range(8)]),
    (70, [i % 7 for i in range(32)]), (70, [i % 6 for i in range(33)]),
    (70, [i % 9 for i in range(75)]),
    # mixed access widths in one launch (rows of 80 and 64 bytes): 16-byte
    # leaves at 16-byte columns, 4-byte and 1-byte ones between them
    (100, [16, 32, 4, 12, 1, 3, 12]), (100, [16, 16, 4, 4, 1, 3, 4, 16]),
    # rows about a warp and the act step's B, and a full-size trajectory
    (1, [4, 4, 4]), (31, [4, 4, 4]), (33, [4, 4, 4]), (64, [4, 4, 4]),
    (262144, [16, 36])])
def test_pack_kernel_matches_ref_over_leaves_widths_and_rows(B, widths):
    from repro_torch.kernels.pack import MAX_LEAVES
    leaves = _u8_leaves(np.random.default_rng(B + len(widths)), B, widths)
    before = build.LAUNCHES["pack"]
    got = ops.pack(leaves)
    nonempty = sum(w > 0 for w in widths)
    assert build.LAUNCHES["pack"] == before + -(-nonempty // MAX_LEAVES)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, ref.pack(leaves))


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


# -- backward kernels (flash_attention_bwd, ssd_bwd) and the LSE output -------
# Held to their plain versions (``ref.*_bwd``: autograd of the plain forward)
# run in f32 on the same inputs (f32 copies of bf16 ones), at a tolerance
# relative to the largest gradient: bf16 2e-2 (the outputs are rounded to
# bf16, and D uses the forward's bf16 output), f32 1e-4 with TF32 off.

FA_BWD_CASES = [
    (8, 256, 256, 16, 8, 128, True),     # qwen3's training shape
    (2, 200, 200, 4, 2, 32, True), (1, 130, 130, 8, 2, 64, True),
    (2, 64, 64, 4, 1, 16, True),         # MQA at hd 16
    (2, 1, 1, 16, 8, 128, True),         # one row
    (2, 65, 65, 16, 8, 128, True),       # one row past a 64-row tile
    (2, 100, 300, 8, 2, 128, True),      # S > T
    (2, 130, 200, 8, 4, 64, False),      # non-causal, S > T
    (2, 200, 70, 4, 4, 32, False),       # non-causal, S < T
    (2, 96, 96, 4, 1, 128, True),        # MQA at hd 128
    (2, 300, 150, 6, 2, 64, True),       # an odd group (3), S < T
    # the wgmma route's tiling: T and S off the 64- and 128-row tiles in
    # both directions, MQA at hd 64, an odd group at hd 128, non-causal
    (1, 129, 129, 8, 2, 128, True), (2, 190, 77, 8, 4, 128, True),
    (2, 77, 190, 4, 2, 64, True), (2, 150, 150, 8, 1, 64, True),
    (2, 100, 100, 6, 2, 128, True), (2, 200, 90, 4, 2, 128, False),
    (1, 70, 250, 4, 4, 64, False),
    # head dims 256 (gemma-7b) and 160 (stablelm-12b), on wgmma in bf16
    # (the two consumers split the head dim) and on the CUDA cores in f32
    # (32-row tiles at 256): the training shapes, T off the tiles, one row,
    # S != T, non-causal, an odd group; T and S off the 64-row tile in
    # both directions, MQA
    (8, 256, 256, 16, 16, 256, True), (8, 256, 256, 32, 8, 160, True),
    (2, 200, 200, 16, 16, 256, True), (2, 130, 130, 32, 8, 160, True),
    (2, 1, 1, 16, 16, 256, True), (2, 100, 300, 8, 2, 160, True),
    (2, 150, 70, 4, 4, 256, False), (2, 96, 96, 6, 2, 160, True),
    (2, 65, 65, 8, 8, 256, True), (1, 63, 63, 8, 2, 160, True),
    (2, 190, 77, 4, 2, 256, True), (2, 77, 190, 8, 4, 160, True),
    (2, 129, 129, 4, 1, 256, True), (2, 200, 90, 8, 8, 160, False)]


def _grad_close(name, got, want, tol, scale=None):
    """max |got - want| within tol of ``scale``, by default the largest
    |want|."""
    err = float((got.float() - want.float()).abs().max())
    scale = scale or max(float(want.float().abs().max()), 1e-6)
    assert torch.isfinite(got.float()).all(), name
    assert err <= tol * scale, f"{name}: max abs err {err}, max |grad| " \
                               f"{scale}, tol {tol} of it"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,K,hd,causal", FA_BWD_CASES)
def test_flash_attention_lse_matches_ref(B, T, S, H, K, hd, causal, dtype,
                                         no_tf32):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    rng = np.random.default_rng(T + S + hd)
    q, k, v = (_randn(rng, s, dtype) for s in
               ((B, T, H, hd), (B, S, K, hd), (B, S, K, hd)))
    o, lse = flash_attention_fwd(q, k, v, causal, with_lse=True)
    o2, none = flash_attention_fwd(q, k, v, causal)
    assert none is None and torch.equal(o, o2)
    want = ref.flash_attention_lse(q, k, causal)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,K,hd,causal", FA_BWD_CASES)
def test_flash_attention_bwd_matches_ref(B, T, S, H, K, hd, causal, dtype,
                                         no_tf32):
    """Through autograd: ops.flash_attention launches the forward kernel
    (with its LSE) and, in backward, the backward kernel, once each."""
    rng = np.random.default_rng(T * S + hd)
    q, k, v = (_randn(rng, s, dtype).requires_grad_() for s in
               ((B, T, H, hd), (B, S, K, hd), (B, S, K, hd)))
    do = _randn(rng, (B, T, H, hd), dtype)
    before = dict(build.LAUNCHES)
    o = ops.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert build.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   do.float(), causal=causal)
    # relative to the largest of the three (dq is 0 where a row sees one
    # key, as at T = 1: its error there is rounding in do . (v - o))
    scale = max(float(w.abs().max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _grad_close(name, g, w, TOL[dtype], scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(16, 8, 128), (16, 16, 256),
                                    (32, 8, 160)])
def test_flash_attention_bwd_is_deterministic(H, K, hd, dtype):
    """At qwen3's, gemma-7b's and stablelm-12b's training shapes (B 8, T
    256)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, s, dtype) for s in
               ((8, 256, H, hd), (8, 256, K, hd), (8, 256, K, hd)))
    do = _randn(rng, (8, 256, H, hd), dtype)
    o, lse = flash_attention_fwd(q, k, v, True, with_lse=True)
    first, again = (flash_attention_bwd(q, k, v, o, lse, do)
                    for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 32),
                                      (torch.bfloat16, 16),
                                      (torch.bfloat16, 160),
                                      (torch.bfloat16, 256),
                                      (torch.float32, 128),
                                      (torch.float32, 64),
                                      (torch.float32, 256)])
def test_flash_attention_bwd_routes(dtype, hd):
    """Every bf16 call at head dims 64, 128, 160 and 256 runs the wgmma
    kernels, hd 16 and 32 and f32 the CUDA-core ones, as the launcher
    counted them."""
    from repro_torch.kernels.flash_attention import (BWD, bwd_route,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)
    rng = np.random.default_rng(hd)
    q = _randn(rng, (2, 100, 4, hd), dtype)
    k, v = (_randn(rng, (2, 100, 2, hd), dtype) for _ in range(2))
    do = _randn(rng, (2, 100, 4, hd), dtype)
    o, lse = flash_attention_fwd(q, k, v, True, with_lse=True)
    build.routes(BWD, reset=True)
    for _ in range(3):
        flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = bwd_route(dtype, hd)
    assert want == ("wgmma" if dtype == torch.bfloat16
                    and hd in (64, 128, 160, 256) else "cuda_core")
    assert build.routes(BWD) == {r: 3 * (r == want)
                                 for r in ("wgmma", "cuda_core")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,K", [(128, 8), (64, 2), (256, 16), (160, 8)])
def test_flash_attention_bwd_on_strided_views(hd, K, dtype, no_tf32):
    """q, k, v as views of one fused projection (B, T, (H + 2K) hd), and a
    transposed, non-contiguous do (a (B, H, T, hd) tensor seen as
    (B, T, H, hd)) that TMA reads as it lies; then a broadcast do (what a
    sum's backward hands over), made contiguous by the wrapper. Each
    against the same call on contiguous copies: the same bits."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    rng = np.random.default_rng(hd + K)
    B, T, H = 2, 150, 16
    qkv = _randn(rng, (B, T, (H + 2 * K) * hd), dtype)
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    k = qkv[..., H * hd:(H + K) * hd].unflatten(-1, (K, hd))
    v = qkv[..., (H + K) * hd:].unflatten(-1, (K, hd))
    do = _randn(rng, (B, H, T, hd), dtype).transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous() or do.is_contiguous())
    o, lse = flash_attention_fwd(q, k, v, True, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    dense = flash_attention_bwd(q.contiguous(), k.contiguous(),
                                v.contiguous(), o, lse, do.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, dense))
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   do.float())
    scale = max(float(w.abs().max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _grad_close(name, g, w, TOL[dtype], scale)
    ones = torch.ones((), dtype=dtype, device="cuda").expand(B, T, H, hd)
    got = flash_attention_bwd(q, k, v, o, lse, ones)
    dense = flash_attention_bwd(q, k, v, o, lse, ones.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, dense))


def _ssd_train_inputs(rng, B, T, H, hd, ds, G, view, dtype):
    """SSD inputs as models/ssm.py hands them over in training, in
    ``dtype``: B_ and C slices of one conv-output row expanded over heads
    (stride 0 with one group), x a slice of the same row or dense."""
    buf = _randn(rng, (B, T, H * hd + 2 * G * ds), dtype) * 0.5
    x = buf[..., :H * hd].unflatten(-1, (H, hd)) if view else \
        _randn(rng, (B, T, H, hd), dtype) * 0.5
    bc = [buf[..., H * hd + i * G * ds:H * hd + (i + 1) * G * ds]
          .unflatten(-1, (G, ds)).unsqueeze(-2)
          .expand(B, T, G, H // G, ds).flatten(-3, -2) for i in range(2)]
    dt = torch.nn.functional.softplus(_randn(rng, (B, T, H), torch.float32))
    A = -torch.exp(_randn(rng, (H,), torch.float32) * 0.3)
    return x, dt, A, bc[0], bc[1]


SSD_BWD_CASES = [  # B, T, H, hd, ds, G, x a view, dh_last given
    (8, 256, 64, 64, 128, 1, True, False),     # mamba2's training shape
    (2, 300, 4, 64, 128, 1, True, False), (2, 1, 4, 64, 128, 1, True, True),
    (3, 50, 4, 16, 16, 1, False, True), (2, 96, 4, 16, 16, 2, True, False),
    (2, 64, 3, 16, 32, 3, False, False), (1, 70, 2, 128, 128, 1, False, True),
    (2, 129, 4, 48, 32, 2, True, False),
    # the tensor cores' 64-step chunks: T one short, whole, one past, two
    # and one past; head dims 16 to 64 beside states 16, 32 and 128
    (2, 63, 4, 64, 128, 1, True, True), (2, 64, 4, 32, 128, 2, True, False),
    (2, 65, 4, 16, 32, 1, False, True), (2, 129, 4, 64, 16, 1, True, False),
    (1, 129, 2, 48, 128, 1, False, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,ds,G,view,dh", SSD_BWD_CASES)
def test_ssd_bwd_matches_ref(B, T, H, hd, ds, G, view, dh, dtype, no_tf32):
    """Through autograd: ops.ssd launches the forward kernel and, in
    backward, the backward kernel, once each, on the route
    ``ssd.bwd_route`` names (as the launcher counted it); the gradients of
    the stride-0 B_ and C reach their group's columns."""
    rng = np.random.default_rng(T + hd + ds)
    x, dt, A, B_, C = _ssd_train_inputs(rng, B, T, H, hd, ds, G, view,
                                        dtype)
    leaves = [t.detach().requires_grad_() for t in (x, dt, A)]
    bc = [t.detach()[..., ::H // G, :].contiguous().requires_grad_()
          for t in (B_, C)]      # one row a group: the heads' expansion
    expand = lambda t: t.unsqueeze(-2).expand(
        B, T, G, H // G, ds).flatten(-3, -2)
    dy = _randn(rng, (B, T, H, hd), dtype)
    dh_last = _randn(rng, (B, H, hd, ds), torch.float32) if dh else None
    before = dict(build.LAUNCHES)
    build.load("ssd_bwd")
    build.routes("ssd_bwd", reset=True)
    Bx, Cx = expand(bc[0]), expand(bc[1])
    y, h = ops.ssd(*leaves, Bx, Cx)
    outs, grads = ([y, h], [dy, dh_last]) if dh else ([y], [dy])
    got = torch.autograd.grad(outs, leaves + bc, grads)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssd"] == before["ssd"] + 1
    assert build.LAUNCHES["ssd_bwd"] == before["ssd_bwd"] + 1
    want_route = ssd_mod.bwd_route(dtype, hd, ds,
                                   ssd_mod.alignment(leaves[0], Bx, Cx))
    assert want_route == ("tensor_core" if dtype == torch.bfloat16
                          and hd <= 64 else "cuda_core")
    assert build.routes("ssd_bwd") == {r: int(r == want_route)
                                       for r in ("tensor_core", "cuda_core")}
    f = [t.detach().float().requires_grad_() for t in leaves + bc]
    with torch.enable_grad():
        wy, wh = ref.ssd(*f[:3], expand(f[3]), expand(f[4]))
        want = torch.autograd.grad(
            [wy, wh] if dh else [wy], f,
            [dy.float(), dh_last] if dh else [dy.float()])
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape
        _grad_close(name, g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_is_deterministic(dtype):
    """At mamba2's training shape (B 8, T 256, H 64, P 64, N 128, x a view,
    stride-0 B_/C): bf16 on the tensor cores, f32 on the CUDA cores."""
    rng = np.random.default_rng(9)
    args = _ssd_train_inputs(rng, 8, 256, 64, 64, 128, 1, True, dtype)
    dy = _randn(rng, (8, 256, 64, 64), dtype)
    build.load("ssd_bwd")
    build.routes("ssd_bwd", reset=True)
    first, again = (ssd_mod.ssd_bwd(*args, dy) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    assert build.routes("ssd_bwd") == {r: 2 * (r == want)
                                       for r in ("tensor_core", "cuda_core")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["x_unaligned", "dy_transposed"])
def test_ssd_bwd_on_strided_layouts(layout, dtype, no_tf32):
    """x a view one element off 16 bytes takes the CUDA cores whatever its
    dtype; a transposed dy ((B, H, T, P) seen as (B, T, H, P)) is read as
    it lies, bit for bit with a contiguous copy, on the route of the call's
    dtype; both against the plain version."""
    rng = np.random.default_rng(17)
    B, T, H, hd, ds = 2, 130, 4, 64, 128
    x, dt, A, B_, C = _ssd_train_inputs(rng, B, T, H, hd, ds, 1, True, dtype)
    dy = _randn(rng, (B, T, H, hd), dtype)
    if layout == "x_unaligned":
        x = _randn(rng, (B, T, H * hd + 1), dtype)[..., 1:].unflatten(
            -1, (H, hd))
    else:
        dy = _randn(rng, (B, H, T, hd), dtype).transpose(1, 2)
        assert not dy.is_contiguous()
    want_route = ssd_mod.bwd_route(dtype, hd, ds,
                                   ssd_mod.alignment(x, B_, C))
    assert want_route == ("tensor_core" if dtype == torch.bfloat16
                          and layout == "dy_transposed" else "cuda_core")
    build.load("ssd_bwd")
    build.routes("ssd_bwd", reset=True)
    got = ssd_mod.ssd_bwd(x, dt, A, B_, C, dy)
    dense = ssd_mod.ssd_bwd(x, dt, A, B_, C, dy.contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, dense))
    assert build.routes("ssd_bwd") == {r: 2 * (r == want_route)
                                       for r in ("tensor_core", "cuda_core")}
    want = ref.ssd_bwd(x.float(), dt, A, B_.float(), C.float(), dy.float())
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _grad_close(name, g, w, TOL[dtype])



def test_flash_decode_smem_matches_the_plan_mirror():
    """csrc's smem_bytes, by flash_decode_smem, equals the one plan reads,
    at every instance, split and group."""
    import ctypes
    from repro_torch.kernels import flash_decode as fd
    fn = build.load("flash_decode").flash_decode_smem
    fn.argtypes = [ctypes.c_int] * 4
    for hd in (16, 32, 64, 128, 160, 256):
        for elem in (2, 4):
            for n in range(1, 9):
                for G in (1, 4, 8, 20):
                    assert fn(hd, int(elem == 2), n, G) == \
                        fd.smem_bytes(n, hd, elem, G), (hd, elem, n, G)


# -- the data-parallel tier (shard_map) at world size 1 over NCCL -------------

def _shard_engine(name, backend, selfplay):
    from repro_torch.league.selfplay import SelfPlay
    em, dist, pol = ocean_policy_stack(getattr(ocean, name)(), hidden=32)
    sp = None
    if selfplay:
        opp = pol.init(torch.Generator(device="cuda").manual_seed(7))
        sp = SelfPlay(lambda: opp)
    tcfg = TrainConfig(num_envs=64, unroll_length=16, update_epochs=2,
                       num_minibatches=2, learning_rate=1e-3, gamma=0.95)
    return TrainEngine(em, pol, tcfg, dist, seed=0, backend=backend,
                       updates_per_launch=2, selfplay=sp)


@pytest.mark.parametrize("name,selfplay", [("Squared", False),
                                           ("Duel", True)])
def test_shard_map_nccl_world_size_1_is_the_jit_tier(name, selfplay,
                                                     no_tf32):
    """The shard_map tier makes its own NCCL group of one rank and is the
    jit tier bit for bit: params, AdamW moments, carry and metrics; one gae
    launch an update on both."""
    import torch.distributed as dist
    out = {}
    for backend in ("jit", "shard_map"):
        eng = _shard_engine(name, backend, selfplay)
        try:
            if backend == "shard_map":
                assert dist.get_backend() == "nccl"
            before = build.LAUNCHES["gae"]
            hist, _ = eng.run(4 * eng.steps_per_update)
            torch.cuda.synchronize()
            assert build.LAUNCHES["gae"] - before == 4
            out[backend] = (hist, tree_leaves(eng.ts.params)
                            + tree_leaves(eng.ts.opt.m)
                            + tree_leaves(eng.ts.opt.v) + [eng.rc.obs])
        finally:
            eng.close()
    assert not dist.is_initialized()
    (ha, la), (hb, lb) = out["jit"], out["shard_map"]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert [[h[k] for k in METRIC_KEYS] for h in ha] == \
        [[h[k] for k in METRIC_KEYS] for h in hb]


def test_shard_map_on_cuda_refuses_a_gloo_group():
    import datetime

    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=30))
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs nccl"):
            _shard_engine("Squared", "shard_map", False)
    finally:
        dist.destroy_process_group()


def test_launcher_profile_names_the_gae_kernel(tmp_path):
    """--profile through the launcher on the card: the trace's CUDA kernel
    events name the gae kernel."""
    import json

    from repro_torch.launch import train as train_cli
    prof = tmp_path / "prof"
    train_cli.main(["--ocean", "squared", "--engine-backend", "shard_map",
                    "--num-envs", "64", "--total-env-steps",
                    str(4 * 64 * 64), "--full-budget", "--ckpt-dir",
                    str(tmp_path / "ck"), "--profile", str(prof),
                    "--profile-launches", "3"])
    (trace,) = prof.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("gae_kernel" in n for n in names) >= 2, names[:20]


# -- the LM plan at world size 1 over NCCL, and remat="dots" ------------------

def _lm_cfg(arch, **kw):
    from repro_torch.configs import with_overrides
    return with_overrides(get_smoke_config(arch), num_layers=2, **kw)


def test_plan_at_world_size_one_over_nccl_is_the_unsharded_step_bitwise():
    """jamba's smoke stack (an SSM + MLP and an attention + MoE layer), bf16,
    two steps on a 1x1 mesh over NCCL against the unsharded steps: params,
    moments and metrics bit for bit, with the collectives live."""
    import torch.distributed as dist

    from repro_torch.data.buffer import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.rl.learner import init_train_state, make_lm_train_step
    cfg = _lm_cfg("jamba-v0.1-52b")
    own = tmesh.init_process_group(torch.device("cuda"))
    try:
        assert dist.get_backend() == "nccl"
        mesh = tmesh.make_mesh((1, 1), ("data", "model"))
        out = []
        for m in (None, mesh):
            pol = BackbonePolicy(cfg, generator=torch.Generator(
                device="cuda").manual_seed(0), mesh=m)
            step = make_lm_train_step(pol, TrainConfig(), loss_chunk=16)
            st = init_train_state(pol.params())
            shd.reset_collectives()
            ms = []
            for i in range(2):
                st, mt = step(st, random_batch(cfg, 4, 32, torch.Generator(
                    device="cuda").manual_seed(10 + i)))
                ms.append(mt)
            out.append((st, ms, dict(shd.COLLECTIVES)))
        (a, ma, _), (b, mb, coll) = out
        assert coll["all_gather"] > 0 and coll["reduce_scatter"] > 0
        for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt.m),
                        tree_leaves(b.params) + tree_leaves(b.opt.m)):
            assert torch.equal(x, y)
        for x, y in zip(ma, mb):
            assert all(torch.equal(x[k], y[k]) for k in x)
    finally:
        if own:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b"])
def test_remat_dots_gradients_match_full_on_the_kernels(arch, no_tf32):
    """f32, the attention and SSD kernels forward and backward: the
    gradients of one seq under "dots" against "full" within 1e-5 of each
    leaf's largest, and flash_attention / ssd run again under both."""
    grads, launches = {}, {}
    for remat in ("full", "dots"):
        cfg = _lm_cfg(arch, remat=remat, dtype="float32",
                      param_dtype="float32")
        toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(1))
        pol = BackbonePolicy(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0))
        p = pol.params()
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_()
        build.reset_launches()
        with torch.enable_grad():
            logits, v, _ = pol.seq(p, toks)
            loss = logits.logsumexp(-1).mean() + v.square().mean()
            grads[remat] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launches[remat] = dict(build.LAUNCHES)
    op = "flash_attention" if arch == "qwen3-0.6b" else "ssd"
    assert launches["dots"][op] == launches["full"][op] == 4
    for g, w in zip(grads["dots"], grads["full"]):
        assert float((g - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-30)


# -- kernels first called from a new thread, the audit and conformance --------

def test_tma_kernels_launch_first_from_a_new_thread(no_tf32):
    """CUDA's tensor-map encoder needs a current context, which a
    thread that has launched nothing yet (autograd's device thread) may
    lack: the wgmma attention backward and forward and quant_matmul's
    wgmma route, each first called from a fresh thread (and then once more
    there, where the context is already bound), and the backward through
    autograd at a small shape, held to the plain version."""
    import threading
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    q = _randn(rng, (1, 64, 4, 128), bf)
    k, v = (_randn(rng, (1, 64, 2, 128), bf) for _ in range(2))
    do = _randn(rng, (1, 64, 4, 128), bf)
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa.flash_attention_fwd(q, k, v, True, with_lse=True)
    x = _randn(rng, (512, 1024), bf)
    w = torch.from_numpy(rng.integers(-127, 128, (1024, 1024),
                                      dtype=np.int8)).cuda()
    s = torch.from_numpy(rng.random(1024, dtype=np.float32) * 0.02).cuda()
    errors = []

    def run(f):
        try:
            f()
            f()
            torch.cuda.synchronize()
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    for f in (lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
              lambda: fa.flash_attention_fwd(q, k, v, True, with_lse=True),
              lambda: qmm.quant_matmul(x, w, s)):
        t = threading.Thread(target=run, args=(f,))
        t.start()
        t.join()
    assert not errors, errors
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, causal=True), ins, do)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   do.float(), causal=True)
    scale = max(float(g.abs().max()) for g in want)
    for g, r in zip(got, want):
        assert float((g.float() - r).abs().max()) <= TOL[bf] * scale


def test_audit_all_on_cuda_is_clean():
    from repro_torch.analysis import audit_all
    audits = audit_all(device="cuda")
    assert [v.render() for a in audits for v in a.violations] == []
    assert all(a.syncs == 0 and a.copies == 0 for a in audits)
    assert sum(a.target.startswith("kernel:") for a in audits) == 8


def test_conformance_on_cuda():
    from repro_torch.envs.conformance import run_cli
    assert run_cli("all", device="cuda") == 0
    assert run_cli("duel", selfplay=True, device="cuda") == 0
