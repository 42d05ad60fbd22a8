"""The quant_matmul wrapper's route rule, and the decode kernel's (N, K)
arithmetic emulated on the CPU against JAX.

``route`` names the kernel path of each CUDA call from M, x's dtype, the
weight's layout and ``alignment``'s two flags (which read the strides and
base addresses); ``launch_m`` in csrc/quant_matmul.cu applies the same rule
to the same arguments and counts the route each launch took, which
``build.routes("quant_matmul")`` reads, beside ``build.LAUNCHES`` (the card
tests hold the two rules together call by call). On the CPU the wrapper
takes the plain version and counts nothing.

The emulation repeats the bf16 decode kernel's arithmetic for the tied
unembed, whose scale lies on K: x · s taken in f32 and split into bf16
``hi + lo``, each product with the integer weight exact in f32, the two
sums added in f32. It is held to JAX's ``x @ (E_q · s).T`` at 1e-4 in f32
(``|x s − hi − lo| <= 2^-16 |x s|``) and at the kernel's bf16 tolerance of
2e-2 once rounded to bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.models.convert import to_torch

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,dtype,transposed,vec,vec_x,want", [
    (8, BF, False, True, True, "decode"),      # every decode projection
    (8, BF, True, True, True, "decode"),       # the tied unembed
    (16, BF, False, False, False, "decode"),   # any strides at decode
    (1, BF, True, False, True, "decode"),
    (17, BF, False, True, True, "wgmma"),      # the prefill kernel
    (4096, BF, False, True, True, "wgmma"),
    (4096, BF, False, True, False, "fma"),     # x beyond TMA: CUDA cores
    (4096, BF, False, False, True, "fma"),     # weight beyond TMA
    (17, BF, False, False, False, "fma"),
    (4096, BF, True, True, True, "fma"),       # (N, K) at prefill
    (8, F32, False, True, True, "fma"),        # f32 x: the CUDA cores
    (4096, F32, False, True, True, "fma"),
])
def test_route_rule(M, dtype, transposed, vec, vec_x, want):
    assert qmm.route(M, dtype, transposed, vec, vec_x) == want


def test_alignment_reads_strides_and_base():
    buf = torch.zeros(200, 1040, dtype=BF)
    assert buf.data_ptr() % 16 == 0
    assert qmm.alignment(buf[:, :1024], buf.new_zeros(1, 16,
                                                      dtype=torch.int8)) \
        == (True, True)
    x_al, x_un = buf[:, 8:1032], buf[:, 3:1027]      # 16 B, 6 B offsets
    w = torch.zeros(1024, 1008, dtype=torch.int8)
    assert qmm.alignment(x_al, w) == (True, True)
    assert qmm.alignment(x_un, w)[1] is False
    assert qmm.alignment(buf[:, :1024].t(), w)[1] is False  # column-major
    assert qmm.alignment(torch.zeros(8, 1027, dtype=BF)[:, :1024], w)[1] \
        is False                                     # row stride 2054 B
    assert qmm.alignment(torch.zeros(8, 1028)[:, :1024], w)[1] is True
    assert qmm.alignment(x_al, w[1:])[0] is True     # base + 1008 B
    assert qmm.alignment(x_al, w[:, 1:])[0] is False
    assert qmm.alignment(x_al, torch.zeros(1024, 1001,
                                           dtype=torch.int8))[0] is False
    # overlapping rows: a stride-0 x, a weight whose rows overlap
    assert qmm.alignment(buf[0, :1024].expand(200, 1024), w)[1] is False
    assert qmm.alignment(x_al, w.as_strided((1024, 1008), (16, 1)))[0] \
        is False


def test_routes_are_read_from_the_launcher(monkeypatch):
    fn, paths = build.ROUTES["quant_matmul"]
    assert paths == ("decode", "wgmma", "fma")   # the C side's order
    assert build.routes("quant_matmul") == dict.fromkeys(paths, 0)
    taken, resets = [4, 1, 2], []

    def copy(counts, reset):     # the library's quant_matmul_routes
        resets.append(reset)
        for i, n in enumerate(taken):
            counts[i] = n
        if reset:
            taken[:] = [0] * len(taken)

    monkeypatch.setitem(build._LIBS, "quant_matmul",
                        type("Lib", (), {fn: staticmethod(copy)})())
    assert build.routes("quant_matmul") == {"decode": 4, "wgmma": 1,
                                            "fma": 2}
    build.LAUNCHES["quant_matmul"] = 7
    build.reset_launches()
    assert resets == [0, 1]
    assert build.LAUNCHES["quant_matmul"] == 0
    assert build.routes("quant_matmul") == dict.fromkeys(paths, 0)


def test_cpu_call_takes_the_plain_version_and_counts_nothing():
    build.reset_launches()
    x = torch.randn(8, 64, dtype=BF)
    w = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    s = torch.rand(32)
    torch.testing.assert_close(qmm.quant_matmul(x, w, s),
                               ref.quant_matmul(x, w, s), atol=0, rtol=0)
    assert build.LAUNCHES["quant_matmul"] == 0
    assert set(build.routes("quant_matmul").values()) == {0}


def _hi_lo_unembed(x, e, s):
    """x (M, K) bf16, e (V, K) integers, s (K,) f32: the decode kernel's
    (N, K) arithmetic; also returns the sum of the hi terms alone."""
    xs = x.float() * s
    hi = xs.to(BF).float()
    lo = (xs - hi).to(BF).float()
    w = e.float()
    return hi @ w.T + lo @ w.T, hi @ w.T


@pytest.mark.parametrize("M", [8, 13])
@pytest.mark.parametrize("qmax", [127, 7])
def test_unembed_hi_lo_arithmetic_matches_jax(M, qmax):
    rng = np.random.default_rng(M + qmax)
    V, K = 300, 1000
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(BF)
    ints = rng.integers(-qmax, qmax + 1, (V, K)).astype(np.int8)
    s = np.abs(rng.standard_normal(K, np.float32)) * 2 / (qmax * K ** 0.5)
    xj = jnp.asarray(x.float().numpy())
    want = np.asarray(xj @ (jnp.asarray(ints, jnp.float32)
                            * jnp.asarray(s)[None, :]).T)
    got, hi_only = _hi_lo_unembed(x, torch.from_numpy(ints),
                                  torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.to(BF).float().numpy(),
                               to_torch(np.asarray(jnp.asarray(want)
                                                   .astype(jnp.bfloat16)))
                               .float().numpy(), atol=2e-2, rtol=2e-2)
    # the lo term is what keeps it exact: the hi terms alone are further off
    err = np.abs(got.numpy() - want).max()
    assert err * 16 < np.abs(hi_only.numpy() - want).max()
