"""The backward kernels' plain versions and arithmetic against ``jax.grad``.

``kernels/ref.py::flash_attention_bwd`` and ``ssd_bwd`` (autograd of the
plain forwards: what the CUDA kernels are held to on the card) against the
vector-Jacobian products of the reference's jnp functions
(``repro.kernels.ref``), from the same numpy inputs. Then the arithmetic of
``csrc/flash_attention_bwd.cu`` (P recomputed from the forward's LSE,
D = rowsum(do * o), dk and dv summed over a KV head's query heads) and of
``csrc/ssd_bwd.cu`` (h walked forward for dC and C . dC, G walked backward
for dx, dB_ and ddt, dt A's gradient carried as the scalar recurrence
q_t = q_{t+1} + dy_t . y_t - dt_t x_t . u_t), written out in torch step for
step, against the same (the SSD walks in f64, as the kernel takes them).
f32 inputs on the CPU; tolerances 1e-5 for attention and 1e-4 for SSD (the
f32 reference's recurrence over T in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd as ssd_mod

FA_CASES = [  # B, T, S, H, K, hd, causal
    (2, 16, 16, 4, 4, 16, True),     # MHA
    (2, 37, 37, 8, 2, 32, True),     # GQA, ragged T
    (1, 20, 20, 4, 1, 64, True),     # MQA
    (2, 24, 24, 4, 2, 128, True),
    (2, 20, 45, 4, 2, 32, True),     # S > T
    (2, 45, 20, 6, 2, 16, True),     # S < T, an odd group
    (2, 33, 17, 4, 4, 64, False),    # non-causal
    (1, 1, 1, 4, 2, 32, True)]       # one row


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _fa_inputs(B, T, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return (_np(rng, (B, T, H, hd)), _np(rng, (B, S, K, hd)),
            _np(rng, (B, S, K, hd)), _np(rng, (B, T, H, hd)))


def _jax_fa_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention(q, k, v, causal),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("B,T,S,H,K,hd,causal", FA_CASES)
def test_flash_attention_bwd_plain_matches_jax_grad(B, T, S, H, K, hd,
                                                    causal):
    q, k, v, do = _fa_inputs(B, T, S, H, K, hd, T * S + hd)
    want = _jax_fa_grads(q, k, v, do, causal)
    got = ref.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, do)),
                                  causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    # the wrapper takes the plain version for CPU tensors, and so does
    # autograd through ops.flash_attention
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa_mod.flash_attention_fwd(tq, tk, tv, causal, with_lse=True)
    got = fa_mod.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    for g, w in zip(torch.autograd.grad(o, (tq, tk, tv),
                                        torch.from_numpy(do)), want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,T,S,H,K,hd,causal", FA_CASES)
def test_flash_attention_lse_matches_jax(B, T, S, H, K, hd, causal):
    q, k, _, _ = _fa_inputs(B, T, S, H, K, hd, T + S)
    s = jnp.einsum("btkgh,bskh->bkgts",
                   jnp.asarray(q).reshape(B, T, K, H // K, hd),
                   jnp.asarray(k)) / np.sqrt(hd)
    if causal:
        s = jnp.where(jnp.arange(T)[:, None] >= jnp.arange(S)[None, :], s,
                      -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, T)
    o, lse = fa_mod.flash_attention_fwd(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(k), causal,
                                        with_lse=True)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)


def _fa_bwd_kernel_arithmetic(q, k, v, o, lse, do, causal, scale):
    """csrc/flash_attention_bwd.cu's algorithm: P = exp(scale s - lse) with
    the mask, D = rowsum(do * o), dS = P (do v^T - D); dq = scale dS k,
    dk = scale dS^T q and dv = P^T do summed over the group's heads."""
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    kh = k.repeat_interleave(G, dim=2)             # head h reads h // G
    vh = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, kh)
    keep = torch.ones(T, S, dtype=torch.bool)
    if causal:
        keep = torch.arange(T)[:, None] >= torch.arange(S)[None, :]
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), 0.0)
    D = (do * o).sum(-1).transpose(1, 2)           # (B, H, T)
    dp = torch.einsum("bthd,bshd->bhts", do, vh)
    ds = p * (dp - D[..., None])
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kh)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, q)
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    fold = lambda x: x.unflatten(2, (K, G)).sum(3)
    return dq, fold(dk), fold(dv)


@pytest.mark.parametrize("B,T,S,H,K,hd,causal", FA_CASES)
def test_flash_attention_bwd_kernel_arithmetic_matches_jax_grad(
        B, T, S, H, K, hd, causal):
    q, k, v, do = _fa_inputs(B, T, S, H, K, hd, T * S + hd)
    want = _jax_fa_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa_mod.flash_attention_fwd(tq, tk, tv, causal, with_lse=True)
    got = _fa_bwd_kernel_arithmetic(tq, tk, tv, o, lse, tdo, causal,
                                    1.0 / np.sqrt(hd))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


def _fa_bwd_wgmma_arithmetic(q, k, v, o, lse, do, causal, scale):
    """The wgmma route of csrc/flash_attention_bwd.cu (bf16 at head dims 64
    and 128) on bf16 q, k, v, do and the forward's bf16 o: S and dP from the
    bf16 operands with f32 sums, P = exp2(S scale log2 e - lse log2 e) and
    dS = P (dP - D) in f32 with D = rowsum(do * o); P and dS rounded to
    bf16 before dV = P^T do, dK = dS^T q and dQ = dS k (f32 sums), dk and
    dv folded over the group. Returns the f32 sums (scale applied) and P,
    dS for the bound."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    kh = k.repeat_interleave(G, dim=2)
    vh = v.repeat_interleave(G, dim=2)
    log2e = 1.4426950408889634
    s = torch.einsum("bthd,bshd->bhts", q, kh)
    keep = torch.ones(T, S, dtype=torch.bool)
    if causal:
        keep = torch.arange(T)[:, None] >= torch.arange(S)[None, :]
    p = torch.where(keep, torch.exp2(s * (scale * log2e)
                                      - (lse * log2e)[..., None]), 0.0)
    D = (do * o).sum(-1).transpose(1, 2)
    dp = torch.einsum("bthd,bshd->bhts", do, vh)
    ds = p * (dp - D[..., None])
    pb, dsb = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = scale * torch.einsum("bhts,bshd->bthd", dsb, kh)
    dk = scale * torch.einsum("bhts,bthd->bshd", dsb, q)
    dv = torch.einsum("bhts,bthd->bshd", pb, do)
    fold = lambda x: x.unflatten(2, (K, G)).sum(3)
    return (dq, fold(dk), fold(dv)), (p, ds)


@pytest.mark.parametrize("B,T,S,H,K,hd,causal",
                         FA_CASES + [(2, 40, 40, 8, 2, 64, True)])
def test_flash_attention_bwd_bf16_rounding_contract_matches_jax_grad(
        B, T, S, H, K, hd, causal):
    """The wgmma route's rounding of P and dS (and of the forward's o, from
    which D is taken) to bf16 holds to jax.grad of the reference in f32 on
    the same bf16 values, element by element within the bound that
    rounding implies: with u = 2^-8 (round to nearest bf16, 8 significant
    bits) |P' - P| <= u |P| and |dS' - dS| <= u |dS| + u |P| sum_d |do o|
    (D from the rounded o), so |dv' - dv| <= u |P|^T |do|,
    |dq' - dq| <= scale E |k| and |dk' - dk| <= scale E^T |q| with E that
    bound on dS; plus u |sum| for the kernel's bf16 output and 1e-5 of the
    largest gradient for f32 sums in another order. The error itself stays
    inside the card's bf16 gate (2e-2 of the largest gradient)."""
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    q, k, v, do = (bf(x) for x in _fa_inputs(B, T, S, H, K, hd, T * S + hd))
    want = _jax_fa_grads(*(x.float().numpy() for x in (q, k, v, do)), causal)
    scale = 1.0 / np.sqrt(hd)
    o, lse = fa_mod.flash_attention_fwd(q.float(), k.float(), v.float(),
                                        causal, with_lse=True)
    o = o.to(torch.bfloat16)             # the forward kernel's bf16 output
    got, (p, ds) = _fa_bwd_wgmma_arithmetic(q, k, v, o, lse, do, causal,
                                            scale)
    u = 2.0 ** -8
    G = H // K
    qf, kf, dof = (x.float().abs() for x in (q, k, do))
    kh = kf.repeat_interleave(G, dim=2)
    do_o = torch.einsum("bthd,bthd->bht", dof, o.float().abs())
    e_ds = u * ds.abs() + u * p.abs() * do_o[..., None]
    fold = lambda x: x.unflatten(2, (K, G)).sum(3)
    bound = (scale * torch.einsum("bhts,bshd->bthd", e_ds, kh),
             fold(scale * torch.einsum("bhts,bthd->bshd", e_ds, qf)),
             fold(u * torch.einsum("bhts,bthd->bshd", p.abs(), dof)))
    top = max(float(np.abs(w).max()) for w in want)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, bound):
        out = g.to(torch.bfloat16).float().numpy()   # the kernel's output
        tol = e.numpy() + u * g.abs().numpy() + 1e-5 * top
        assert float(np.abs(out - w).max()) <= 2e-2 * top, name
        np.testing.assert_array_less(np.abs(out - w), tol + 1e-12,
                                     err_msg=name)


SSD_CASES = [  # B, T, H, hd, ds, G, dh_last given
    (2, 37, 4, 16, 16, 1, False),    # T not a multiple of a chunk
    (2, 37, 4, 16, 16, 2, True),     # two groups
    (1, 1, 2, 8, 4, 1, True),        # one step
    (2, 24, 6, 12, 8, 3, False)]


def _ssd_inputs(B, T, H, hd, ds, G, seed):
    """x, dt > 0, A < 0, group-level B and C (B, T, G, ds), dy, dh_last."""
    rng = np.random.default_rng(seed)
    x = _np(rng, (B, T, H, hd))
    dt = np.log1p(np.exp(_np(rng, (B, T, H)))).astype(np.float32)
    A = (-np.exp(_np(rng, (H,)) * 0.3)).astype(np.float32)
    Bg, Cg = _np(rng, (B, T, G, ds)), _np(rng, (B, T, G, ds))
    dy, dh = _np(rng, (B, T, H, hd)), _np(rng, (B, H, hd, ds))
    return x, dt, A, Bg, Cg, dy, dh


def _jax_ssd_grads(x, dt, A, Bg, Cg, dy, dh, H):
    """jax.grad through the reference's oracle, B and C expanded per head by
    ``jnp.repeat`` as models/ssm.py does: (dx, ddt, dA, dBg, dCg)."""
    G = Bg.shape[2]

    def f(x, dt, A, Bg, Cg):
        rep = lambda t: jnp.repeat(t, H // G, axis=2)
        return jref.ssd(x, dt, A, rep(Bg), rep(Cg))

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, A, Bg, Cg)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


def _expand(t, H):
    B, T, G, ds = t.shape
    return t.unsqueeze(3).expand(B, T, G, H // G, ds).flatten(2, 3)


def _fold(t, G):
    """(B, T, H, ds) per-head gradients → (B, T, G, ds) group sums."""
    return t.unflatten(2, (G, -1)).sum(3)


@pytest.mark.parametrize("B,T,H,hd,ds,G,dh", SSD_CASES)
def test_ssd_bwd_plain_matches_jax_grad(B, T, H, hd, ds, G, dh):
    x, dt, A, Bg, Cg, dy, dh_last = _ssd_inputs(B, T, H, hd, ds, G, T + G)
    want = _jax_ssd_grads(x, dt, A, Bg, Cg, dy,
                          dh_last if dh else np.zeros_like(dh_last), H)
    tx, tdt, tA, tB, tC = map(torch.from_numpy, (x, dt, A, Bg, Cg))
    got = ref.ssd_bwd(tx, tdt, tA, _expand(tB, H), _expand(tC, H),
                      torch.from_numpy(dy),
                      torch.from_numpy(dh_last) if dh else None)
    got = list(got[:3]) + [_fold(got[3], G), _fold(got[4], G)]
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    # autograd through ops.ssd on CPU tensors, the expansion's backward
    # summing the groups, gives the same
    leaves = [t.clone().requires_grad_() for t in (tx, tdt, tA, tB, tC)]
    y, h = ops.ssd(*leaves[:3], _expand(leaves[3], H),
                   _expand(leaves[4], H))
    outs, grads = ([y, h], [torch.from_numpy(dy), torch.from_numpy(dh_last)]
                   ) if dh else ([y], [torch.from_numpy(dy)])
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"),
                          torch.autograd.grad(outs, leaves, grads), want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def _ssd_bwd_kernel_arithmetic(x, dt, A, B_, C, dy, dh_last):
    """csrc/ssd_bwd.cu's two walks for each (batch, head), in f64 from the
    f32 inputs on, as the kernel walks them; outputs in f32."""
    x, dt, A, B_, C, dy = (t.double() for t in (x, dt, A, B_, C, dy))
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    dx, dB, dC = (torch.zeros_like(t) for t in (x, B_, C))
    ddt, dA = torch.zeros_like(dt), torch.zeros_like(A)
    for b in range(Bb):
        for h in range(H):
            a = torch.exp(dt[b, :, h] * A[h])
            st, yd = x.new_zeros((P, N)), x.new_zeros(T)
            for t in range(T):                     # pass 1: h forward
                st = a[t] * st + dt[b, t, h] * torch.outer(x[b, t, h],
                                                           B_[b, t, h])
                dC[b, t, h] = st.T @ dy[b, t, h]
                yd[t] = C[b, t, h] @ dC[b, t, h]
            q = ((dh_last[b, h].double() * st).sum()
                 if dh_last is not None else 0.0)
            G = (dh_last[b, h].double() if dh_last is not None
                 else x.new_zeros((P, N)))
            a_next = 1.0
            for t in reversed(range(T)):           # pass 2: G backward
                G = a_next * G + torch.outer(dy[b, t, h], C[b, t, h])
                u = G @ B_[b, t, h]
                dB[b, t, h] = dt[b, t, h] * (G.T @ x[b, t, h])
                dx[b, t, h] = dt[b, t, h] * u
                xu = x[b, t, h] @ u
                q = q + yd[t] - dt[b, t, h] * xu
                ddt[b, t, h] = xu + A[h] * q
                dA[h] += dt[b, t, h] * q
                a_next = a[t]
    return tuple(t.float() for t in (dx, ddt, dA, dB, dC))


@pytest.mark.parametrize("B,T,H,hd,ds,G,dh", SSD_CASES)
def test_ssd_bwd_kernel_arithmetic_matches_jax_grad(B, T, H, hd, ds, G, dh):
    x, dt, A, Bg, Cg, dy, dh_last = _ssd_inputs(B, T, H, hd, ds, G,
                                                2 * T + G)
    want = _jax_ssd_grads(x, dt, A, Bg, Cg, dy,
                          dh_last if dh else np.zeros_like(dh_last), H)
    tB, tC = (_expand(torch.from_numpy(t), H) for t in (Bg, Cg))
    got = _ssd_bwd_kernel_arithmetic(
        torch.from_numpy(x), torch.from_numpy(dt), torch.from_numpy(A), tB,
        tC, torch.from_numpy(dy), torch.from_numpy(dh_last) if dh else None)
    got = list(got[:3]) + [_fold(got[3], G), _fold(got[4], G)]
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_backward_wrappers_check_their_arguments():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="do is"):
        fa_mod.flash_attention_bwd(q, k, k, q, None, q[:, :4])
    x = torch.zeros(1, 8, 2, 16)
    dt, A, Bc = torch.ones(1, 8, 2), -torch.ones(2), torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="dy is"):
        ssd_mod.ssd_bwd(x, dt, A, Bc, Bc, x[:, :4])
    with pytest.raises(ValueError, match="dh_last"):
        ssd_mod.ssd_bwd(x, dt, A, Bc, Bc, x, torch.zeros(1, 2, 16, 5))
