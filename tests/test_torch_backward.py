"""The backward kernels' plain versions and arithmetic against ``jax.grad``.

``kernels/ref.py::flash_attention_bwd`` and ``ssd_bwd`` (autograd of the
plain forwards: what the CUDA kernels are held to on the card) against the
vector-Jacobian products of the reference's jnp functions
(``repro.kernels.ref``), from the same numpy inputs. Then the arithmetic of
``csrc/flash_attention_bwd.cu`` (P recomputed from the forward's LSE,
D = rowsum(do * o), dk and dv summed over a KV head's query heads) and of
``csrc/ssd_bwd.cu``'s CUDA-core route (h walked forward for dC and C . dC,
G walked backward for dx, dB_ and ddt, dt A's gradient carried as the
scalar recurrence q_t = q_{t+1} + dy_t . y_t - dt_t x_t . u_t), written out
in torch step for step, against the same (the SSD walks in f64, as the
kernel takes them), and of its tensor-core route (the chunked backward,
dt A's gradient from four direct sums), exact at chunks 16, 64 and 128 and
with the kernel's bf16 roundings within the bound they imply. f32 inputs
on the CPU; tolerances 1e-5 for attention and 1e-4 for SSD (the f32
reference's recurrence over T in another order).
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
    """The wgmma route of csrc/flash_attention_bwd.cu (bf16 at head dims 64,
    128, 160 and 256) on bf16 q, k, v, do and the forward's bf16 o: S and
    dP from the bf16 operands with f32 sums, P = exp2(S scale log2 e - lse
    log2 e) and dS = P (dP - D) in f32 with D = rowsum(do * o); P and dS
    rounded to bf16 before dV = P^T do, dK = dS^T q and dQ = dS k (f32
    sums), dk and dv folded over the group. Returns the f32 sums (scale
    applied) and P, dS for the bound. Above hd 128 the kernel's two
    consumers split the output's head dim and each computes S and dP over
    the whole of it: the same arithmetic, column by column (D's f32 sum is
    taken in two halves there, an order this f32 sum does not fix)."""
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


# head dims 256 (gemma-7b) and 160 (stablelm-12b), whose two consumers
# split the head dim: G 1, G 4, odd groups, S != T, non-causal
FA_WIDE_CASES = [
    (2, 20, 20, 4, 4, 256, True),    # G 1
    (1, 24, 24, 8, 2, 160, True),    # G 4
    (2, 21, 21, 6, 2, 256, True),    # an odd group (3)
    (1, 17, 30, 3, 1, 160, True),    # an odd group (3), S > T
    (2, 33, 17, 4, 4, 160, False)]   # non-causal, S < T


@pytest.mark.parametrize("B,T,S,H,K,hd,causal",
                         FA_CASES + [(2, 40, 40, 8, 2, 64, True)]
                         + FA_WIDE_CASES)
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


def _ssd_bwd_chunked(x, dt, A, B_, C, dy, dh_last, Q, rounded=False):
    """The tensor-core route of csrc/ssd_bwd.cu, in f64 (the kernel's sums
    are f32): the states entering each chunk of Q steps recomputed forward,
    then the chunks walked backward carrying dh, with u = (S o L)^T dy +
    v B dh^T, dC = dS B + e^cum dy h_prev, dB = dS^T C + w x dh, dh_prev =
    e^{cum_Q} dh + dy^T e^cum C, and dl from its four direct sums (the
    rectangle sum of M = S dS over i >= t > j, the suffix sum of
    C_i . dC_state_i, the prefix sum of dt_j x_j . u_state_j, and
    e^{cum_Q} <dh, h_prev>). With ``rounded``, the kernel's roundings: x w
    once to bf16 (u = 2^-8), h_prev, dh, S o L, dS and dy e^cum as bf16
    hi + lo (u^2), dx, dB and dC out in bf16; then it also returns a
    first-order bound on each output's error from those roundings,
    propagated through absolute values. Returns (dx, ddt, dA, dB_, dC) in
    the inputs' layout and the bounds (zeros without ``rounded``)."""
    u = 2.0 ** -8
    bf = lambda t: t.to(torch.bfloat16).double()
    if rounded:
        one = lambda t: (bf(t), u * t.abs())
        hilo = lambda t: (bf(t) + bf(t - bf(t)), u * u * t.abs())
    else:
        one = hilo = lambda t: (t, torch.zeros_like(t))
    ab = torch.abs
    ein = torch.einsum
    x, dy, Bm, Cm = (t.double().permute(0, 2, 1, 3) for t in (x, dy, B_, C))
    dt = dt.double().permute(0, 2, 1)
    A = A.double()
    Bb, H, T, P = x.shape
    N = Bm.shape[-1]
    nc = -(-T // Q)
    pad = nc * Q - T
    x, dy, Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                     .unflatten(2, (nc, Q)) for t in (x, dy, Bm, Cm))
    dt = torch.nn.functional.pad(dt, (0, pad)).unflatten(2, (nc, Q))
    cum = (dt * A[None, :, None, None]).cumsum(-1)      # (B, H, nc, Q)
    cq = cum[..., -1]
    idx = torch.arange(Q)
    low = idx[:, None] >= idx[None, :]                  # i >= j
    rect = ((idx[None, :, None] >= idx[:, None, None])  # [t, i, j]:
            & (idx[None, None, :] < idx[:, None, None])).double()  # j<t<=i
    suffix = (idx[None, :] >= idx[:, None]).double()    # [t, i]: i >= t
    prefix = (idx[None, :] < idx[:, None]).double()     # [t, j]: j < t

    states, h = [], torch.zeros(Bb, H, P, N, dtype=torch.float64)
    eh = torch.zeros_like(h)
    for c in range(nc):                     # the states entering each chunk
        states.append((h, eh))
        w = torch.exp(cq[:, :, c, None] - cum[:, :, c]) * dt[:, :, c]
        xw, exw = one(x[:, :, c] * w[..., None])
        eq = torch.exp(cq[:, :, c])[..., None, None]
        h = eq * h + ein("bhjp,bhjn->bhpn", xw, Bm[:, :, c])
        eh = eq * eh + ein("bhjp,bhjn->bhpn", exw, ab(Bm[:, :, c]))

    outs = [torch.zeros_like(t) for t in (x, dt, Bm, Cm)]  # dx ddt dB dC
    errs = [torch.zeros_like(t) for t in outs]
    dA = torch.zeros(H, dtype=torch.float64)
    edA = torch.zeros_like(dA)
    dh = (dh_last.double() if dh_last is not None
          else torch.zeros(Bb, H, P, N, dtype=torch.float64))
    edh = torch.zeros_like(dh)
    for c in reversed(range(nc)):
        xc, yc, bc, cc, dtc, ci = (t[:, :, c] for t in (x, dy, Bm, Cm, dt,
                                                        cum))
        hp, ehp = states[c]
        hpr, ehr = hilo(hp)
        ehp = ehp + ehr
        dhr, edr = hilo(dh)
        edr = edr + edh
        diff = ci[..., :, None] - ci[..., None, :]
        L = torch.where(low, torch.exp(torch.where(low, diff, 0.0)), 0.0)
        S = ein("bhin,bhjn->bhij", cc, bc)
        G = ein("bhip,bhjp->bhij", yc, xc)
        dS = G * L * dtc[..., None, :]
        M = S * dS
        SLr, eSL = hilo(S * L)
        dSr, edS = hilo(dS)
        v = torch.exp(cq[:, :, c, None] - ci)
        w = v * dtc
        ust = v[..., None] * ein("bhjn,bhpn->bhjp", bc, dhr)
        eust = v[..., None] * ein("bhjn,bhpn->bhjp", ab(bc), edr)
        uu = ein("bhij,bhip->bhjp", SLr, yc) + ust
        eu = ein("bhij,bhip->bhjp", eSL, ab(yc)) + eust
        dx, edx = dtc[..., None] * uu, dtc[..., None] * eu
        xu, exu = (xc * uu).sum(-1), (ab(xc) * eu).sum(-1)
        dB = (ein("bhij,bhin->bhjn", dSr, cc)
              + w[..., None] * ein("bhjp,bhpn->bhjn", xc, dhr))
        edB = (ein("bhij,bhin->bhjn", edS, ab(cc))
               + w[..., None] * ein("bhjp,bhpn->bhjn", ab(xc), edr))
        ec = torch.exp(ci)[..., None]
        dCs = ec * ein("bhip,bhpn->bhin", yc, hpr)
        edCs = ec * ein("bhip,bhpn->bhin", ab(yc), ehp)
        dC = ein("bhij,bhjn->bhin", dSr, bc) + dCs
        edC = ein("bhij,bhjn->bhin", edS, ab(bc)) + edCs
        ev, eev = (cc * dCs).sum(-1), (ab(cc) * edCs).sum(-1)
        fv = dtc * (xc * ust).sum(-1)
        efv = dtc * (ab(xc) * eust).sum(-1)
        eqc = torch.exp(cq[:, :, c])
        k4 = eqc * (dh * hpr).sum((-2, -1))
        ek4 = eqc * ((ab(dh) * ehp).sum((-2, -1))
                     + (edh * ab(hpr)).sum((-2, -1)))
        dl = (ein("tij,bhij->bht", rect, M) + ein("ti,bhi->bht", suffix, ev)
              + ein("tj,bhj->bht", prefix, fv) + k4[..., None])
        edl = (ein("ti,bhi->bht", suffix, eev)
               + ein("tj,bhj->bht", prefix, efv) + ek4[..., None])
        ddt = xu + A[None, :, None] * dl
        eddt = exu + ab(A)[None, :, None] * edl
        dA = dA + (dtc * dl).sum((0, 2))
        edA = edA + (dtc * edl).sum((0, 2))
        for k, (o, e) in enumerate(((dx, edx), (ddt, eddt), (dB, edB),
                                    (dC, edC))):
            outs[k][:, :, c], errs[k][:, :, c] = o, e
        dye, edye = hilo(yc * ec)
        dh = eqc[..., None, None] * dh + ein("bhip,bhin->bhpn", dye, cc)
        edh = (eqc[..., None, None] * edh
               + ein("bhip,bhin->bhpn", edye, ab(cc)))
    for k in (0, 2, 3):                     # dx, dB, dC out in bf16
        if rounded:
            errs[k] = errs[k] + u * outs[k].abs()
            outs[k] = bf(outs[k])
    back = lambda t: t.flatten(2, 3)[:, :, :T].transpose(1, 2)
    got, bound = ([back(o[0]), back(o[1]), d, back(o[2]), back(o[3])]
                  for o, d in ((outs, dA), (errs, edA)))
    return got, bound


SSD_CHUNKED_CASES = [  # Q (the backward's chunk), B, T, H, G, dh_last given
    (16, 2, 32, 6, 1, True), (16, 1, 31, 6, 2, False),
    (16, 2, 33, 6, 3, True), (16, 1, 5, 6, 1, False), (16, 2, 1, 6, 2, True),
    (64, 1, 128, 6, 3, False), (64, 2, 63, 6, 1, True),
    (64, 1, 65, 6, 2, True), (64, 2, 20, 6, 3, False),
    (64, 1, 1, 6, 1, False),
    (128, 1, 256, 6, 2, True), (128, 1, 127, 6, 3, False),
    (128, 2, 129, 6, 1, False), (128, 1, 50, 6, 2, True),
    (128, 1, 1, 6, 3, True)]


@pytest.mark.parametrize("Q,B,T,H,G,dh", SSD_CHUNKED_CASES)
def test_ssd_bwd_chunked_arithmetic_matches_jax_grad(Q, B, T, H, G, dh):
    """The tensor-core route's chunked backward, exact (f64, no rounding),
    at chunks 16, 64 and 128 with T a multiple of the chunk, one off either
    way, below it and 1; one to three groups; with and without dh_last:
    its rectangle sums for dl, the state terms and dh_prev give jax.grad."""
    x, dt, A, Bg, Cg, dy, dh_last = _ssd_inputs(B, T, H, 16, 16, G,
                                                3 * T + Q + G)
    want = _jax_ssd_grads(x, dt, A, Bg, Cg, dy,
                          dh_last if dh else np.zeros_like(dh_last), H)
    tB, tC = (_expand(torch.from_numpy(t), H) for t in (Bg, Cg))
    got, _ = _ssd_bwd_chunked(
        torch.from_numpy(x), torch.from_numpy(dt), torch.from_numpy(A), tB,
        tC, torch.from_numpy(dy), torch.from_numpy(dh_last) if dh else None,
        Q)
    got = list(got[:3]) + [_fold(got[3], G), _fold(got[4], G)]
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("B,T,H,hd,ds,G,dh", [
    (2, 256, 4, 64, 128, 1, False),     # mamba2's widths, 4 chunks of 64
    (1, 129, 4, 32, 32, 2, True),       # a ragged last chunk
    (2, 63, 3, 16, 16, 3, True),        # below a chunk
    (1, 1, 2, 16, 32, 1, False)])       # one step
def test_ssd_bwd_bf16_rounding_contract_matches_jax_grad(B, T, H, hd, ds, G,
                                                         dh):
    """The tensor-core route's roundings (``_ssd_bwd_chunked`` with
    ``rounded``, at the kernel's chunk ``ssd.BWD_CHUNK``) on bf16 inputs
    hold to jax.grad of the reference in f32 on the same bf16 values,
    element by element within the first-order bound those roundings imply,
    plus 1e-4 of each element and of the output's largest for the f32
    reference's own sums; each output also within the card's bf16 gate
    (2e-2 of its largest). dA's error is reported as a fraction of its
    largest."""
    x, dt, A, Bg, Cg, dy, dh_last = _ssd_inputs(B, T, H, hd, ds, G, T + hd)
    x, Bg, Cg, dy = (torch.from_numpy(t * 0.5).to(torch.bfloat16)
                     for t in (x, Bg, Cg, dy))
    want = _jax_ssd_grads(*(t.float().numpy() for t in (x,)), dt, A,
                          Bg.float().numpy(), Cg.float().numpy(),
                          dy.float().numpy(),
                          dh_last if dh else np.zeros_like(dh_last), H)
    got, bound = _ssd_bwd_chunked(
        x, torch.from_numpy(dt), torch.from_numpy(A), _expand(Bg, H),
        _expand(Cg, H), dy, torch.from_numpy(dh_last) if dh else None,
        ssd_mod.BWD_CHUNK, rounded=True)
    got = list(got[:3]) + [_fold(got[3], G), _fold(got[4], G)]
    bound = list(bound[:3]) + [_fold(bound[3], G), _fold(bound[4], G)]
    for name, g, w, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                             bound):
        g, e = g.numpy(), e.numpy()
        top = float(np.abs(w).max())
        err = np.abs(g - w)
        assert float(err.max()) <= 2e-2 * top, (name, float(err.max()), top)
        np.testing.assert_array_less(err, e + 1e-4 * (np.abs(w) + top)
                                     + 1e-30, err_msg=name)
        if name == "dA":                # 0 at T = 1 without dh_last
            frac = float(err.max()) / max(top, 1e-30)
            assert frac <= 2e-2, f"dA max abs err {frac:.3g} of its largest"


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
