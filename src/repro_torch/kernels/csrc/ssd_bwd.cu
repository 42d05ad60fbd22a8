// Mamba2 SSD scan backward for Hopper (sm_90a): dx, ddt, dA, dB_, dC.
//
// Replaces no Pallas kernel: the TPU kernel (src/repro/kernels/ssd.py,
// forward only) has no backward, and JAX gets the gradient by
// differentiating the jnp program around it. Training needs it on the card
// (models/ssm.py::ssm_apply under autograd), so the port's autograd
// Function (kernels/ssd.py) launches this.
//
// Two routes; the launcher counts the one each call took (ssd_bwd_routes),
// by the rule kernels/ssd.py::bwd_route states: bf16 x with head dim P and
// state size N multiples of 16, P <= 64, N <= 128, and x, B_ and C with unit
// element stride and 16-byte aligned bases and (b, t, h) strides take the
// tensor cores ("tensor_core"); f32 (the f32 gates) and every other shape
// the f64 CUDA-core walks ("cuda_core"). dy is read through its strides on
// both; the wrapper copies it only where the 16-byte copies cannot read it.
//
// == The tensor-core route: the chunked backward ==
//
// The forward (ssd.cu), from h = 0, with l_t = dt_t A: h_t = exp(l_t)
// h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t. Take one chunk of Q steps of a
// (b, h), cum the inclusive cumsum of l within it and cum_Q its last value,
// h_prev (P x N) the state entering the chunk and dh the gradient of the
// state leaving it (dh_last for the last chunk). For i >= j let
//
//   L_ij = exp(cum_i - cum_j),   S = C B^T,   dS_ij = (dy_i . x_j) L_ij dt_j,
//   M_ij = (dy_i . x_j)(C_i . B_j) L_ij dt_j = S_ij dS_ij,
//   v_j = exp(cum_Q - cum_j),    w_j = v_j dt_j.
//
// Then, differentiating y_i = sum_{j<=i} S_ij L_ij dt_j x_j + e^{cum_i}
// h_prev C_i and h_out = e^{cum_Q} h_prev + sum_j w_j x_j B_j^T:
//
//   u    = (S o L)^T dy + diag(v) B dh^T       dx = diag(dt) u
//   dC   = dS B + diag(e^cum) dy h_prev        dB = dS^T C + diag(w) x dh
//   dh_prev = e^{cum_Q} dh + dy^T diag(e^cum) C
//
// and the gradient in l_t (d cum_i / d l_t = [t <= i]) as four direct sums,
// each of terms of one sign pattern, none a difference of running sums:
//
//   dl_t = sum_{i>=t, j<t} M_ij                    (a rectangle of M)
//        + sum_{i>=t} e^{cum_i} dy_i . (h_prev C_i)  (= C_i . dC_state_i)
//        + sum_{j<t} w_j x_j . (dh B_j)              (= dt_j x_j . u_state_j)
//        + e^{cum_Q} <dh, h_prev>,
//
//   ddt_t = x_t . u_t + A dl_t,   dA = sum_{b,t} dt_t dl_t.
//
// (The CUDA-core walks below get dl as a telescoping difference of running
// sums, which an all-f32 version could not keep within the f32 gate; these
// sums need no exact recurrence, so f32 sums of f32 accumulators serve.)
// The gradient does not depend on the chunk, so the backward takes its own,
// QB = 64 steps, whatever chunk the forward was called with; the chunked
// arithmetic is held to jax.grad at chunks 16, 64 and 128 by a CPU
// emulation in tests/test_torch_backward.py.
//
// A persistent grid of one block an SM takes (b, h) items in turn. An item
// first walks its chunks forward to recompute the states entering chunks
// 1 .. nc - 1, h = e^{cum_Q} h + (x w)^T B (the forward kernel's state
// update), into an f32 scratch (B, H, nc - 1, P, N) the wrapper allocates
// (written and read back by the same block, so it stays in the L2); then
// it walks them backward, carrying dh. Every step has the next step's x,
// dy, B and C (16 bytes a cp.async, zero-filled past T, P and N) and dt in
// flight behind its products, in a two-stage ring that runs on from item
// to item. Two roles of 4 warps, one of each a sub-partition:
// - rows i (warps 0-3, rows 16 w .. 16 w + 15 of the chunk): dC, starting
//   from e^{cum_i} dy h_prev (whose rows dotted with C give dl's second
//   sum), then dS B over the column blocks up to the diagonal (dS from
//   dy x^T, the mask and the weights on the accumulators); then, with dy
//   e^{cum} in shared memory, dh = e^{cum_Q} dh + (dy e^cum)^T C, warp w
//   holding rows p 16 w .. 16 w + 15 of dh in f32 registers from chunk to
//   chunk (64 a thread).
// - rows j (warps 4-7), in two passes: u = v B dh^T (its rows dotted with
//   x give dl's third sum), then over the column blocks from the diagonal
//   on S^T = B C^T and dS^T = x dy^T, weighted and masked on the
//   accumulators, which give M (into shared memory, f32) and, as bf16
//   hi + lo A fragments, u += (S o L)^T dy; dx = dt u, x . u; then dB =
//   w x dh + dS^T C, dS^T recomputed block by block.
//   After the chunk's products the same warps take dl's rectangle sums
//   (each row's prefix over j, then each column's sum over i >= t), its two
//   row sums, ddt and the chunk's part of dA.
// Products on mma.sync m16n8k16 (bf16 in, f32 sums), fed by ldmatrix from
// padded tiles: a 64-step chunk is 4 row tiles of 16 per role, so every
// product is a 16-row tile of one warp, the causal blocks differ from warp
// to warp, and an accumulator's column tiles are the next product's A
// fragments without shared memory. wgmma was tried for the four state
// products, which are the same for every warp of a role (dy h_prev, dh_prev,
// B dh^T, x dh: RS wgmma, the A fragments in registers, B, C, dh and h_prev
// tiles in the 128-byte swizzle read once a warpgroup): right on every
// case, but slower at mamba2's training shape on an H100, and ptxas
// spilled whichever one product, or register fence, was taken out. Register
// budget (QB 64): rows i hold dh (64) and half of dC (32) f32 accumulators
// beside dy's fragments; rows j u (32), then dB (64), in two passes; the
// k loops are rolled or unrolled twice, where ptxas hoisted every
// fragment's load and spilled; ptxas -v must show no spills (chip_smoke.py,
// NO_SPILLS).
//
// Rounding. Every product's operands are the bf16 inputs or one of these,
// and every sum is f32: S o L and dS enter their products as bf16 hi + lo
// (two products, ~2^-16 relative), as the forward's masked scores do; dh
// and h_prev as bf16 hi + lo, as the forward's carried state; dy_i
// e^{cum_i} (dh_prev's A operand) as bf16 hi + lo; x_j w_j rounded once to
// bf16 for the recomputed state, as the forward does. The mask comes
// before the exp (exp(cum_i - cum_j) overflows for i < j). The cumsums,
// M, the rectangle and row sums, dl, ddt and dA stay f32; dx, dB_ and dC
// are rounded once to bf16 on output. tests/test_torch_backward.py holds
// an emulation of exactly this arithmetic to jax.grad, element by element,
// within the bound these roundings imply.
//
// Determinism: no atomics. Each (b, h) writes its dA partial, and
// ssd_bwd_da_kernel sums the partials over b in order; every other output
// element is written once, every sum taken in a fixed order.
//
// What bounds it on the H100: at mamba2's training shape (B 8, T 256, H 64,
// P 64, N 128, one group, bf16) it must read x, dt, B_, C (once a group)
// and dy and write dx, ddt, dB_ and dC (dense over heads) once: 119.5 MB,
// 0.0357 ms at 3.35 TB/s. Its products over the causal pairs of 64-step
// chunks (S, dy x^T, (S o L)^T dy, dS B, dS^T C: 2 (3N + 2P) a pair) and
// the five state products (2 P N a step each) are 1.51e10 FLOP, 0.0153 ms
// at 989 TFLOP/s. So bytes bound the work, 2.3x above the products. The
// design keeps the loads in flight behind the products and the states in
// the L2. Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W): 0.277
// ms, 7.8x its bound, 5x the f64 walks' 1.377. What holds it there: the
// products run on mma.sync with hi + lo operands and dS recomputed where
// its registers are not kept, one warp of each role a sub-partition, and
// every warp reads the B operands of its state products whole (dh and
// h_prev as hi + lo, C). tools/ssd_bwd_parts.py times the kernel with one
// part cut out at a time: 2.4-14.6% saved each (rows j's dB pass the
// most), 20.8% for rows j's products whole, the two roles' savings not
// adding up: the sub-partitions' shared-memory reads and issue, shared by
// both roles, set the time more than one warp's chain. Levers: B operands
// read once a warpgroup (wgmma, tried above), dB_ and dC summed over a
// group's heads in the kernel.
//
// == The CUDA-core route (f32, and shapes the tiles do not take) ==
//
// The forward (ssd.cu), from h_{-1} = 0, a_t = exp(dt_t A):
//
//   h_t = a_t h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,   h_last = h_{T-1}
//
// With G_t the gradient of the loss in h_t (G_{T-1} = dh_last + dy C^T,
// G_t = a_{t+1} G_{t+1} + dy_t C_t^T) and u_t = G_t B_t:
//
//   dC_t = h_t^T dy_t,   dx_t = dt_t u_t,   dB_t = dt_t G_t^T x_t,
//   q_t  = a_t <G_t, h_{t-1}>  (the gradient in dt_t A),
//   ddt_t = x_t . u_t + A q_t,   dA = sum_{b,t} dt_t q_t.
//
// q_t needs h_{t-1} beside G_t, which are walked in opposite directions. It
// comes without either from  <G_t, h_t> = q_{t+1} + dy_t . y_t  and
// <G_t, h_t> = q_t + dt_t x_t . u_t, so
//
//   q_t = q_{t+1} + dy_t . y_t - dt_t x_t . u_t,   q_T = <dh_last, h_last>,
//
// with dy_t . y_t = C_t . dC_t. Two walks of a (batch, head) block, then:
// pass 1 steps h forward and writes dC_t and yd_t = C_t . dC_t; pass 2 steps
// G backward and writes dx_t, dB_t and ddt_t, carrying q. Nothing of size
// T x state is kept; the state never leaves the chip. q is a running
// difference of terms that can be much larger than it (a strong decay
// makes q small), and it telescopes only if h and G follow their
// recurrences exactly: a rounded state breaks that. So the walks carry the
// state, the products and every sum in f64 from the f32 inputs on. All
// in f32, an H100 run of chip_smoke.py saw dA 1.06e-4 of its largest from
// the plain version, past the f32 gate's 1e-4; tools/ssd_bwd_precision.py
// --emulate puts dA all in f32 at 6.5e-5 of an f64 oracle's largest, and
// these walks in f64 at 2.9e-13. A second small kernel sums
// the blocks' dA over the batch in order, so two calls give the same bits
// (no atomics anywhere).
//
// Layout: 8 warps; warp w owns state rows w PR .. w PR + PR - 1 and lane l
// columns l + 32 k (k < NK), PR x NK f64 registers of h (pass 1) or G (pass
// 2). Rows past P and columns past N stay 0. A reduction over columns (u)
// is a transposing butterfly over the warp (log2 PR halving exchanges, then
// the rest of the xor tree); a reduction over rows (dC, dB) goes through
// shared memory, each warp's partial per step, summed over the 8 warps in
// order once per tile of TS steps. Inputs come through their strides into
// shared memory a tile at a time (x may be a view, B_ and C stride 0 over
// heads); the products run on the CUDA cores in f64 whatever the input
// type.
//
// What bounds it on the H100: at mamba2's training shape the f64 walks
// take ~2.4e10 FLOP (~7 a state element and step) on the CUDA cores, 0.7
// ms at their f64 peak (34 TFLOP/s), 20x the bytes' bound: operations
// bound this route. It stays for f32, whose gates need this precision, and
// for the shapes the tiles do not take.
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int TS = 8;  // steps a tile (one warp a step for the dot products)
static_assert(TS == WARPS, "one warp a step reduces yd and x . u");

template <int PR, int NK>
struct Shape {
  static constexpr int PM = WARPS * PR;  // state rows held
  static constexpr int NM = 32 * NK;     // state columns held
  // x, dy, u (TS x PM); B, C (TS x NM); column partials (TS x 8 x NM);
  // dt (TS); the f64 arrays are static
  static constexpr int FLOATS =
      3 * TS * PM + 2 * TS * NM + TS * WARPS * NM + TS;
};

// Sums of v[0..R) over the 32 lanes of a warp: halving exchanges send the
// half a lane does not keep; after them the lane holds the partial of row
// `row` (the kept halves' offsets), and the xor tree finishes it. Lanes
// whose low log2(32 / R) bits are 0 hold distinct rows.
template <typename V, int R>
__device__ __forceinline__ V row_sums(V (&v)[R], int lane, int& row) {
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R a power of 2");
  int base = 0;
  int off = 16;
#pragma unroll
  for (int w = R; w > 1; w >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const V send = up ? v[i] : v[i + w / 2];
      const V keep = up ? v[i + w / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    if (up) base += w / 2;
  }
  V s = v[0];
  for (; off >= 1; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  row = base;
  return s;
}

__device__ __forceinline__ double sum32d(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void *x, *dt, *A, *Bm, *C, *dy, *dh;
  void *dx, *ddt, *dB, *dC, *yd, *dA_part, *dA, *hs;
  int B, T, H, P, N;
  long long x_sb, x_st, x_sh, x_se, dt_sb, dt_st, dt_sh, A_s;
  long long B_sb, B_st, B_sh, B_se, C_sb, C_st, C_sh, C_se;
  long long y_sb, y_st, y_sh, y_se;
};

template <typename T, int PR, int NK>
__global__ void __launch_bounds__(NT)
ssd_bwd_kernel(const Args a) {
  using E = rt::Elem<T>;
  using S = Shape<PR, NK>;
  constexpr int PM = S::PM, NM = S::NM;
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                  // TS x PM
  float* sdy = sx + TS * PM;         // TS x PM
  float* su = sdy + TS * PM;         // TS x PM
  float* sB = su + TS * PM;          // TS x NM
  float* sC = sB + TS * NM;          // TS x NM
  float* red = sC + TS * NM;         // TS x WARPS x NM
  float* sdt = red + TS * WARPS * NM;
  // the decay, and each warp's part of yd_t and of x_t . u_t, f64
  __shared__ double sa[TS], spart[TS * WARPS], sdot[TS], sblk[WARPS];

  const int h = blockIdx.x, b = blockIdx.y;
  const int T_ = a.T, P = a.P, N = a.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* dy = static_cast<const T*>(a.dy) + b * a.y_sb + h * a.y_sh;
  const T* Bm = static_cast<const T*>(a.Bm) + b * a.B_sb + h * a.B_sh;
  const T* C = static_cast<const T*>(a.C) + b * a.C_sb + h * a.C_sh;
  const float* dt = static_cast<const float*>(a.dt) + b * a.dt_sb +
                    h * a.dt_sh;
  const double A = static_cast<const float*>(a.A)[h * a.A_s];
  const long long bth = (long long)b * T_ * a.H;  // (b, 0, 0) of outputs
  double* yd = static_cast<double*>(a.yd) + ((long long)b * a.H + h) * T_;
  const float* dh = a.dh == nullptr ? nullptr
                    : static_cast<const float*>(a.dh) +
                          ((long long)b * a.H + h) * P * N;

  // stage steps t0 .. t0 + TS - 1 (zeros past T, P, N; a = 1 past T)
  auto stage = [&](int t0) {
    for (int i = threadIdx.x; i < TS * PM; i += NT) {
      const int s = i / PM, p = i % PM, t = t0 + s;
      const bool in = t < T_ && p < P;
      sx[i] = in ? E::to_float(x[t * a.x_st + p * a.x_se]) : 0.f;
      sdy[i] = in ? E::to_float(dy[t * a.y_st + p * a.y_se]) : 0.f;
    }
    for (int i = threadIdx.x; i < TS * NM; i += NT) {
      const int s = i / NM, n = i % NM, t = t0 + s;
      const bool in = t < T_ && n < N;
      sB[i] = in ? E::to_float(Bm[t * a.B_st + n * a.B_se]) : 0.f;
      sC[i] = in ? E::to_float(C[t * a.C_st + n * a.C_se]) : 0.f;
    }
    if (threadIdx.x < TS) {
      const int t = t0 + threadIdx.x;
      const float d = t < T_ ? dt[t * a.dt_st] : 0.f;
      sdt[threadIdx.x] = d;
      sa[threadIdx.x] = exp((double)d * A);
    }
  };
  // the 8 warps' column partials of each step, summed in order
  auto col_sum = [&](int s, int n) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[(s * WARPS + w) * NM + n];
    return (float)v;
  };
  // spart's 8 warp parts of each step, summed in order, into sdot
  auto step_sums = [&]() {
    if (threadIdx.x < TS) {
      double v = 0.0;
      for (int w = 0; w < WARPS; ++w) v += spart[threadIdx.x * WARPS + w];
      sdot[threadIdx.x] = v;
    }
  };

  double st[PR][NK];  // h in pass 1, G in pass 2
#pragma unroll
  for (int r = 0; r < PR; ++r)
#pragma unroll
    for (int k = 0; k < NK; ++k) st[r][k] = 0.0;

  // -- pass 1: h forward; dC_t = h_t^T dy_t and yd_t = C_t . dC_t --------
  for (int t0 = 0; t0 < T_; t0 += TS) {
    __syncthreads();  // the previous tile's reads are done
    stage(t0);
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < TS; ++s) {
      const double at = sa[s], w = sdt[s];
      double c[NK];
#pragma unroll
      for (int k = 0; k < NK; ++k) c[k] = 0.0;
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        const double wx = w * sx[s * PM + warp * PR + r];
        const double g = sdy[s * PM + warp * PR + r];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          st[r][k] = fma(at, st[r][k], wx * sB[s * NM + lane + 32 * k]);
          c[k] = fma(st[r][k], g, c[k]);
        }
      }
      double part = 0.0;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        red[(s * WARPS + warp) * NM + lane + 32 * k] = (float)c[k];
        part = fma((double)sC[s * NM + lane + 32 * k], c[k], part);
      }
      part = sum32d(part);
      if (lane == 0) spart[s * WARPS + warp] = part;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TS * NM; i += NT) {
      const int s = i / NM, n = i % NM, t = t0 + s;
      if (t < T_ && n < N)
        static_cast<T*>(a.dC)[(bth + (long long)t * a.H + h) * N + n] =
            E::from_float(col_sum(s, n));
    }
    step_sums();
    __syncthreads();
    if (threadIdx.x < TS && t0 + (int)threadIdx.x < T_)
      yd[t0 + threadIdx.x] = sdot[threadIdx.x];
  }

  // q_T = <dh_last, h_last>, summed in a fixed order
  double q = 0.0;
  if (dh != nullptr) {
    double v = 0.0;
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int p = warp * PR + r, n = lane + 32 * k;
        if (p < P && n < N) v = fma(st[r][k], (double)dh[p * N + n], v);
      }
    v = sum32d(v);
    __syncthreads();
    if (lane == 0) sblk[warp] = v;
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) q += sblk[w];
  }

  // -- pass 2: G backward; dx, dB_, ddt, and the dA partial ---------------
#pragma unroll
  for (int r = 0; r < PR; ++r)
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int p = warp * PR + r, n = lane + 32 * k;
      st[r][k] = dh != nullptr && p < P && n < N ? dh[p * N + n] : 0.0;
    }
  double a_next = 1.0, dA_acc = 0.0;
  const int last = (T_ - 1) / TS * TS;
  for (int t0 = last; t0 >= 0; t0 -= TS) {
    __syncthreads();  // the previous tile's reads are done
    stage(t0);
    __syncthreads();
#pragma unroll 1
    for (int s = TS - 1; s >= 0; --s) {
      double v[PR], c[NK];
#pragma unroll
      for (int k = 0; k < NK; ++k) c[k] = 0.0;
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        const double g = sdy[s * PM + warp * PR + r];
        const double xv = sx[s * PM + warp * PR + r];
        v[r] = 0.0;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = s * NM + lane + 32 * k;
          st[r][k] = fma(a_next, st[r][k], g * sC[n]);
          v[r] = fma(st[r][k], (double)sB[n], v[r]);
          c[k] = fma(st[r][k], xv, c[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < NK; ++k)
        red[(s * WARPS + warp) * NM + lane + 32 * k] = (float)c[k];
      int row;
      const double u = row_sums(v, lane, row);
      double part = 0.0;  // x_t . u_t over this warp's rows
      if ((lane & (32 / PR - 1)) == 0) {
        su[s * PM + warp * PR + row] = (float)u;
        part = u * sx[s * PM + warp * PR + row];
      }
      part = sum32d(part);
      if (lane == 0) spart[s * WARPS + warp] = part;
      a_next = sa[s];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TS * NM; i += NT) {
      const int s = i / NM, n = i % NM, t = t0 + s;
      if (t < T_ && n < N)
        static_cast<T*>(a.dB)[(bth + (long long)t * a.H + h) * N + n] =
            E::from_float(sdt[s] * col_sum(s, n));
    }
    for (int i = threadIdx.x; i < TS * PM; i += NT) {
      const int s = i / PM, p = i % PM, t = t0 + s;
      if (t < T_ && p < P)
        static_cast<T*>(a.dx)[(bth + (long long)t * a.H + h) * P + p] =
            E::from_float(sdt[s] * su[i]);
    }
    step_sums();
    __syncthreads();
    if (threadIdx.x == 0) {  // the scalar walk of q over the tile
      for (int s = TS - 1; s >= 0; --s) {
        const int t = t0 + s;
        if (t >= T_) continue;
        q += yd[t] - (double)sdt[s] * sdot[s];
        static_cast<float*>(a.ddt)[bth + (long long)t * a.H + h] =
            (float)(sdot[s] + A * q);
        dA_acc = fma((double)sdt[s], q, dA_acc);
      }
    }
  }
  if (threadIdx.x == 0)
    static_cast<double*>(a.dA_part)[(long long)b * a.H + h] = dA_acc;
}

// dA[h] = sum over b of the (b, h) blocks' partials, in order of b.
__global__ void ssd_bwd_da_kernel(const double* __restrict__ part,
                                  float* __restrict__ dA, int B, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  double v = 0.0;
  for (int b = 0; b < B; ++b) v += part[(long long)b * H + h];
  dA[h] = (float)v;
}

template <typename T, int PR, int NK>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = ssd_bwd_kernel<T, PR, NK>;
  const size_t smem = Shape<PR, NK>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.H, a.B), NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<(a.H + 127) / 128, 128, 0, stream>>>(
      static_cast<const double*>(a.dA_part), static_cast<float*>(a.dA), a.B,
      a.H);
  return cudaGetLastError();
}

// Rows a warp holds: P <= 16, <= 64, <= 128; columns a lane: N <= 32, 128.
template <typename T>
int launch_shape(const Args& a, cudaStream_t stream) {
  if (a.P <= 16)
    return a.N <= 32 ? launch<T, 2, 1>(a, stream) : launch<T, 2, 4>(a, stream);
  if (a.P <= 64)
    return a.N <= 32 ? launch<T, 8, 1>(a, stream) : launch<T, 8, 4>(a, stream);
  return a.N <= 32 ? launch<T, 16, 1>(a, stream)
                   : launch<T, 16, 4>(a, stream);
}

// -- the tensor-core route (bf16) --------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NI = 4;              // warps of rows i: dC and dh
constexpr int NJ = 4;              // warps of rows j: dx, dB, ddt and dA
constexpr int NT = 32 * (NI + NJ);
constexpr int QB = 64;             // the backward's chunk
constexpr int PC = 64;             // head dim of the tiles (smaller: padded)
constexpr int NC = 128;            // state size of the tiles
constexpr int XLD = PC + 8;        // staged x and dy rows (bf16) and B, C,
constexpr int BLD = NC + 8;        // dh and h_prev rows: 16 bytes of pad, so
                                   // ldmatrix's 8 rows hit 8 bank groups
constexpr int MLD = QB + 1;        // M's rows (f32), odd
constexpr float LOG2E = 1.4426950408889634f;

struct Stage {                     // one chunk's inputs
  bf16 x[QB * XLD];
  bf16 dy[QB * XLD];
  bf16 b[QB * BLD];
  bf16 c[QB * BLD];
};

struct Smem {                      // 214,040 bytes
  Stage st[2];                     // the ring
  bf16 dhh[PC * BLD], dhl[PC * BLD];   // dh as bf16 hi + lo, [p][n]
  bf16 hph[PC * BLD], hpl[PC * BLD];   // h_prev as bf16 hi + lo, [p][n]
  bf16 yeh[QB * XLD], yel[QB * XLD];   // dy_i e^{cum_i} hi + lo, [i][p];
                                       // x_j w_j (yeh) in a forward step
  float m[QB * MLD];               // M[i][j], then its rows' prefix sums
  float cum[2][QB];                // a chunk's cumsum of dt*A*log2(e), and
  float dt[2][QB];                 // its dt, by step parity
  float e[QB], f[QB], xu[QB];      // dl's row sums' terms, x . u
  float ef[QB], fx[QB];            // their suffix (E) and prefix (F) sums
  float dpart[2][QB];              // D's two halves over i
  float k4[NI], red[2];
};

struct Step {                      // a chunk of an item, either walk
  int item, c;
  bool rev;
};

// bf16 hi + lo of (a, b): hi the rounded values, lo their rounded remainders
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = rt::pack_bf16(a, b);
  const float2 r = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = rt::pack_bf16(a - r.x, b - r.y);
}

__device__ __forceinline__ float2 f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float ex2(float x) { return rt::exp2_approx(x); }

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// a role's 4 warps (barrier 1: rows i, 2: rows j)
template <int ID>
__device__ __forceinline__ void role_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"n"(ID) : "memory");
}

// the sum of the 4 lanes of a row (lane % 4), in a fixed order
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(NT, 1)
ssd_bwd_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // ldmatrix lane offsets: A (rows lane % 16, k half lane / 16), B stored
  // [n][k] (n lane % 8 + 8 (lane / 16), k half (lane / 8) % 2), and their
  // transposes
  const int ar = lane & 15, ak = (lane >> 4) * 8;
  const int bn = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 8;
  const int T_ = a.T, H = a.H, P = a.P, N = a.N, BH = a.B * a.H;
  const int nc = (T_ + QB - 1) / QB;  // chunks of an item
  const bf16* X = static_cast<const bf16*>(a.x);
  const bf16* DY = static_cast<const bf16*>(a.dy);
  const bf16* BM = static_cast<const bf16*>(a.Bm);
  const bf16* CM = static_cast<const bf16*>(a.C);
  const float* DT = static_cast<const float*>(a.dt);
  const float* AA = static_cast<const float*>(a.A);
  float* HS = static_cast<float*>(a.hs);
  const long long PN = (long long)P * N;

  // A step's inputs into a stage: x and B (and, walking backward, dy and
  // C) of every row of the tiles, zero past T, P and N, so no product
  // needs a bound.
  auto load = [&](int s, Step st) {
    Stage& S = sm.st[s];
    const int b = st.item / H, h = st.item % H, c0 = st.c * QB;
    const int qv = min(QB, T_ - c0);
    const bf16* xb = X + b * a.x_sb + h * a.x_sh + c0 * a.x_st;
    const bf16* yb = DY + b * a.y_sb + h * a.y_sh + c0 * a.y_st;
    const bf16* bb = BM + b * a.B_sb + h * a.B_sh + c0 * a.B_st;
    const bf16* cb = CM + b * a.C_sb + h * a.C_sh + c0 * a.C_st;
    for (int i = tid; i < QB * PC / 8; i += NT) {
      const int r = i / (PC / 8), k = (i % (PC / 8)) * 8;
      const bool ok = r < qv && k < P;
      rt::cp_async16(&S.x[r * XLD + k], ok ? xb + r * a.x_st + k : xb, ok);
      if (st.rev)
        rt::cp_async16(&S.dy[r * XLD + k], ok ? yb + r * a.y_st + k : yb,
                       ok);
    }
    for (int i = tid; i < QB * NC / 8; i += NT) {
      const int r = i / (NC / 8), k = (i % (NC / 8)) * 8;
      const bool ok = r < qv && k < N;
      rt::cp_async16(&S.b[r * BLD + k], ok ? bb + r * a.B_st + k : bb, ok);
      if (st.rev)
        rt::cp_async16(&S.c[r * BLD + k], ok ? cb + r * a.C_st + k : cb,
                       ok);
    }
    rt::cp_async_commit();
  };
  // dt of a step's chunk, 2 steps a lane (0 past T), for the scan
  auto load_dt = [&](Step st, float (&d)[2]) {
    const float* p = DT + (st.item / H) * a.dt_sb + (st.item % H) * a.dt_sh;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = st.c * QB + 2 * lane + k;
      d[k] = t < T_ ? p[t * a.dt_st] : 0.f;
    }
  };
  // one warp's scan of them into the inclusive cumsum of dt*A*log2(e)
  auto scan = [&](Step st, const float (&d)[2], int s) {
    const float a2 = AA[(st.item % H) * a.A_s] * LOG2E;
    const float v0 = d[0] * a2, v1 = v0 + d[1] * a2;
    float incl = v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const float off = incl - v1;
    sm.cum[s][2 * lane] = v0 + off;
    sm.cum[s][2 * lane + 1] = v1 + off;
    sm.dt[s][2 * lane] = d[0];
    sm.dt[s][2 * lane + 1] = d[1];
  };
  // The steps: each item's chunks 0 .. nc - 2 forward (the states), then
  // nc - 1 .. 0 backward; items blockIdx.x, + gridDim.x, ...
  auto next = [&](Step st) -> Step {
    if (!st.rev)
      return st.c + 1 < nc - 1 ? Step{st.item, st.c + 1, false}
                               : Step{st.item, nc - 1, true};
    if (st.c > 0) return Step{st.item, st.c - 1, true};
    return Step{st.item + (int)gridDim.x, 0, nc == 1};
  };
  // Both roles meet at the same block barriers (bar.sync 0). begin() waits
  // until this step has landed, then issues the copies of the next one
  // into the other stage, whose readers are done; warp 0 loads the next
  // step's dt, which it scans once its own products are issued.
  auto begin = [&](int s, Step st, float (&dn)[2]) -> Step {
    const Step nx = next(st);
    rt::cp_async_wait<0>();
    block_sync();
    if (nx.item < BH) {
      load(s ^ 1, nx);
      if (warp == 0) load_dt(nx, dn);
    }
    return nx;
  };
  // h_prev of the chunk after state k of item (scratch, f32) into shared
  // memory as bf16 hi + lo, by one role's 128 threads (tt)
  auto load_hp = [&](int item, int k, int tt) {
    const float* src = HS + ((long long)item * (nc - 1) + k) * PN;
    for (int v = tt; v < PC * NC / 4; v += 128) {
      const int p = v / (NC / 4), n = (v % (NC / 4)) * 4;
      const float4 h4 = p < P && n < N
                            ? *reinterpret_cast<const float4*>(&src[p * N + n])
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t h0, l0, h1, l1;
      split2(h4.x, h4.y, h0, l0);
      split2(h4.z, h4.w, h1, l1);
      *reinterpret_cast<uint2*>(&sm.hph[p * BLD + n]) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(&sm.hpl[p * BLD + n]) = make_uint2(l0, l1);
    }
  };
  // A forward step (both roles): x_j w_j rounded once to bf16, then
  // h = e^{cum_Q} h + (x w)^T B, warp w holding rows p 16 (w % 4) .. + 15
  // and columns 64 (w / 4) .. + 63 in f32; the state after chunk c goes to
  // the scratch.
  auto fwd_step = [&](int s, Step st, float (&hf)[8][4]) {
    const Stage& S = sm.st[s];
    const float* cum = sm.cum[s];
    const float* dts = sm.dt[s];
    const float cq = cum[QB - 1];
    for (int v = tid; v < QB * PC / 8; v += NT) {
      const int r = v / (PC / 8), k = (v % (PC / 8)) * 8;
      const float w = ex2(cq - cum[r]) * dts[r];
      const uint4 xv = *reinterpret_cast<const uint4*>(&S.x[r * XLD + k]);
      const uint32_t* in = &xv.x;
      uint4 o;
      uint32_t* out = &o.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&in[e]));
        out[e] = rt::pack_bf16(f.x * w, f.y * w);
      }
      *reinterpret_cast<uint4*>(&sm.yeh[r * XLD + k]) = o;
    }
    block_sync();                  // x w is whole
    const float eq = ex2(cq);
    const int mt = warp & 3, nh = warp >> 2;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) hf[i][k] = st.c > 0 ? hf[i][k] * eq : 0.f;
#pragma unroll
    for (int kb = 0; kb < QB / 16; ++kb) {
      uint32_t af[4];
      rt::ldsm_x4_trans(af, &sm.yeh[(kb * 16 + bn) * XLD + mt * 16 + bk]);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t bf[4];
        rt::ldsm_x4_trans(bf, &S.b[(kb * 16 + bk + (lane & 7)) * BLD +
                                   nh * 64 + pr * 16 + ak]);
        rt::mma_bf16(hf[2 * pr], af, bf);
        rt::mma_bf16(hf[2 * pr + 1], af, bf + 2);
      }
    }
    float* hs = HS + ((long long)st.item * (nc - 1) + st.c) * PN;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nh * 64 + nt * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = mt * 16 + g + 8 * r;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(&hs[p * N + n]) =
              make_float2(hf[nt][2 * r], hf[nt][2 * r + 1]);
      }
    }
  };

  const Step first{(int)blockIdx.x, 0, nc == 1};
  if (first.item >= BH) return;
  load(0, first);
  if (warp == 0) {
    float d[2];
    load_dt(first, d);
    scan(first, d, 0);
  }

  if (warp < NI) {
    // -- rows i -------------------------------------------------------------
    const int i0 = warp * 16;      // this warp's rows of the chunk, and of dh
    int s = 0;
    for (int item = blockIdx.x; item < BH; item += gridDim.x) {
      {
        float hf[8][4];
        for (int c = 0; c < nc - 1; ++c, s ^= 1) {
          float dn[2];
          const Step nx = begin(s, Step{item, c, false}, dn);
          fwd_step(s, Step{item, c, false}, hf);
          if (warp == 0 && nx.item < BH) scan(nx, dn, s ^ 1);
        }
      }
      const int b = item / H, h = item % H;
      bf16* dCo = static_cast<bf16*>(a.dC) + (long long)b * T_ * H * N +
                  (long long)h * N;
      float dh[16][4];             // rows p i0 + g (+ 8), columns 8 nt + 2 t4
      for (int c = nc - 1; c >= 0; --c, s ^= 1) {
        float dn[2];
        const Step nx = begin(s, Step{item, c, true}, dn);
        const bool has_dh = c < nc - 1 || a.dh != nullptr;
        if (c == nc - 1) {         // dh_last (or 0); the other role h_prev
          const float* src = a.dh == nullptr ? nullptr
                             : static_cast<const float*>(a.dh) + item * PN;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int p = i0 + g + 8 * r, n = nt * 8 + 2 * t4;
              const float2 v =
                  src != nullptr && p < P && n < N
                      ? *reinterpret_cast<const float2*>(&src[p * N + n])
                      : make_float2(0.f, 0.f);
              dh[nt][2 * r] = v.x;
              dh[nt][2 * r + 1] = v.y;
            }
#pragma unroll
          for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int o = (i0 + g + 8 * r) * BLD + nt * 8 + 2 * t4;
              uint32_t hi, lo;
              split2(dh[nt][2 * r], dh[nt][2 * r + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(&sm.dhh[o]) = hi;
              *reinterpret_cast<uint32_t*>(&sm.dhl[o]) = lo;
            }
          block_sync();            // dh and h_prev are in shared memory
        }
        const Stage& S = sm.st[s];
        const float* cum = sm.cum[s];
        const float* dts = sm.dt[s];
        const int c0 = c * QB, qv = min(QB, T_ - c0);
        const float cq = cum[QB - 1];
        const float ci0 = cum[i0 + g], ci1 = cum[i0 + g + 8];

        // <dh, h_prev> over this warp's rows of dh (dl's last term)
        if (c > 0 && has_dh) {
          float v = 0.f;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int o = (i0 + g + 8 * r) * BLD + nt * 8 + 2 * t4;
              const float2 hh = f2(&sm.hph[o]), hl = f2(&sm.hpl[o]);
              v += dh[nt][2 * r] * (hh.x + hl.x) +
                   dh[nt][2 * r + 1] * (hh.y + hl.y);
            }
          v = rt::sum32(v);
          if (lane == 0) sm.k4[warp] = v;
        }

        // dC = e^{cum_i} dy_i h_prev (its rows dotted with C: dl's second
        // sum's terms), then + dS B; in two halves of N (an accumulator of
        // 32 registers beside dh's 64), dS recomputed for each
        const float e0 = ex2(ci0), e1 = ex2(ci1);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 1
        for (int nh = 0; nh < 2; ++nh) {
          float acc[NC / 16][4];
#pragma unroll
          for (int nt = 0; nt < NC / 16; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
          if (c > 0) {             // h_prev is 0 before the first chunk
#pragma unroll 1
            for (int kk = 0; kk < PC / 16; ++kk) {
              uint32_t yf[4];
              rt::ldsm_x4(yf, &S.dy[(i0 + ar) * XLD + kk * 16 + ak]);
#pragma unroll
              for (int nb = 0; nb < NC / 32; ++nb) {
                uint32_t hh[4], hl[4];
                const int o = (kk * 16 + bk + (lane & 7)) * BLD + nh * 64 +
                              nb * 16 + ak;
                rt::ldsm_x4_trans(hh, &sm.hph[o]);
                rt::ldsm_x4_trans(hl, &sm.hpl[o]);
                rt::mma_bf16(acc[2 * nb], yf, hh);
                rt::mma_bf16(acc[2 * nb + 1], yf, hh + 2);
                rt::mma_bf16(acc[2 * nb], yf, hl);
                rt::mma_bf16(acc[2 * nb + 1], yf, hl + 2);
              }
            }
#pragma unroll
            for (int nt = 0; nt < NC / 16; ++nt) {
              const int n = nh * 64 + nt * 8 + 2 * t4;
              acc[nt][0] *= e0;
              acc[nt][1] *= e0;
              acc[nt][2] *= e1;
              acc[nt][3] *= e1;
              const float2 c0v = f2(&S.c[(i0 + g) * BLD + n]);
              const float2 c1v = f2(&S.c[(i0 + g + 8) * BLD + n]);
              s0 += acc[nt][0] * c0v.x + acc[nt][1] * c0v.y;
              s1 += acc[nt][2] * c1v.x + acc[nt][3] * c1v.y;
            }
          }
          for (int jb = 0; jb <= warp; ++jb) {  // blocks up to the diagonal
            // dy x^T, two partial sums over k (shorter chains)
            float sa[2][2][4];
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
                for (int k = 0; k < 4; ++k) sa[h2][e][k] = 0.f;
#pragma unroll
            for (int kk = 0; kk < PC / 16; ++kk) {
              uint32_t yf[4], xf[4];
              rt::ldsm_x4(yf, &S.dy[(i0 + ar) * XLD + kk * 16 + ak]);
              rt::ldsm_x4(xf, &S.x[(jb * 16 + bn) * XLD + kk * 16 + bk]);
              rt::mma_bf16(sa[kk & 1][0], yf, xf);
              rt::mma_bf16(sa[kk & 1][1], yf, xf + 2);
            }
            // dS = (dy x^T) L dt_j, the mask before the exp, as bf16 hi + lo
            uint32_t ah[4], al[4];
            const int ii0 = i0 + g, ii1 = ii0 + 8;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = jb * 16 + e * 8 + 2 * t4;
              const float2 cj = *reinterpret_cast<const float2*>(&cum[j]);
              const float2 dj = *reinterpret_cast<const float2*>(&dts[j]);
              float v[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) v[k] = sa[0][e][k] + sa[1][e][k];
              split2(j <= ii0 ? v[0] * (ex2(ci0 - cj.x) * dj.x) : 0.f,
                     j + 1 <= ii0 ? v[1] * (ex2(ci0 - cj.y) * dj.y) : 0.f,
                     ah[2 * e], al[2 * e]);
              split2(j <= ii1 ? v[2] * (ex2(ci1 - cj.x) * dj.x) : 0.f,
                     j + 1 <= ii1 ? v[3] * (ex2(ci1 - cj.y) * dj.y) : 0.f,
                     ah[2 * e + 1], al[2 * e + 1]);
            }
#pragma unroll
            for (int nb = 0; nb < NC / 32; ++nb) {
              uint32_t bb[4];
              rt::ldsm_x4_trans(bb, &S.b[(jb * 16 + bk + (lane & 7)) * BLD +
                                         nh * 64 + nb * 16 + ak]);
              rt::mma_bf16(acc[2 * nb], ah, bb);
              rt::mma_bf16(acc[2 * nb + 1], ah, bb + 2);
              rt::mma_bf16(acc[2 * nb], al, bb);
              rt::mma_bf16(acc[2 * nb + 1], al, bb + 2);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NC / 16; ++nt) {
            const int n = nh * 64 + nt * 8 + 2 * t4;
            if (n >= N) continue;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = i0 + g + 8 * r;
              if (i < qv)
                *reinterpret_cast<uint32_t*>(
                    &dCo[(long long)(c0 + i) * H * N + n]) =
                    rt::pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
            }
          }
        }
        s0 = sum4(s0);
        s1 = sum4(s1);
        if (t4 == 0) {
          sm.e[i0 + g] = s0;
          sm.e[i0 + g + 8] = s1;
        }

        // dy_i e^{cum_i} as bf16 hi + lo, this warp's rows, for dh_prev
#pragma unroll
        for (int v = 0; v < 16 * PC / 8 / 32; ++v) {
          const int idx = v * 32 + lane;
          const int r = i0 + idx / (PC / 8), k = (idx % (PC / 8)) * 8;
          const float er = ex2(cum[r]);
          const uint4 yv = *reinterpret_cast<const uint4*>(&S.dy[r * XLD + k]);
          const uint32_t* in = &yv.x;
          uint4 hi, lo;
          uint32_t* ho = &hi.x;
          uint32_t* lo_ = &lo.x;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&in[e]));
            split2(fv.x * er, fv.y * er, ho[e], lo_[e]);
          }
          *reinterpret_cast<uint4*>(&sm.yeh[r * XLD + k]) = hi;
          *reinterpret_cast<uint4*>(&sm.yel[r * XLD + k]) = lo;
        }
        role_sync<1>();            // dy e^cum is whole

        // dh_prev = e^{cum_Q} dh + (dy e^cum)^T C, rows p i0 .. i0 + 15
        const float eq = ex2(cq);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) dh[nt][k] *= eq;
#pragma unroll 1
        for (int kb = 0; kb < QB / 16; ++kb) {
          uint32_t ah[4], al[4];
          const int o = (kb * 16 + bn) * XLD + i0 + bk;
          rt::ldsm_x4_trans(ah, &sm.yeh[o]);
          rt::ldsm_x4_trans(al, &sm.yel[o]);
#pragma unroll
          for (int nb = 0; nb < NC / 16; ++nb) {
            uint32_t cf[4];
            rt::ldsm_x4_trans(cf, &S.c[(kb * 16 + bk + (lane & 7)) * BLD +
                                       nb * 16 + ak]);
            rt::mma_bf16(dh[2 * nb], ah, cf);
            rt::mma_bf16(dh[2 * nb + 1], ah, cf + 2);
            rt::mma_bf16(dh[2 * nb], al, cf);
            rt::mma_bf16(dh[2 * nb + 1], al, cf + 2);
          }
        }
        if (warp == 0 && nx.item < BH) scan(nx, dn, s ^ 1);
        block_sync();              // this chunk's readers of dh, h_prev and
                                   // dy e^cum are done; e, k4 are written
        if (c > 0) {               // dh and h_prev of chunk c - 1
#pragma unroll
          for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int o = (i0 + g + 8 * r) * BLD + nt * 8 + 2 * t4;
              uint32_t hi, lo;
              split2(dh[nt][2 * r], dh[nt][2 * r + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(&sm.dhh[o]) = hi;
              *reinterpret_cast<uint32_t*>(&sm.dhl[o]) = lo;
            }
          if (c > 1) load_hp(item, c - 2, tid);
        }
      }
    }
    return;
  }

  // -- rows j ---------------------------------------------------------------
  const int tt = tid - 32 * NI;    // 0 .. 127 in this role
  const int j0 = (warp - NI) * 16;  // this warp's rows of the chunk
  int s = 0;
  for (int item = blockIdx.x; item < BH; item += gridDim.x) {
    {
      float hf[8][4];
      for (int c = 0; c < nc - 1; ++c, s ^= 1) {
        float dn[2];
        begin(s, Step{item, c, false}, dn);
        fwd_step(s, Step{item, c, false}, hf);
      }
    }
    const int b = item / H, h = item % H;
    const float Ah = AA[h * a.A_s];
    const long long o_t = (long long)H;   // ddt's step stride
    float* ddt = static_cast<float*>(a.ddt) + (long long)b * T_ * H + h;
    bf16* dxo = static_cast<bf16*>(a.dx) + (long long)b * T_ * H * P +
                (long long)h * P;
    bf16* dBo = static_cast<bf16*>(a.dB) + (long long)b * T_ * H * N +
                (long long)h * N;
    float dA_acc = 0.f;
    for (int c = nc - 1; c >= 0; --c, s ^= 1) {
      float dn[2];
      begin(s, Step{item, c, true}, dn);
      const bool has_dh = c < nc - 1 || a.dh != nullptr;
      if (c == nc - 1) {
        if (nc > 1) load_hp(item, nc - 2, tt);
        block_sync();              // dh and h_prev are in shared memory
      }
      const Stage& S = sm.st[s];
      const float* cum = sm.cum[s];
      const float* dts = sm.dt[s];
      const int c0 = c * QB, qv = min(QB, T_ - c0);
      const float cq = cum[QB - 1];
      const float cj0 = cum[j0 + g], cj1 = cum[j0 + g + 8];
      const float dj0 = dts[j0 + g], dj1 = dts[j0 + g + 8];
      const float v0 = ex2(cq - cj0), v1 = ex2(cq - cj1);

      // dS^T = (x dy^T) L dt_j over column block ib (the mask before the
      // exp), as bf16 hi + lo A fragments (k = i); with S^T also S o L's,
      // and M = S dS into shared memory
      auto ds_block = [&](int ib, uint32_t (&dsh)[4], uint32_t (&dsl)[4],
                          bool with_s, uint32_t (&sh)[4], uint32_t (&sl)[4]) {
        float sp[2][2][4], dp[2][2][4];   // two partial sums over k each
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int k = 0; k < 4; ++k) sp[h2][e][k] = dp[h2][e][k] = 0.f;
        // k in pairs, the first loop unrolled only twice: unrolled whole,
        // ptxas hoisted every fragment's load and spilled
        if (with_s) {
#pragma unroll 2
          for (int k2 = 0; k2 < NC / 32; ++k2) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int kk = 2 * k2 + h2;
              uint32_t bf[4], cf[4];
              rt::ldsm_x4(bf, &S.b[(j0 + ar) * BLD + kk * 16 + ak]);
              rt::ldsm_x4(cf, &S.c[(ib * 16 + bn) * BLD + kk * 16 + bk]);
              rt::mma_bf16(sp[h2][0], bf, cf);
              rt::mma_bf16(sp[h2][1], bf, cf + 2);
            }
          }
        }
#pragma unroll
        for (int k2 = 0; k2 < PC / 32; ++k2) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int kk = 2 * k2 + h2;
            uint32_t xf[4], yf[4];
            rt::ldsm_x4(xf, &S.x[(j0 + ar) * XLD + kk * 16 + ak]);
            rt::ldsm_x4(yf, &S.dy[(ib * 16 + bn) * XLD + kk * 16 + bk]);
            rt::mma_bf16(dp[h2][0], xf, yf);
            rt::mma_bf16(dp[h2][1], xf, yf + 2);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = ib * 16 + e * 8 + 2 * t4;
          const float2 ci = *reinterpret_cast<const float2*>(&cum[i]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = j0 + g + 8 * r;
            const float cj = r ? cj1 : cj0, dj = r ? dj1 : dj0;
            const float l0 = i >= j ? ex2(ci.x - cj) : 0.f;
            const float l1 = i + 1 >= j ? ex2(ci.y - cj) : 0.f;
            const float d0 = (dp[0][e][2 * r] + dp[1][e][2 * r]) * l0 * dj;
            const float d1 =
                (dp[0][e][2 * r + 1] + dp[1][e][2 * r + 1]) * l1 * dj;
            split2(d0, d1, dsh[2 * e + r], dsl[2 * e + r]);
            if (with_s) {
              const float s0 = sp[0][e][2 * r] + sp[1][e][2 * r];
              const float s1 = sp[0][e][2 * r + 1] + sp[1][e][2 * r + 1];
              sm.m[i * MLD + j] = s0 * d0;
              sm.m[(i + 1) * MLD + j] = s1 * d1;
              split2(s0 * l0, s1 * l1, sh[2 * e + r], sl[2 * e + r]);
            }
          }
        }
      };

      // pass 1: u = v_j B dh^T (the state's part: its rows dotted with x
      // are dl's third sum's terms), then + (S o L)^T dy over the column
      // blocks from the diagonal on, which also give M; dx = dt u, x . u
      {
        float ax[PC / 8][4];
#pragma unroll
        for (int nt = 0; nt < PC / 8; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) ax[nt][k] = 0.f;
        float z0 = 0.f, z1 = 0.f;
        if (has_dh) {
#pragma unroll 2
          for (int kk = 0; kk < NC / 16; ++kk) {
            uint32_t bf[4];
            rt::ldsm_x4(bf, &S.b[(j0 + ar) * BLD + kk * 16 + ak]);
#pragma unroll
            for (int pb = 0; pb < PC / 16; ++pb) {
              uint32_t hh[4], hl[4];
              const int o = (pb * 16 + bn) * BLD + kk * 16 + bk;
              rt::ldsm_x4(hh, &sm.dhh[o]);
              rt::ldsm_x4(hl, &sm.dhl[o]);
              rt::mma_bf16(ax[2 * pb], bf, hh);
              rt::mma_bf16(ax[2 * pb + 1], bf, hh + 2);
              rt::mma_bf16(ax[2 * pb], bf, hl);
              rt::mma_bf16(ax[2 * pb + 1], bf, hl + 2);
            }
          }
#pragma unroll
          for (int nt = 0; nt < PC / 8; ++nt) {
            const int p = nt * 8 + 2 * t4;
            ax[nt][0] *= v0;
            ax[nt][1] *= v0;
            ax[nt][2] *= v1;
            ax[nt][3] *= v1;
            const float2 x0 = f2(&S.x[(j0 + g) * XLD + p]);
            const float2 x1 = f2(&S.x[(j0 + g + 8) * XLD + p]);
            z0 += ax[nt][0] * x0.x + ax[nt][1] * x0.y;
            z1 += ax[nt][2] * x1.x + ax[nt][3] * x1.y;
          }
        }
        z0 = sum4(z0);
        z1 = sum4(z1);
        if (t4 == 0) {
          sm.f[j0 + g] = dj0 * z0;
          sm.f[j0 + g + 8] = dj1 * z1;
        }
        for (int ib = warp - NI; ib < QB / 16; ++ib) {
          uint32_t sh[4], sl[4], dsh[4], dsl[4];
          ds_block(ib, dsh, dsl, true, sh, sl);
#pragma unroll
          for (int pb = 0; pb < PC / 16; ++pb) {
            uint32_t yb[4];
            rt::ldsm_x4_trans(yb, &S.dy[(ib * 16 + bk + (lane & 7)) * XLD +
                                        pb * 16 + ak]);
            rt::mma_bf16(ax[2 * pb], sh, yb);
            rt::mma_bf16(ax[2 * pb + 1], sh, yb + 2);
            rt::mma_bf16(ax[2 * pb], sl, yb);
            rt::mma_bf16(ax[2 * pb + 1], sl, yb + 2);
          }
        }
        float q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < PC / 8; ++nt) {
          const int p = nt * 8 + 2 * t4;
          const float2 x0 = f2(&S.x[(j0 + g) * XLD + p]);
          const float2 x1 = f2(&S.x[(j0 + g + 8) * XLD + p]);
          q0 += ax[nt][0] * x0.x + ax[nt][1] * x0.y;
          q1 += ax[nt][2] * x1.x + ax[nt][3] * x1.y;
          if (p >= P) continue;
          if (j0 + g < qv)
            *reinterpret_cast<uint32_t*>(
                &dxo[(long long)(c0 + j0 + g) * H * P + p]) =
                rt::pack_bf16(dj0 * ax[nt][0], dj0 * ax[nt][1]);
          if (j0 + g + 8 < qv)
            *reinterpret_cast<uint32_t*>(
                &dxo[(long long)(c0 + j0 + g + 8) * H * P + p]) =
                rt::pack_bf16(dj1 * ax[nt][2], dj1 * ax[nt][3]);
        }
        q0 = sum4(q0);
        q1 = sum4(q1);
        if (t4 == 0) {
          sm.xu[j0 + g] = q0;
          sm.xu[j0 + g + 8] = q1;
        }
      }

      // pass 2: dB = w_j x_j dh + dS^T C (dS^T recomputed: its 64
      // registers are not live beside u's)
      {
        float ab[NC / 8][4];
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) ab[nt][k] = 0.f;
        if (has_dh) {
#pragma unroll 2
          for (int kk = 0; kk < PC / 16; ++kk) {
            uint32_t xf[4];
            rt::ldsm_x4(xf, &S.x[(j0 + ar) * XLD + kk * 16 + ak]);
#pragma unroll
            for (int nb = 0; nb < NC / 16; ++nb) {
              uint32_t hh[4], hl[4];
              const int o = (kk * 16 + bk + (lane & 7)) * BLD + nb * 16 + ak;
              rt::ldsm_x4_trans(hh, &sm.dhh[o]);
              rt::ldsm_x4_trans(hl, &sm.dhl[o]);
              rt::mma_bf16(ab[2 * nb], xf, hh);
              rt::mma_bf16(ab[2 * nb + 1], xf, hh + 2);
              rt::mma_bf16(ab[2 * nb], xf, hl);
              rt::mma_bf16(ab[2 * nb + 1], xf, hl + 2);
            }
          }
          const float w0 = v0 * dj0, w1 = v1 * dj1;
#pragma unroll
          for (int nt = 0; nt < NC / 8; ++nt) {
            ab[nt][0] *= w0;
            ab[nt][1] *= w0;
            ab[nt][2] *= w1;
            ab[nt][3] *= w1;
          }
        }
        for (int ib = warp - NI; ib < QB / 16; ++ib) {
          uint32_t dsh[4], dsl[4], unused_h[4], unused_l[4];
          ds_block(ib, dsh, dsl, false, unused_h, unused_l);
#pragma unroll
          for (int nb = 0; nb < NC / 16; ++nb) {
            uint32_t cb[4];
            rt::ldsm_x4_trans(cb, &S.c[(ib * 16 + bk + (lane & 7)) * BLD +
                                       nb * 16 + ak]);
            rt::mma_bf16(ab[2 * nb], dsh, cb);
            rt::mma_bf16(ab[2 * nb + 1], dsh, cb + 2);
            rt::mma_bf16(ab[2 * nb], dsl, cb);
            rt::mma_bf16(ab[2 * nb + 1], dsl, cb + 2);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt) {
          const int n = nt * 8 + 2 * t4;
          if (n >= N) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = j0 + g + 8 * r;
            if (j < qv)
              *reinterpret_cast<uint32_t*>(
                  &dBo[(long long)(c0 + j) * H * N + n]) =
                  rt::pack_bf16(ab[nt][2 * r], ab[nt][2 * r + 1]);
          }
        }
      }
      block_sync();                // M, e, f, xu and k4 are whole

      // dl by direct sums: each row i's exclusive prefix R_i(t) = sum_{j<t}
      // M_ij (a warp's scan, 2 columns a lane; positions past i, never
      // read, may sum garbage), E_t = sum_{i>=t} e_i and F_t = sum_{j<t}
      // f_j (scans); then D_t = sum_{i>=t} R_i(t) in two halves of i
      const int wl = warp - NI;
#pragma unroll 4
      for (int r = wl * 16; r < wl * 16 + 16; ++r) {
        float* row = &sm.m[r * MLD];
        const float m0 = row[2 * lane], m1 = row[2 * lane + 1];
        float incl = m0 + m1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.f;
        row[2 * lane] = excl;
        row[2 * lane + 1] = excl + m0;
      }
      if (wl == 0) {               // E: a suffix scan of e (2 rows a lane)
        const float e0 = sm.e[2 * lane], e1 = sm.e[2 * lane + 1];
        float incl = e0 + e1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_down_sync(0xffffffffu, incl, o);
          if (lane + o < 32) incl += v;
        }
        float after = __shfl_down_sync(0xffffffffu, incl, 1);
        if (lane == 31) after = 0.f;
        sm.ef[2 * lane] = incl;            // e_{2l} + e_{2l+1} + after
        sm.ef[2 * lane + 1] = e1 + after;
      } else if (wl == 1) {        // F: an exclusive prefix scan of f
        const float f0 = sm.f[2 * lane], f1 = sm.f[2 * lane + 1];
        float incl = f0 + f1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.f;
        sm.fx[2 * lane] = excl;
        sm.fx[2 * lane + 1] = excl + f0;
      }
      role_sync<2>();
      {
        const int t = tt & (QB - 1), half = tt / QB;
        float dsum = 0.f;
        const int i_end = half ? QB : QB / 2;
#pragma unroll 8
        for (int i = max(t, half * (QB / 2)); i < i_end; ++i)
          dsum += sm.m[i * MLD + t];
        sm.dpart[half][t] = dsum;
      }
      role_sync<2>();
      float part = 0.f;
      if (tt < QB) {
        const int t = tt;
        const float k4 =
            c > 0 && has_dh
                ? (sm.k4[0] + sm.k4[1] + sm.k4[2] + sm.k4[3]) * ex2(cq)
                : 0.f;
        const float dl =
            (sm.dpart[0][t] + sm.dpart[1][t]) + sm.ef[t] + sm.fx[t] + k4;
        if (t < qv) ddt[(long long)(c0 + t) * o_t] = sm.xu[t] + Ah * dl;
        part = dts[t] * dl;
      }
      part = rt::sum32(part);
      if (lane == 0 && tt < QB) sm.red[tt / 32] = part;
      role_sync<2>();
      if (tt == 0) dA_acc += sm.red[0] + sm.red[1];
    }
    if (tt == 0)
      static_cast<double*>(a.dA_part)[item] = static_cast<double>(dA_acc);
  }
}

int launch(const Args& a, cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err =
      rt::allow_smem(ssd_bwd_tc_kernel, (int)sizeof(Smem), done);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H, grid = BH < rt::sm_count() ? BH : rt::sm_count();
  ssd_bwd_tc_kernel<<<grid, NT, sizeof(Smem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<(a.H + 127) / 128, 128, 0, stream>>>(
      static_cast<const double*>(a.dA_part), static_cast<float*>(a.dA), a.B,
      a.H);
  return cudaGetLastError();
}

bool vec16(const void* p, long long sb, long long st, long long sh,
           long long se) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && se == 1 && sb % 8 == 0 &&
         st % 8 == 0 && sh % 8 == 0;
}

// Whether a bf16 call fits the tiles: head dim and state size multiples of
// 16 (head dim <= 64, state <= 128), and x, B_ and C with unit element
// stride and 16-byte aligned bases and (b, t, h) strides.
bool takes(const Args& a) {
  return a.P % 16 == 0 && a.P <= PC && a.N % 16 == 0 && a.N <= NC &&
         vec16(a.x, a.x_sb, a.x_st, a.x_sh, a.x_se) &&
         vec16(a.Bm, a.B_sb, a.B_st, a.B_sh, a.B_se) &&
         vec16(a.C, a.C_sb, a.C_st, a.C_sh, a.C_se);
}

}  // namespace tc

// The routes a call can take (the wrapper's ``bwd_route`` names them), and
// the launches each has had: the launcher counts the route it took.
enum Route { TENSOR_CORE, CUDA_CORE, ROUTES };
std::atomic<unsigned long long> taken[ROUTES];

}  // namespace

// Returns the cudaError_t of the launches (0 on success). x, B_, C, dy are
// read through their (batch, seq, head, element) strides, dt through its
// (batch, seq, head) strides and A through its stride; dh_last is null or
// a contiguous f32 (B, H, P, N) tensor. dx (B,T,H,P), dB_, dC (B,T,H,N) in
// x's type, ddt (B,T,H) and dA (H,) f32 are contiguous outputs; dA_part
// (B,H) f64 is scratch, and so are, on the CUDA cores, yd (B,H,T) f64 and,
// on the tensor cores, states (B,H,nc - 1,P,N) f32 with nc = ceil(T / 64)
// (null when nc is 1). P and N at most 128, T >= 1. With cuda_core set the
// call takes the CUDA cores whatever its shape (to time that route at a
// shape the tensor cores take); on the tensor cores dy must be readable by
// 16-byte copies, as x is.
extern "C" int ssd_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* dy, const void* dh_last, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* yd, void* dA_part, void* states,
    int B, int T_, int H, int P, int N, long long x_sb, long long x_st,
    long long x_sh, long long x_se, long long dt_sb, long long dt_st,
    long long dt_sh, long long A_s, long long B_sb, long long B_st,
    long long B_sh, long long B_se, long long C_sb, long long C_st,
    long long C_sh, long long C_se, long long y_sb, long long y_st,
    long long y_sh, long long y_se, int is_bf16, int cuda_core,
    void* stream) {
  if (P < 1 || P > 128 || N < 1 || N > 128 || T_ < 1)
    return cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.dt = dt; a.A = A; a.Bm = Bm; a.C = C; a.dy = dy; a.dh = dh_last;
  a.dx = dx; a.ddt = ddt; a.dB = dB; a.dC = dC; a.yd = yd;
  a.dA_part = dA_part; a.dA = dA; a.hs = states;
  a.B = B; a.T = T_; a.H = H; a.P = P; a.N = N;
  a.x_sb = x_sb; a.x_st = x_st; a.x_sh = x_sh; a.x_se = x_se;
  a.dt_sb = dt_sb; a.dt_st = dt_st; a.dt_sh = dt_sh; a.A_s = A_s;
  a.B_sb = B_sb; a.B_st = B_st; a.B_sh = B_sh; a.B_se = B_se;
  a.C_sb = C_sb; a.C_st = C_st; a.C_sh = C_sh; a.C_se = C_se;
  a.y_sb = y_sb; a.y_st = y_st; a.y_sh = y_sh; a.y_se = y_se;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Route r = CUDA_CORE;
  int err;
  if (is_bf16 && !cuda_core && tc::takes(a)) {
    const int nc = (T_ + tc::QB - 1) / tc::QB;
    if (!tc::vec16(dy, y_sb, y_st, y_sh, y_se) ||
        (nc > 1 && states == nullptr))
      return cudaErrorInvalidValue;
    r = TENSOR_CORE;
    err = tc::launch(a, st);
  } else {
    if (yd == nullptr) return cudaErrorInvalidValue;
    err = is_bf16 ? launch_shape<__nv_bfloat16>(a, st)
                  : launch_shape<float>(a, st);
  }
  if (err == 0) taken[r].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// Copies the launches by route (tensor_core, cuda_core) since the last reset
// into counts[2]; with reset, zeroes them.
extern "C" void ssd_bwd_routes(unsigned long long* counts, int reset) {
  for (int r = 0; r < ROUTES; ++r)
    counts[r] = reset ? taken[r].exchange(0) : taken[r].load();
}
