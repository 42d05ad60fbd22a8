// Mamba2 SSD (state-space duality) chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (ssd, def at :69,
// pallas_call at :87). Same contract, from h0 = 0:
//
//   x (B,T,H,P) and B_, C (B,T,H,N) in f32 or bf16; dt (B,T,H) f32 > 0;
//   A (H,) f32 < 0  ->  y (B,T,H,P) in x's type, h_last (B,H,P,N) in f32
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
//
// computed chunk by chunk as the Pallas body does. Within a chunk of Q steps,
// with cum the inclusive cumsum of dt*A over the chunk:
//
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//        + exp(cum_i) (h C_i)                       (the carried state)
//   h'   = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// What bounds it on the H100: at the serve shape (B 8, T 512, H 64, P 64,
// N 128, chunk 128, one group) x read and y written in bf16, dt, B and C
// read, h_last written: 87 MB with B and C counted once per group, 0.026 ms
// at 3.35 TB/s; its 2.1e10 FLOP take 0.022 ms on the bf16 tensor cores and
// 0.32 ms on the f32 CUDA cores. The four products of a chunk are matrix
// products (C B^T, the masked scores times x, C h^T and (x w)^T B), so the
// bf16 route puts them on the tensor cores and keeps the next chunk's loads
// in flight behind them. What is left is latency and shared-memory traffic:
// two warps a sub-partition, each ldmatrix and mma.sync waiting tens of
// cycles for its result, and every warp reading all of the carried h.
//
// Two routes; the launcher counts the one each call took (ssd_routes):
//
// Tensor cores (bf16 x, head dim and state size multiples of 16, head dim
// <= 64, chunk >= 16, x, B_ and C with unit element stride and 16-byte
// aligned bases and strides; mamba2's prefill):
// - A block walks a (b, h)'s chunks in order, as the Pallas grid does, so
//   the state never leaves the chip: the (P, N) state lives in registers,
//   f32, as the accumulators of the state update; only h_last is written
//   to device memory. The grid is one block an SM, each block taking
//   (b, h) items in turn, so the ring runs on from one item's last chunk
//   into the next item's first and only a block's first load is exposed.
// - A two-stage ring: while chunk c is computed, chunk c + 1's x, B and C
//   (16 bytes a cp.async) are in flight; each input is read through its
//   strides, h folded into the base pointer, so x may be a view of the conv
//   output and B_/C stride-0 expansions over heads. Rows past the chunk and
//   columns past P or N are zero-filled (src-size 0), so no product needs
//   a bound. (TMA in place of cp.async measured 2% slower on an H100 in a
//   one-role version of this kernel: the copies' issue does not bound it.)
// - Two roles, one warp of each a sub-partition. 4 y warps: warp w owns
//   row tiles w and 7 - w of the chunk (16 rows each, the same causal work
//   for all four): the carried state's term exp(cum_i) C h^T by mma.sync
//   m16n8k16 for both tiles in one k-loop (C's rows as A fragments; each
//   fragment of h read once for the two); then, a tile at a time,
//   S = C B^T in groups of two 16-column blocks up to the diagonal (groups
//   wholly above it are skipped, a group's block above it comes out masked
//   to 0), the mask and exp(cum_i - cum_j) dt_j applied to the
//   accumulators, the mask before the exp; S kept in registers as the A
//   operands of S x (x by ldmatrix.trans). 4 state warps at the same time:
//   x_j w_j into shared memory, then h = exp(cum_last) h + (x w)^T B, warp
//   m owning rows 16m .. 16m + 15 of h in f32 registers from chunk to
//   chunk; after the y warps are done with the last h they write the new
//   one for the next chunk's C h^T. At the serve shape on an H100
//   (tools/kernel_host_ab.py, graph replay): one role of 8 warps, the
//   state update after the y phase, 0.143 ms; 8 y warps beside 4 state
//   warps, 0.121 ms, but three warps a sub-partition leave 168 registers
//   a thread and the y warps spilled; these 8 warps, 0.130 ms with 218
//   registers and no spills, and 0.127 ms (230 registers) once the two
//   tiles' C h^T shared their h fragments.
// - Every loop of products runs to fixed bounds (tiles of P 64, N 128 and
//   128 rows, zeros where the inputs end): a bound tested inside such a
//   loop became a branch and a warp sync around each ldmatrix and mma.sync,
//   and nothing was loaded ahead of its use.
// - The cumsum of dt*A (log2 units, for ex2) is off the y warps' path:
//   state warp 4 loads the next chunk's dt at the top of a chunk and scans
//   it after its update, into the other parity's arrays. Two block
//   barriers a chunk (bar.sync 0 from either role's loop): one when its
//   loads have landed, one when the y warps are done with the carried h; a
//   named barrier among the state warps once x w is whole.
// - Rounding (the Pallas body multiplies in f32): the products accumulate
//   in f32 and the operands are rounded at three points and no others: the
//   masked scores enter S x as bf16 hi + lo (two products); the state is
//   carried from chunk to chunk in f32 and read by C h^T as bf16 hi + lo;
//   x_j w_j is rounded once to bf16 for the state update; h_last is the f32
//   state. (tools/ssd_rounding_margin.py, on the CPU at an eighth of the
//   serve shape: one rounding of S and h left y at up to 0.83 of the 2e-2
//   gate; hi + lo at 0.37, near the 0.30 of exact products.)
//   tests/test_torch_ssd_route.py holds a CPU emulation of exactly this
//   arithmetic to JAX.
//
// CUDA cores (f32 x, which the f32 gates need in f32 arithmetic, and shapes
// the tiles cannot take): one block per (b, h) with the state in shared
// memory; per chunk x and B staged as f32, then row blocks of the chunk (64
// rows with 16 warps at head dim 64, else 32 rows with 8 warps): C rows, the
// masked scores S (stored transposed, so a warp reads its 4 rows as one
// float4) and y; then the state update. Column groups wholly above a warp's
// rows are skipped. The cumsum of dt*A over the chunk, and each difference
// of it that a decay exp(cum_i - cum_j) takes, are f64 (the f32 route's
// only f64): in f32 the cumsum reached |cum| ~ 90 over a 128-step chunk of
// mamba2-1.3b at random init, its rounding cost every decay ~1e-5 of
// relative error, and the route added 1.6e-6 of relative error to y and
// h_last a layer, 17x an f32 recurrence's, which summed over 48 layers to
// the f32 serve gate's edge (tools/mamba2_gate_margin.py on an H100). T
// may be any length >= 1 on both routes (the Pallas kernel asserts
// T % chunk == 0), the tail chunk masked.
//
// Shared memory: above the 48 KB default on both routes (227,328 bytes on
// the tensor cores), so each instance raises its limit once a device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int RW = 4;          // rows per warp in a row block (a float4)
constexpr int QMAX = 128;      // longest chunk
constexpr int QG = QMAX / 32;  // column groups of a chunk
constexpr int NMAX = 128;      // largest d_state
constexpr int NL = NMAX / 32;  // state columns per lane in the update
constexpr int U = 8;           // global loads in flight per thread

struct Str4 {
  long long b, t, h, e;
};

// -- the CUDA-core route (f32, and shapes the tiles cannot take) ----------

// Warps per block for PC = ceil(P / 32): 16 for head dim 33..64 (mamba2's
// 64), so twice the warps hide the latency of shared loads; 8 otherwise,
// where 16 would not fit in shared memory (P > 64) or would leave the
// state update fewer than 4 rows per warp (P <= 32).
template <int PC> struct Shape {
  static constexpr int NW = PC == 2 ? 16 : 8;   // warps
  static constexpr int NT = 32 * NW;            // threads
  static constexpr int R = RW * NW;             // chunk rows per row block
  static constexpr int PU = 32 * PC / NW;       // state rows per warp
};

// Stage a (rows x cols) tile, element (r, c) at g[r * rs + c * es], into
// shared s[r * ld + c] as f32, zero where r >= rv or c >= cv. Each of the
// NT threads issues U loads before it stores any, so U are in flight.
template <int NT, typename T>
__device__ __forceinline__ void stage(float* __restrict__ s, int ld,
                                      const T* __restrict__ g, long long rs,
                                      long long es, int rows, int cols,
                                      int rv, int cv) {
  using E = rt::Elem<T>;
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += NT * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT;
      const int r = i / cols, c = i % cols;
      v[u] = (i < total && r < rv && c < cv)
                 ? E::to_float(g[r * rs + c * es]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT;
      if (i < total) s[(i / cols) * ld + i % cols] = v[u];
    }
  }
}

template <typename T, int PC>
__global__ void __launch_bounds__(Shape<PC>::NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ hlast, int H, int Tn, int P, int N, int Q,
           Str4 sx, Str4 sdt, long long sA, Str4 sb, Str4 sc) {
  using E = rt::Elem<T>;
  constexpr int NT = Shape<PC>::NT, R = Shape<PC>::R, PU = Shape<PC>::PU;
  constexpr int PP = PC * 32;           // padded head dim (x row stride)
  const int QP = ((Q + 31) / 32) * 32;  // padded chunk length
  const int HS = N | 1;                 // state and B row stride (odd)

  extern __shared__ double smem_d[];
  double* cum = smem_d;         // [QP]      inclusive cumsum of dt*A, f64
  float* hs = reinterpret_cast<float*>(cum + QP);  // [PP][HS] the state
  float* xs = hs + PP * HS;     // [QP][PP]  x of the chunk
  float* bs = xs + QP * PP;     // [QP][HS]  B of the chunk
  float* cs = bs + QP * HS;     // [R][N]    C of a row block
  float* ss = cs + R * N;       // [QP][R]   masked scores of a row block,
                                //           transposed: ss[j][r]
  float* dts = ss + QP * R;     // [QP]      dt

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float a = A[h * sA];
  const T* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const T* bb = Bm + b * sb.b + h * sb.h;
  const T* cb = Cm + b * sc.b + h * sc.h;
  const long long syt = (long long)H * P;        // y is (B,T,H,P) dense
  T* yb = y + (long long)b * Tn * syt + (long long)h * P;

  for (int i = tid; i < PP * HS; i += NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < Tn; c0 += Q) {
    const int qv = min(Q, Tn - c0);      // valid rows of this chunk
    __syncthreads();                     // last chunk's readers are done
    stage<NT>(xs, PP, xb + c0 * sx.t, sx.t, sx.e, QP, PP, qv, P);
    stage<NT>(bs, HS, bb + c0 * sb.t, sb.t, sb.e, QP, N, qv, N);
    for (int i = tid; i < QP; i += NT)
      dts[i] = i < qv ? dtb[(c0 + i) * sdt.t] : 0.f;
    __syncthreads();
    if (warp == 0) {                     // cumsum: 4 per lane, then a scan
      double v[QMAX / 32];
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int i = lane * (QMAX / 32) + k;
        run += i < QP ? (double)dts[i] * a : 0.0;
        v[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const double off = incl - run;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int i = lane * (QMAX / 32) + k;
        if (i < QP) cum[i] = v[k] + off;
      }
    }
    __syncthreads();
    const double clast = cum[qv - 1];

    for (int i0 = 0; i0 < qv; i0 += R) {
      stage<NT>(cs, N, cb + (c0 + i0) * sc.t, sc.t, sc.e, R, N, qv - i0,
                N);
      __syncthreads();

      // S[r][j] = (C_r . B_j) exp(cum_r - cum_j) dt_j for j <= r, else 0
      const int rw = warp * RW;                 // first row in the block
      const int r0 = i0 + rw;                   // first row in the chunk
      const int gmax =
          r0 < qv ? min(QP / 32, (r0 + RW - 1) / 32 + 1) : 0;
      float acc[RW][QG];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int g = 0; g < QG; ++g) acc[i][g] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float cr[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) cr[i] = cs[(rw + i) * N + k];
#pragma unroll
        for (int g = 0; g < QG; ++g) {
          if (g < gmax) {
            const float bv = bs[(g * 32 + lane) * HS + k];
#pragma unroll
            for (int i = 0; i < RW; ++i) acc[i][g] += cr[i] * bv;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        const int j = g * 32 + lane;
        if (j < QP) {
          float4 sv;
          float* sp = &sv.x;
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const int r = r0 + i;
            sp[i] = (g < gmax && j <= r)
                        ? acc[i][g] * expf((float)(cum[r] - cum[j])) *
                              dts[j]
                        : 0.f;
          }
          *reinterpret_cast<float4*>(ss + j * R + rw) = sv;
        }
      }
      __syncthreads();

      // y_r = sum_{j<=r} S[r][j] x_j + exp(cum_r) (h C_r)
      float ya[RW][PC], ca[RW][PC];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) ya[i][c] = ca[i][c] = 0.f;
      const int jw = r0 < qv ? min(r0 + RW, qv) : 0;  // S[r][j] = 0, j > r
#pragma unroll 4
      for (int j = 0; j < jw; ++j) {
        const float4 sv = *reinterpret_cast<const float4*>(ss + j * R + rw);
        const float* sp = &sv.x;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float xv = xs[j * PP + c * 32 + lane];
#pragma unroll
          for (int i = 0; i < RW; ++i) ya[i][c] += sp[i] * xv;
        }
      }
      if (r0 < qv) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cr[RW];
#pragma unroll
          for (int i = 0; i < RW; ++i) cr[i] = cs[(rw + i) * N + n];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const float hv = hs[(c * 32 + lane) * HS + n];
#pragma unroll
            for (int i = 0; i < RW; ++i) ca[i][c] += cr[i] * hv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = r0 + i;
        if (r < qv) {
          const float e = expf((float)cum[r]);
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int p = c * 32 + lane;
            if (p < P)
              yb[(c0 + r) * syt + p] = E::from_float(ya[i][c] + e * ca[i][c]);
          }
        }
      }
      __syncthreads();                  // before cs, ss and hs change
    }

    // h = exp(cum_last) h + sum_j w_j x_j B_j^T; each thread owns its
    // (p, n) entries: p = PU warp + u (a float4-aligned run), n = lane + 32 m
    const float eq = expf((float)clast);
    float ha[PU][NL];
#pragma unroll
    for (int u = 0; u < PU; ++u)
#pragma unroll
      for (int m = 0; m < NL; ++m) {
        const int n = lane + 32 * m;
        ha[u][m] = n < N ? eq * hs[(warp * PU + u) * HS + n] : 0.f;
      }
#pragma unroll 2
    for (int j = 0; j < qv; ++j) {
      float xv[PU];
#pragma unroll
      for (int u = 0; u < PU; u += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(xs + j * PP + warp * PU + u);
        xv[u] = v4.x;
        xv[u + 1] = v4.y;
        xv[u + 2] = v4.z;
        xv[u + 3] = v4.w;
      }
      const float w = expf((float)(clast - cum[j])) * dts[j];
#pragma unroll
      for (int m = 0; m < NL; ++m) {
        const int n = lane + 32 * m;
        if (m * 32 < N) {
          const float bv = n < N ? w * bs[j * HS + n] : 0.f;
#pragma unroll
          for (int u = 0; u < PU; ++u) ha[u][m] += xv[u] * bv;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PU; ++u)
#pragma unroll
      for (int m = 0; m < NL; ++m) {
        const int n = lane + 32 * m;
        if (n < N) hs[(warp * PU + u) * HS + n] = ha[u][m];
      }
  }

  __syncthreads();
  float* hb = hlast + (long long)blockIdx.x * P * N;
  for (int i = tid; i < P * N; i += NT) {
    const int p = i / N, n = i % N;
    hb[i] = hs[p * HS + n];
  }
}

template <int PC>
size_t smem_bytes(int N, int Q) {
  const size_t PP = PC * 32, QP = ((Q + 31) / 32) * 32, HS = N | 1;
  const size_t R = Shape<PC>::R;
  return sizeof(float) * (PP * HS + QP * PP + QP * HS + R * N + QP * R +
                          QP) +
         sizeof(double) * QP;
}

template <typename T, int PC>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* hlast, int Bn, int Tn, int H, int P,
           int N, int Q, Str4 sx, Str4 sdt, long long sA, Str4 sb, Str4 sc,
           cudaStream_t st) {
  static unsigned long long done = 0;
  auto kern = ssd_kernel<T, PC>;
  const cudaError_t err =
      rt::allow_smem(kern, (int)smem_bytes<PC>(NMAX, QMAX), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<Bn * H, Shape<PC>::NT, smem_bytes<PC>(N, Q), st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(hlast), H, Tn, P, N, Q, sx, sdt, sA, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_p(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* hlast, int Bn, int Tn, int H,
               int P, int N, int Q, Str4 sx, Str4 sdt, long long sA, Str4 sb,
               Str4 sc, cudaStream_t st) {
  if (P <= 32)
    return launch<T, 1>(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H, P, N, Q, sx,
                        sdt, sA, sb, sc, st);
  if (P <= 64)
    return launch<T, 2>(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H, P, N, Q, sx,
                        sdt, sA, sb, sc, st);
  return launch<T, 4>(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H, P, N, Q, sx,
                      sdt, sA, sb, sc, st);
}

// -- the tensor-core route (bf16) --------------------------------------------
namespace tc {

constexpr int NY = 4;              // warps of the y phase: two row tiles
constexpr int NS = 4;              // warps of the state update: a p block
constexpr int NT = 32 * (NY + NS);
constexpr int PC = 64;             // head dim of the tiles (smaller: padded)
constexpr int NC = 128;            // state size of the tiles
constexpr int QC = 128;            // rows of a chunk's tiles
constexpr int XLD = PC + 8;        // staged x rows (bf16): 16 bytes of pad,
constexpr int BLD = NC + 8;        // staged B and C rows: so ldmatrix's 8
                                   // rows fall in 8 different bank groups
constexpr int NK = NC / 16;        // k-steps over the state
constexpr int PT = PC / 16;        // 16-wide blocks of the head dim
constexpr int JG = 2;              // column blocks of S in registers at once
constexpr int NB = NC / 16;        // 16-wide state blocks
constexpr float LOG2E = 1.4426950408889634f;

struct Stage {                     // one chunk's inputs
  bf16 x[QC * XLD];
  bf16 b[QC * BLD];
  bf16 c[QC * BLD];
};

struct Smem {                      // 227,328 bytes
  Stage st[2];                     // the ring
  bf16 hhi[PC * NC];               // the carried state as bf16 hi + lo,
  bf16 hlo[PC * NC];               // [p][n], swizzled (hsw)
  bf16 xw[QC * PC];                // x_j w_j, [j][p], swizzled (xsw)
  float cum[2][QC];                // a chunk's cumsum of dt*A*log2(e), and
  float dt[2][QC];                 // its dt, by chunk parity
};

// Unpadded tiles whose rows are a multiple of 128 bytes: 16-byte chunk c of
// row r sits at chunk c ^ (r % 8), so ldmatrix's 8 rows and the fragment
// stores hit 8 different bank groups.
__device__ __forceinline__ int hsw(int p, int n) {
  return p * NC + ((((n >> 3) ^ p) & 7) | ((n >> 3) & ~7)) * 8 + (n & 7);
}
__device__ __forceinline__ int xsw(int j, int p) {
  return j * PC + ((((p >> 3) ^ j) & 7) | ((p >> 3) & ~7)) * 8 + (p & 7);
}

// bf16 hi + lo of (a, b): hi the rounded values, lo their rounded remainders
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = rt::pack_bf16(a, b);
  const float2 r = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = rt::pack_bf16(a - r.x, b - r.y);
}

__device__ __forceinline__ float ex2(float x) { return rt::exp2_approx(x); }

// All threads of the block; called from both warp roles' loops.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// One warp's scan of a chunk: dt of its steps (4 a lane, 0 past the chunk)
// into the inclusive cumsum of dt*A*log2(e); both stored.
__device__ __forceinline__ void scan_chunk(const float (&d)[4], float a2,
                                           int lane, float* cum, float* dts) {
  const float v0 = d[0] * a2, v1 = v0 + d[1] * a2, v2 = v1 + d[2] * a2,
              v3 = v2 + d[3] * a2;
  float incl = v3;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float off = incl - v3;
  *reinterpret_cast<float4*>(&cum[4 * lane]) =
      make_float4(v0 + off, v1 + off, v2 + off, v3 + off);
  *reinterpret_cast<float4*>(&dts[4 * lane]) =
      make_float4(d[0], d[1], d[2], d[3]);
}

__global__ void __launch_bounds__(NT, 1)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, bf16* __restrict__ y,
              float* __restrict__ hlast, int BH, int H, int Tn, int P, int N,
              int Q, Str4 sx, Str4 sdt, long long sA, Str4 sb, Str4 sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long syt = (long long)H * P;        // y is (B,T,H,P) dense
  // y warp w takes row tiles w and 7 - w (the same causal work for all
  // four); state warp NY + m takes p block m of the state, all of N
  const int mt = warp - NY;
  // ldmatrix lane offsets: A (rows lane % 16, k half lane / 16), B stored
  // [n][k] (n lane % 8 + 8 (lane / 16), k half (lane / 8) % 2), and their
  // transposes
  const int ar = lane & 15, ak = (lane >> 4) * 8;
  const int bn = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 8;

  // A chunk's x, B and C of (b, h) = item into a stage: every row of the
  // tiles, zero past the chunk and past P or N, so the products need no
  // bounds.
  auto load = [&](int s, int item, int c0) {
    Stage& S = sm.st[s];
    const int b = item / H, h = item % H;
    const bf16* xb = x + b * sx.b + h * sx.h;
    const bf16* bb = Bm + b * sb.b + h * sb.h;
    const bf16* cb = Cm + b * sc.b + h * sc.h;
    const int qv = min(Q, Tn - c0);
    for (int i = tid; i < QC * PC / 8; i += NT) {
      const int r = i / (PC / 8), k = (i % (PC / 8)) * 8;
      const bool ok = r < qv && k < P;
      rt::cp_async16(&S.x[r * XLD + k], ok ? xb + (c0 + r) * sx.t + k : xb,
                     ok);
    }
    for (int i = tid; i < QC * NC / 8; i += NT) {
      const int r = i / (NC / 8), k = (i % (NC / 8)) * 8;
      const bool ok = r < qv && k < N;
      rt::cp_async16(&S.b[r * BLD + k], ok ? bb + (c0 + r) * sb.t + k : bb,
                     ok);
      rt::cp_async16(&S.c[r * BLD + k], ok ? cb + (c0 + r) * sc.t + k : cb,
                     ok);
    }
    rt::cp_async_commit();
  };
  // dt of item's chunk at c0, 4 steps a lane (0 past the chunk), for the
  // scan
  auto load_dt = [&](int item, int c0, float (&d)[4]) {
    const float* dtb = dt + (item / H) * sdt.b + (item % H) * sdt.h;
    const int qv = min(Q, Tn - c0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      d[k] = i < qv ? dtb[(c0 + i) * sdt.t] : 0.f;
    }
  };

  // The block walks items blockIdx.x, + gridDim.x, ... (a grid of one
  // block an SM) and each item's chunks in order; the ring runs on from one
  // item's last chunk into the next item's first.
  auto a2_of = [&](int item) { return A[(item % H) * sA] * LOG2E; };
  int item = blockIdx.x;
  if (item >= BH) return;
  load(0, item, 0);
  if (warp == NY) {
    float d[4];
    load_dt(item, 0, d);
    scan_chunk(d, a2_of(item), lane, sm.cum[0], sm.dt[0]);
  }
  // The two roles walk the same chunks and meet at the same two block
  // barriers a chunk (bar.sync 0, from either role's loop). begin() waits
  // until chunk (item, c0) has landed, then issues the copies of the next
  // one, (item2, c2).
  auto begin = [&](int s, int item, int c0, int& item2, int& c2) {
    const bool more = c0 + Q < Tn;
    item2 = more ? item : item + gridDim.x;
    c2 = more ? c0 + Q : 0;
    rt::cp_async_wait<0>();
    block_sync();                  // this chunk has landed, its cumsum is
                                   // written; the last one's readers of the
                                   // other stage are done
    if (item2 < BH) load(s ^ 1, item2, c2);
  };

  if (warp >= NY) {
    // the state warps: x_j w_j in bf16, w_j = exp(cum_last - cum_j) dt_j
    // (0 past the chunk, where x and dt are 0), rows 32 mt .. 32 mt + 31;
    // then h = exp(cum_last) h + (x w)^T B on p block mt in f32, held in
    // registers from chunk to chunk, while the y warps compute
    float hacc[NB][2][4];
    for (int s = 0, c0 = 0; item < BH; s ^= 1) {
      int item2, c2;
      begin(s, item, c0, item2, c2);
      float dnext[4];              // warp NY: the next chunk's dt, in flight
      if (warp == NY && item2 < BH) load_dt(item2, c2, dnext);
      const int qv = min(Q, Tn - c0);
      const bool more = c0 + Q < Tn;
      const Stage& S = sm.st[s];
      const float* cum = sm.cum[s];
      const float* dts = sm.dt[s];
      const float clast = cum[qv - 1];
#pragma unroll
      for (int v = 0; v < 32 * PC / 8 / 32; ++v) {
        const int i = v * 32 + lane;
        const int r = mt * 32 + i / (PC / 8), k = (i % (PC / 8)) * 8;
        const float w = ex2(clast - cum[r]) * dts[r];
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
        *reinterpret_cast<uint4*>(&sm.xw[xsw(r, k)]) = o;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * NS) : "memory");
      const float eq = ex2(clast);
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            hacc[i][e][k] = c0 > 0 ? hacc[i][e][k] * eq : 0.f;
#pragma unroll
      for (int kb = 0; kb < QC / 16; ++kb) {
        uint32_t af[4], bf[NB][4];
        rt::ldsm_x4_trans(af, &sm.xw[xsw(kb * 16 + bn, mt * 16 + bk)]);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          rt::ldsm_x4_trans(bf[i], &S.b[(kb * 16 + bk + (lane & 7)) * BLD +
                                        i * 16 + ak]);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          rt::mma_bf16(hacc[i][0], af, bf[i]);
          rt::mma_bf16(hacc[i][1], af, bf[i] + 2);
        }
      }
      // the next chunk's cumsum, into the other parity's arrays, which no
      // warp reads in this chunk
      if (warp == NY && item2 < BH)
        scan_chunk(dnext, a2_of(item2), lane, sm.cum[s ^ 1], sm.dt[s ^ 1]);
      block_sync();                // h's readers are done

      // h for the next chunk's C h^T as bf16 hi + lo, or h_last after an
      // item's last chunk
      const int p0 = mt * 16 + g;
      float* hb = hlast + (long long)item * P * N;
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = i * 16 + e * 8 + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float a = hacc[i][e][2 * r], c = hacc[i][e][2 * r + 1];
            const int p = p0 + 8 * r;
            if (more) {
              uint32_t hi, lo;
              split2(a, c, hi, lo);
              *reinterpret_cast<uint32_t*>(&sm.hhi[hsw(p, n)]) = hi;
              *reinterpret_cast<uint32_t*>(&sm.hlo[hsw(p, n)]) = lo;
            } else if (p < P && n < N) {
              *reinterpret_cast<float2*>(&hb[p * N + n]) = make_float2(a, c);
            }
          }
        }
      item = item2;
      c0 = c2;
    }
    return;
  }

  // the y warps
  for (int s = 0, c0 = 0; item < BH; s ^= 1) {
    int item2, c2;
    begin(s, item, c0, item2, c2);
    const int qv = min(Q, Tn - c0);
    bf16* yb = y + (long long)(item / H) * Tn * syt +
               (long long)(item % H) * P;
    const Stage& S = sm.st[s];
    const float* cum = sm.cum[s];
    const float* dts = sm.dt[s];

    // y for this warp's two 16-row tiles (t 0: tile warp, t 1: tile
    // 7 - warp): both tiles' C h^T in one k-loop, so each h fragment is
    // read once for both, then each tile's S x
    float yacc[2][2 * PT][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) yacc[t][n][k] = 0.f;
    if (c0 > 0 && warp * 16 < qv) {  // exp(cum_i) C_i h^T (h is 0 before)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t cf[2][4], bh[PT][4], bl[PT][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
          rt::ldsm_x4(cf[t], &S.c[((t ? 7 - warp : warp) * 16 + ar) * BLD +
                                  kk * 16 + ak]);
#pragma unroll
        for (int pb = 0; pb < PT; ++pb) {
          rt::ldsm_x4(bh[pb], &sm.hhi[hsw(pb * 16 + bn, kk * 16 + bk)]);
          rt::ldsm_x4(bl[pb], &sm.hlo[hsw(pb * 16 + bn, kk * 16 + bk)]);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int pb = 0; pb < PT; ++pb) {
            rt::mma_bf16(yacc[t][2 * pb], cf[t], bh[pb]);
            rt::mma_bf16(yacc[t][2 * pb + 1], cf[t], bh[pb] + 2);
          }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int pb = 0; pb < PT; ++pb) {
            rt::mma_bf16(yacc[t][2 * pb], cf[t], bl[pb]);
            rt::mma_bf16(yacc[t][2 * pb + 1], cf[t], bl[pb] + 2);
          }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int r0 = (t ? 7 - warp : warp) * 16;
        const float e0 = ex2(cum[r0 + g]), e1 = ex2(cum[r0 + g + 8]);
#pragma unroll
        for (int n = 0; n < 2 * PT; ++n) {
          yacc[t][n][0] *= e0;
          yacc[t][n][1] *= e0;
          yacc[t][n][2] *= e1;
          yacc[t][n][3] *= e1;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = t ? 7 - warp : warp;
      const int r0 = tile * 16;
      if (r0 < qv) {
        const float ci0 = cum[r0 + g], ci1 = cum[r0 + g + 8];
        const int i0 = r0 + g, i1 = i0 + 8;
        // C's rows as the A fragment of k-step kk (loaded where used: held
        // for all k-steps they would cost 32 registers)
        auto c_frag = [&](int kk, uint32_t (&cf)[4]) {
          rt::ldsm_x4(cf, &S.c[(r0 + ar) * BLD + kk * 16 + ak]);
        };

        // S = C B^T in groups of JG column blocks up to the diagonal (a
        // group's blocks above it come out masked to 0), then S x
        for (int j0 = 0; j0 <= tile; j0 += JG) {
          float sacc[JG][2][4];
#pragma unroll
          for (int u = 0; u < JG; ++u)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int k = 0; k < 4; ++k) sacc[u][e][k] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            uint32_t cf[4], bf[JG][4];
            c_frag(kk, cf);
#pragma unroll
            for (int u = 0; u < JG; ++u)
              rt::ldsm_x4(bf[u],
                          &S.b[((j0 + u) * 16 + bn) * BLD + kk * 16 + bk]);
#pragma unroll
            for (int u = 0; u < JG; ++u) {
              rt::mma_bf16(sacc[u][0], cf, bf[u]);
              rt::mma_bf16(sacc[u][1], cf, bf[u] + 2);
            }
          }

          // mask (before the exp) and weight; S as bf16 hi + lo, in
          // registers, the A operands of S x
#pragma unroll
          for (int u = 0; u < JG; ++u) {
            const int jb = j0 + u;
            uint32_t bx[PT][4];      // x's fragments, loaded under the mask
#pragma unroll
            for (int pb = 0; pb < PT; ++pb)
              rt::ldsm_x4_trans(bx[pb], &S.x[(jb * 16 + bk + (lane & 7)) *
                                                 XLD + pb * 16 + ak]);
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = jb * 16 + e * 8 + 2 * t4;
              const float2 cj = *reinterpret_cast<const float2*>(&cum[j]);
              const float2 dj = *reinterpret_cast<const float2*>(&dts[j]);
              split2(j <= i0 ? sacc[u][e][0] * (ex2(ci0 - cj.x) * dj.x) : 0.f,
                     j + 1 <= i0 ? sacc[u][e][1] * (ex2(ci0 - cj.y) * dj.y)
                                 : 0.f,
                     ah[2 * e], al[2 * e]);
              split2(j <= i1 ? sacc[u][e][2] * (ex2(ci1 - cj.x) * dj.x) : 0.f,
                     j + 1 <= i1 ? sacc[u][e][3] * (ex2(ci1 - cj.y) * dj.y)
                                 : 0.f,
                     ah[2 * e + 1], al[2 * e + 1]);
            }
#pragma unroll
            for (int pb = 0; pb < PT; ++pb) {
              rt::mma_bf16(yacc[t][2 * pb], ah, bx[pb]);
              rt::mma_bf16(yacc[t][2 * pb + 1], ah, bx[pb] + 2);
            }
#pragma unroll
            for (int pb = 0; pb < PT; ++pb) {
              rt::mma_bf16(yacc[t][2 * pb], al, bx[pb]);
              rt::mma_bf16(yacc[t][2 * pb + 1], al, bx[pb] + 2);
            }
          }
        }

#pragma unroll
        for (int n = 0; n < 2 * PT; ++n) {
          const int p = n * 8 + 2 * t4;
          if (p >= P) continue;
          if (i0 < qv)
            *reinterpret_cast<uint32_t*>(yb + (c0 + i0) * syt + p) =
                rt::pack_bf16(yacc[t][n][0], yacc[t][n][1]);
          if (i1 < qv)
            *reinterpret_cast<uint32_t*>(yb + (c0 + i1) * syt + p) =
                rt::pack_bf16(yacc[t][n][2], yacc[t][n][3]);
        }
      }
    }
    block_sync();                  // h's readers are done
    item = item2;
    c0 = c2;
  }
}

int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* hlast, int Bn, int Tn, int H, int P,
           int N, int Q, Str4 sx, Str4 sdt, long long sA, Str4 sb, Str4 sc,
           cudaStream_t st) {
  static unsigned long long done = 0;
  const cudaError_t err =
      rt::allow_smem(ssd_tc_kernel, (int)sizeof(Smem), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BH = Bn * H, grid = BH < rt::sm_count() ? BH : rt::sm_count();
  ssd_tc_kernel<<<grid, NT, sizeof(Smem), st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
      static_cast<float*>(hlast), BH, H, Tn, P, N, Q, sx, sdt, sA, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

// Whether a bf16 call fits the tiles: head dim and state size multiples of
// 16 (head dim <= 64), chunks of at least 16 steps, and x, B_ and C with
// unit element stride and 16-byte aligned bases and (b, t, h) strides.
bool takes(const void* x, const void* Bm, const void* Cm, int P, int N,
           int chunk, Str4 sx, Str4 sb, Str4 sc) {
  auto vec = [](const void* p, Str4 s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.e == 1 &&
           s.b % 8 == 0 && s.t % 8 == 0 && s.h % 8 == 0;
  };
  return P % 16 == 0 && P <= PC && N % 16 == 0 && N <= NC && chunk >= 16 &&
         vec(x, sx) && vec(Bm, sb) && vec(Cm, sc);
}

}  // namespace tc

// The routes a call can take (the wrapper's ``route`` names them), and the
// launches each has had: the launcher counts the route it took.
enum Route { TENSOR_CORE, CUDA_CORE, ROUTES };
std::atomic<unsigned long long> taken[ROUTES];

}  // namespace

// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for shapes outside 1 <= chunk <= 128, 1 <= P <= 128,
// 1 <= N <= 128. Chunks are min(chunk, T) steps. Strides are in elements:
// (b, t, h, element) for x, B_ and C, (b, t, h) for dt, one for A. y
// (B,T,H,P) and h_last (B,H,P,N) are dense.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* hlast,
                       int Bn, int Tn, int H, int P, int N, int chunk,
                       long long x_sb, long long x_st, long long x_sh,
                       long long x_se, long long dt_sb, long long dt_st,
                       long long dt_sh, long long a_s, long long b_sb,
                       long long b_st, long long b_sh, long long b_se,
                       long long c_sb, long long c_st, long long c_sh,
                       long long c_se, int is_bf16, void* stream) {
  if (Bn <= 0 || H <= 0 || Tn <= 0) return cudaSuccess;
  if (chunk < 1 || chunk > QMAX || P < 1 || P > 128 || N < 1 || N > NMAX)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Q = chunk < Tn ? chunk : Tn;
  const Str4 sx{x_sb, x_st, x_sh, x_se}, sdt{dt_sb, dt_st, dt_sh, 0};
  const Str4 sb{b_sb, b_st, b_sh, b_se}, sc{c_sb, c_st, c_sh, c_se};
  Route r = CUDA_CORE;
  int err;
  if (is_bf16 && tc::takes(x, Bm, Cm, P, N, chunk, sx, sb, sc)) {
    r = TENSOR_CORE;
    err = tc::launch(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H, P, N, Q, sx, sdt,
                     a_s, sb, sc, st);
  } else if (is_bf16) {
    err = dispatch_p<bf16>(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H, P, N, Q,
                           sx, sdt, a_s, sb, sc, st);
  } else {
    err = dispatch_p<float>(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H, P, N, Q,
                            sx, sdt, a_s, sb, sc, st);
  }
  if (err == 0) taken[r].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// Copies the launches by route (tensor_core, cuda_core) since the last reset
// into counts[2]; with reset, zeroes them.
extern "C" void ssd_routes(unsigned long long* counts, int reset) {
  for (int r = 0; r < ROUTES; ++r)
    counts[r] = reset ? taken[r].exchange(0) : taken[r].load();
}
