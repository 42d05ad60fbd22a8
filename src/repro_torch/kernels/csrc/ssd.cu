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
// What bounds it on the H100: bytes, at the serve shape (B 8, T 512, H 64,
// P 64, N 128, chunk 128): x read and y written in bf16, dt, B and C read,
// h_last written, 87 MB (B and C counted once per group), 0.026 ms at
// 3.35 TB/s; its 2.1e10 FLOP would take 0.022 ms on the bf16 tensor cores.
// This first kernel does its math in f32 on the CUDA cores (0.32 ms at
// 67 TFLOP/s), so it is far from that bound; mma.sync / wgmma is later work.
//
// Design (simple first):
// - The Pallas grid (B*H, chunks) with the state carried in VMEM across the
//   sequential chunk axis becomes one block per (b, h) that walks its chunks
//   in a loop: blocks run in no order on Hopper. The (P, N) state stays in
//   shared memory (rows padded to an odd stride) for the whole sequence;
//   only h_last is written to device memory.
// - Per chunk, x and B are staged in shared memory as f32 (each thread
//   keeps 8 global loads in flight); then row blocks of the chunk (64 rows
//   with 16 warps at head dim 64, else 32 rows with 8 warps): C rows, the
//   masked scores S (stored transposed, so a warp reads its 4 rows as one
//   float4) and y; then the state update. In the row blocks each warp owns
//   4 rows and each lane columns lane + 32 g; in the state update each
//   warp owns a run of state rows p and each lane columns n = lane + 32 m.
//   Every shared load is a broadcast or 32 consecutive words (odd padded
//   strides where lanes walk rows).
// - The causal mask is applied before the exp: exp(cum_i - cum_j) for j > i
//   can overflow, and inf * 0 is NaN. Column groups wholly above a warp's
//   rows are skipped.
// - Every input is read through its four strides (b, t, h, element), so x
//   may be a slice of the conv output and B_/C stride-0 expansions over
//   heads; nothing is copied. T may be any length >= 1: the tail chunk is
//   masked (the Pallas kernel asserts T % chunk == 0).
// - Shared memory: at the serve shape 198,912 bytes, above the 48 KB
//   default, so the launch raises the limit with cudaFuncSetAttribute and
//   returns its error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int RW = 4;          // rows per warp in a row block (a float4)
constexpr int QMAX = 128;      // longest chunk
constexpr int QG = QMAX / 32;  // column groups of a chunk
constexpr int NMAX = 128;      // largest d_state
constexpr int NL = NMAX / 32;  // state columns per lane in the update
constexpr int U = 8;           // global loads in flight per thread

struct Str4 {
  long long b, t, h, e;
};

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

  extern __shared__ float smem[];
  float* hs = smem;             // [PP][HS]  the state h[p][n]
  float* xs = hs + PP * HS;     // [QP][PP]  x of the chunk
  float* bs = xs + QP * PP;     // [QP][HS]  B of the chunk
  float* cs = bs + QP * HS;     // [R][N]    C of a row block
  float* ss = cs + R * N;       // [QP][R]   masked scores of a row block,
                                //           transposed: ss[j][r]
  float* dts = ss + QP * R;     // [QP]      dt
  float* cum = dts + QP;        // [QP]      inclusive cumsum of dt*A
  float* wj = cum + QP;         // [QP]      exp(cum_last - cum_j) dt_j

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
      float v[QMAX / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int i = lane * (QMAX / 32) + k;
        run += i < QP ? dts[i] * a : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float off = incl - run;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int i = lane * (QMAX / 32) + k;
        if (i < QP) cum[i] = v[k] + off;
      }
    }
    __syncthreads();
    const float clast = cum[qv - 1];
    for (int i = tid; i < QP; i += NT)
      wj[i] = i < qv ? expf(clast - cum[i]) * dts[i] : 0.f;

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
                        ? acc[i][g] * expf(cum[r] - cum[j]) * dts[j] : 0.f;
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
          const float e = expf(cum[r]);
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
    const float eq = expf(clast);
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
      const float w = wj[j];
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
                          3 * QP);
}

template <typename T, int PC>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* hlast, int Bn, int Tn, int H, int P,
           int N, int Q, Str4 sx, Str4 sdt, long long sA, Str4 sb, Str4 sc,
           cudaStream_t st) {
  const size_t smem = smem_bytes<PC>(N, Q);
  auto kern = ssd_kernel<T, PC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<Bn * H, Shape<PC>::NT, smem, st>>>(
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

}  // namespace

// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for shapes outside 1 <= Q <= 128, 1 <= P <= 128,
// 1 <= N <= 128. Strides are in elements: (b, t, h, element) for x, B_ and
// C, (b, t, h) for dt, one for A. y (B,T,H,P) and h_last (B,H,P,N) are
// dense.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* hlast,
                       int Bn, int Tn, int H, int P, int N, int Q,
                       long long x_sb, long long x_st, long long x_sh,
                       long long x_se, long long dt_sb, long long dt_st,
                       long long dt_sh, long long a_s, long long b_sb,
                       long long b_st, long long b_sh, long long b_se,
                       long long c_sb, long long c_st, long long c_sh,
                       long long c_se, int is_bf16, void* stream) {
  if (Bn <= 0 || H <= 0 || Tn <= 0) return cudaSuccess;
  if (Q < 1 || Q > QMAX || P < 1 || P > 128 || N < 1 || N > NMAX)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Str4 sx{x_sb, x_st, x_sh, x_se}, sdt{dt_sb, dt_st, dt_sh, 0};
  const Str4 sb{b_sb, b_st, b_sh, b_se}, sc{c_sb, c_st, c_sh, c_se};
  if (is_bf16)
    return dispatch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H,
                                     P, N, Q, sx, sdt, a_s, sb, sc, st);
  return dispatch_p<float>(x, dt, A, Bm, Cm, y, hlast, Bn, Tn, H, P, N, Q,
                           sx, sdt, a_s, sb, sc, st);
}
