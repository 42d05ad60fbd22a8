// Mamba2 SSD scan backward for Hopper (sm_90a): dx, ddt, dA, dB_, dC.
//
// Replaces no Pallas kernel: the TPU kernel (src/repro/kernels/ssd.py,
// forward only) has no backward, and JAX gets the gradient by
// differentiating the jnp program around it. Training needs it on the card
// (models/ssm.py::ssm_apply under autograd), so the port's autograd
// Function (kernels/ssd.py) launches this.
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
// What bounds it on the H100: at mamba2's training shape (B 8, T 256, H 64,
// P 64, N 128, bf16) it must read x, dt, B_, C (B_, C once per group), dy
// and write dx, ddt, dB_, dC: ~50 MB, 0.015 ms at 3.35 TB/s; its two walks
// do ~7 FLOP per state element and step (~2.4e10 FLOP), 0.7 ms on the f64
// CUDA cores at their peak (34 TFLOP/s). So operations bound this kernel;
// a chunked form on the tensor cores (wgmma), whose rounding would have to
// keep q's telescoping, is its Hopper redesign, later work (ROADMAP.md).
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
  void *dx, *ddt, *dB, *dC, *yd, *dA_part, *dA;
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

}  // namespace

// Returns the cudaError_t of the launches (0 on success). x, B_, C, dy are
// read through their (batch, seq, head, element) strides, dt through its
// (batch, seq, head) strides and A through its stride; dh_last is null or
// a contiguous f32 (B, H, P, N) tensor. dx (B,T,H,P), dB_, dC (B,T,H,N) in
// x's type, ddt (B,T,H) and dA (H,) f32 are contiguous outputs; yd (B,H,T)
// and dA_part (B,H) f64 are scratch. P and N at most 128, T >= 1.
extern "C" int ssd_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* dy, const void* dh_last, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* yd, void* dA_part, int B, int T_,
    int H, int P, int N, long long x_sb, long long x_st, long long x_sh,
    long long x_se, long long dt_sb, long long dt_st, long long dt_sh,
    long long A_s, long long B_sb, long long B_st, long long B_sh,
    long long B_se, long long C_sb, long long C_st, long long C_sh,
    long long C_se, long long y_sb, long long y_st, long long y_sh,
    long long y_se, int is_bf16, void* stream) {
  if (P < 1 || P > 128 || N < 1 || N > 128 || T_ < 1)
    return cudaErrorInvalidValue;
  const Args a{x,     dt,    A,     Bm,    C,     dy,    dh_last, dx,
               ddt,   dB,    dC,    yd,    dA_part, dA,  B,       T_,
               H,     P,     N,     x_sb,  x_st,  x_sh,  x_se,    dt_sb,
               dt_st, dt_sh, A_s,   B_sb,  B_st,  B_sh,  B_se,    C_sb,
               C_st,  C_sh,  C_se,  y_sb,  y_st,  y_sh,  y_se};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_shape<__nv_bfloat16>(a, st);
  return launch_shape<float>(a, st);
}
