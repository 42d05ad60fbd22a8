// Causal GQA flash attention backward for Hopper (sm_90a): dq, dk, dv.
//
// Replaces no Pallas kernel: the TPU kernel (src/repro/kernels/
// flash_attention.py, forward only) has no backward, and JAX gets the
// gradient by differentiating the jnp program around it. Training needs it
// on the card (models/attention.py::attend_full under autograd), so the
// port's autograd Function (kernels/flash_attention.py) launches this.
//
// Contract: q, do (B,T,H,hd), k, v (B,S,K,hd), o (B,T,H,hd) the forward's
// output and lse (B,H,T) f32 its rows' log-sum-exp (flash_attention.cu);
// query head h reads KV head h / G; causal mask col <= row aligned at 0.
// With P = exp(scale q k^T - lse) (0 where masked) and D = rowsum(do * o):
//
//   dv = P^T do,   dS = P * (do v^T - D),   dq = scale dS k,
//   dk = scale dS^T q,
//
// dk and dv summed over the G query heads of a KV head. Every sum is taken
// in f32 in a fixed order (no atomics), so two calls give the same bits.
// Outputs are contiguous, in q's dtype; the inputs are read through their
// strides (last dimension contiguous).
//
// Two kernels, one after the other on the stream:
//  1. dq: a block per (64-row query tile, head, batch) computes D for its
//     rows (and writes it to a scratch (B,H,T) buffer), then walks the key
//     tiles the mask leaves it, recomputing P and dS, and accumulates dq.
//  2. dk, dv: a block per (64-row key tile, KV head, batch) holds its k and
//     v tiles and walks the query tiles of every head of the group that can
//     see them, recomputing P and dS, with dk and dv in registers.
// Each recomputes S and dP, as FlashAttention-2's backward does without its
// atomics. A simple first kernel: tiles are staged in shared memory as f32
// and the products run on the f32 CUDA cores, thread (ty, tx) of a 16 x 16
// grid owning rows ty + 16 i and columns tx + 16 j of each 64 x 64 score
// tile and of each 64 x hd accumulator, as flash_attention.cu's f32
// kernel does. What bounds it on the H100: at qwen3's training shape (B 8,
// T 256, H 16, K 8, hd 128, causal) it must do about 5.5 GFLOP (four
// products over the causal pairs; S and dP again in the dq pass) and move
// q, k, v, o, do, dq, dk, dv once (~42 MB): 0.013 ms on the bf16 tensor
// cores, 0.08 ms on the f32 CUDA cores at their peak; this kernel runs on
// the CUDA cores, so operations bound it. Its Hopper redesign (wgmma, TMA)
// is later work (ROADMAP.md).
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // rows of a query tile
constexpr int BK = 64;   // rows of a key tile
constexpr int NT = 256;  // 16 x 16 threads
constexpr int LDP = BK + 1;  // row stride of a 64 x 64 f32 tile

template <int HD>
constexpr int LD = HD + 1;  // row stride of a 64 x HD f32 tile

// Stage a (64 x HD) tile of T, row r at g + r * stride, into shared memory
// as f32 with row stride LD; rows >= valid are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* s, const T* g, long long stride,
                                      int valid) {
  using E = rt::Elem<T>;
  for (int i = threadIdx.x; i < 64 * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    s[r * LD<HD> + d] = r < valid ? E::to_float(g[r * stride + d]) : 0.f;
  }
}

// The 4 x 4 products of this thread's rows of a (64 x HD) and columns of b
// (64 x HD): out[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d].
template <int HD>
__device__ __forceinline__ void dots(float (&out)[4][4], const float* a,
                                     const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD<HD> + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD<HD> + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// P and dS of a (64 query x 64 key) tile at rows q0, columns k0: P = exp(s
// scale - lse) where the mask keeps (row, col), else 0; dS = P (dP - D).
// sL, sD hold the tile rows' lse and D.
__device__ __forceinline__ void p_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                         const float* sL, const float* sD,
                                         int q0, int k0, int T_, int S,
                                         int causal, float scale, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool keep = row < T_ && col < S && !(causal && col > row);
      const float p = keep ? expf(s[i][j] * scale - sL[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - sD[r]);
    }
  }
}

template <typename T, int HD>
constexpr size_t dq_smem() {  // q, do, k, v tiles, dS, lse and D
  return (4 * 64 * LD<HD> + 64 * LDP + 2 * 64) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const float* __restrict__ lse, const T* __restrict__ dO,
                 T* __restrict__ dq, float* __restrict__ Dout, int T_, int S,
                 int H, int G, long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 long long d_sb, long long d_st, long long d_sh, int causal,
                 float scale) {
  using E = rt::Elem<T>;
  constexpr int DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * LD<HD>;
  float* sK = sdO + 64 * LD<HD>;
  float* sV = sK + 64 * LD<HD>;
  float* sdS = sV + 64 * LD<HD>;
  float* sL = sdS + 64 * LDP;
  float* sD = sL + 64;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rows = min(BQ, T_ - q0);
  stage<T, HD>(sQ, q + b * q_sb + q0 * q_st + h * q_sh, q_st, rows);
  stage<T, HD>(sdO, dO + b * d_sb + q0 * d_st + h * d_sh, d_st, rows);
  __syncthreads();
  // D = rowsum(do * o): a warp per 8 rows, lanes over hd
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += NT / 32) {
    float acc = 0.f;
    if (r < rows) {
      const T* orow = o + b * o_sb + (q0 + r) * o_st + h * o_sh;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(sdO[r * LD<HD> + d], E::to_float(orow[d]), acc);
    }
    acc = rt::sum32(acc);
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = r < rows ? lse[((long long)b * H + h) * T_ + q0 + r] : 0.f;
      if (r < rows) Dout[((long long)b * H + h) * T_ + q0 + r] = acc;
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DJ; ++d) acc[i][d] = 0.f;

  const int kv_end = causal ? min(S, q0 + rows) : S;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS reads are done
    stage<T, HD>(sK, kb + k0 * k_ss, k_ss, min(BK, S - k0));
    stage<T, HD>(sV, vb + k0 * v_ss, v_ss, min(BK, S - k0));
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<HD>(s, sQ, sK, ty, tx);
    dots<HD>(dp, sdO, sV, ty, tx);
    p_and_ds(s, dp, sL, sD, q0, k0, T_, S, causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sdS[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int d = 0; d < DJ; ++d) kv[d] = sK[c * LD<HD> + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < DJ; ++d) acc[i][d] = fmaf(ds[i], kv[d], acc[i][d]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T_) continue;
    T* out = dq + ((long long)(b * T_ + row) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < DJ; ++d)
      out[tx + 16 * d] = E::from_float(acc[i][d] * scale);
  }
}

template <typename T, int HD>
constexpr size_t dkdv_smem() {  // k, v, q, do tiles, P, dS, lse and D
  return (4 * 64 * LD<HD> + 2 * 64 * LDP + 2 * 64) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ Din, const T* __restrict__ dO,
                   T* __restrict__ dk, T* __restrict__ dv, int T_, int S,
                   int H, int K, int G, long long q_sb, long long q_st,
                   long long q_sh, long long k_sb, long long k_ss,
                   long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, long long d_sb, long long d_st,
                   long long d_sh, int causal, float scale) {
  using E = rt::Elem<T>;
  constexpr int DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + 64 * LD<HD>;
  float* sQ = sV + 64 * LD<HD>;
  float* sdO = sQ + 64 * LD<HD>;
  float* sP = sdO + 64 * LD<HD>;
  float* sdS = sP + 64 * LDP;
  float* sL = sdS + 64 * LDP;
  float* sD = sL + 64;

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int keys = min(BK, S - k0);
  stage<T, HD>(sK, k + b * k_sb + k0 * k_ss + kh * k_sh, k_ss, keys);
  stage<T, HD>(sV, v + b * v_sb + k0 * v_ss + kh * v_sh, v_ss, keys);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DJ; ++d) dk_acc[i][d] = dv_acc[i][d] = 0.f;

  // causal: query rows before k0 see none of these keys
  const int qt0 = causal ? k0 / BQ : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    for (int q0 = qt0 * BQ; q0 < T_; q0 += BQ) {
      const int rows = min(BQ, T_ - q0);
      __syncthreads();  // the previous tile's reads are done
      stage<T, HD>(sQ, q + b * q_sb + q0 * q_st + h * q_sh, q_st, rows);
      stage<T, HD>(sdO, dO + b * d_sb + q0 * d_st + h * d_sh, d_st, rows);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const long long at = ((long long)b * H + h) * T_ + q0 + r;
        sL[r] = r < rows ? lse[at] : 0.f;
        sD[r] = r < rows ? Din[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dots<HD>(s, sQ, sK, ty, tx);
      dots<HD>(dp, sdO, sV, ty, tx);
      p_and_ds(s, dp, sL, sD, q0, k0, T_, S, causal, scale, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sP[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
          sdS[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // this thread's keys ty + 16 i and columns tx + 16 d: dv += P^T do,
      // dk += dS^T q, over the tile's query rows in order
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float p[4], ds[4], dov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sP[r * LDP + ty + 16 * i];
          ds[i] = sdS[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int d = 0; d < DJ; ++d) {
          dov[d] = sdO[r * LD<HD> + tx + 16 * d];
          qv[d] = sQ[r * LD<HD> + tx + 16 * d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < DJ; ++d) {
            dv_acc[i][d] = fmaf(p[i], dov[d], dv_acc[i][d]);
            dk_acc[i][d] = fmaf(ds[i], qv[d], dk_acc[i][d]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    const long long at = ((long long)(b * S + key) * K + kh) * HD;
#pragma unroll
    for (int d = 0; d < DJ; ++d) {
      dk[at + tx + 16 * d] = E::from_float(dk_acc[i][d] * scale);
      dv[at + tx + 16 * d] = E::from_float(dv_acc[i][d]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dO;
  void *dq, *dk, *dv, *D;
  int B, T, S, H, K;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh, d_sb, d_st, d_sh;
  int causal;
  float scale;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.K;
  auto kdq = fa_bwd_dq_kernel<T, HD>;
  auto kkv = fa_bwd_dkdv_kernel<T, HD>;
  const size_t s1 = dq_smem<T, HD>(), s2 = dkdv_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  const dim3 g1((a.T + BQ - 1) / BQ, a.H, a.B);
  kdq<<<g1, NT, s1, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const T*>(a.dO),
      static_cast<T*>(a.dq), static_cast<float*>(a.D), a.T, a.S, a.H, G,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.o_sb, a.o_st, a.o_sh, a.d_sb, a.d_st, a.d_sh, a.causal,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((a.S + BK - 1) / BK, a.K, a.B);
  kkv<<<g2, NT, s2, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.D), static_cast<const T*>(a.dO),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.T, a.S, a.H, a.K, G,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.d_sb, a.d_st, a.d_sh, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(a, stream);
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Strides are in
// elements (batch, seq, head; the last dimension contiguous); dq is a
// contiguous (B, T, H, hd) tensor, dk and dv contiguous (B, S, K, hd), lse
// a contiguous f32 (B, H, T) tensor, D an f32 (B, H, T) scratch buffer.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv, void* D,
    int B, int T_, int S, int H, int K, int hd, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, long long d_sb,
    long long d_st, long long d_sh, int is_bf16, int causal, float scale,
    void* stream) {
  const Args a{q,    k,    v,    o,    lse,  dO,   dq,   dk,   dv,
               D,    B,    T_,   S,    H,    K,    q_sb, q_st, q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_st, o_sh,
               d_sb, d_st, d_sh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_hd<__nv_bfloat16>(hd, a, st);
  return launch_hd<float>(hd, a, st);
}
