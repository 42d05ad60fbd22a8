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
// strides (last dimension contiguous). Each kernel recomputes S and dP, as
// FlashAttention-2's backward does without its atomics.
//
// What bounds it on the H100: at qwen3's training shape (B 8, T 256, H 16,
// K 8, hd 128, causal, bf16) the seven products over the causal pairs (S
// and dP in both kernels, dV, dK, dQ) are 7.5 GFLOP, 7.6 us at 989
// TFLOP/s of bf16 tensor cores, and moving q, k, v, o, do once and writing
// dq, dk, dv is ~50 MB, 15 us at 3.35 TB/s: bytes bound it. Two routes;
// the launcher counts the one each call took (flash_attention_bwd_routes):
//
// wgmma, bf16 at head dims 64 and 128 (the training path; wgb::), after
// FlashAttention-3's backward without its dq atomics. Two kernels, one
// after the other on the stream, each a producer warpgroup and two
// consumer warpgroups (setmaxnreg: producer 24 registers, consumers 240);
// one producer lane issues every TMA copy (128-byte swizzle, 64-row boxes,
// rows past T or S arrive as zeros) into a 2-stage ring paced by mbarriers
// ("full" per stage, "empty" once all 8 consumer warps are done with it).
//  1. dq (the forward's layout): each consumer owns 64 query rows of one
//     head (the two heads of a GQA pair where G is even, else two 64-row
//     tiles of one head), loads its Q and dO tiles once, computes D for its
//     rows from dO and the forward's o, and writes D and lse log2 e to a
//     scratch whose rows are padded to a multiple of 64 (pad: D 0, lse
//     1e30, so P = 0 there). The producer streams 64-row K and V tiles of
//     the key range the mask leaves the block. S = Q K^T and dP = dO V^T by
//     SS wgmma m64n64k16 (both operands K-major), P = exp2(S scale log2 e -
//     lse log2 e), dS = P (dP - D) on the accumulator fragments; dQ += dS K
//     by RS wgmma m64nHDk16, dS going from the accumulator fragments to the
//     A fragments in registers (bf16) and K read MN-major from the same
//     tile. Query tiles are launched heaviest first.
//  2. dk, dv: a block owns 128 keys of one KV head; each consumer 64 of
//     them, whose K and V tiles it loads once. The producer streams 64-row
//     Q and dO tiles, with their rows of the scratch (lse log2 e and D, by
//     bulk copy), for every query head of the group and only the query
//     tiles the causal mask lets see these keys. S^T = K Q^T and dP^T =
//     V dO^T by SS wgmma, P^T and dS^T on the fragments, then dV += P^T dO
//     and dK += dS^T Q by RS wgmma (dO and Q read MN-major): P and dS never
//     go through shared memory. dK and dV stay in f32 registers over the
//     group's heads and query tiles, in order (at hd 128: 128 values a
//     thread, S^T and dP^T 32 each).
// Only tiles that cross the diagonal or the end of T or S are masked; a
// consumer skips tiles the mask hides from it (but waits for and releases
// their stage). Epilogues apply scale, stage the tile in shared memory
// (swizzled) and write it in 16-byte stores. A deliberate difference from
// the reference: P and dS are rounded to bf16 before the three RS products,
// as FlashAttention-2 and -3 do (a relative error of at most 2^-8 an
// element); S, dP, D and every sum stay f32.
//
// cuda_core, f32 (the TF32-off gates only) and bf16 at head dims 16 and 32
// (no full-width arch has them), 160 (stablelm-12b) and 256 (gemma-7b): the
// first simple kernels. dq: a block per (query tile, head, batch) computes
// D for its rows (into the scratch), then walks the key tiles the mask
// leaves it; dk, dv: a block per (key tile, KV head, batch) holds its k and
// v tiles and walks the query tiles of every head of the group that can
// see them. Tiles are staged in shared memory as f32 and the products run
// on the f32 CUDA cores, thread (ty, tx) of a 16 x 16 grid owning rows
// ty + 16 i and columns tx + 16 j of each score tile and of each tile x hd
// accumulator; operations bound them (0.08 ms at the f32 CUDA cores' peak
// at the shape above). Tiles are 64 rows, and 32 at hd 256, where four
// 64-row f32 tiles would not fit a block's shared memory (ROWS). A
// tensor-core backward above hd 128 (FlashAttention-3 splits dK and dV's
// head dim across its two consumers) is later work.
#include <atomic>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NT = 256;  // 16 x 16 threads

// Rows of a query or key tile: 64, and 32 above head dim 160, where the
// four 64-row f32 tiles of a block (280 KB and 297 KB of shared memory in
// all at hd 256) exceed the 227 KB of a block; 32-row tiles take 136 KB
// and 140 KB. RI is a thread's rows (and columns) of a score tile.
template <int HD>
constexpr int ROWS = HD > 160 ? 32 : 64;
template <int HD>
constexpr int RI = ROWS<HD> / 16;
template <int HD>
constexpr int LDP = ROWS<HD> + 1;  // row stride of a score tile (floats)
template <int HD>
constexpr int LD = HD + 1;  // row stride of a ROWS x HD f32 tile

// Stage a (ROWS x HD) tile of T, row r at g + r * stride, into shared
// memory as f32 with row stride LD; rows >= valid are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* s, const T* g, long long stride,
                                      int valid) {
  using E = rt::Elem<T>;
  for (int i = threadIdx.x; i < ROWS<HD> * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    s[r * LD<HD> + d] = r < valid ? E::to_float(g[r * stride + d]) : 0.f;
  }
}

// The RI x RI products of this thread's rows of a (ROWS x HD) and columns
// of b (ROWS x HD): out[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d].
template <int HD>
__device__ __forceinline__ void dots(float (&out)[RI<HD>][RI<HD>],
                                     const float* a, const float* b, int ty,
                                     int tx) {
  constexpr int N = RI<HD>;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[N], bv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) av[i] = a[(ty + 16 * i) * LD<HD> + d];
#pragma unroll
    for (int j = 0; j < N; ++j) bv[j] = b[(tx + 16 * j) * LD<HD> + d];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// P and dS of a (ROWS query x ROWS key) tile at rows q0, columns k0: P =
// exp(s scale - lse) where the mask keeps (row, col), else 0; dS = P (dP -
// D). sL, sD hold the tile rows' lse and D.
template <int HD>
__device__ __forceinline__ void p_and_ds(float (&s)[RI<HD>][RI<HD>],
                                         float (&dp)[RI<HD>][RI<HD>],
                                         const float* sL, const float* sD,
                                         int q0, int k0, int T_, int S,
                                         int causal, float scale, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < RI<HD>; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < RI<HD>; ++j) {
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
  return (4 * ROWS<HD> * LD<HD> + ROWS<HD> * LDP<HD> + 2 * ROWS<HD>) *
         sizeof(float);
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
  constexpr int R = ROWS<HD>, N = RI<HD>, DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + R * LD<HD>;
  float* sK = sdO + R * LD<HD>;
  float* sV = sK + R * LD<HD>;
  float* sdS = sV + R * LD<HD>;
  float* sL = sdS + R * LDP<HD>;
  float* sD = sL + R;

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rows = min(R, T_ - q0);
  stage<T, HD>(sQ, q + b * q_sb + q0 * q_st + h * q_sh, q_st, rows);
  stage<T, HD>(sdO, dO + b * d_sb + q0 * d_st + h * d_sh, d_st, rows);
  __syncthreads();
  // D = rowsum(do * o): a warp per 8 rows, lanes over hd
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += NT / 32) {
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

  float acc[N][DJ];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int d = 0; d < DJ; ++d) acc[i][d] = 0.f;

  const int kv_end = causal ? min(S, q0 + rows) : S;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  for (int k0 = 0; k0 < kv_end; k0 += R) {
    __syncthreads();  // the previous tile's K and dS reads are done
    stage<T, HD>(sK, kb + k0 * k_ss, k_ss, min(R, S - k0));
    stage<T, HD>(sV, vb + k0 * v_ss, v_ss, min(R, S - k0));
    __syncthreads();
    float s[N][N], dp[N][N];
    dots<HD>(s, sQ, sK, ty, tx);
    dots<HD>(dp, sdO, sV, ty, tx);
    p_and_ds<HD>(s, dp, sL, sD, q0, k0, T_, S, causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        sdS[(ty + 16 * i) * LDP<HD> + tx + 16 * j] = dp[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < R; ++c) {
      float ds[N], kv[DJ];
#pragma unroll
      for (int i = 0; i < N; ++i) ds[i] = sdS[(ty + 16 * i) * LDP<HD> + c];
#pragma unroll
      for (int d = 0; d < DJ; ++d) kv[d] = sK[c * LD<HD> + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int d = 0; d < DJ; ++d) acc[i][d] = fmaf(ds[i], kv[d], acc[i][d]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
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
  return (4 * ROWS<HD> * LD<HD> + 2 * ROWS<HD> * LDP<HD> + 2 * ROWS<HD>) *
         sizeof(float);
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
  constexpr int R = ROWS<HD>, N = RI<HD>, DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + R * LD<HD>;
  float* sQ = sV + R * LD<HD>;
  float* sdO = sQ + R * LD<HD>;
  float* sP = sdO + R * LD<HD>;
  float* sdS = sP + R * LDP<HD>;
  float* sL = sdS + R * LDP<HD>;
  float* sD = sL + R;

  const int k0 = blockIdx.x * R, kh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int keys = min(R, S - k0);
  stage<T, HD>(sK, k + b * k_sb + k0 * k_ss + kh * k_sh, k_ss, keys);
  stage<T, HD>(sV, v + b * v_sb + k0 * v_ss + kh * v_sh, v_ss, keys);

  float dk_acc[N][DJ], dv_acc[N][DJ];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int d = 0; d < DJ; ++d) dk_acc[i][d] = dv_acc[i][d] = 0.f;

  // causal: query rows before k0 see none of these keys
  const int qt0 = causal ? k0 / R : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    for (int q0 = qt0 * R; q0 < T_; q0 += R) {
      const int rows = min(R, T_ - q0);
      __syncthreads();  // the previous tile's reads are done
      stage<T, HD>(sQ, q + b * q_sb + q0 * q_st + h * q_sh, q_st, rows);
      stage<T, HD>(sdO, dO + b * d_sb + q0 * d_st + h * d_sh, d_st, rows);
      for (int r = threadIdx.x; r < R; r += NT) {
        const long long at = ((long long)b * H + h) * T_ + q0 + r;
        sL[r] = r < rows ? lse[at] : 0.f;
        sD[r] = r < rows ? Din[at] : 0.f;
      }
      __syncthreads();
      float s[N][N], dp[N][N];
      dots<HD>(s, sQ, sK, ty, tx);
      dots<HD>(dp, sdO, sV, ty, tx);
      p_and_ds<HD>(s, dp, sL, sD, q0, k0, T_, S, causal, scale, ty, tx);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          sP[(ty + 16 * i) * LDP<HD> + tx + 16 * j] = s[i][j];
          sdS[(ty + 16 * i) * LDP<HD> + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // this thread's keys ty + 16 i and columns tx + 16 d: dv += P^T do,
      // dk += dS^T q, over the tile's query rows in order
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        float p[N], ds[N], dov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          p[i] = sP[r * LDP<HD> + ty + 16 * i];
          ds[i] = sdS[r * LDP<HD> + ty + 16 * i];
        }
#pragma unroll
        for (int d = 0; d < DJ; ++d) {
          dov[d] = sdO[r * LD<HD> + tx + 16 * d];
          qv[d] = sQ[r * LD<HD> + tx + 16 * d];
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int d = 0; d < DJ; ++d) {
            dv_acc[i][d] = fmaf(p[i], dov[d], dv_acc[i][d]);
            dk_acc[i][d] = fmaf(ds[i], qv[d], dk_acc[i][d]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
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

// -- bf16 at head dims 64 and 128: TMA ring, warpgroup products (wgmma) ----

namespace wgb {

using namespace hop;  // wgmma_*, tma_tile, make_map (wgmma.cuh)
using bf16 = __nv_bfloat16;
constexpr int CONSUMERS = 2;  // warpgroups, each 64 rows
constexpr int NT = 128 * (1 + CONSUMERS);  // warpgroup 0 is the producer
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <= 65536,
              "the register file holds the block");
constexpr int STAGES = 2;          // tiles in the shared-memory ring
constexpr int ROWS = 64;           // rows of every tile (queries or keys)
constexpr int HALF = ROWS * 128;   // bytes of a tile's 64-column half
constexpr float LOG2E = 1.4426950408889634f;
constexpr float PAD_LSE = 1e30f;   // lse log2 e of a row past T: P = 0

template <int HD>
constexpr int TILE = ROWS * HD * 2;  // bytes of a 64-row tile

struct Barriers {
  uint64_t once, full[STAGES], empty[STAGES];
};

// Both kernels: two tiles a consumer, two a stage, the dk/dv kernel's
// scratch rows (lse log2 e and D, 64 each) a stage, the barriers.
template <int HD>
constexpr size_t smem_bytes() {
  return 2 * CONSUMERS * TILE<HD> + 2 * STAGES * TILE<HD> +
         2 * STAGES * ROWS * sizeof(float) + sizeof(Barriers) +
         1024;  // + alignment slack
}

__host__ __device__ inline int padded(int T) {  // scratch row length
  return (T + ROWS - 1) / ROWS * ROWS;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init(Barriers& bar) {
  if (threadIdx.x == 0) {
    rt::mbar_init(&bar.once, 1);
    for (int i = 0; i < STAGES; ++i) {
      rt::mbar_init(&bar.full[i], 1);
      rt::mbar_init(&bar.empty[i], 4 * CONSUMERS);  // one per consumer warp
    }
    rt::mbar_init_fence();
  }
  __syncthreads();
}

// A K-major operand at k-step kk (16 columns) of a 64-row tile, and an
// MN-major B operand at k-step c (rows 16c..16c+15: two 8-row groups, SBO
// 1024; the column halves HALF bytes apart, LBO).
__device__ __forceinline__ uint64_t k_major(const unsigned char* tile,
                                            int kk) {
  return rt::wgmma_desc(tile + (kk / 4) * HALF + (kk % 4) * 32, 16, 1024);
}

__device__ __forceinline__ uint64_t mn_major(const unsigned char* tile,
                                             int c) {
  return rt::wgmma_desc(tile + c * 2048, HALF, 1024);
}

// acc (64 x 64) = A B^T over the head dim: A and B 64-row tiles
template <int HD>
__device__ __forceinline__ void issue_abt(float (&acc)[32],
                                          const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_m64n64(acc, k_major(a, kk), k_major(b, kk), kk > 0);
}

// acc (64 x HD) += A B: A (64 x 64) as the bf16 fragments of four k-steps,
// B a 64-row tile read MN-major
template <int HD>
__device__ __forceinline__ void issue_ab(float (&acc)[HD / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (HD == 128)
      wgmma_rs_m64n128_t(acc, a[c], mn_major(b, c));
    else
      wgmma_rs_m64n64_t(acc, a[c], mn_major(b, c));
  }
}

// The bf16 A fragments of a 64 x 64 accumulator: column tiles 2c and
// 2c + 1 are k-step c.
__device__ __forceinline__ void to_fragments(uint32_t (&f)[4][4],
                                             const float (&x)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[c][i] = rt::pack_bf16(x[8 * c + 2 * i], x[8 * c + 2 * i + 1]);
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();  // this warp is done with the stage
  if (lane == 0) rt::mbar_arrive(empty);
}

// Write acc * mul (a 64 x HD accumulator) as bf16 rows out + r * ld for
// r < valid: each warp stages its 16 rows in the swizzled tile s, which no
// wgmma reads any more, and stores them in 16-byte pieces.
template <int HD>
__device__ __forceinline__ void store_tile(unsigned char* s,
                                           const float (&acc)[HD / 2],
                                           float mul, bf16* out,
                                           long long ld, int valid, int warp,
                                           int lane) {
  constexpr int DN = HD / 8;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(
          s + rt::swizzle128<HALF>(warp * 16 + g + 8 * r, d) + 4 * t) =
          rt::pack_bf16(acc[4 * d + 2 * r] * mul,
                        acc[4 * d + 2 * r + 1] * mul);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < DN / 2; ++it) {
    const int i = lane + it * 32, r = warp * 16 + i / DN, c = i % DN;
    if (r < valid)
      *reinterpret_cast<uint4*>(out + r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(s + rt::swizzle128<HALF>(r, c));
  }
}

// dq, and the scratch rows D and L (lse log2 e) of every (batch, head)
// over padded(T) rows. Block (head pair or head, batch, query tile from the
// last): consumer w owns head h0 + w % hpb, rows q0 + 64 (w / hpb).
template <int HD>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_wg_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const bf16* __restrict__ o, const float* __restrict__ lse,
                    float* __restrict__ D, float* __restrict__ L,
                    bf16* __restrict__ dq, int T_, int S, int H, int G,
                    int hpb, int q_ord, int k_ord, int v_ord, int d_ord,
                    long long o_sb, long long o_st, long long o_sh,
                    int causal, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);         // CONSUMERS tiles
  unsigned char* sdO = sQ + CONSUMERS * TILE<HD>;  // CONSUMERS tiles
  unsigned char* sRing = sdO + CONSUMERS * TILE<HD>;  // STAGES x (K, V)
  Barriers& bar = *reinterpret_cast<Barriers*>(
      sRing + 2 * STAGES * TILE<HD> + 2 * STAGES * ROWS * sizeof(float));

  const int bq = ROWS * (CONSUMERS / hpb);  // query rows per block
  const int h0 = blockIdx.x * hpb, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * bq;  // heaviest tiles first
  const int kh = h0 / G;
  // causal: key tiles past the block's last query row are fully masked
  const int kv_end = causal ? min(S, min(q0 + bq, T_)) : S;
  const int nkv = (kv_end + ROWS - 1) / ROWS;
  const int w = threadIdx.x / 128 - 1;  // consumer warpgroup; -1 producer
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init(bar);

  if (w < 0) {  // the producer: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    rt::mbar_expect_tx(&bar.once, 2 * CONSUMERS * TILE<HD>);
    for (int c = 0; c < CONSUMERS; ++c) {
      const int h = h0 + c % hpb, row = q0 + ROWS * (c / hpb);
      tma_tile<HD, HALF>(sQ + c * TILE<HD>, &tq, q_ord, &bar.once, h, row, b);
      tma_tile<HD, HALF>(sdO + c * TILE<HD>, &tdo, d_ord, &bar.once, h, row,
                         b);
    }
    for (int j = 0; j < nkv; ++j) {
      const int st = j % STAGES, free = ((j / STAGES) & 1) ^ 1;
      unsigned char* sKs = sRing + st * 2 * TILE<HD>;
      rt::mbar_wait(&bar.empty[st], free);
      rt::mbar_expect_tx(&bar.full[st], 2 * TILE<HD>);
      tma_tile<HD, HALF>(sKs, &tk, k_ord, &bar.full[st], kh, j * ROWS, b);
      tma_tile<HD, HALF>(sKs + TILE<HD>, &tv, v_ord, &bar.full[st], kh,
                         j * ROWS, b);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int h = h0 + w % hpb;
  const int qw = q0 + ROWS * (w / hpb);  // this warpgroup's first query row
  const int g = lane / 4, t = lane % 4;
  const int row0 = qw + warp * 16 + g;  // rows row0 and row0 + 8
  unsigned char* sQw = sQ + w * TILE<HD>;
  const unsigned char* sdOw = sdO + w * TILE<HD>;
  const long long bh = (long long)b * H + h;
  rt::mbar_wait(&bar.once, 0);

  // D of the warp's 16 rows: lanes 2r and 2r + 1 take the two halves of
  // row r's head dim (dO from shared memory, o from device memory)
  float Dr[2], Lr[2];
  {
    const int rl = warp * 16 + lane / 2, row = qw + rl;
    float acc = 0.f;
    if (row < T_) {
      const bf16* orow = o + b * o_sb + row * o_st + h * o_sh;
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        const int c = (lane % 2) * (HD / 16) + i;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(
            sdOw + rt::swizzle128<HALF>(rl, c));
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(o2[e]);
          const float2 y = __bfloat1622float2(d2[e]);
          acc = fmaf(y.x, x.x, acc);
          acc = fmaf(y.y, x.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    Dr[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    Dr[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
    const int Tp = padded(T_);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      Lr[r] = row < T_ ? lse[bh * T_ + row] * LOG2E : PAD_LSE;
      if (t == 0 && row < Tp) {
        D[bh * Tp + row] = Dr[r];
        L[bh * Tp + row] = Lr[r];
      }
    }
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < nkv; ++j) {
    const int st = j % STAGES, k0 = j * ROWS;
    const unsigned char* sKs = sRing + st * 2 * TILE<HD>;
    rt::mbar_wait(&bar.full[st], (j / STAGES) & 1);
    if (qw < T_ && !(causal && k0 > qw + ROWS - 1)) {
      float s[32], dp[32];
      rt::wgmma_fence();
      issue_abt<HD>(s, sQw, sKs);
      issue_abt<HD>(dp, sdOw, sKs + TILE<HD>);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(s);
      rt::fence_regs(dp);
      // element 4n + e: row row0 + 8 (e / 2), key k0 + 8 n + 2 t + e % 2
      const bool masked =
          (causal && k0 + ROWS - 1 > qw) || k0 + ROWS > S || qw + ROWS > T_;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i % 4) / 2;
        float p = rt::exp2_approx(fmaf(s[i], scale_log2, -Lr[r]));
        if (masked) {
          const int col = k0 + 8 * (i / 4) + 2 * t + i % 2,
                    row = row0 + 8 * r;
          if (col >= S || row >= T_ || (causal && col > row)) p = 0.f;
        }
        dp[i] = p * (dp[i] - Dr[r]);
      }
      uint32_t df[4][4];
      to_fragments(df, dp);
      rt::wgmma_fence();
      issue_ab<HD>(acc, df, sKs);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(acc);
      rt::fence_regs(df);
    }
    release(&bar.empty[st], lane);
  }
  store_tile<HD>(sQw, acc, scale, dq + ((b * (long long)T_ + qw) * H + h) * HD,
                 (long long)H * HD, T_ - qw, warp, lane);
}

// dk and dv. Block (KV head, batch, 128-key tile): consumer w owns keys
// k0 + 64 w.. of KV head kh; the producer streams (Q, dO, L, D) tiles of
// query head kh G + hh, rows q0.., for hh over the group and q0 from the
// first tile the causal mask lets see k0.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_wg_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ D,
                      const float* __restrict__ L, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int T_, int S, int H, int K,
                      int G, int q_ord, int k_ord, int v_ord, int d_ord,
                      int causal, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);          // CONSUMERS tiles
  unsigned char* sV = sK + CONSUMERS * TILE<HD>;    // CONSUMERS tiles
  unsigned char* sRing = sV + CONSUMERS * TILE<HD>;  // STAGES x (Q, dO)
  float* sLD = reinterpret_cast<float*>(sRing + 2 * STAGES * TILE<HD>);
  Barriers& bar = *reinterpret_cast<Barriers*>(sLD + 2 * STAGES * ROWS);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * CONSUMERS * ROWS;  // heaviest tiles first
  const int qt0 = causal ? k0 / ROWS : 0;  // causal: earlier rows see none
  const int nq = max(0, (T_ + ROWS - 1) / ROWS - qt0);
  const int ntiles = G * nq;
  const int w = threadIdx.x / 128 - 1;  // consumer warpgroup; -1 producer
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init(bar);

  if (w < 0) {  // the producer: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    const int Tp = padded(T_);
    rt::mbar_expect_tx(&bar.once, 2 * CONSUMERS * TILE<HD>);
    for (int c = 0; c < CONSUMERS; ++c) {
      tma_tile<HD, HALF>(sK + c * TILE<HD>, &tk, k_ord, &bar.once, kh,
                         k0 + ROWS * c, b);
      tma_tile<HD, HALF>(sV + c * TILE<HD>, &tv, v_ord, &bar.once, kh,
                         k0 + ROWS * c, b);
    }
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES, free = ((j / STAGES) & 1) ^ 1;
      const int h = kh * G + j / nq, q0 = (qt0 + j % nq) * ROWS;
      unsigned char* sQs = sRing + st * 2 * TILE<HD>;
      float* sLs = sLD + st * 2 * ROWS;
      const long long at = ((long long)b * H + h) * Tp + q0;
      rt::mbar_wait(&bar.empty[st], free);
      rt::mbar_expect_tx(&bar.full[st],
                         2 * TILE<HD> + 2 * ROWS * sizeof(float));
      tma_tile<HD, HALF>(sQs, &tq, q_ord, &bar.full[st], h, q0, b);
      tma_tile<HD, HALF>(sQs + TILE<HD>, &tdo, d_ord, &bar.full[st], h, q0,
                         b);
      rt::bulk_load(sLs, L + at, ROWS * sizeof(float), &bar.full[st]);
      rt::bulk_load(sLs + ROWS, D + at, ROWS * sizeof(float),
                    &bar.full[st]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int kw = k0 + ROWS * w;  // this warpgroup's first key
  const int g = lane / 4, t = lane % 4;
  const int key0 = kw + warp * 16 + g;  // keys key0 and key0 + 8
  unsigned char* sKw = sK + w * TILE<HD>;
  unsigned char* sVw = sV + w * TILE<HD>;
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  rt::mbar_wait(&bar.once, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES, q0 = (qt0 + j % nq) * ROWS;
    const unsigned char* sQs = sRing + st * 2 * TILE<HD>;
    const unsigned char* sdOs = sQs + TILE<HD>;
    const float* sL = sLD + st * 2 * ROWS;
    const float* sD = sL + ROWS;
    rt::mbar_wait(&bar.full[st], (j / STAGES) & 1);
    if (kw < S && !(causal && q0 + ROWS - 1 < kw)) {
      float s[32], dp[32];
      rt::wgmma_fence();
      issue_abt<HD>(s, sKw, sQs);
      issue_abt<HD>(dp, sVw, sdOs);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(s);
      rt::fence_regs(dp);
      // element 4n + e: key key0 + 8 (e / 2), query q0 + 8 n + 2 t + e % 2
      const bool masked =
          (causal && kw + ROWS - 1 > q0) || q0 + ROWS > T_ || kw + ROWS > S;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * n + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          float p = rt::exp2_approx(
              fmaf(s[i], scale_log2, -(e % 2 ? l2.y : l2.x)));
          if (masked) {
            const int key = key0 + 8 * (e / 2), qry = q0 + 8 * n + 2 * t + e % 2;
            if (qry >= T_ || key >= S || (causal && key > qry)) p = 0.f;
          }
          s[i] = p;
          dp[i] = p * (dp[i] - (e % 2 ? d2.y : d2.x));
        }
      }
      uint32_t pf[4][4], df[4][4];
      to_fragments(pf, s);
      to_fragments(df, dp);
      rt::wgmma_fence();
      issue_ab<HD>(dv_acc, pf, sdOs);
      issue_ab<HD>(dk_acc, df, sQs);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(dv_acc);
      rt::fence_regs(dk_acc);
      rt::fence_regs(pf);
      rt::fence_regs(df);
    }
    release(&bar.empty[st], lane);
  }
  const long long at = ((b * (long long)S + kw) * K + kh) * HD;
  store_tile<HD>(sKw, dk_acc, scale, dk + at, (long long)K * HD, S - kw, warp,
                 lane);
  store_tile<HD>(sVw, dv_acc, 1.f, dv + at, (long long)K * HD, S - kw, warp,
                 lane);
}

}  // namespace wgb

struct Args {
  const void *q, *k, *v, *o, *lse, *dO;
  void *dq, *dk, *dv, *D;
  int B, T, S, H, K;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh, d_sb, d_st, d_sh;
  int causal;
  float scale;
};

template <int HD>
int launch_wg(const Args& a, cudaStream_t stream) {
  using wgb::bf16;
  constexpr int R = wgb::ROWS;
  CUtensorMap tq, tk, tv, tdo;
  int q_ord, k_ord, v_ord, d_ord;
  cudaError_t err;
  if ((err = wgb::make_map(&tq, &q_ord, a.q, HD, R, a.H, a.T, a.B, a.q_sh,
                           a.q_st, a.q_sb)) ||
      (err = wgb::make_map(&tk, &k_ord, a.k, HD, R, a.K, a.S, a.B, a.k_sh,
                           a.k_ss, a.k_sb)) ||
      (err = wgb::make_map(&tv, &v_ord, a.v, HD, R, a.K, a.S, a.B, a.v_sh,
                           a.v_ss, a.v_sb)) ||
      (err = wgb::make_map(&tdo, &d_ord, a.dO, HD, R, a.H, a.T, a.B, a.d_sh,
                           a.d_st, a.d_sb)))
    return err;
  auto kdq = wgb::fa_bwd_wg_dq_kernel<HD>;
  auto kkv = wgb::fa_bwd_wg_dkdv_kernel<HD>;
  const int smem = (int)wgb::smem_bytes<HD>();
  static unsigned long long done_dq = 0, done_kv = 0;
  if ((err = rt::allow_smem(kdq, smem, done_dq)) ||
      (err = rt::allow_smem(kkv, smem, done_kv)))
    return err;
  const int G = a.H / a.K;
  const int hpb = G % wgb::CONSUMERS == 0 ? wgb::CONSUMERS : 1;
  const int bq = R * (wgb::CONSUMERS / hpb);
  float* D = static_cast<float*>(a.D);
  float* L = D + (size_t)a.B * a.H * wgb::padded(a.T);
  const float scale_log2 = a.scale * wgb::LOG2E;
  const dim3 g1(a.H / hpb, a.B, (a.T + bq - 1) / bq);
  kdq<<<g1, wgb::NT, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(a.o),
      static_cast<const float*>(a.lse), D, L, static_cast<bf16*>(a.dq), a.T,
      a.S, a.H, G, hpb, q_ord, k_ord, v_ord, d_ord, a.o_sb, a.o_st, a.o_sh,
      a.causal, scale_log2, a.scale);
  if ((err = cudaGetLastError())) return err;
  const int bk = R * wgb::CONSUMERS;
  const dim3 g2(a.K, a.B, (a.S + bk - 1) / bk);
  kkv<<<g2, wgb::NT, smem, stream>>>(
      tq, tk, tv, tdo, D, L, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.T, a.S, a.H, a.K, G, q_ord, k_ord, v_ord,
      d_ord, a.causal, scale_log2, a.scale);
  return cudaGetLastError();
}

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
  constexpr int R = ROWS<HD>;
  const dim3 g1((a.T + R - 1) / R, a.H, a.B);
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
  const dim3 g2((a.S + R - 1) / R, a.K, a.B);
  kkv<<<g2, NT, s2, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.D), static_cast<const T*>(a.dO),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.T, a.S, a.H, a.K, G,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.d_sb, a.d_st, a.d_sh, a.causal, a.scale);
  return cudaGetLastError();
}

// The routes a call can take (the wrapper's ``bwd_route`` names them), and
// the launches each has had: the launcher counts the route it took.
enum Route { WGMMA, CUDA_CORE, ROUTES };
std::atomic<unsigned long long> taken[ROUTES];

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Strides are in
// elements (batch, seq, head; the last dimension contiguous; on the wgmma
// route 16-byte aligned, as TMA reads them); dq is a contiguous
// (B, T, H, hd) tensor, dk and dv contiguous (B, S, K, hd), lse a
// contiguous f32 (B, H, T) tensor, D an f32 scratch of 2 B H Tp floats,
// Tp = T rounded up to a multiple of 64. bf16 at head dims 64 and 128 takes
// the wgmma route, everything else the CUDA cores.
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
  Route r = CUDA_CORE;
  int err;
  switch (is_bf16 ? hd : -hd) {
    case 128:
      r = WGMMA;
      err = launch_wg<128>(a, st);
      break;
    case 64:
      r = WGMMA;
      err = launch_wg<64>(a, st);
      break;
    case 256:
      err = launch<__nv_bfloat16, 256>(a, st);
      break;
    case 160:
      err = launch<__nv_bfloat16, 160>(a, st);
      break;
    case 32:
      err = launch<__nv_bfloat16, 32>(a, st);
      break;
    case 16:
      err = launch<__nv_bfloat16, 16>(a, st);
      break;
    case -256:
      err = launch<float, 256>(a, st);
      break;
    case -160:
      err = launch<float, 160>(a, st);
      break;
    case -128:
      err = launch<float, 128>(a, st);
      break;
    case -64:
      err = launch<float, 64>(a, st);
      break;
    case -32:
      err = launch<float, 32>(a, st);
      break;
    case -16:
      err = launch<float, 16>(a, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err == 0) taken[r].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// Copies the launches by route (wgmma, cuda_core) since the last reset into
// counts[2]; with reset, zeroes them.
extern "C" void flash_attention_bwd_routes(unsigned long long* counts,
                                           int reset) {
  for (int r = 0; r < ROUTES; ++r)
    counts[r] = reset ? taken[r].exchange(0) : taken[r].load();
}
