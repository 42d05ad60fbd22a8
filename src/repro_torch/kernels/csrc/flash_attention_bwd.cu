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
// dq, dk, dv is ~50 MB, 15 us at 3.35 TB/s: bytes bound it. At gemma-7b's
// (H 16, K 16, hd 256) the bytes are 134 MB (40 us) and the seven products
// 15 GFLOP (15 us); at stablelm-12b's (H 32, K 8, hd 160) 105 MB (31 us)
// and 19 GFLOP (19 us). Two routes;
// the launcher counts the one each call took (flash_attention_bwd_routes):
//
// wgmma, bf16 at head dims 64, 128, 160 and 256 (the training path; wgb::),
// after FlashAttention-3's backward without its dq atomics. Two kernels, one
// after the other on the stream, each a producer warpgroup and two
// consumer warpgroups (setmaxnreg: producer 24 registers, consumers 240);
// one producer lane issues every TMA copy (128-byte swizzle, 64-row boxes
// in 64-column halves, rows past T or S arrive as zeros; hd 160 as three
// halves, the tensor map's dim 0 kept at 160 so that columns 160-191
// arrive as zeros, as in the forward) into a 2-stage ring paced by
// mbarriers ("full" per stage, "empty" once all 8 consumer warps are done
// with it).
//  1. dq (the forward's layout): at hd 64, 128 and 160 each consumer owns
//     64 query rows of one head (the two heads of a GQA pair where G is
//     even, else two 64-row tiles of one head); at 256 the two share one
//     64-row tile of one head. The block loads its Q and dO tiles once,
//     computes D for its rows from dO and the forward's o, and writes D and
//     lse log2 e to a scratch whose rows are padded to a multiple of 64
//     (pad: D 0, lse 1e30, so P = 0 there). The producer streams 64-row K
//     and V tiles of the key range the mask leaves the block. S = Q K^T and
//     dP = dO V^T by SS wgmma m64n64k16 (both operands K-major), P =
//     exp2(S scale log2 e - lse log2 e), dS = P (dP - D) on the accumulator
//     fragments; dQ += dS K by RS wgmma, m64n128k16 over each pair of the
//     consumer's halves and m64n64k16 over an odd one, dS going from the
//     accumulator fragments to the A fragments in registers (bf16) and K
//     read MN-major from the same tile. Query tiles are launched heaviest
//     first.
//  2. dk, dv: a block owns 64 keys of one KV head a consumer at hd 64 and
//     128 (each consumer loads its K and V tiles once), one 64-key tile
//     shared by both above. The producer streams 64-row Q and dO tiles,
//     with their rows of the scratch (lse log2 e and D, by bulk copy), for
//     every query head of the group and only the query tiles the causal
//     mask lets see these keys. S^T = K Q^T and dP^T = V dO^T by SS wgmma,
//     P^T and dS^T on the fragments, then dV += P^T dO and dK += dS^T Q by
//     RS wgmma (dO and Q read MN-major): at 64 and 128 P and dS never go
//     through shared memory. dK and dV stay in f32 registers over the
//     group's heads and query tiles, in order. Key tiles are launched
//     heaviest first.
// Above hd 128 a consumer cannot hold dK and dV over the whole head dim (at
// 256: 128 + 128 registers a thread, on top of S^T and dP^T at 32 each);
// at 256 two 64-row tiles a consumer plus the ring would need 256 KB of
// shared memory of the 227 KB a block has, in both kernels. There (the
// dk/dv kernel above 128, the dq kernel at 256; dQ at 160 takes 96
// registers and its block 192 KB, and keeps the layout of 64 and 128) the
// two consumers of a block share one 64-row tile and split the output's
// head dim along the halves:
// consumer 0 owns columns 0-127 (m64n128 products), consumer 1 the rest
// (128-255 at hd 256; at 160 one m64n64 half whose last 32 columns are
// TMA's zeros, and only 128-159 are written). dK and dV then take 64 + 64
// registers at most, and a block's shared memory is its two tiles, the
// ring and the exchange below: at 256 226.5 KB of the 227 KB a block may
// have in the dk/dv kernel and 210.5 KB in the dq kernel, at 160 178.5 KB
// in the dk/dv kernel (smem_bytes). S and dP
// (S^T and dP^T) reduce over the whole head dim: each consumer computes
// them for 32 of the tile's 64 columns (m64n32k16, B from row 32 w), turns
// them into the bf16 A fragments of its two k-steps of the products that
// follow, and trades those with the other consumer through shared memory
// (a slot a thread, read by the thread of the other consumer that holds
// the same fragment rows; two slots by tile parity, so one named barrier a
// tile orders the trade). Each then runs the RS products over its columns
// with all four k-steps. The dq kernel's consumers add their halves of D
// through shared memory, in one order, and both wait at the named barrier
// before the epilogue stages a tile the other may still read.
// Only tiles that cross the diagonal or the end of T or S are masked; a
// consumer skips tiles the mask hides from it (but waits for and releases
// their stage). Epilogues apply scale, stage the tile in shared memory
// (swizzled) and write it in 16-byte stores. A deliberate difference from
// the reference: P and dS are rounded to bf16 before the three RS products,
// as FlashAttention-2 and -3 do (a relative error of at most 2^-8 an
// element); S, dP, D and every sum stay f32.
//
// cuda_core, f32 (the TF32-off gates only) and bf16 at head dims 16 and 32
// (no full-width arch has them): the first simple kernels. dq: a block per
// (query tile, head, batch) computes D for its rows (into the scratch),
// then walks the key tiles the mask leaves it; dk, dv: a block per (key
// tile, KV head, batch) holds its k and v tiles and walks the query tiles
// of every head of the group that can see them. Tiles are staged in shared
// memory as f32 and the products run on the f32 CUDA cores, thread (ty, tx)
// of a 16 x 16 grid owning rows ty + 16 i and columns tx + 16 j of each
// score tile and of each tile x hd accumulator; operations bound them (0.08
// ms at the f32 CUDA cores' peak at the shape above). Tiles are 64 rows,
// and 32 at hd 256, where four 64-row f32 tiles would not fit a block's
// shared memory (ROWS).
#include <atomic>
#include <type_traits>

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

// -- bf16 at head dims 64, 128, 160 and 256: TMA ring, warpgroup products --

namespace wgb {

using namespace hop;  // wgmma_*, tma_tile, make_map (wgmma.cuh)
using bf16 = __nv_bfloat16;
constexpr int CONSUMERS = 2;  // warpgroups
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
constexpr int NH = (HD + 63) / 64;  // 64-column halves (hd 160: three)
template <int HD>
constexpr int TILE = NH<HD> * HALF;  // bytes of a 64-row tile
// Where a consumer cannot hold its accumulators over the whole head dim
// (dK and dV above hd 128, dQ above 160) the two consumers share one
// 64-row tile and split the output's head dim (consumer 0 halves 0-1,
// consumer 1 the rest): a block owns one tile of each of its two operands,
// else one a consumer.
enum Kernel { DQ, DKDV };
template <Kernel KN, int HD>
constexpr bool SPLIT = HD > (KN == DQ ? 160 : 128);
template <Kernel KN, int HD>
constexpr int OWN = SPLIT<KN, HD> ? 1 : CONSUMERS;

struct Barriers {
  uint64_t once, full[STAGES], empty[STAGES];
};

// Split consumers trade the bf16 A fragments of the products they share
// (dS; P^T and dS^T in the dk/dv kernel) through shared memory: Q uint4 a
// thread, for each consumer and each tile parity.
template <Kernel KN>
constexpr int XQ = KN == DQ ? 2 : 4;
template <Kernel KN, int HD>
constexpr int XWORDS = SPLIT<KN, HD> ? 2 * CONSUMERS * 128 * 4 * XQ<KN> : 0;

// Both kernels: the block's own tiles (two operands), two tiles a stage,
// the dk/dv kernel's scratch rows (lse log2 e and D, 64 each) a stage, the
// dq kernel's exchange of D between split consumers, the fragments'
// exchange, the barriers.
template <Kernel KN, int HD>
constexpr size_t smem_bytes() {
  return 2 * OWN<KN, HD> * TILE<HD> + 2 * STAGES * TILE<HD> +
         2 * STAGES * ROWS * sizeof(float) +
         CONSUMERS * ROWS * sizeof(float) + XWORDS<KN, HD> * 4 +
         sizeof(Barriers) + 1024;  // + alignment slack
}
static_assert(smem_bytes<DQ, 160>() <= 232448 &&
                  smem_bytes<DQ, 256>() <= 232448 &&
                  smem_bytes<DKDV, 256>() <= 232448,
              "a block's shared memory");

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

// The consumer warpgroups' own barrier (the producer has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
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

// acc (64 x NN) = A B^T over the head dim: A a 64-row tile, B the NN rows
// (64, or 32 from row 0 or 32: b 4096 bytes on) of another
template <int HD, int NN>
__device__ __forceinline__ void issue_abt(float (&acc)[NN / 2],
                                          const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (NN == 64)
      wgmma_ss_m64n64(acc, k_major(a, kk), k_major(b, kk), kk > 0);
    else
      wgmma_ss_m64n32(acc, k_major(a, kk), k_major(b, kk), kk > 0);
  }
}

// acc (64 x NC) += A B: A (64 x 64) as the bf16 fragments of four k-steps,
// B the NC columns of a 64-row tile from half b on, read MN-major: an
// m64n128 product over a pair of halves, an m64n64 over an odd one
template <int NC>
__device__ __forceinline__ void issue_ab(float (&acc)[NC / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* b) {
  static_assert(NC == 64 || NC == 128 || NC == 192, "halves of a tile");
  float(&odd)[32] = *reinterpret_cast<float(*)[32]>(acc + NC / 2 - 32);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (NC >= 128)
      wgmma_rs_m64n128_t(*reinterpret_cast<float(*)[64]>(acc), a[c],
                         mn_major(b, c));
    if constexpr (NC != 128)
      wgmma_rs_m64n64_t(odd, a[c], mn_major(b + (NC - 64) * 128, c));
  }
}

// The bf16 A fragments of a 64 x 16 KS accumulator: column tiles 2c and
// 2c + 1 are k-step c.
template <int KS>
__device__ __forceinline__ void to_fragments(uint32_t (&f)[KS][4],
                                             const float (&x)[8 * KS]) {
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[c][i] = rt::pack_bf16(x[8 * c + 2 * i], x[8 * c + 2 * i + 1]);
}

// This thread's slot i (a uint4) of consumer cw's fragments at tile parity
// par: the partner thread (same warp and lane of the other consumer) holds
// the same rows of the A fragments.
template <Kernel KN>
__device__ __forceinline__ uint4* slot(uint32_t* sF, int par, int cw, int i) {
  return reinterpret_cast<uint4*>(sF) +
         ((par * CONSUMERS + cw) * XQ<KN> + i) * 128 + threadIdx.x % 128;
}

__device__ __forceinline__ uint4 as_uint4(const uint32_t (&f)[4]) {
  return make_uint4(f[0], f[1], f[2], f[3]);
}

// The four k-steps of an A operand from this consumer's two (k-steps 2w,
// 2w + 1) and the partner's two (its slots from theirs on, 128 apart).
__device__ __forceinline__ void merge(uint32_t (&f)[4][4],
                                      const uint32_t (&mine)[2][4],
                                      const uint4* theirs, int w) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 v = theirs[128 * c];
    const uint32_t o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[c][i] = w == 0 ? mine[c][i] : o[i];
      f[2 + c][i] = w == 0 ? o[i] : mine[c][i];
    }
  }
}

// dS = P (dP - D), P = exp2(S scale log2 e - L) or 0 where masked, in place
// on the dq kernel's S and dP accumulators over NN keys from key kc (element
// 4n + e: row row0 + 8 (e / 2), key kc + 8 n + 2 t + e % 2).
template <int NN>
__device__ __forceinline__ void ds_rows(float (&s)[NN / 2],
                                        float (&dp)[NN / 2],
                                        const float (&Lr)[2],
                                        const float (&Dr)[2], int kc,
                                        int row0, int t, bool masked, int T_,
                                        int S, int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) {
    const int r = (i % 4) / 2;
    float p = rt::exp2_approx(fmaf(s[i], scale_log2, -Lr[r]));
    if (masked) {
      const int col = kc + 8 * (i / 4) + 2 * t + i % 2, row = row0 + 8 * r;
      if (col >= S || row >= T_ || (causal && col > row)) p = 0.f;
    }
    dp[i] = p * (dp[i] - Dr[r]);
  }
}

// P^T and dS^T in place on the dk/dv kernel's S^T and dP^T accumulators
// over NN queries from tile column qc (element 4n + e: key key0 + 8 (e /
// 2), query q0 + qc + 8 n + 2 t + e % 2; sL, sD the tile's rows).
template <int NN>
__device__ __forceinline__ void p_ds_t(float (&s)[NN / 2], float (&dp)[NN / 2],
                                       const float* sL, const float* sD,
                                       int qc, int q0, int key0, int t,
                                       bool masked, int T_, int S,
                                       int causal, float scale_log2) {
#pragma unroll
  for (int n = 0; n < NN / 8; ++n) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(sL + qc + 8 * n + 2 * t);
    const float2 d2 =
        *reinterpret_cast<const float2*>(sD + qc + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      float p =
          rt::exp2_approx(fmaf(s[i], scale_log2, -(e % 2 ? l2.y : l2.x)));
      if (masked) {
        const int key = key0 + 8 * (e / 2),
                  qry = q0 + qc + 8 * n + 2 * t + e % 2;
        if (qry >= T_ || key >= S || (causal && key > qry)) p = 0.f;
      }
      s[i] = p;
      dp[i] = p * (dp[i] - (e % 2 ? d2.y : d2.x));
    }
  }
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();  // this warp is done with the stage
  if (lane == 0) rt::mbar_arrive(empty);
}

// Write the first NV of acc's NC columns (a 64 x NC accumulator) times mul
// as bf16 rows out + r * ld for r < valid: each warp stages its 16 rows in
// the swizzled halves at s, which no wgmma reads any more, and stores them
// in 16-byte pieces.
template <int NC, int NV>
__device__ __forceinline__ void store_tile(unsigned char* s,
                                           const float (&acc)[NC / 2],
                                           float mul, bf16* out,
                                           long long ld, int valid, int warp,
                                           int lane) {
  constexpr int DN = NV / 8;
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

// Runs body(NC, NV, c0) for the columns consumer w owns: all of them (NC
// accumulator columns, 192 at hd 160, whose last 32 are TMA's zeros, NV =
// HD real), or split, its share of the halves (NC columns from half c0 on,
// the first NV of them real: at 256 128 each, at 160 128 and 32 of an
// m64n64 half).
template <Kernel KN, int HD, typename F>
__device__ __forceinline__ void by_columns(int w, F&& body) {
  using I = std::integral_constant<int, 128>;
  if constexpr (!SPLIT<KN, HD>)
    body(std::integral_constant<int, 64 * NH<HD>>(),
         std::integral_constant<int, HD>(), 0);
  else if constexpr (HD == 256)
    body(I(), I(), 2 * w);
  else if (w == 0)
    body(I(), I(), 0);
  else
    body(std::integral_constant<int, 64 * (NH<HD> - 2)>(),
         std::integral_constant<int, HD - 128>(), 2);
}

// dq, and the scratch rows D and L (lse log2 e) of every (batch, head)
// over padded(T) rows. Block (head pair or head, batch, query tile from the
// last): consumer w owns head h0 + w % hpb, rows q0 + 64 (w / hpb); at hd
// 256 both consumers own head h0, rows q0.., each its columns.
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
  constexpr bool split = SPLIT<DQ, HD>;
  constexpr int own = OWN<DQ, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);      // own tiles
  unsigned char* sdO = sQ + own * TILE<HD>;     // own tiles
  unsigned char* sRing = sdO + own * TILE<HD>;  // STAGES x (K, V)
  float* sX = reinterpret_cast<float*>(sRing + 2 * STAGES * TILE<HD>) +
              2 * STAGES * ROWS;  // D's shares, CONSUMERS x ROWS
  uint32_t* sF = reinterpret_cast<uint32_t*>(sX + CONSUMERS * ROWS);
  Barriers& bar = *reinterpret_cast<Barriers*>(sF + XWORDS<DQ, HD>);

  const int bq = ROWS * (own / hpb);  // query rows per block
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
    rt::mbar_expect_tx(&bar.once, 2 * own * TILE<HD>);
    for (int c = 0; c < own; ++c) {
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
  const int wt = split ? 0 : w;  // the block's tile this consumer reads
  const int h = h0 + wt % hpb;
  const int qw = q0 + ROWS * (wt / hpb);  // this warpgroup's first query row
  const int g = lane / 4, t = lane % 4;
  const int row0 = qw + warp * 16 + g;  // rows row0 and row0 + 8
  unsigned char* sQw = sQ + wt * TILE<HD>;
  const unsigned char* sdOw = sdO + wt * TILE<HD>;
  const long long bh = (long long)b * H + h;
  rt::mbar_wait(&bar.once, 0);

  // D of the warp's 16 rows: lanes 2r and 2r + 1 (of each consumer, when
  // the two share the rows) take a share of row r's head dim (dO from
  // shared memory, o from device memory); split consumers add their shares
  // through shared memory, in one order
  float Dr[2], Lr[2];
  {
    constexpr int PARTS = split ? CONSUMERS : 1;
    constexpr int CH = HD / 16 / PARTS;  // 8-column chunks a lane
    const int part = split ? w : 0;
    const int rl = warp * 16 + lane / 2, row = qw + rl;
    float acc = 0.f;
    if (row < T_) {
      const bf16* orow = o + b * o_sb + row * o_st + h * o_sh;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = (part * 2 + lane % 2) * CH + i;
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
    if constexpr (split) {
      if (lane % 2 == 0) sX[w * ROWS + rl] = acc;
      consumers_sync();
      acc = sX[rl] + sX[ROWS + rl];
    }
    Dr[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    Dr[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
    const int Tp = padded(T_);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      Lr[r] = row < T_ ? lse[bh * T_ + row] * LOG2E : PAD_LSE;
      if (t == 0 && part == 0 && row < Tp) {
        D[bh * Tp + row] = Dr[r];
        L[bh * Tp + row] = Lr[r];
      }
    }
  }

  by_columns<DQ, HD>(w, [&](auto nc, auto nv, int c0) {
    constexpr int NC = decltype(nc)::value, NV = decltype(nv)::value;
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < nkv; ++j) {
      const int st = j % STAGES, k0 = j * ROWS;
      const unsigned char* sKs = sRing + st * 2 * TILE<HD>;
      rt::mbar_wait(&bar.full[st], (j / STAGES) & 1);
      const bool live = qw < T_ && !(causal && k0 > qw + ROWS - 1);
      const bool masked =
          (causal && k0 + ROWS - 1 > qw) || k0 + ROWS > S || qw + ROWS > T_;
      uint32_t df[4][4];
      if constexpr (!split) {
        if (live) {
          float s[32], dp[32];
          rt::wgmma_fence();
          issue_abt<HD, 64>(s, sQw, sKs);
          issue_abt<HD, 64>(dp, sdOw, sKs + TILE<HD>);
          rt::wgmma_commit();
          rt::wgmma_wait<0>();
          rt::fence_regs(s);
          rt::fence_regs(dp);
          ds_rows<64>(s, dp, Lr, Dr, k0, row0, t, masked, T_, S, causal,
                      scale_log2);
          to_fragments(df, dp);
        }
      } else {  // S and dP of keys k0 + 32 w.., then trade dS
        uint32_t mine[2][4];
        if (live) {
          float s[16], dp[16];
          rt::wgmma_fence();
          issue_abt<HD, 32>(s, sQw, sKs + 4096 * w);
          issue_abt<HD, 32>(dp, sdOw, sKs + TILE<HD> + 4096 * w);
          rt::wgmma_commit();
          rt::wgmma_wait<0>();
          rt::fence_regs(s);
          rt::fence_regs(dp);
          ds_rows<32>(s, dp, Lr, Dr, k0 + 32 * w, row0, t, masked, T_, S,
                      causal, scale_log2);
          to_fragments(mine, dp);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            *slot<DQ>(sF, j & 1, w, c) = as_uint4(mine[c]);
        }
        consumers_sync();
        if (live) merge(df, mine, slot<DQ>(sF, j & 1, 1 - w, 0), w);
      }
      if (live) {
        rt::wgmma_fence();
        issue_ab<NC>(acc, df, sKs + c0 * HALF);
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(acc);
        rt::fence_regs(df);
      }
      release(&bar.empty[st], lane);
    }
    if constexpr (split) consumers_sync();  // the other's S reads sQw
    store_tile<NC, NV>(sQw + c0 * HALF, acc, scale,
                       dq + ((b * (long long)T_ + qw) * H + h) * HD + 64 * c0,
                       (long long)H * HD, T_ - qw, warp, lane);
  });
}

// dk and dv. Block (KV head, batch, key tile of 64 OWN keys): consumer w
// owns keys k0 + 64 w.. of KV head kh (above hd 128 both own k0.., each its
// columns); the producer streams (Q, dO, L, D) tiles of query head kh G +
// hh, rows q0.., for hh over the group and q0 from the first tile the
// causal mask lets see k0.
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
  constexpr bool split = SPLIT<DKDV, HD>;
  constexpr int own = OWN<DKDV, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);     // own tiles
  unsigned char* sV = sK + own * TILE<HD>;     // own tiles
  unsigned char* sRing = sV + own * TILE<HD>;  // STAGES x (Q, dO)
  float* sLD = reinterpret_cast<float*>(sRing + 2 * STAGES * TILE<HD>);
  uint32_t* sF =
      reinterpret_cast<uint32_t*>(sLD + 2 * STAGES * ROWS + CONSUMERS * ROWS);
  Barriers& bar = *reinterpret_cast<Barriers*>(sF + XWORDS<DKDV, HD>);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * own * ROWS;  // heaviest tiles first
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
    rt::mbar_expect_tx(&bar.once, 2 * own * TILE<HD>);
    for (int c = 0; c < own; ++c) {
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
  const int wt = split ? 0 : w;  // the block's tile this consumer reads
  const int kw = k0 + ROWS * wt;     // this warpgroup's first key
  const int g = lane / 4, t = lane % 4;
  const int key0 = kw + warp * 16 + g;  // keys key0 and key0 + 8
  unsigned char* sKw = sK + wt * TILE<HD>;
  unsigned char* sVw = sV + wt * TILE<HD>;
  rt::mbar_wait(&bar.once, 0);

  by_columns<DKDV, HD>(w, [&](auto nc, auto nv, int c0) {
    constexpr int NC = decltype(nc)::value, NV = decltype(nv)::value;
    float dk_acc[NC / 2], dv_acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES, q0 = (qt0 + j % nq) * ROWS;
      const unsigned char* sQs = sRing + st * 2 * TILE<HD>;
      const unsigned char* sdOs = sQs + TILE<HD>;
      const float* sL = sLD + st * 2 * ROWS;
      const float* sD = sL + ROWS;
      rt::mbar_wait(&bar.full[st], (j / STAGES) & 1);
      const bool live = kw < S && !(causal && q0 + ROWS - 1 < kw);
      const bool masked =
          (causal && kw + ROWS - 1 > q0) || q0 + ROWS > T_ || kw + ROWS > S;
      uint32_t pf[4][4], df[4][4];
      if constexpr (!split) {
        if (live) {
          float s[32], dp[32];
          rt::wgmma_fence();
          issue_abt<HD, 64>(s, sKw, sQs);
          issue_abt<HD, 64>(dp, sVw, sdOs);
          rt::wgmma_commit();
          rt::wgmma_wait<0>();
          rt::fence_regs(s);
          rt::fence_regs(dp);
          p_ds_t<64>(s, dp, sL, sD, 0, q0, key0, t, masked, T_, S, causal,
                     scale_log2);
          to_fragments(pf, s);
          to_fragments(df, dp);
        }
      } else {  // S^T and dP^T of queries q0 + 32 w.., then trade P, dS
        uint32_t pm[2][4], dm[2][4];
        if (live) {
          float s[16], dp[16];
          rt::wgmma_fence();
          issue_abt<HD, 32>(s, sKw, sQs + 4096 * w);
          issue_abt<HD, 32>(dp, sVw, sdOs + 4096 * w);
          rt::wgmma_commit();
          rt::wgmma_wait<0>();
          rt::fence_regs(s);
          rt::fence_regs(dp);
          p_ds_t<32>(s, dp, sL, sD, 32 * w, q0, key0, t, masked, T_, S,
                     causal, scale_log2);
          to_fragments(pm, s);
          to_fragments(dm, dp);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            *slot<DKDV>(sF, j & 1, w, c) = as_uint4(pm[c]);
            *slot<DKDV>(sF, j & 1, w, 2 + c) = as_uint4(dm[c]);
          }
        }
        consumers_sync();
        if (live) {
          merge(pf, pm, slot<DKDV>(sF, j & 1, 1 - w, 0), w);
          merge(df, dm, slot<DKDV>(sF, j & 1, 1 - w, 2), w);
        }
      }
      if (live) {
        rt::wgmma_fence();
        issue_ab<NC>(dv_acc, pf, sdOs + c0 * HALF);
        issue_ab<NC>(dk_acc, df, sQs + c0 * HALF);
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(dv_acc);
        rt::fence_regs(dk_acc);
        rt::fence_regs(pf);
        rt::fence_regs(df);
      }
      release(&bar.empty[st], lane);
    }
    if constexpr (split) consumers_sync();  // the other's S reads sK, sV
    const long long at = ((b * (long long)S + kw) * K + kh) * HD + 64 * c0;
    store_tile<NC, NV>(sKw + c0 * HALF, dk_acc, scale, dk + at,
                       (long long)K * HD, S - kw, warp, lane);
    store_tile<NC, NV>(sVw + c0 * HALF, dv_acc, 1.f, dv + at,
                       (long long)K * HD, S - kw, warp, lane);
  });
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
  const int smem_dq = (int)wgb::smem_bytes<wgb::DQ, HD>();
  const int smem_kv = (int)wgb::smem_bytes<wgb::DKDV, HD>();
  static unsigned long long done_dq = 0, done_kv = 0;
  if ((err = rt::allow_smem(kdq, smem_dq, done_dq)) ||
      (err = rt::allow_smem(kkv, smem_kv, done_kv)))
    return err;
  const int G = a.H / a.K;
  const int hpb = !wgb::SPLIT<wgb::DQ, HD> && G % wgb::CONSUMERS == 0
                      ? wgb::CONSUMERS
                      : 1;
  const int bq = R * (wgb::OWN<wgb::DQ, HD> / hpb);
  float* D = static_cast<float*>(a.D);
  float* L = D + (size_t)a.B * a.H * wgb::padded(a.T);
  const float scale_log2 = a.scale * wgb::LOG2E;
  const dim3 g1(a.H / hpb, a.B, (a.T + bq - 1) / bq);
  kdq<<<g1, wgb::NT, smem_dq, stream>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(a.o),
      static_cast<const float*>(a.lse), D, L, static_cast<bf16*>(a.dq), a.T,
      a.S, a.H, G, hpb, q_ord, k_ord, v_ord, d_ord, a.o_sb, a.o_st, a.o_sh,
      a.causal, scale_log2, a.scale);
  if ((err = cudaGetLastError())) return err;
  const int bk = R * wgb::OWN<wgb::DKDV, HD>;
  const dim3 g2(a.K, a.B, (a.S + bk - 1) / bk);
  kkv<<<g2, wgb::NT, smem_kv, stream>>>(
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
// Tp = T rounded up to a multiple of 64. bf16 at head dims 64, 128, 160 and
// 256 takes the wgmma route, everything else (f32; bf16 at 16 and 32) the
// CUDA cores.
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
      r = WGMMA;
      err = launch_wg<256>(a, st);
      break;
    case 160:
      r = WGMMA;
      err = launch_wg<160>(a, st);
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
