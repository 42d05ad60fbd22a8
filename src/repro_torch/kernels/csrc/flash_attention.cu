// Causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :93). Same contract: q (B,T,H,hd),
// k/v (B,S,K,hd), query head h reads KV head h / G; causal mask row >= col
// aligned at 0; masked scores are -1e30; m, l and the accumulator are f32;
// l is floored at 1e-30; output in q's dtype. With a non-null lse pointer
// each kernel also writes the rows' natural log-sum-exp of the scaled,
// masked scores, m + log(l), f32 (B, H, T), in its epilogue: the backward
// kernel (flash_attention_bwd.cu) recomputes P from it. The serve path
// passes null and writes nothing more.
//
// What bounds it on the H100: at the serve shape (B 8, T 512, H 16, K 8,
// hd 128, bf16) moving q, k, v and o once takes 15 us at 3.35 TB/s and the
// causal products 8.7 us at 989 TFLOP/s, so bytes bound it up to T ~ 885 and
// operations beyond. At gemma-7b's prefill (H 16, K 16, hd 256) the bytes
// are 134 MB (40 us), at stablelm-12b's (H 32, K 8, hd 160) 105 MB (31 us).
// Three kernels, each counting the route it took (flash_attention_routes):
//
// bf16 at head dims 64, 128, 160 and 256 (the serve path; wg::): warpgroup
// products and TMA. A block is a producer warpgroup and two consumer warpgroups; each
// consumer owns 64 query rows of one head: the two heads of a GQA pair
// (same rows, so both read every K/V tile the block loads once), or two
// 64-row tiles of one head when H / K is odd. One producer lane issues TMA
// copies (cp.async.bulk.tensor, 128-byte swizzle) of the Q tiles and of
// 128-row K and V tiles (64-row above hd 128: the 2-stage ring of 128-row
// tiles would be 256 KB at 256; with 64 it is 192 KB in all) into a 2-stage
// ring, paced by mbarriers ("full" per tile, "empty" per K and per V
// stage); rows past T or S arrive as zeros and are masked. The head dim
// travels in 64-column halves: hd 160 as three, the tensor map's dim 0
// kept at 160 so that TMA zero-fills columns 160-191 (the barrier still
// counts the whole box). setmaxnreg moves registers from the producer (24)
// to the consumers (240; at hd 256 the output takes 128 a thread, S at 64
// keys 32, P 16). A consumer computes S = Q K^T with wgmma m64nBKk16 (Q and
// K read from shared memory by descriptor) and P V as m64n128k16 products
// over pairs of V's halves and an m64n64k16 over an odd half (P from
// registers, V read transposed from shared memory; the epilogue writes the
// real columns only). Its softmax runs on the accumulator fragments (a row's max over
// the 4 lanes of a quad; scale * log2 e folded into the exponent's FFMA,
// ex2.approx; the rescale of the output skipped where no row's max moved)
// while the tensor cores run the previous tile's P V: S_j is issued, then
// P_{j-1} V_{j-1}, and only S_j is waited for before the softmax. The two
// consumers take turns to issue (named barriers), so one's softmax overlaps
// the other's products. P goes to the A fragments of P V pair by pair and
// never through shared memory; the output is staged in the consumer's own
// Q tile and written in 16-byte stores. Only tiles that cross the diagonal
// or the end of S are masked; fully masked key tiles are never loaded.
// The grid is (heads, query tile, batch): the blocks go batch row by batch
// row, each row's query tiles heaviest first (the tile index reversed), so
// that a head's tiles run close together and read its K/V from HBM about
// once, and the short tiles of one row run beside the long ones of the
// next. A (heads, batch, query tile) grid, heaviest first over the whole
// launch, read each head's K/V once per query tile where the launch's K/V
// exceed the L2 (gemma-7b's prefill: 67 MB).
//
// bf16 at head dims 16 and 32 (tc::): mma.sync m16n8k16 on the tensor
// cores. A block of 4 warps owns a 64-row query tile of one head; each warp
// owns 16 rows, whose Q fragments it loads once (ldmatrix). 64-row K/V tiles
// come through a 2-stage cp.async ring (16-byte copies; the ragged tail
// zero-filled by the src-size operand), the next in flight while the
// current one's math runs; K fragments by ldmatrix, V by ldmatrix.trans;
// the softmax and P as above (exp2f, no fold), with rows HD + 8 elements
// apart so that ldmatrix hits all 32 banks.
//
// A deliberate difference from the Pallas kernel in both bf16 kernels: P is
// rounded to bf16 before P V (the Pallas body multiplies f32 P), a relative
// error of at most 2^-8 per element; the row sums l add the f32 P, as
// Pallas does.
//
// f32 (the TF32-off parity gates only): the first simple kernel, kept as
// it was (214 KB of shared memory at hd 256). One block of 256 threads per (64-row query tile, head, batch); Q
// and each 64-row K/V tile sit in shared memory; thread (ty, tx) of a
// 16x16 grid owns query rows ty+16i and, per tile, score columns tx+16j,
// with its 4x4 scores, the rows' running max/denominator and a 4 x hd/16
// slice of the output accumulator in registers; products on the f32 CUDA
// cores.
// The layout is read through strides; the ragged tail (T or S not a multiple
// of the tile) is zero-filled and masked.
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // 16 x 16 threads

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return 3 * BQ * (HD + rt::Elem<T>::PAD) * sizeof(T) +
         BQ * (BK + 1) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int T_,
                       int S, int H, int G, long long q_sb, long long q_st,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, int causal, float scale) {
  using E = rt::Elem<T>;
  constexpr int LD = HD + E::PAD;   // shared row stride of Q/K/V (elements)
  constexpr int LDP = BK + 1;       // shared row stride of P (floats)
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = HD / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BK * LD;
  float* sP = reinterpret_cast<float*>(sV + BK * LD);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  rt::load_tile<T, HD, LD>(sQ, q + b * q_sb + q0 * q_st + h * q_sh, q_st,
                           BQ, min(BQ, T_ - q0));

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = rt::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DJ; ++d) acc[i][d] = 0.f;
  }

  // causal: key tiles past this tile's last query row are fully masked
  const int kv_end = causal ? min(S, min(q0 + BQ, T_)) : S;
  const int nkv = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < nkv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V/P reads are done
    rt::load_tile<T, HD, LD>(sK, kb + k0 * k_ss, k_ss, BK, min(BK, S - k0));
    rt::load_tile<T, HD, LD>(sV, vb + k0 * v_ss, v_ss, BK, min(BK, S - k0));
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = E::load2(sQ + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kv[j] = E::load2(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          s[i][j] = fmaf(qv[i].y, kv[j].y, fmaf(qv[i].x, kv[j].x, s[i][j]));
    }

    // online softmax per row; the 16 lanes of a half-warp share the rows
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = rt::NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= S || (causal && col > row)) x = rt::NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], rt::max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + rt::sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DJ; ++d) acc[i][d] *= alpha;
    }
    __syncwarp();  // rows of P are written and read by one half-warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int d = 0; d < DJ; ++d)
        vv[d] = E::to_float(sV[c * LD + tx + 16 * d]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int d = 0; d < DJ; ++d) acc[i][d] = fmaf(p[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T_) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * T_ + row] = m[i] + logf(denom);
    T* orow = o + ((long long)(b * T_ + row) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < DJ; ++d)
      orow[tx + 16 * d] = E::from_float(acc[i][d] / denom);
  }
}

// -- bf16 at head dims 16 and 32: mma.sync and a cp.async K/V ring ---------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;  // each warp owns 16 of the BQ query rows
constexpr int STAGES = 2;       // K/V tiles in the shared-memory ring
static_assert(BQ == 16 * WARPS, "16 query rows per warp");

// Row stride in elements: 2 HD + 16 bytes, an odd number of 16-byte units.
template <int HD>
constexpr int LDS = HD + 8;

template <int HD>
constexpr size_t smem_bytes() {
  return (BQ + 2 * STAGES * BK) * LDS<HD> * sizeof(bf16);
}

// Issue the cp.async copies of a (64 x HD) tile whose row r starts at
// g + r * stride; rows >= valid read nothing and are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long stride, int valid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  static_assert((64 * CPR) % NT == 0, "chunks divide over the threads");
#pragma unroll
  for (int it = 0; it < 64 * CPR / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < valid;
    rt::cp_async16(s + r * LDS<HD> + c, ok ? g + r * stride + c : g, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 2)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse,
                          int T_, int S, int H, int G, long long q_sb,
                          long long q_st, long long q_sh, long long k_sb,
                          long long k_ss, long long k_sh, long long v_sb,
                          long long v_ss, long long v_sh, int causal,
                          float scale_log2) {
  constexpr int LD = LDS<HD>;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int DN = HD / 8;   // 8-wide output column tiles
  constexpr int SN = BK / 8;   // 8-wide score column tiles
  static_assert(KS >= 1 && DN % 2 == 0, "head dim 16 to 128");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;           // STAGES tiles
  bf16* sV = sK + STAGES * BK * LD;  // STAGES tiles

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int kh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* kb = k + b * k_sb + kh * k_sh;
  const bf16* vb = v + b * v_sb + kh * v_sh;
  // causal: key tiles past this tile's last query row are fully masked
  const int kv_end = causal ? min(S, min(q0 + BQ, T_)) : S;
  const int nkv = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int j) {
    const int k0 = j * BK, valid = min(BK, S - k0);
    load_tile<HD>(sK + (j % STAGES) * BK * LD, kb + k0 * k_ss, k_ss, valid);
    load_tile<HD>(sV + (j % STAGES) * BK * LD, vb + k0 * v_ss, v_ss, valid);
  };

  load_tile<HD>(sQ, q + b * q_sb + q0 * q_st + h * q_sh, q_st,
                min(BQ, T_ - q0));
  rt::cp_async_commit();
  load_kv(0);
  rt::cp_async_commit();
  rt::cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, one per 16-wide k-step
  uint32_t qf[KS][4];
  const bf16* sQw = sQ + warp * 16 * LD;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    rt::ldsm_x4(qf[kk], sQw + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);

  float acc[DN][4];
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  // rows g and g + 8 of the warp: running max (log2 units) and this lane's
  // part of the row sum (the quad's parts are added at the end)
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;

  for (int j = 0; j < nkv; ++j) {
    if (j + 1 < nkv) load_kv(j + 1);  // in flight during this tile's math
    rt::cp_async_commit();            // (empty on the last tile)
    rt::cp_async_wait<1>();           // tile j has landed
    __syncthreads();
    const bf16* Ks = sK + (j % STAGES) * BK * LD;
    const bf16* Vs = sV + (j % STAGES) * BK * LD;
    const int k0 = j * BK;

    // S = Q K^T: one ldmatrix.x4 gives the B fragments of two score tiles
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        uint32_t kf[4];
        rt::ldsm_x4(kf, Ks + (n * 8 + lane % 8 + (lane / 16) * 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8);
        rt::mma_bf16(s[n], qf[kk], kf);
        rt::mma_bf16(s[n + 1], qf[kk], kf + 2);
      }

    // online softmax on the fragments: element e of tile n is row
    // row0 + 8 (e / 2), column k0 + 8 n + 2 t + e % 2
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > S;
    float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int col = k0 + n * 8 + 2 * t + e % 2;
          if (col >= S || (causal && col > row0 + 8 * (e / 2)))
            x = rt::NEG_INF;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int d = 0; d < DN; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e / 2];

    // P V: score tiles 2c and 2c + 1 are the A fragment of k-step c
#pragma unroll
    for (int c = 0; c < SN / 2; ++c) {
      float p[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[i][e] = exp2f(s[2 * c + i][e] - m[e / 2]);
          l[e / 2] += p[i][e];
        }
      const uint32_t pf[4] = {
          rt::pack_bf16(p[0][0], p[0][1]), rt::pack_bf16(p[0][2], p[0][3]),
          rt::pack_bf16(p[1][0], p[1][1]), rt::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int d = 0; d < DN; d += 2) {
        uint32_t vf[4];
        rt::ldsm_x4_trans(vf, Vs + (c * 16 + lane % 16) * LD + d * 8 +
                                  (lane / 16) * 8);
        rt::mma_bf16(acc[d], pf, vf);
        rt::mma_bf16(acc[d + 1], pf, vf + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  // normalise, stage the warp's 16 rows in its own rows of sQ, and write
  // them out in 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    // m is in log2 units: ln(sum) = (m + log2 l) ln 2
    const int row = row0 + 8 * r;
    if (lse != nullptr && t == 0 && row < T_)
      lse[((long long)b * H + h) * T_ + row] =
          (m[r] + log2f(fmaxf(l[r], 1e-30f))) * 0.6931471805599453f;
  }
  bf16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(sO + (g + 8 * r) * LD + d * 8 + 2 * t) =
          rt::pack_bf16(acc[d][2 * r] * inv[r], acc[d][2 * r + 1] * inv[r]);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < DN / 2; ++it) {
    const int i = lane + it * 32, r = i / DN, c = (i % DN) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < T_)
      *reinterpret_cast<uint4*>(o + ((long long)(b * T_ + row) * H + h) * HD +
                                c) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c);
  }
}

}  // namespace tc

// -- bf16 at head dims 64 and 128: TMA ring, warpgroup products (wgmma) ----

namespace wg {

using namespace hop;  // wgmma_*, tma_tile, make_map (wgmma.cuh)
using bf16 = __nv_bfloat16;
constexpr int CONSUMERS = 2;  // warpgroups, each 64 query rows of one head
constexpr int NT = 128 * (1 + CONSUMERS);  // warpgroup 0 is the producer
// Registers a thread: 168 at launch (64K over NT threads); the producer
// hands its down to 24 so that each consumer can hold 240.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <= 65536,
              "the register file holds the block");
constexpr int STAGES = 2;     // K/V tiles in the shared-memory ring
// Key rows per K/V tile: 128, and 64 above head dim 128, where two stages
// of 128-row K and V tiles (256 KB at 256) exceed the 227 KB of a block.
template <int HD>
constexpr int BKW = HD > 128 ? 64 : 128;
// 64-column halves of the head dim: 160 is carried as three, whose columns
// 160-191 TMA zero-fills (the tensor map's dim 0 stays 160) and the
// epilogue never writes.
template <int HD>
constexpr int NH = (HD + 63) / 64;
constexpr int QHALF = 64 * 128;     // bytes of a Q tile's 64-column half
template <int HD>
constexpr int KHALF = BKW<HD> * 128;  // bytes of a K/V tile's half

template <int HD>
constexpr int QTILE = NH<HD> * QHALF;  // bytes of a 64-row Q tile
template <int HD>
constexpr int KTILE = NH<HD> * KHALF<HD>;  // bytes of a K/V tile

struct Barriers {
  uint64_t q, full_k[STAGES], full_v[STAGES], empty_k[STAGES],
      empty_v[STAGES];
};

template <int HD>
constexpr size_t smem_bytes() {
  return CONSUMERS * QTILE<HD> + 2 * STAGES * KTILE<HD> + sizeof(Barriers) +
         1024;  // + alignment slack
}

// Block: a producer warpgroup, one lane of which keeps K/V tiles coming by
// TMA through a ring of STAGES (an mbarrier "full" per K and per V tile,
// "empty" when all consumer warps are done with a stage); CONSUMERS
// warpgroups each own 64 query rows of one head: the two heads of a GQA
// pair (hpb 2, the same rows, so both need the same K/V tiles), or two
// 64-row tiles of one head (hpb 1). The two roles never reconverge, so
// setmaxnreg moves registers from the producer to the consumers.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_attention_wg_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int T_, int S, int H, int G,
                          int hpb, int q_ord, int k_ord, int v_ord,
                          int causal, float scale_log2) {
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int DN = HD / 8;   // 8-wide output column tiles written
  constexpr int BK = BKW<HD>;
  constexpr int SN = BK / 8;   // 8-wide score column tiles
  // accumulator floats a thread: 64 rows by NH halves of 64 columns over
  // 128 threads (at 256: 128, beside S's 32 and P's 16 of the 240)
  constexpr int NACC = 32 * NH<HD>;
  static_assert(HD == 64 || HD == 128 || HD == 160 || HD == 256,
                "head dims 64, 128, 160 and 256");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = sQ + CONSUMERS * QTILE<HD>;  // STAGES tiles
  unsigned char* sV = sK + STAGES * KTILE<HD>;      // STAGES tiles
  Barriers& bar = *reinterpret_cast<Barriers*>(sV + STAGES * KTILE<HD>);

  const int bq = 64 * (CONSUMERS / hpb);  // query rows per block
  const int h0 = blockIdx.x * hpb, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // heaviest tiles first
  const int kh = h0 / G;
  // causal: key tiles past the block's last query row are fully masked
  const int kv_end = causal ? min(S, min(q0 + bq, T_)) : S;
  const int nkv = (kv_end + BK - 1) / BK;
  const int w = threadIdx.x / 128 - 1;  // consumer warpgroup; -1 producer
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    rt::mbar_init(&bar.q, 1);
    for (int i = 0; i < STAGES; ++i) {
      rt::mbar_init(&bar.full_k[i], 1);
      rt::mbar_init(&bar.full_v[i], 1);
      rt::mbar_init(&bar.empty_k[i], 4 * CONSUMERS);  // one per consumer
      rt::mbar_init(&bar.empty_v[i], 4 * CONSUMERS);  // warp
    }
    rt::mbar_init_fence();
  }
  __syncthreads();

  if (w < 0) {  // the producer: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    rt::mbar_expect_tx(&bar.q, CONSUMERS * QTILE<HD>);
    for (int c = 0; c < CONSUMERS; ++c)
      tma_tile<HD, QHALF>(sQ + c * QTILE<HD>, &tq, q_ord, &bar.q,
                          h0 + c % hpb, q0 + 64 * (c / hpb), b);
    for (int j = 0; j < nkv; ++j) {
      const int st = j % STAGES, free = ((j / STAGES) & 1) ^ 1;
      rt::mbar_wait(&bar.empty_k[st], free);
      rt::mbar_expect_tx(&bar.full_k[st], KTILE<HD>);
      tma_tile<HD, KHALF<HD>>(sK + st * KTILE<HD>, &tk, k_ord,
                              &bar.full_k[st], kh, j * BK, b);
      rt::mbar_wait(&bar.empty_v[st], free);
      rt::mbar_expect_tx(&bar.full_v[st], KTILE<HD>);
      tma_tile<HD, KHALF<HD>>(sV + st * KTILE<HD>, &tv, v_ord,
                              &bar.full_v[st], kh, j * BK, b);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int h = h0 + w % hpb;
  const int qw = q0 + 64 * (w / hpb);  // this warpgroup's first query row
  const int g = lane / 4, t = lane % 4;
  const int row0 = qw + warp * 16 + g;
  const unsigned char* sQw = sQ + w * QTILE<HD>;
  float acc[NACC], s[SN * 4];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  // rows g and g + 8 of the warp: running max (log2 units) and this lane's
  // part of the row sum (the quad's parts are added at the end)
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

  // S = Q K^T of the tile in stage st: 64 x BK per warpgroup, Q and K from
  // shared memory
  auto issue_s = [&](int st) {
    const unsigned char* Ks = sK + st * KTILE<HD>;
    rt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int off = (kk % 4) * 32;
      const uint64_t dq = rt::wgmma_desc(sQw + (kk / 4) * QHALF + off, 16,
                                         1024);
      const uint64_t dk = rt::wgmma_desc(Ks + (kk / 4) * KHALF<HD> + off, 16,
                                         1024);
      if constexpr (BK == 128)
        wgmma_ss_m64n128(s, dq, dk, kk > 0);
      else
        wgmma_ss_m64n64(s, dq, dk, kk > 0);
    }
    rt::wgmma_commit();
  };
  // acc += P V of the tile in stage st; score tiles 2c and 2c + 1 are the A
  // fragment of k-step c (keys 16c..16c+15: two 8-row groups of V, SBO
  // 1024; the column halves of V are KHALF bytes apart, LBO). The head dim
  // is covered a pair of halves at a time by m64n128 and an odd half by
  // m64n64, each into its own columns of acc (half p's at acc[32 p]).
  auto issue_pv = [&](int st) {
    const unsigned char* Vs = sV + st * KTILE<HD>;
    rt::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
      for (int p = 0; p + 1 < NH<HD>; p += 2)
        wgmma_rs_m64n128_t(
            *reinterpret_cast<float(*)[64]>(acc + 32 * p), pf[c],
            rt::wgmma_desc(Vs + p * KHALF<HD> + c * 2048, KHALF<HD>, 1024));
      if constexpr (NH<HD> % 2 == 1)
        wgmma_rs_m64n64_t(
            *reinterpret_cast<float(*)[32]>(acc + 32 * (NH<HD> - 1)), pf[c],
            rt::wgmma_desc(Vs + (NH<HD> - 1) * KHALF<HD> + c * 2048,
                           KHALF<HD>, 1024));
    }
    rt::wgmma_commit();
  };
  // online softmax on the accumulators of the tile at k0, in place: s
  // becomes P (f32); element 4n + e is row row0 + 8 (e / 2), column
  // k0 + 8 n + 2 t + e % 2. Where nothing is masked (and scale > 0) the
  // row max is taken of the raw scores and the scale folds into the
  // exponent's FFMA; tiles that cross the diagonal or the end of S are
  // scaled and masked first.
  auto softmax = [&](int k0) {
    const bool masked = (causal && k0 + BK - 1 > qw) || k0 + BK > S;
    const bool fold = !masked && scale_log2 > 0.f;
    if (!fold) {
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + e % 2;
          s[4 * n + e] = col >= S || (causal && col > row0 + 8 * (e / 2))
                             ? rt::NEG_INF
                             : s[4 * n + e] * scale_log2;
        }
    }
    const float c = fold ? scale_log2 : 1.f;
    float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
    for (int i = 0; i < SN * 4; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * c);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < SN * 4; ++i) {
      s[i] = rt::exp2_approx(fmaf(s[i], c, -m[(i % 4) / 2]));
      l[(i % 4) / 2] += s[i];
    }
  };
  // P to the bf16 A fragments of P V, after acc has taken the rescale
  // (skipped where no row of the warp has a new max)
  auto rescale_and_pack = [&]() {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i % 4) / 2];
    }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[c][i] = rt::pack_bf16(s[8 * c + 2 * i], s[8 * c + 2 * i + 1]);
  };
  auto release = [&](uint64_t* empty) {  // this warp is done with a stage
    __syncwarp();
    if (lane == 0) rt::mbar_arrive(empty);
  };
  // The consumers take turns to issue their products (named barriers 1 and
  // 2), so that one's softmax runs while the other's products do.
  static_assert(CONSUMERS == 2, "two consumers take turns");
  auto my_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
  };
  auto your_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
  };
  if (w == 1) your_turn();  // consumer 0 takes the first turn

  // Tile j's softmax runs on the CUDA cores while tile j - 1's P V runs on
  // the tensor cores: S_j is issued, then P_{j-1} V_{j-1}; S_j is waited
  // for alone, its softmax computed, and only then P_{j-1} V_{j-1}.
  rt::mbar_wait(&bar.q, 0);
  rt::mbar_wait(&bar.full_k[0], 0);
  my_turn();
  issue_s(0);
  your_turn();
  rt::wgmma_wait<0>();
  rt::fence_regs(s);
  release(&bar.empty_k[0]);
  softmax(0);
  rescale_and_pack();
  for (int j = 1; j < nkv; ++j) {
    const int st = j % STAGES, ph = (j / STAGES) & 1;
    const int pst = (j - 1) % STAGES, pph = ((j - 1) / STAGES) & 1;
    rt::mbar_wait(&bar.full_k[st], ph);
    rt::mbar_wait(&bar.full_v[pst], pph);
    my_turn();
    issue_s(st);
    issue_pv(pst);
    your_turn();
    rt::wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may run on
    rt::fence_regs(s);
    release(&bar.empty_k[st]);
    softmax(j * BK);
    rt::wgmma_wait<0>();
    rt::fence_regs(acc);
    rt::fence_regs(pf);
    release(&bar.empty_v[pst]);
    rescale_and_pack();
  }
  const int lst = (nkv - 1) % STAGES;
  rt::mbar_wait(&bar.full_v[lst], ((nkv - 1) / STAGES) & 1);
  my_turn();
  issue_pv(lst);
  if (w == 0) your_turn();  // the last turn: consumer 0 has no next turn
  rt::wgmma_wait<0>();
  rt::fence_regs(acc);
  release(&bar.empty_v[lst]);

  // normalise, stage the warpgroup's 64 rows in its own Q tile (swizzled;
  // no wgmma reads it any more), and write each warp's 16 rows out in
  // 16-byte stores: the HD real columns only
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    // m is in log2 units: ln(sum) = (m + log2 l) ln 2
    const int row = row0 + 8 * r;
    if (lse != nullptr && t == 0 && row < T_)
      lse[((long long)b * H + h) * T_ + row] =
          (m[r] + log2f(fmaxf(l[r], 1e-30f))) * 0.6931471805599453f;
  }
  unsigned char* sO = sQ + w * QTILE<HD>;
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(
          sO + rt::swizzle128<QHALF>(warp * 16 + g + 8 * r, d) + 4 * t) =
          rt::pack_bf16(acc[4 * d + 2 * r] * inv[r],
                        acc[4 * d + 2 * r + 1] * inv[r]);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < DN / 2; ++it) {
    const int i = lane + it * 32, r = warp * 16 + i / DN, c = i % DN;
    const int row = qw + r;
    if (row < T_)
      *reinterpret_cast<uint4*>(o + ((long long)(b * T_ + row) * H + h) * HD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(sO + rt::swizzle128<QHALF>(r, c));
  }
}

}  // namespace wg

template <int HD>
int launch_wg(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int T_, int S, int H, int K, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              int causal, float scale, cudaStream_t stream) {
  using wg::bf16;
  CUtensorMap tq, tk, tv;
  int q_ord, k_ord, v_ord;
  cudaError_t err;
  constexpr int R = wg::BKW<HD>;
  if ((err = wg::make_map(&tq, &q_ord, q, HD, 64, H, T_, B, q_sh, q_st,
                          q_sb)) ||
      (err = wg::make_map(&tk, &k_ord, k, HD, R, K, S, B, k_sh, k_ss, k_sb)) ||
      (err = wg::make_map(&tv, &v_ord, v, HD, R, K, S, B, v_sh, v_ss, v_sb)))
    return err;
  auto kern = wg::flash_attention_wg_kernel<HD>;
  const size_t smem = wg::smem_bytes<HD>();
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / K;
  const int hpb = G % wg::CONSUMERS == 0 ? wg::CONSUMERS : 1;
  const int bq = 64 * (wg::CONSUMERS / hpb);
  const dim3 grid(H / hpb, (T_ + bq - 1) / bq, B);
  kern<<<grid, wg::NT, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, T_, S, H, G, hpb, q_ord, k_ord,
      v_ord, causal, scale * 1.4426950408889634f);  // log2 units, for exp2f
  return cudaGetLastError();
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int T_, int S, int H, int K, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              int causal, float scale, cudaStream_t stream) {
  using tc::bf16;
  auto kern = tc::flash_attention_tc_kernel<HD>;
  const size_t smem = tc::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (T_ + BQ - 1) / BQ);
  kern<<<grid, tc::NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, T_, S, H,
      H / K,
      q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
      scale * 1.4426950408889634f);  // scores in log2 units, for exp2f
  return cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T_, int S, int H, int K, long long q_sb, long long q_st,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, int causal,
           float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 64) {
    return launch_wg<HD>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
                         stream);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_tc<HD>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
                         stream);
  } else {
    auto kern = flash_attention_kernel<T, HD>;
    const size_t smem = smem_bytes<T, HD>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T_ + BQ - 1) / BQ, H, B);
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, T_, S, H, H / K,
        q_sb,
        q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale);
    return cudaGetLastError();
  }
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int T_, int S, int H, int K, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              int causal, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st,
                           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
                           scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st,
                           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
                           scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st,
                           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
                           scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st, q_sh,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
                            st);
    case 160:
      return launch<T, 160>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st, q_sh,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
                            st);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st, q_sh,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
                            st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The routes a call can take (the wrapper's ``fwd_route`` names them), and
// the launches each has had: the launcher counts the route it took.
enum Route { WGMMA, MMA_SYNC, CUDA_CORE, ROUTES };
std::atomic<unsigned long long> taken[ROUTES];

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides are in
// elements; the last dimension of q, k and v is contiguous; o is a
// contiguous (B, T, H, hd) tensor; lse, null or a contiguous f32 (B, H, T)
// tensor, receives each row's log-sum-exp.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse_, int B,
                                   int T_,
                                   int S, int H, int K, int hd,
                                   long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss,
                                   long long v_sh, int is_bf16, int causal,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_);
  int err;
  Route r = CUDA_CORE;
  if (is_bf16) {
    r = hd >= 64 ? WGMMA : MMA_SYNC;
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, T_, S, H, K, q_sb,
                                   q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                   v_sh, causal, scale, st);
  } else {
    err = launch_hd<float>(hd, q, k, v, o, lse, B, T_, S, H, K, q_sb, q_st,
                           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
                           scale, st);
  }
  if (err == 0) taken[r].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// Copies the launches by route (wgmma, mma_sync, cuda_core) since the last
// reset into counts[3]; with reset, zeroes them.
extern "C" void flash_attention_routes(unsigned long long* counts,
                                       int reset) {
  for (int r = 0; r < ROUTES; ++r)
    counts[r] = reset ? taken[r].exchange(0) : taken[r].load();
}
