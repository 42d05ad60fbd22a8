// Weight-quantised matmul (W8A16 / W4A16) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py
// (quant_matmul, pallas_call at :56). Same contract: out = x @ (w_q * scale)
// in x's dtype, products summed in f32, the per-channel scale applied to the
// f32 sum in the epilogue as the Pallas body does. x is (M, K) f32 or bf16
// with any strides; w_q is int8, or int4 packed two to a byte along its
// stored last axis (even index in the low nibble, sign-extended here), stored
// row-major as (K, N) or, "transposed", as (N, K) (the tied unembed reads the
// (V, d) embedding table). The scale lies on the stored last axis: on N for
// (K, N), applied to the sum; on K for (N, K), folded into x as x is staged.
// A scale of S < that axis's length is tiled: element i takes scale[i % S].
// Any M, N and K (the Pallas kernel asserts they divide by its blocks).
//
// Routes (the wrapper's ``route`` states the same rule; the launcher counts
// the route each launch took, read by quant_matmul_routes):
//
// "decode", bf16 x at M <= 16 (every decode projection and the unembed of
// the serve path): the tensor-core decode kernels of dec:: below, bound by
// the weight bytes. Each lane builds mma.sync A fragments of the weight
// from its own 16- or 8-byte chunks in registers (byte tricks, no
// per-element conversion), a shared-memory ring fed by cp.async holds a
// block's whole share of the weight at qwen3's layer shapes, so every load
// is in flight before the first product, and K is split over a thread
// block cluster of up to 8 blocks until the grid covers the SMs, the ranks'
// sums pushed to the first rank's shared memory (one cluster barrier). The
// (N, K) kernel takes x * s as two bf16 terms (hi + lo).
//
// "wgmma", bf16 x at M > 16 with a (K, N) weight (every projection of the
// serve path's prefill), where TMA can describe both (the wrapper's ``vec``
// and ``vec_x``): the warp-specialised kernel of pf:: below, bound by
// operations: TMA feeds x and the raw weight through an mbarrier ring, two
// consumer warpgroups dequantise each weight tile into shared memory and
// run wgmma on it.
//
// "fma", the CUDA-core tiles: f32 x (held at 1e-4), and bf16 x at M > 16
// that the wgmma kernel does not take (an (N, K) weight, or an x or weight
// TMA cannot describe: unaligned or overlapping rows). A block of 256
// threads computes a BM x BN output tile, walking K in BK steps. Each
// step's weight tile is read from device memory in 16-byte chunks in its
// stored order (coalesced in both layouts), turned to f32 in registers and
// stored to shared memory as [k][n]; x is staged as f32 [k][m]. The next
// step's chunks are loaded into registers before the current step's f32
// FMAs. Two tiles, picked by M: decode (f32 x at M <= 16) takes 8 x 64
// tiles with BK 128, each thread all 8 rows of 2 columns and each warp 16
// of a step's 128 rows; the warps' sums meet in shared memory, and K is
// split over a thread block cluster as above. Prefill takes 128 x 128
// tiles, 8 x 8 outputs per thread.
//
// int8 and int4 values are exact in bf16 and products of bf16 values exact
// in f32, so every route sums the same terms in another order.
#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int MAX_SPLIT = 8;  // the portable cluster size

// WK: each thread holds all BM rows of its TN columns and the warps split
// each K step (decode); else thread (tx, ty) holds TM x TN outputs (prefill).
template <int BM_, int BN_, int BK_, int TM_, int TN_, bool WK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr bool WK = WK_;
  static constexpr int TX = BN / TN;                  // threads along N
  static constexpr int TY = WK ? NT / TX : BM / TM;   // warps along K, or
                                                      // threads along M
  static_assert(TX * TY == NT, "NT threads per block");
  static_assert(!WK || (TM == BM && TX == 32 && BK % TY == 0),
                "WK: a warp spans the tile's columns, BK splits over warps");
  static constexpr int LDX = BM + 4;  // sX[k][m], rows 16-byte aligned
  static constexpr int LDW = BN + 4;  // sW[k][n]
  static_assert(!WK || (TY * BM * BN <= BK * LDW && BM * BN <= BK * LDX),
                "WK: the warps' partial tiles fit in sW, their sum in sX");
};
using Decode = Tile<8, 64, 128, 8, 2, true>;
using Prefill = Tile<128, 128, 32, 8, 8, false>;

union Chunk {
  uint4 v;
  unsigned char b[16];
};

// The weight tile of one K step as it is stored: ROWS rows (k for (K, N),
// n for (N, K)) of COLS bytes, read as 16-byte chunks.
template <class C, bool INT4, bool NK>
struct WTile {
  static constexpr int VPB = INT4 ? 2 : 1;  // values per byte
  static constexpr int ROWS = NK ? C::BN : C::BK;
  static constexpr int COLS = (NK ? C::BK : C::BN) / VPB;
  static constexpr int CPR = COLS / 16;
  static_assert(CPR * 16 == COLS, "tile rows are whole 16-byte chunks");
  static constexpr int CHUNKS = ROWS * CPR;
  static constexpr int PER_THREAD = (CHUNKS + NT - 1) / NT;

  // Chunk c sits at (row, byte). (K, N) tiles go along a row (coalesced,
  // store conflicts at most 2-way); (N, K) tiles go down the rows, so that
  // the transposing shared-memory stores of a warp hit 32 banks.
  __device__ static void at(int c, int& row, int& byte) {
    if (NK) {
      row = c % ROWS;
      byte = (c / ROWS) * 16;
    } else {
      row = c / CPR;
      byte = (c % CPR) * 16;
    }
  }
};

template <typename T, bool INT4, bool NK, class C>
__global__ void __launch_bounds__(NT)
qmm_kernel(const T* __restrict__ x, const unsigned char* __restrict__ w,
           const float* __restrict__ scale, T* __restrict__ out, int M, int N,
           int K, long long sxm, long long sxk, long long ldw, int S, int vec) {
  using E = rt::Elem<T>;
  using W = WTile<C, INT4, NK>;
  constexpr int XPT = C::BM * C::BK / NT;  // x values staged per thread
  static_assert(XPT * NT == C::BM * C::BK, "x tile divides over threads");

  __shared__ __align__(16) float sX[C::BK * C::LDX];
  __shared__ __align__(16) float sW[C::BK * C::LDW];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, tx = tid % C::TX, ty = tid / C::TX;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;

  // the stored weight: its rows, the bytes in a row, and the logical length
  // of the packed axis (values beyond it are never stored or add x = 0)
  const int w_rows = NK ? N : K;
  const int w_len = NK ? K : N;
  const long long row_bytes = INT4 ? (w_len + 1) / 2 : w_len;

  const int nkt = (K + C::BK - 1) / C::BK;
  const int kt0 = (int)((long long)rank * nkt / split);
  const int kt1 = (int)((long long)(rank + 1) * nkt / split);

  Chunk wr[W::PER_THREAD];
  float xr[XPT];

  auto load = [&](int kt) {
    const int k0 = kt * C::BK;
    const int row0 = NK ? n0 : k0;
    const long long byte0 = (NK ? k0 : n0) / W::VPB;
#pragma unroll
    for (int i = 0; i < W::PER_THREAD; ++i) {
      const int c = tid + i * NT;
      wr[i].v = make_uint4(0u, 0u, 0u, 0u);
      if (c >= W::CHUNKS) continue;
      int r, b;
      W::at(c, r, b);
      const long long gr = row0 + r, gb = byte0 + b;
      if (gr >= w_rows || gb >= row_bytes) continue;
      const unsigned char* p = w + gr * ldw + gb;
      if (vec && gb + 16 <= row_bytes) {
        wr[i].v = *reinterpret_cast<const uint4*>(p);
      } else {
        for (int j = 0; j < 16 && gb + j < row_bytes; ++j) wr[i].b[j] = p[j];
      }
    }
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * NT, m = e / C::BK, k = e % C::BK;
      const int gm = m0 + m, gk = k0 + k;
      xr[i] = (gm < M && gk < K) ? E::to_float(x[gm * sxm + gk * sxk]) : 0.f;
    }
  };

  auto stage = [&](int kt) {
    const int k0 = kt * C::BK;
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * NT, m = e / C::BK, k = e % C::BK;
      float v = xr[i];
      if (NK && k0 + k < K) v *= scale[(k0 + k) % S];
      sX[k * C::LDX + m] = v;
    }
#pragma unroll
    for (int i = 0; i < W::PER_THREAD; ++i) {
      const int c = tid + i * NT;
      if (c >= W::CHUNKS) continue;
      int r, b;
      W::at(c, r, b);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned char byte = wr[i].b[j];
        float v0, v1 = 0.f;
        if (INT4) {
          v0 = (float)((int)(signed char)(byte << 4) >> 4);
          v1 = (float)((int)(signed char)byte >> 4);
        } else {
          v0 = (float)(signed char)byte;
        }
        const int col = (b + j) * W::VPB;  // value index along the row
        if (NK) {
          sW[col * C::LDW + r] = v0;
          if (INT4) sW[(col + 1) * C::LDW + r] = v1;
        } else {
          sW[r * C::LDW + col] = v0;
          if (INT4) sW[r * C::LDW + col + 1] = v1;
        }
      }
    }
  };

  // this thread's outputs: rows ty*TM + i (all BM rows with WK); columns
  // tx*TN + j with WK, else tx*TN/2 + j in each half of the tile
  // (neighbouring threads read neighbouring shared words)
  constexpr int HN = C::TN / 2;
  auto col_of = [&](int j) {
    if (C::WK) return tx * C::TN + j;
    return j < HN ? tx * HN + j : C::BN / 2 + tx * HN + (j - HN);
  };

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // the previous step's reads are done
    stage(kt);
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);  // in flight during the FMAs
    // with WK warp ty takes rows [ty * BK/TY, (ty + 1) * BK/TY) of the step
    constexpr int KW = C::WK ? C::BK / C::TY : C::BK;
    const int kw = C::WK ? ty * KW : 0;
#pragma unroll 4
    for (int kk = kw; kk < kw + KW; ++kk) {
      float a[C::TM], bw[C::TN];
      const float* xs = sX + kk * C::LDX + (C::WK ? 0 : ty * C::TM);
      const float* ws = sW + kk * C::LDW;
      if constexpr (C::TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < C::TM; i += 4) {
          const float4 t = *reinterpret_cast<const float4*>(xs + i);
          a[i] = t.x, a[i + 1] = t.y, a[i + 2] = t.z, a[i + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < C::TM; ++i) a[i] = xs[i];
      }
      if constexpr (HN % 4 == 0) {
#pragma unroll
        for (int j = 0; j < C::TN; j += 4) {
          const float4 t = *reinterpret_cast<const float4*>(ws + col_of(j));
          bw[j] = t.x, bw[j + 1] = t.y, bw[j + 2] = t.z, bw[j + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < C::TN; ++j) bw[j] = ws[col_of(j)];
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
  }

  auto store = [&](int m, int n, float v) {
    if (m < M && n < N) {
      if (!NK) v *= scale[n % S];
      out[(long long)m * N + n] = E::from_float(v);
    }
  };

  if constexpr (C::WK) {
    // the warps' partial tiles are summed in shared memory, then the
    // cluster's ranks' sums in distributed shared memory
    constexpr int TILE = C::BM * C::BN;
    float* red = sW;   // [warp][m][n]
    float* part = sX;  // [m][n], read by the other ranks
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        red[(ty * C::BM + i) * C::BN + col_of(j)] = acc[i][j];
    __syncthreads();
    for (int e = tid; e < TILE; e += NT) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < C::TY; ++w) v += red[w * TILE + e];
      if (split == 1)
        store(m0 + e / C::BN, n0 + e % C::BN, v);
      else
        part[e] = v;
    }
    if (split > 1) {
      cluster.sync();
      const int per = (TILE + split - 1) / split;
      const int e1 = min(TILE, (rank + 1) * per);
      for (int e = rank * per + tid; e < e1; e += NT) {
        float v = 0.f;
        for (int r = 0; r < split; ++r)
          v += cluster.map_shared_rank(part, r)[e];
        store(m0 + e / C::BN, n0 + e % C::BN, v);
      }
      cluster.sync();  // keep this block's part alive for the other ranks
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      store(m0 + ty * C::TM + i, n0 + col_of(j), acc[i][j]);
}

// -- the tensor-core decode kernels (bf16 x, M <= 16) ------------------------
//
// out^T = W^T x^T on mma.sync m16n8k16: the weight is A (16 output columns
// by 16 k), x^T is B (16 k by 8 rows of x), so M <= 8 fills one n8 tile and
// M <= 16 two (MT). int8 and int4 values are exact in bf16 and the products
// exact in f32. Inside one k-step the order of k is free as long as A and B
// agree on it, and the output column of an A row is free as long as the
// four lanes of a quad agree on it; both freedoms let each lane build its
// fragments from the bytes of a few 16-byte (or 8-byte) chunks in
// registers, with no transpose through shared memory:
//  - int8 bytes become exact f32 by prmt into the mantissa of 2^23 (after
//    an xor that biases them by 128) and one subtraction; two such f32 give
//    a bf16 pair by one prmt of their high halves, from any two bytes;
//  - int4 pairs come from one lop3 (the nibbles at bits 0 and 16, biased
//    by 8, under a bf16 128) and one bf16x2 fma that takes 136 off.
// In the (K, N) kernel each lane streams its own chunks through its own
// slots of a shared-memory ring (cp.async, R k-steps a warp), so no block
// barrier paces the loads, and at qwen3's layer shapes the ring holds a
// block's whole share: every load is issued before the first product. The
// (N, K) kernel stages whole rows a warp at a time (see there). Reductions
// run in a fixed order (warps, then the cluster's ranks), so results repeat
// bit for bit. Bound by the weight bytes; at qwen3's layer shapes a call
// is a chain of short phases (load, products, two reductions) whose cost
// is set more by the first execution of each launch's code than by their
// work, so the code keeps its slow paths out of line (PERF.md).
namespace dec {

using bf16 = __nv_bfloat16;
constexpr int NT = 256, WARPS = NT / 32;
constexpr int R = 4;          // ring slots a warp: k-steps of (K, N)
constexpr int RU = 2;         // and 4 KB units of (N, K)

// four signed bytes -> four exact floats (2^23 + 128 + v, less 2^23 + 128)
__device__ __forceinline__ void i8x4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// two floats that bf16 holds exactly -> a bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// the signed nibbles at bits 0-3 and 16-19 of v -> a bf16 pair:
// ((v & 0x000f000f) ^ 0x43084308) is bf16 128 + (nibble ^ 8) = 136 + value
__device__ __forceinline__ uint32_t i4pair(uint32_t v) {
  uint32_t h;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(h)
      : "r"(v), "r"(0x000f000fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(h)
      : "r"(h), "r"(0x3F803F80u), "r"(0xC308C308u));  // h * 1 - 136
  return h;
}

// N bytes (16, 8 or 4) from device memory into shared memory, async
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    rt::cp_async16(dst, src, true);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     rt::smem_addr(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}

// CB bytes of a weight row from byte b on, zero past the row (or all
// zeros for a null row), by plain loads: the path of unaligned weights and
// of a row's ragged end, kept out of line so that the hot path stays short
template <int CB>
__device__ __noinline__ void stage_bytes(unsigned char* dst,
                                         const unsigned char* row,
                                         long long b, long long row_bytes) {
  union {
    uint4 v;
    unsigned char c[16];
  } u;
  u.v = make_uint4(0u, 0u, 0u, 0u);
  if (row != nullptr)
    for (int j = 0; j < CB && b + j < row_bytes; ++j) u.c[j] = row[b + j];
  if constexpr (CB == 16)
    *reinterpret_cast<uint4*>(dst) = u.v;
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(u.v.x, u.v.y);
}

// CB bytes of a weight row from byte b on into the lane's slot: by cp.async
// where the chunk is aligned and whole, else by stage_bytes
template <int CB>
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* row, long long b,
                                      long long row_bytes, int vec) {
  if (row != nullptr && vec && b + CB <= row_bytes) {
    cp_async<CB>(dst, row + b);
  } else {
    stage_bytes<CB>(dst, row, b, row_bytes);
  }
}

// x[m][k], x[m][k + 1] as a bf16 pair, zero outside (M, K), by plain loads
__device__ __noinline__ void stage_xpair_slow(unsigned char* dst,
                                              const bf16* __restrict__ x,
                                              int m, int k, int M, int K,
                                              long long sxm, long long sxk) {
  uint32_t v = 0u;
  if (m < M && k < K) {
    const bf16* p = x + m * sxm + k * sxk;
    const bf16 hi = k + 1 < K ? p[sxk] : __float2bfloat16(0.f);
    const __nv_bfloat162 h(p[0], hi);
    v = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint32_t*>(dst) = v;
}

// the same into the lane's slot by cp.async where the pair is whole and
// 4-byte aligned
__device__ __forceinline__ void stage_xpair(unsigned char* dst,
                                            const bf16* __restrict__ x, int m,
                                            int k, int M, int K,
                                            long long sxm, long long sxk,
                                            int vec_x) {
  if (vec_x && m < M && k + 1 < K)
    cp_async<4>(dst, x + m * sxm + k);
  else
    stage_xpair_slow(dst, x, m, k, M, K, sxm, sxk);
}

// (K, N): a block owns 128 output columns over a K range (its rank's share
// when K is split over a cluster of gridDim.z blocks); warp w takes the
// range's 16-row k-steps w, w + 8, .... Lane (g, t) stages rows 2t, 2t+1,
// 2t+8, 2t+9 of a k-step at the tile's columns 16g..16g+15 (CB bytes each)
// and the x pairs (k, k + 1) and (k + 8, k + 9) of its rows g (and g + 8)
// at k = 2t, and is the A fragment of 8 tiles: tile j row g is column
// 16g + j, row g + 8 is 16g + 8 + j; k is in its natural order, so the x
// pairs are its B fragment. The warps' sums meet in shared memory; the
// ranks other than 0 push theirs into rank 0's shared memory with st.async,
// which completes on rank 0's mbarrier, and rank 0 adds them in rank order.
template <bool INT4, int MT>
__global__ void __launch_bounds__(NT)
dec_kn_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ w,
              const float* __restrict__ scale, bf16* __restrict__ out, int M,
              int N, int K, long long sxm, long long sxk, long long ldw,
              int S, int vec, int vec_x) {
  constexpr int VPB = INT4 ? 2 : 1;
  constexpr int CB = 16 / VPB;              // bytes of a row a lane stages
  constexpr int LANE_B = 4 * CB + 16;       // + its x pairs (MT * 8 B)
  constexpr int STEP_B = 32 * LANE_B;
  constexpr int ACC = MT * 8 * 4;           // accumulators a lane
  constexpr int PER = ACC * 32 / NT / 4;    // float4 of sums a thread adds
  constexpr int RING_B = WARPS * R * STEP_B, RED_B = WARPS * ACC * 32 * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [warp][ACC][lane], after
  float* slots = reinterpret_cast<float*>(      // the ring; [rank - 1][ACC]
      smem + (RING_B > RED_B ? RING_B : RED_B));  // [lane]
  __shared__ uint64_t pushed;  // rank 0: the other ranks' sums have landed

  const int split = gridDim.z, rank = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * 128;
  const long long row_bytes = INT4 ? (N + 1) / 2 : N;
  const long long b0 = n0 / VPB + g * CB;
  const int KT = (K + 15) / 16;
  const int kt0 = (int)((long long)rank * KT / split);
  const int kt1 = (int)((long long)(rank + 1) * KT / split);
  const int steps = kt1 - kt0 > warp ? (kt1 - kt0 - warp + WARPS - 1) / WARPS
                                     : 0;
  unsigned char* mine = smem + warp * R * STEP_B + lane * LANE_B;

  auto issue = [&](int i) {
    const int k = (kt0 + warp + i * WARPS) * 16 + 2 * t;
    unsigned char* dst = mine + (i % R) * STEP_B;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = k + (r & 1) + 8 * (r >> 1);
      stage<CB>(dst + r * CB, row < K ? w + row * ldw : nullptr, b0,
                row_bytes, vec);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        stage_xpair(dst + 4 * CB + 8 * mt + 4 * h, x, mt * 8 + g, k + 8 * h,
                    M, K, sxm, sxk, vec_x);
  };
  // the loads first: what follows runs while they are in flight
#pragma unroll 1  // one copy of issue's code, fetched once
  for (int i = 0; i < R; ++i) {
    if (i < steps) issue(i);
    rt::cp_async_commit();
  }

  if (split > 1) {
    if (rank == 0 && threadIdx.x == 0) {
      rt::mbar_init(&pushed, 1);
      rt::mbar_init_fence();
      rt::mbar_expect_tx(&pushed, (split - 1) * ACC * 32 * 4);
    }
    // relaxed: a release here would wait for the loads just issued; the
    // mbarrier's init is released by its own fence
    rt::cluster_arrive_relaxed();  // waited for before the first push
  }
  // thread tid adds and stores entries 4 tid + 4 NT p + c (c < 4) of
  // [ACC][lane] (accumulator e / 32 of lane e % 32): one output column n
  // (lane 4 (tid % 8) + c, accumulator tid / 8 + 32 p, so tile j = warp and
  // q = (tid / 8) % 4) and rows 8 p + 2 c + q % 2
  const int qe = (threadIdx.x / 8) % 4;
  const int n_out = n0 + 16 * (threadIdx.x % 8) + warp + 8 * (qe / 2);
  const float s_out = n_out < N ? scale[n_out % S] : 0.f;  // read early

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

  for (int i = 0; i < steps; ++i) {
    rt::cp_async_wait<R - 1>();
    const unsigned char* src = mine + (i % R) * STEP_B;
    uint32_t a[8][4];
    if constexpr (INT4) {
      uint2 r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint2*>(src + q * CB);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns 8h..8h+7: A row g + 8h
        const uint32_t w0 = h ? r[0].y : r[0].x, w1 = h ? r[1].y : r[1].x;
        const uint32_t w2 = h ? r[2].y : r[2].x, w3 = h ? r[3].y : r[3].x;
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5410);
        const uint32_t hi01 = __byte_perm(w0, w1, 0x7632);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5410);
        const uint32_t hi23 = __byte_perm(w2, w3, 0x7632);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[s][h] = i4pair(lo01 >> (4 * s));
          a[4 + s][h] = i4pair(hi01 >> (4 * s));
          a[s][2 + h] = i4pair(lo23 >> (4 * s));
          a[4 + s][2 + h] = i4pair(hi23 >> (4 * s));
        }
      }
    } else {
      uint4 r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint4*>(src + q * CB);
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // columns 4c..4c+3
        float f[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          i8x4(c == 0 ? r[q].x : c == 1 ? r[q].y : c == 2 ? r[q].z : r[q].w,
               f[q]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = 4 * c + b, j = n % 8, h = n / 8;
          a[j][h] = pair(f[0][b], f[1][b]);
          a[j][2 + h] = pair(f[2][b], f[3][b]);
        }
      }
    }
    const uint32_t* bx = reinterpret_cast<const uint32_t*>(src + 4 * CB);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j) rt::mma_bf16(acc[mt][j], a[j], bx + 2 * mt);
    if (i + R < steps) issue(i + R);  // into the slot just read
    rt::cp_async_commit();
  }

  __syncthreads();  // every warp is done with the ring
  const float* af = &acc[0][0][0];
#pragma unroll
  for (int i = 0; i < ACC; ++i) red[(warp * ACC + i) * 32 + lane] = af[i];
  __syncthreads();
  float4 v[PER];  // this block's sums of the thread's entries
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = 4 * threadIdx.x + 4 * NT * p;
    v[p] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
      const float4 r =
          *reinterpret_cast<const float4*>(red + q * ACC * 32 + e);
      v[p].x += r.x, v[p].y += r.y, v[p].z += r.z, v[p].w += r.w;
    }
  }
  if (split > 1 && rank > 0) {  // push to rank 0 and leave
    rt::cluster_wait();  // rank 0's barrier is ready
    const uint32_t bar = rt::mapa(rt::smem_addr(&pushed), 0);
#pragma unroll
    for (int p = 0; p < PER; ++p)
      rt::st_async(rt::mapa(rt::smem_addr(slots + (rank - 1) * ACC * 32 +
                                          4 * threadIdx.x + 4 * NT * p),
                            0),
                   v[p], bar);
    return;
  }
  if (split > 1) {
    rt::cluster_wait();
    rt::mbar_wait(&pushed, 0);
#pragma unroll
    for (int p = 0; p < PER; ++p)
      for (int r = 1; r < split; ++r) {
        const float4 o = *reinterpret_cast<const float4*>(
            slots + (r - 1) * ACC * 32 + 4 * threadIdx.x + 4 * NT * p);
        v[p].x += o.x, v[p].y += o.y, v[p].z += o.z, v[p].w += o.w;
      }
  }
  if (n_out >= N) return;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const float vv[4] = {v[p].x, v[p].y, v[p].z, v[p].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = 8 * p + 2 * c + qe % 2;
      if (m < M)
        out[(long long)m * N + n_out] = __float2bfloat16(vv[c] * s_out);
    }
  }
}

// (N, K) (the tied unembed): a warp owns 16 weight rows (output columns) at
// a time and walks K in units of 256 bytes of each row (256 k in int8, 512
// in int4), staged row by row: each cp.async of the warp reads 256 bytes of
// each of two rows (a lane-fragment pattern of 64 bytes from each of eight
// rows streams the unembed at two thirds of the rate). After the wait the
// warp meets (__syncwarp) and lane (g, t) reads, for each 64-byte quarter q
// of the unit, 16 bytes of rows g and g + 8 at byte 64q + 16t (chunks of odd
// rows sit XOR 4, so that a quarter's reads hit every bank). The scale lies
// on K: x * s is taken in f32 and split into bf16 hi + lo, two products of
// each A fragment (|x s - hi - lo| <= 2^-16 |x s|). The block stages those B
// fragments, in the order the lanes read them (one 16-byte word a lane and
// k-step: hi b0, hi b1, lo b0, lo b1), for a chunk of KC k in shared memory
// once, or once a chunk and group of row tiles where K > KC. int8 k-step j
// of a quarter reads bytes 4j..4j+3 of the lane's 16 (k pairs (0, 1),
// (2, 3)); int4 k-steps 2c and 2c + 1 read word c (k pairs (0, 4), (1, 5)
// and (2, 6), (3, 7) of its 8 nibbles).
template <bool INT4, int MT>
__global__ void __launch_bounds__(NT)
dec_nk_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ w,
              const float* __restrict__ scale, bf16* __restrict__ out, int M,
              int N, int K, long long sxm, long long sxk, long long ldw,
              int S, int vec, int KC) {
  constexpr int VPB = INT4 ? 2 : 1;
  constexpr int QK = 64 * VPB;           // k per quarter (64 bytes)
  constexpr int UK = 4 * QK;             // k per unit (256 bytes)
  constexpr int JU = 4 * VPB;            // k-steps per quarter
  constexpr int UNIT_B = 16 * 256;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xsf = reinterpret_cast<uint4*>(smem);  // [quarter][mt][j][lane]
  const int QC = KC / QK;                       // quarters a chunk
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* ring =
      smem + (long long)QC * MT * JU * 32 * 16 + warp * RU * UNIT_B;

  const long long row_bytes = INT4 ? (K + 1) / 2 : K;
  const int U = (K + UK - 1) / UK;  // units a row tile
  const int UCH = KC / UK;          // units a chunk
  const int tiles = (N + 15) / 16;
  const int groups = (tiles + WARPS - 1) / WARPS;  // a tile for each warp
  const int mine_groups =
      (int)blockIdx.x < groups
          ? (groups - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int total = mine_groups * U;
  auto tile_of = [&](int s) {
    return ((int)blockIdx.x + (s / U) * (int)gridDim.x) * WARPS + warp;
  };

  // unit s: 8 copies a lane, rows 2i + lane / 16, bytes 16 (lane % 16) on
  auto issue = [&](int s) {
    const int n0 = tile_of(s) * 16;
    const long long b = (long long)(s % U) * 256 + 16 * (lane % 16);
    unsigned char* dst = ring + (s % RU) * UNIT_B;
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const int r = 2 * i + lane / 16, n = n0 + r;
      stage<16>(dst + r * 256 + (((lane % 16) ^ ((r & 1) << 2)) << 4),
                n < N ? w + n * ldw : nullptr, b, row_bytes, vec);
    }
  };

  // x * s at (m, k), zero outside (M, K)
  auto xs = [&](int m, int k) {
    return m < M && k < K
               ? __bfloat162float(x[m * sxm + k * sxk]) * scale[k % S]
               : 0.f;
  };
  auto stage_xs = [&](int c) {
    for (int e = threadIdx.x; e < QC * MT * JU * 32; e += NT) {
      const int l = e % 32, j = (e / 32) % JU, mt = (e / (32 * JU)) % MT;
      const int qq = e / (32 * JU * MT);
      const int m = mt * 8 + l / 4, lt = l % 4;
      const int kb = c * KC + qq * QK;
      int k0, k1, k2, k3;  // b0 = (k0, k1), b1 = (k2, k3)
      if (INT4) {
        k0 = kb + 32 * lt + 8 * (j / 2) + 2 * (j % 2);
        k1 = k0 + 4, k2 = k0 + 1, k3 = k0 + 5;
      } else {
        k0 = kb + 16 * lt + 4 * j;
        k1 = k0 + 1, k2 = k0 + 2, k3 = k0 + 3;
      }
      const float v[4] = {xs(m, k0), xs(m, k1), xs(m, k2), xs(m, k3)};
      float hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = __bfloat162float(__float2bfloat16(v[i]));
        lo[i] = v[i] - hi[i];
      }
      xsf[e] = make_uint4(rt::pack_bf16(hi[0], hi[1]),
                          rt::pack_bf16(hi[2], hi[3]),
                          rt::pack_bf16(lo[0], lo[1]),
                          rt::pack_bf16(lo[2], lo[3]));
    }
  };

  float acc[2][MT][4];  // hi and lo terms
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[h][mt][q] = 0.f;

#pragma unroll 1
  for (int i = 0; i < RU; ++i) {
    if (i < total) issue(i);
    rt::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    const int u = s % U;
    if (u % UCH == 0 && (s == 0 || U > UCH)) {  // (re)stage x * s
      __syncthreads();
      stage_xs(u / UCH);
      __syncthreads();
    }
    rt::cp_async_wait<RU - 1>();
    __syncwarp();  // the unit's rows came by the whole warp's copies
    const unsigned char* src = ring + (s % RU) * UNIT_B;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = ((4 * q + t) ^ ((g & 1) << 2)) << 4;
      const uint4 rg = *reinterpret_cast<const uint4*>(src + g * 256 + c);
      const uint4 r8 =
          *reinterpret_cast<const uint4*>(src + (g + 8) * 256 + c);
      const uint4* fr = xsf + ((u % UCH) * 4 + q) * MT * JU * 32 + lane;
#pragma unroll
      for (int cw = 0; cw < 4; ++cw) {
        const uint32_t vg = cw == 0 ? rg.x : cw == 1 ? rg.y : cw == 2 ? rg.z
                                                                     : rg.w;
        const uint32_t v8 = cw == 0 ? r8.x : cw == 1 ? r8.y : cw == 2 ? r8.z
                                                                     : r8.w;
#pragma unroll
        for (int h = 0; h < VPB; ++h) {
          uint32_t a[4];
          if constexpr (INT4) {
            a[0] = i4pair(vg >> (8 * h));
            a[1] = i4pair(v8 >> (8 * h));
            a[2] = i4pair(vg >> (8 * h + 4));
            a[3] = i4pair(v8 >> (8 * h + 4));
          } else {
            float f[4], f8[4];
            i8x4(vg, f);
            i8x4(v8, f8);
            a[0] = pair(f[0], f[1]);
            a[1] = pair(f8[0], f8[1]);
            a[2] = pair(f[2], f[3]);
            a[3] = pair(f8[2], f8[3]);
          }
          const int j = VPB * cw + h;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint4 b = fr[(mt * JU + j) * 32];
            const uint32_t bh[2] = {b.x, b.y}, bl[2] = {b.z, b.w};
            rt::mma_bf16(acc[0][mt], a, bh);
            rt::mma_bf16(acc[1][mt], a, bl);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the slot
    if (s + RU < total) issue(s + RU);
    rt::cp_async_commit();
    if (u == U - 1) {  // the row tile is done: rows g, g + 8, columns 2t, 2t+1
      const int n = tile_of(s) * 16 + g;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = mt * 8 + 2 * t + q % 2, nn = n + 8 * (q / 2);
          if (m < M && nn < N)
            out[(long long)m * N + nn] =
                __float2bfloat16(acc[0][mt][q] + acc[1][mt][q]);
          acc[0][mt][q] = acc[1][mt][q] = 0.f;
        }
    }
  }
}

template <bool INT4, int MT>
int launch_kn(const void* x, const void* w, const void* scale, void* out,
              int M, int N, int K, long long sxm, long long sxk, long long ldw,
              int S, int vec, int vec_x, cudaStream_t stream) {
  constexpr int CB = INT4 ? 8 : 16, ACC = MT * 8 * 4;
  constexpr int RING_B = WARPS * R * 32 * (4 * CB + 16);
  constexpr int RED_B = WARPS * ACC * 32 * 4;
  constexpr int BASE = RING_B > RED_B ? RING_B : RED_B;
  constexpr int SLOT_B = ACC * 32 * 4;
  static unsigned long long done = 0;
  auto kern = dec_kn_kernel<INT4, MT>;
  cudaError_t err = rt::allow_smem(kern, BASE + MAX_SPLIT * SLOT_B, done);
  if (err != cudaSuccess) return err;
  // split K over a cluster as far as one wave of blocks allows, at most
  // MAX_SPLIT ways and never below a k-step a warp
  const int tiles = (N + 127) / 128, KT = (K + 15) / 16;
  int split = 1;
  while (split < MAX_SPLIT && tiles * (split + 1) <= rt::sm_count() &&
         (split + 1) * WARPS <= KT)
    ++split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, 1, split);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = BASE + (split > 1 ? split * SLOT_B : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(x),
      static_cast<const unsigned char*>(w), static_cast<const float*>(scale),
      static_cast<bf16*>(out), M, N, K, sxm, sxk, ldw, S, vec, vec_x);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool INT4, int MT>
int launch_nk(const void* x, const void* w, const void* scale, void* out,
              int M, int N, int K, long long sxm, long long sxk, long long ldw,
              int S, int vec, cudaStream_t stream) {
  constexpr int UK = INT4 ? 512 : 256;
  constexpr int KC_MAX = 2048 / MT;  // 64 KB of x * s fragments
  constexpr int RING_B = WARPS * RU * 16 * 256;
  static unsigned long long done = 0;
  auto kern = dec_nk_kernel<INT4, MT>;
  cudaError_t err = rt::allow_smem(kern, KC_MAX * MT * 32 + RING_B, done);
  if (err != cudaSuccess) return err;
  const int KC = min(KC_MAX, (K + UK - 1) / UK * UK);
  const int groups = ((N + 15) / 16 + WARPS - 1) / WARPS;
  const int grid = min(groups, 2 * rt::sm_count());
  kern<<<grid, NT, KC * MT * 32 + RING_B, stream>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(out), M, N, K, sxm,
      sxk, ldw, S, vec, KC);
  return cudaGetLastError();
}

template <bool INT4, bool NK>
int launch_dec(const void* x, const void* w, const void* scale, void* out,
               int M, int N, int K, long long sxm, long long sxk,
               long long ldw, int S, int vec, int vec_x, cudaStream_t st) {
  if constexpr (NK) {
    if (M <= 8)
      return launch_nk<INT4, 1>(x, w, scale, out, M, N, K, sxm, sxk, ldw, S,
                                vec, st);
    return launch_nk<INT4, 2>(x, w, scale, out, M, N, K, sxm, sxk, ldw, S,
                              vec, st);
  } else {
    if (M <= 8)
      return launch_kn<INT4, 1>(x, w, scale, out, M, N, K, sxm, sxk, ldw, S,
                                vec, vec_x, st);
    return launch_kn<INT4, 2>(x, w, scale, out, M, N, K, sxm, sxk, ldw, S,
                              vec, vec_x, st);
  }
}

}  // namespace dec

// -- the warp-specialised prefill kernel (bf16 x, (K, N) weight, M > 16) ---
//
// Bound by operations at the serve shapes (M 4096). A block owns a 128 x
// 256 output tile: a producer warpgroup, one lane of which keeps TMA copies
// of x (128 x 64 bf16, 128-byte swizzle) and of the raw weight (64 x 256
// values as stored, int8 or packed int4) coming through a ring of STAGES
// (mbarriers "full" and "empty" per stage); and two consumer warpgroups,
// each 64 rows of x. The consumers dequantise each raw tile into a bf16
// tile in shared memory, split between them, in the layout a wgmma B
// descriptor reads MN-major (64-column panels, rows 128 B apart, 16-byte
// chunks XOR-permuted by row, as TMA's 128-byte swizzle writes V in
// flash_attention), then issue one wgmma m64n256k16 per 16-deep k-step
// (x as A and the weight as B, both from shared memory), f32 accumulators
// in registers. Three bf16 tiles rotate: tile k + 1's products are queued
// before tile k's are waited for, and the dequantisation of tile k + 2
// runs on the CUDA cores meanwhile; a named barrier of the 256 consumer
// threads hands each tile over. int8 bytes become bf16 as in the decode
// kernels; int4 nibbles pair
// as (n, n + 4) (one lop3 and one bf16x2 fma a pair) and the tile's column
// order records it: column p of each group of 8 holds n = p / 2 + 4 (p % 2).
// The epilogue scales the f32 sums (scale[n % S]), rounds them to bf16,
// stages them in the consumer's bf16 tile and writes 16-byte rows. The
// dequantised tile goes through shared memory (rather than the weight as a
// register A operand of out^T = W^T x^T, which would save that round trip)
// because it keeps both operands in the descriptor layouts flash_attention
// proved on this card and the output in x's row order.
namespace pf {

using bf16 = __nv_bfloat16;
constexpr int BM = 128, BN = 256, BK = 64;
constexpr int CONSUMERS = 2;  // warpgroups, 64 rows of x each
constexpr int NT = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <= 65536,
              "the register file holds the block");
constexpr int STAGES = 3;   // x and raw weight tiles in flight
constexpr int WBUFS = 3;    // bf16 weight tiles: one read by the products
                            // in flight, one queued, one being written
constexpr int XTILE = BM * BK * 2;       // bytes of an x tile
constexpr int PANEL = BK * 128;          // 64 bf16 columns of a weight tile
constexpr int WTILE = BN / 64 * PANEL;   // a dequantised weight tile
template <bool INT4>
constexpr int RAW = BK * BN / (INT4 ? 2 : 1);  // a raw weight tile

struct Barriers {
  uint64_t full[STAGES], empty[STAGES];
};

template <bool INT4>
constexpr int smem_bytes() {
  return STAGES * (XTILE + RAW<INT4>) + WBUFS * WTILE + (int)sizeof(Barriers) +
         1024;  // + alignment slack
}

// D (64 x 256, f32) += A B: A (64 x 16) K-major and B (16 x 256) MN-major,
// both in shared memory (descriptors; imm-trans-b 1).
__device__ __forceinline__ void wgmma_ss_m64n256_tb(float (&d)[128],
                                                    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <bool INT4>
__global__ void __launch_bounds__(NT, 1)
qmm_wg_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              const float* __restrict__ scale, bf16* __restrict__ out, int M,
              int N, int K, int S) {
  constexpr int VPB = INT4 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sx = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sr = sx + STAGES * XTILE;       // raw weight tiles
  unsigned char* sw = sr + STAGES * RAW<INT4>;   // bf16 weight tiles
  Barriers& bar = *reinterpret_cast<Barriers*>(sw + WBUFS * WTILE);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;
  const int w = threadIdx.x / 128 - 1;  // consumer warpgroup; -1 producer

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      rt::mbar_init(&bar.full[i], 1);
      rt::mbar_init(&bar.empty[i], 4 * CONSUMERS);  // one per consumer warp
    }
    rt::mbar_init_fence();
  }
  __syncthreads();

  if (w < 0) {  // the producer: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % STAGES, free = ((kt / STAGES) & 1) ^ 1;
      rt::mbar_wait(&bar.empty[st], free);
      rt::mbar_expect_tx(&bar.full[st], XTILE + RAW<INT4>);
      rt::tma_load_2d(sx + st * XTILE, &tx, &bar.full[st], kt * BK, m0);
      rt::tma_load_2d(sr + st * RAW<INT4>, &tw, &bar.full[st], n0 / VPB,
                      kt * BK);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x - 128;  // 0..255 over both consumers
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[128];  // the warpgroup's 64 x 256 sums
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // raw tile kt (waited for) -> bf16 tile kt % WBUFS: 2048 items of (row
  // k, 8 columns), 8 a thread
  auto dequant = [&](int kt) {
    const int st = kt % STAGES;
    rt::mbar_wait(&bar.full[st], (kt / STAGES) & 1);
    const unsigned char* r = sr + st * RAW<INT4>;
    unsigned char* d = sw + (kt % WBUFS) * WTILE;
#pragma unroll
    for (int it = 0; it < BK * BN / 8 / 256; ++it) {
      const int item = tid + it * 256;
      const int k = item / (BN / 8), c = item % (BN / 8);
      uint4 v;
      if constexpr (INT4) {
        const uint32_t b = *reinterpret_cast<const uint32_t*>(
            r + k * (BN / 2) + c * 4);
        v = make_uint4(dec::i4pair(b), dec::i4pair(b >> 4),
                       dec::i4pair(b >> 8), dec::i4pair(b >> 12));
      } else {
        const uint2 b =
            *reinterpret_cast<const uint2*>(r + k * BN + c * 8);
        float f0[4], f1[4];
        dec::i8x4(b.x, f0);
        dec::i8x4(b.y, f1);
        v = make_uint4(dec::pair(f0[0], f0[1]), dec::pair(f0[2], f0[3]),
                       dec::pair(f1[0], f1[1]), dec::pair(f1[2], f1[3]));
      }
      *reinterpret_cast<uint4*>(d + rt::swizzle128<PANEL>(k, c)) = v;
    }
    rt::fence_proxy_async();  // the wgmma reads it through the async proxy
  };
  // the products of tile kt: x rows of this warpgroup (A, K-major) times
  // the bf16 tile (B, MN-major; the 64-column panels LBO apart)
  const unsigned char* xw = sx + w * 64 * 128;
  auto issue = [&](int kt) {
    const unsigned char* xs = xw + (kt % STAGES) * XTILE;
    const unsigned char* wb = sw + (kt % WBUFS) * WTILE;
    rt::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      wgmma_ss_m64n256_tb(acc, rt::wgmma_desc(xs + s * 32, 16, 1024),
                          rt::wgmma_desc(wb + s * 2048, PANEL, 1024));
    rt::wgmma_commit();
  };

  // tile kt + 1's products are queued before tile kt's are waited for; the
  // dequantisation of tile kt + 2 runs on the CUDA cores meanwhile, into
  // the bf16 tile that tile kt - 1's products (done in every warpgroup by
  // the previous barrier) read
  for (int kt = 0; kt < 2 && kt < nk; ++kt) dequant(kt);
  consumers_sync();
  if (nk > 0) issue(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      issue(kt + 1);
      rt::wgmma_wait<1>();
    } else {
      rt::wgmma_wait<0>();
    }
    // no fence of acc here: tile kt + 1's products still own it
    __syncwarp();
    if (lane == 0) rt::mbar_arrive(&bar.empty[kt % STAGES]);  // tile kt done
    if (kt + 2 < nk) dequant(kt + 2);
    consumers_sync();
  }
  rt::fence_regs(acc);

  // scale, round and stage the warpgroup's 64 x 256 outputs in its own bf16
  // tile (rows 512 B apart, 16-byte chunks XOR-permuted by row; every
  // product is done: the last barrier), then write them out in 16-byte
  // stores. Accumulator 4j + 2r + e is row 16 warp + g + 8r and the tile's
  // column 8j + 2t + e, which holds n = 8j + 2t + e (int8) or
  // 8j + t + 4e (int4).
  unsigned char* so = sw + w * WTILE;
  const int g = lane / 4, t = lane % 4;
  auto at = [&](int row, int n) {
    return so + row * (2 * BN) + (((n / 8) ^ (row % 8)) << 4) + (n % 8) * 2;
  };
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + (INT4 ? t + 4 * e : 2 * t + e);
      int sn = n0 + n;
      if (sn >= S) sn %= S;  // a tiled scale
      const float sc = n0 + n < N ? scale[sn] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<bf16*>(at(warp * 16 + g + 8 * r, n)) =
            __float2bfloat16(acc[4 * j + 2 * r + e] * sc);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
  const int wt = threadIdx.x % 128;
#pragma unroll 4
  for (int it = 0; it < 64 * (BN / 8) / 128; ++it) {
    const int i = wt + it * 128, row = i / (BN / 8), c = i % (BN / 8);
    const int m = m0 + w * 64 + row, n = n0 + 8 * c;
    if (m >= M || n >= N) continue;
    const bf16* v = reinterpret_cast<const bf16*>(at(row, 8 * c));
    bf16* o = out + (long long)m * N + n;
    if (N % 8 == 0) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int q = 0; q < 8 && n + q < N; ++q) o[q] = v[q];
    }
  }
}

// 2-D tensor maps: x (M, K) bf16 in 64 x 128 boxes with the 128-byte
// swizzle; the weight's stored bytes (K rows of row_bytes) in BN / VPB x 64
// boxes, unswizzled. Parts of a box outside the tensor arrive as zeros.
template <bool INT4>
cudaError_t make_maps(CUtensorMap* tx, CUtensorMap* tw, const void* x,
                      const void* w, int M, int N, int K, long long sxm,
                      long long ldw) {
  auto encode = rt::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (cudaError_t err = rt::bind_context()) return err;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)sxm * sizeof(bf16)};
  const cuuint32_t xb[2] = {64, BM};
  CUresult r = encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(x), xd, xs, xb, one,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t wd[2] = {(cuuint64_t)(INT4 ? (N + 1) / 2 : N),
                            (cuuint64_t)K};
  const cuuint64_t ws[1] = {(cuuint64_t)ldw};
  const cuuint32_t wbox[2] = {BN / (INT4 ? 2 : 1), BK};
  r = encode(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wd,
             ws, wbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool INT4>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int N, int K, long long sxm, long long ldw, int S,
           cudaStream_t stream) {
  CUtensorMap tx, tw;
  cudaError_t err = make_maps<INT4>(&tx, &tw, x, w, M, N, K, sxm, ldw);
  if (err != cudaSuccess) return err;
  static unsigned long long done = 0;
  auto kern = qmm_wg_kernel<INT4>;
  err = rt::allow_smem(kern, smem_bytes<INT4>(), done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NT, smem_bytes<INT4>(), stream>>>(
      tx, tw, static_cast<const float*>(scale), static_cast<bf16*>(out), M,
      N, K, S);
  return cudaGetLastError();
}

}  // namespace pf

template <typename T, bool INT4, bool NK, class C>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int N, int K, long long sxm, long long sxk, long long ldw, int S,
           int vec, cudaStream_t stream) {
  const int tiles_n = (N + C::BN - 1) / C::BN;
  const int tiles_m = (M + C::BM - 1) / C::BM;
  int split = 1;
  if (C::WK) {
    // split K until there are 4 blocks per SM, at most MAX_SPLIT ways and
    // never past one K step per rank
    const int sms = rt::sm_count();
    const long long tiles = (long long)tiles_n * tiles_m;
    while (split < MAX_SPLIT && (split + 1) * C::BK <= K &&
           tiles * split < 4LL * sms)
      ++split;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n, tiles_m, split);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, qmm_kernel<T, INT4, NK, C>, static_cast<const T*>(x),
      static_cast<const unsigned char*>(w), static_cast<const float*>(scale),
      static_cast<T*>(out), M, N, K, sxm, sxk, ldw, S, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernels a call can take (the wrapper's ``route`` names them), and the
// launches each has had: the launcher counts the route it took.
enum Route { DECODE, WGMMA, FMA, ROUTES };
std::atomic<unsigned long long> taken[ROUTES];

template <typename T, bool INT4, bool NK>
int launch_m(const void* x, const void* w, const void* scale, void* out,
             int M, int N, int K, long long sxm, long long sxk, long long ldw,
             int S, int vec, int vec_x, cudaStream_t st, Route& route) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (BF16) {
    if (M <= 16) {
      route = DECODE;
      return dec::launch_dec<INT4, NK>(x, w, scale, out, M, N, K, sxm, sxk,
                                       ldw, S, vec, vec_x, st);
    }
  }
  if constexpr (BF16 && !NK) {
    if (vec && vec_x) {  // TMA describes both
      route = WGMMA;
      return pf::launch<INT4>(x, w, scale, out, M, N, K, sxm, ldw, S, st);
    }
  }
  route = FMA;
  if constexpr (!BF16) {
    if (M <= 16)
      return launch<T, INT4, NK, Decode>(x, w, scale, out, M, N, K, sxm, sxk,
                                         ldw, S, vec, st);
  }
  return launch<T, INT4, NK, Prefill>(x, w, scale, out, M, N, K, sxm, sxk,
                                      ldw, S, vec, st);
}

template <typename T>
int launch_w(int is_int4, int transposed, const void* x, const void* w,
             const void* scale, void* out, int M, int N, int K, long long sxm,
             long long sxk, long long ldw, int S, int vec, int vec_x,
             cudaStream_t st, Route& r) {
  if (is_int4)
    return transposed ? launch_m<T, true, true>(x, w, scale, out, M, N, K, sxm,
                                                sxk, ldw, S, vec, vec_x, st, r)
                      : launch_m<T, true, false>(x, w, scale, out, M, N, K,
                                                 sxm, sxk, ldw, S, vec, vec_x,
                                                 st, r);
  return transposed ? launch_m<T, false, true>(x, w, scale, out, M, N, K, sxm,
                                               sxk, ldw, S, vec, vec_x, st, r)
                    : launch_m<T, false, false>(x, w, scale, out, M, N, K, sxm,
                                                sxk, ldw, S, vec, vec_x, st,
                                                r);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x strides (sxm, sxk)
// are in elements; ldw is the weight's row stride in bytes; out is a
// contiguous (M, N) tensor; vec says that the weight's base and row stride
// are 16-byte aligned and its rows do not overlap, vec_x that x's rows are
// contiguous, do not overlap and are 16-byte aligned; S is the scale's
// length.
extern "C" int quant_matmul_fwd(const void* x, const void* w,
                                const void* scale, void* out, int M, int N,
                                int K, long long sxm, long long sxk,
                                long long ldw, int S, int is_bf16,
                                int is_int4, int transposed, int vec,
                                int vec_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Route r = FMA;
  const int err =
      is_bf16 ? launch_w<__nv_bfloat16>(is_int4, transposed, x, w, scale, out,
                                        M, N, K, sxm, sxk, ldw, S, vec, vec_x,
                                        st, r)
              : launch_w<float>(is_int4, transposed, x, w, scale, out, M, N, K,
                                sxm, sxk, ldw, S, vec, vec_x, st, r);
  if (err == 0) taken[r].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// Copies the launches by route (decode, wgmma, fma) since the last reset
// into counts[3]; with reset, zeroes them.
extern "C" void quant_matmul_routes(unsigned long long* counts, int reset) {
  for (int r = 0; r < ROUTES; ++r)
    counts[r] = reset ? taken[r].exchange(0) : taken[r].load();
}
