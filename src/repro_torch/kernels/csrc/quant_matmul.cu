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
// Design (simple first): a block of 256 threads computes a BM x BN output
// tile, walking K in BK steps. Each step's weight tile is read from device
// memory in 16-byte chunks in its stored order (coalesced in both layouts),
// turned to f32 in registers and stored to shared memory as [k][n]; x is
// staged as f32 [k][m]. The next step's chunks are loaded into registers
// before the current step's f32 FMAs on the CUDA cores. Two tiles, picked by
// M: decode (M <= 16) takes 8 x 64 tiles with BK 128, each thread all 8 rows
// of 2 columns and each warp 16 of a step's 128 rows; the warps' sums meet
// in shared memory, and K is split over a thread block cluster of up to 8
// blocks when the output tiles alone would not fill the SMs, the ranks'
// sums meeting in distributed shared memory. Prefill takes 128 x 128 tiles,
// 8 x 8 outputs per thread. At decode the kernel is bound by the weight bytes
// (1 byte per weight in int8, half in int4), but at qwen3's shapes each call
// costs a few microseconds of launch, cluster and reduction whatever its
// bytes (a matrix-vector kernel without the shared-memory staging was no
// faster; PERF.md); at prefill it is bound by operations.
//
// Prefill with bf16 x and a (K, N) weight (every projection of the serve
// path) runs on the tensor cores instead: the same 128 x 128 tile and
// register prefetch, x staged as bf16 [m][k], the weight dequantised to
// bf16 (exact for int8 and int4) and stored [k][n], mma.sync m16n8k16 with
// f32 accumulators (each warp 64 x 32 of the tile), B fragments read with
// ldmatrix.trans. Products of bf16 values are exact in f32, so this sums
// the same terms as the FMA path in another order. f32 x (held at 1e-4)
// and the (N, K) layout at prefill keep the f32 FMA path.
#include <cooperative_groups.h>

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

// -- the tensor-core prefill tile (bf16 x, (K, N) weight) --------------------

constexpr int TBM = Prefill::BM, TBN = Prefill::BN, TBK = Prefill::BK;
constexpr int LDA = TBK + 8;  // halves: conflict-free 32-bit fragment loads
constexpr int LDB = TBN + 8;  // halves: conflict-free ldmatrix rows

using rt::ldsm_x2_trans;  // the fragment helpers of common.cuh
using rt::mma_bf16;
using rt::pack_bf16;

template <bool INT4>
__global__ void __launch_bounds__(NT)
qmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const unsigned char* __restrict__ w,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
              int M, int N, int K, long long sxm, long long sxk, long long ldw,
              int S, int vec, int vec_x) {
  using W = WTile<Prefill, INT4, false>;
  constexpr int XCH = TBM * TBK / 8 / NT;  // 8-value x chunks per thread
  __shared__ __align__(16) __nv_bfloat16 sA[TBM * LDA];
  __shared__ __align__(16) __nv_bfloat16 sB[TBK * LDB];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // warp's 64 x 32
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const long long row_bytes = INT4 ? (N + 1) / 2 : N;
  const int nkt = (K + TBK - 1) / TBK;

  Chunk wr[W::PER_THREAD];
  uint4 xr[XCH];

  auto load = [&](int kt) {
    const int k0 = kt * TBK;
    const long long byte0 = n0 / W::VPB;
#pragma unroll
    for (int i = 0; i < W::PER_THREAD; ++i) {
      const int c = tid + i * NT;
      wr[i].v = make_uint4(0u, 0u, 0u, 0u);
      if (c >= W::CHUNKS) continue;
      int r, b;
      W::at(c, r, b);
      const long long gr = k0 + r, gb = byte0 + b;
      if (gr >= K || gb >= row_bytes) continue;
      const unsigned char* p = w + gr * ldw + gb;
      if (vec && gb + 16 <= row_bytes) {
        wr[i].v = *reinterpret_cast<const uint4*>(p);
      } else {
        for (int j = 0; j < 16 && gb + j < row_bytes; ++j) wr[i].b[j] = p[j];
      }
    }
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int e = tid + i * NT, m = e / (TBK / 8), kc = (e % (TBK / 8)) * 8;
      const int gm = m0 + m, gk = k0 + kc;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (gm >= M) continue;
      const __nv_bfloat16* p = x + gm * sxm + gk * sxk;
      if (vec_x && gk + 8 <= K) {
        xr[i] = *reinterpret_cast<const uint4*>(p);
      } else {
        union {
          uint4 v;
          __nv_bfloat16 h[8];
        } u;
        for (int j = 0; j < 8; ++j)
          u.h[j] = gk + j < K ? p[j * sxk] : __float2bfloat16(0.f);
        xr[i] = u.v;
      }
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int e = tid + i * NT, m = e / (TBK / 8), kc = (e % (TBK / 8)) * 8;
      *reinterpret_cast<uint4*>(sA + m * LDA + kc) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < W::PER_THREAD; ++i) {
      const int c = tid + i * NT;
      if (c >= W::CHUNKS) continue;
      int r, b;
      W::at(c, r, b);
      uint32_t h[8 * W::VPB];  // 16 (int8) or 32 (int4) bf16, two a word
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned char byte = wr[i].b[j];
        if (INT4) {
          h[j] = pack_bf16((float)((int)(signed char)(byte << 4) >> 4),
                           (float)((int)(signed char)byte >> 4));
        } else if (j % 2 == 0) {
          h[j / 2] = pack_bf16((float)(signed char)byte,
                               (float)(signed char)wr[i].b[j + 1]);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(sB + r * LDB + b * W::VPB);
#pragma unroll
      for (int q = 0; q < 2 * W::VPB; ++q)
        dst[q] = make_uint4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  if (nkt > 0) load(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous step's reads are done
    stage();
    __syncthreads();
    if (kt + 1 < nkt) load(kt + 1);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* pa = sA + (wm + mi * 16 + g) * LDA + kk + 2 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(pa);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(pa + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        ldsm_x2_trans(b[ni][0], b[ni][1],
                      sB + (kk + (lane & 15)) * LDB + wn + ni * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm + mi * 16 + g + (q / 2) * 8;
        const int n = n0 + wn + ni * 8 + 2 * t + q % 2;
        if (m < M && n < N)
          out[(long long)m * N + n] =
              __float2bfloat16(acc[mi][ni][q] * scale[n % S]);
      }
}

template <bool INT4>
int launch_tc(const void* x, const void* w, const void* scale, void* out,
              int M, int N, int K, long long sxm, long long sxk, long long ldw,
              int S, int vec, int vec_x, cudaStream_t stream) {
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  qmm_tc_kernel<INT4><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const unsigned char*>(w), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, N, K, sxm, sxk, ldw, S, vec, vec_x);
  return cudaGetLastError();
}

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
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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

template <typename T, bool INT4, bool NK>
int launch_m(const void* x, const void* w, const void* scale, void* out,
             int M, int N, int K, long long sxm, long long sxk, long long ldw,
             int S, int vec, int vec_x, cudaStream_t st) {
  if (M <= 16)
    return launch<T, INT4, NK, Decode>(x, w, scale, out, M, N, K, sxm, sxk,
                                       ldw, S, vec, st);
  if constexpr (std::is_same<T, __nv_bfloat16>::value && !NK)
    return launch_tc<INT4>(x, w, scale, out, M, N, K, sxm, sxk, ldw, S, vec,
                           vec_x, st);
  return launch<T, INT4, NK, Prefill>(x, w, scale, out, M, N, K, sxm, sxk,
                                      ldw, S, vec, st);
}

template <typename T>
int launch_w(int is_int4, int transposed, const void* x, const void* w,
             const void* scale, void* out, int M, int N, int K, long long sxm,
             long long sxk, long long ldw, int S, int vec, int vec_x,
             cudaStream_t st) {
  if (is_int4)
    return transposed ? launch_m<T, true, true>(x, w, scale, out, M, N, K, sxm,
                                                sxk, ldw, S, vec, vec_x, st)
                      : launch_m<T, true, false>(x, w, scale, out, M, N, K,
                                                 sxm, sxk, ldw, S, vec, vec_x,
                                                 st);
  return transposed ? launch_m<T, false, true>(x, w, scale, out, M, N, K, sxm,
                                               sxk, ldw, S, vec, vec_x, st)
                    : launch_m<T, false, false>(x, w, scale, out, M, N, K, sxm,
                                                sxk, ldw, S, vec, vec_x, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x strides (sxm, sxk)
// are in elements; ldw is the weight's row stride in bytes; out is a
// contiguous (M, N) tensor; vec says that the weight's base and row stride
// are 16-byte aligned, vec_x that x's rows are contiguous and 16-byte
// aligned; S is the scale's length.
extern "C" int quant_matmul_fwd(const void* x, const void* w,
                                const void* scale, void* out, int M, int N,
                                int K, long long sxm, long long sxk,
                                long long ldw, int S, int is_bf16,
                                int is_int4, int transposed, int vec,
                                int vec_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_w<__nv_bfloat16>(is_int4, transposed, x, w, scale, out, M, N,
                                   K, sxm, sxk, ldw, S, vec, vec_x, st);
  return launch_w<float>(is_int4, transposed, x, w, scale, out, M, N, K, sxm,
                         sxk, ldw, S, vec, vec_x, st);
}
