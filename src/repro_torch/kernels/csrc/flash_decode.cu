// One-query (decode) GQA attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, def at :65, pallas_call at :84). Same contract: q (B,H,hd),
// caches k/v (B,S,K,hd), `length` an int32 scalar in device memory (the
// Pallas kernel's SMEM scalar): positions <= length attend, the rest are
// masked with -1e30; query head h reads KV head h / G; f32 softmax
// statistics and accumulator; l floored at 1e-30; output (B,H,hd) in q's
// dtype. Reading `length` on the device keeps decode free of host syncs.
// `length` may also be -1 (no filled position: the output is 0), which a
// context-parallel rank passes when its slice of the sequence holds none of
// the filled prefix.
//
// What bounds it on the H100: bytes. A call reads the filled K/V prefix
// once, 2 * B * (length + 1) * K * hd elements (18.9 MB at qwen3-0.6b's last
// serve step, B 8, S 576, K 8, hd 128: 5.6 us at 3.35 TB/s), and does 4
// FLOPs per element read, far below the tensor cores' line. The Pallas
// kernel walks S in order on one core; here S is split over the blocks of a
// thread block cluster, so that the whole card streams:
// - Split-KV over clusters. The grid is (n_split, K * head groups, B): the
//   n_split blocks of each (batch, KV head, group of up to 8 query heads)
//   form n_split / cl thread block clusters of cl <= 8 blocks. Block j takes
//   positions [j * split, (j + 1) * split), split a multiple of 16 chosen on
//   the host from B, K and S (never from `length`: kernels/flash_decode.py's
//   ``plan``), about one block an SM; a block whose split starts past
//   `length` loads nothing and contributes m = -1e30, l = 0. At the serve
//   shape: 128 blocks of 288 positions (54 KB of shared memory each), one
//   cluster of 2 a pair. At B 1, K 8 (the context-parallel decode's rank, a
//   long cache on one card) one cluster a pair would fill 64 of the 132
//   SMs, so ``plan`` gives each pair two clusters of 8: 128 blocks.
// - An asynchronous ring. A block's two warps each own every other 16-
//   position tile and stream its K and V rows through their own 3-stage
//   cp.async ring (16 bytes a lane), issued before any math; tile i + 2's
//   loads are in flight while tile i is computed, and no block barrier
//   falls inside the loop.
// - Tensor cores in bf16: mma.sync m16n8k16 with q (the block's query
//   heads, rows 0-7 of A) in registers and K by ldmatrix as B, so S comes
//   out heads x positions; P stays in registers as the A operand of P V
//   (rounded to bf16, as flash_attention.cu does; l sums the f32 P), V by
//   ldmatrix.trans as B. scale * log2(e) is folded into one multiply and
//   exp2. f32 caches take CUDA cores (a lane per position and half of the
//   heads for the scores, a lane per head dim for P V).
// - The combine stays in the cluster. Every warp ends with its (m, l, acc);
//   the warps of ranks 1..cl-1 push theirs into rank 0's shared memory with
//   st.async, completing on rank 0's mbarrier, and leave; rank 0 merges
//   every part in (rank, warp) order into the output. One relaxed cluster
//   barrier, no float atomics, one launch a call, and the same output bits
//   on every call. With several clusters a pair, rank 0 writes its cluster's
//   merge as the LSE route writes it (out in f32 and its log-sum-exp) to a
//   workspace the wrapper allocates, and bumps the pair's arrival counter;
//   the last cluster to arrive merges the clusters' parts by their
//   log-sum-exps, as the context-parallel ranks' merge does, in cluster
//   order (the order, not the arrival, fixes the bits), into the output,
//   and sets the counter back to 0 for the next launch, so that no memset
//   runs and a CUDA graph replays the launch as it stands. The
//   counters are one array of the library on each device: two launches
//   that overlap on two streams of one device would share them, and the
//   port launches decode attention on one stream.
// - The LSE route (the context-parallel decode's, whose ranks merge their
//   softmax statistics: distributed/plan.py's merge_decode). With an `lse`
//   pointer, the block that writes the output (rank 0, or the last cluster's
//   rank 0) also writes each head's log-sum-exp of the scaled scores,
//   ln 2 (M + log2 L), from the (M, L) its merge already holds; -inf
//   where nothing is filled. It writes `o` in f32, unrounded, so that the
//   ranks' merge rounds to the cache's type once, as one device's decode
//   does; rounded to bf16 it is the other route's `o`, bit for bit. Same
//   launch; the launcher counts the route each call took
//   (flash_decode_routes).
// Head dims 16 to 256: at gemma-7b's (256) a bf16 block with 8 ranks takes
// 221,184 bytes (the ring 101,376, q 4,224, the slots 115,584) of the
// 232,448 a block may have; above hd 128 q is read from shared memory, so
// that the accumulator keeps its registers. The f32 ring at 256 keeps 2
// stages, not 3, and ``plan`` caps its split where the slots would not fit
// (smem_bytes, flash_decode_smem).
#include <atomic>

#include "common.cuh"

namespace {

constexpr int TP = 16;        // cache positions a tile
constexpr int WARPS = 2;      // warps a block, each with its own ring
constexpr int NT = 32 * WARPS;
// dynamic shared memory a launch may ask for: the 232,448 bytes of a block
// less 1 KiB for its static shared memory (the cluster's barrier)
constexpr int SMEM_MAX = 232448 - 1024;
constexpr int GB = 8;         // query heads a block: rows 0-7 of an m16 tile
constexpr int MAX_SPLIT = 8;  // blocks a cluster (the portable limit)
constexpr int NP = MAX_SPLIT * WARPS;  // parts of a cluster, at most
constexpr int MAX_CLUSTERS = NP;  // clusters a (batch, KV head, head group)
// (batch, KV head, head group) triples a launch of several clusters each may
// have: one arrival counter each
constexpr int MAX_PAIRS = 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A warp's part: (m, l) a head (log2 units), then acc[head][HD], all f32. A
// warp keeps its part in its block's shared memory; the warps of ranks 1..n
// push theirs to rank 0's slots, (2 GB + gb HD) floats each (gb the block's
// heads), in (rank, warp) order.
template <typename T, int HD>
struct Layout {
  static constexpr bool F32 = sizeof(T) == 4;
  // ring stages a warp: 3, and 2 for f32 above head dim 160, whose 3-stage
  // ring (195 KB) leaves no room for the parts (kernels/flash_decode.py's
  // ``plan`` caps the cluster there so that the slots fit: 5 at 8 heads a
  // block)
  static constexpr int R = F32 && HD > 160 ? 2 : 3;
  static constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte chunk
  static constexpr int LD = HD + VEC;         // shared row stride: rows 16
                                              // bytes apart in the banks
  static constexpr int CPR = HD / VEC;        // chunks a row
  static constexpr int STAGE = 2 * TP * LD;   // a K tile, then a V tile
  static constexpr int WARP_RING_B = R * STAGE * (int)sizeof(T);
  static constexpr int RING_B = WARPS * WARP_RING_B;
  static constexpr int PART_B = (2 * GB + GB * HD) * 4;
  static constexpr int WTS_B = GB * NP * 4;   // the merge weights
  // bf16 up to hd 128: a warp holds q as its A fragments in registers;
  // above, they would crowd out the accumulator (128 registers at 256), so
  // q waits after the ring (GB x HD, rows HD + 8 apart: no bank conflicts)
  // and is read a k-step at a time
  static constexpr bool QREG = F32 || HD <= 128;
  static constexpr int LDQ = HD + 8;
  static constexpr int QB_B = QREG ? 0 : GB * LDQ * 2;
  // bf16: a warp's part overwrites its own ring once it is done, the merge
  // weights follow warp 0's part. f32: the warps' parts hold their
  // accumulators through the loop, then each warp's P (GB x TP) and rescale
  // (GB), and q (GB x HD); the merge weights overwrite the P tiles. Then the
  // slots (rank 0 only: the others' dynamic shared memory ends before).
  static constexpr int PARTS_OFF = F32 ? RING_B : 0;
  static constexpr int PART_STEP = F32 ? PART_B : WARP_RING_B;
  static constexpr int P_OFF = RING_B + WARPS * PART_B;
  static constexpr int A_OFF = P_OFF + WARPS * GB * TP * 4;
  static constexpr int Q_OFF = A_OFF + WARPS * GB * 4;
  static constexpr int WTS_OFF = F32 ? P_OFF : PART_B;
  static constexpr int SLOTS_OFF = F32 ? Q_OFF + GB * HD * 4 : RING_B + QB_B;
  static constexpr int MAX_B = SLOTS_OFF + (MAX_SPLIT - 1) * WARPS * PART_B;
  static_assert(F32 || PART_B + WTS_B <= WARP_RING_B,
                "a part and the weights fit the ring they overwrite");
  static_assert(!F32 || WTS_B <= WARPS * GB * TP * 4,
                "the weights fit the P tiles");
};

// Dynamic shared memory of a launch: the slots for the parts of a cluster's
// cl ranks, of gb heads (kernels/flash_decode.py's ``smem_bytes`` mirrors
// it).
template <typename T, int HD>
constexpr int smem_bytes(int cl, int gb) {
  return Layout<T, HD>::SLOTS_OFF +
         (cl - 1) * WARPS * (2 * GB + gb * HD) * 4;
}

// The most a launch of the instance may ask for: its largest split, or the
// block's limit where that is larger (the launcher refuses such a split).
template <typename T, int HD>
constexpr int smem_cap() {
  return Layout<T, HD>::MAX_B < SMEM_MAX ? Layout<T, HD>::MAX_B : SMEM_MAX;
}

// Weights of the first n parts for each of the block's gb heads, in part
// order: wts[g][r] = 2^(m_r - M) / max(L, 1e-30), M the parts' max and
// L = sum_r 2^(m_r - M) l_r; with `lse` (the block's heads' row of the
// output) also ln 2 (M + log2 L), or -inf where L is 0 (no position).
__device__ __forceinline__ void merge_weights(const float* const (&p)[NP],
                                              int n, int gb, float* wts,
                                              float* __restrict__ lse) {
  for (int g = threadIdx.x; g < gb; g += NT) {
    float m[NP], M = rt::NEG_INF;
#pragma unroll
    for (int r = 0; r < NP; ++r)
      if (r < n) {
        m[r] = p[r][2 * g];
        M = fmaxf(M, m[r]);
      }
    float a[NP], L = 0.f;
#pragma unroll
    for (int r = 0; r < NP; ++r)
      if (r < n) {
        a[r] = rt::exp2_approx(m[r] - M);
        L = fmaf(a[r], p[r][2 * g + 1], L);
      }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    if (lse != nullptr) lse[g] = L > 0.f ? (M + log2f(L)) * LN2 : -INFINITY;
#pragma unroll
    for (int r = 0; r < NP; ++r)
      if (r < n) wts[g * NP + r] = a[r] * inv;
  }
}

// out[e] = sum_r wts[g][r] acc_r[e] for each element e = g * HD + d of the
// gb heads, the first n parts added in order.
template <typename T, int HD>
__device__ __forceinline__ void merge_values(const float* const (&p)[NP],
                                             int n, int gb, const float* wts,
                                             T* __restrict__ out) {
  for (int e = threadIdx.x; e < gb * HD; e += NT) {
    const int g = e / HD;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < NP; ++r)
      if (r < n) acc = fmaf(wts[g * NP + r], p[r][2 * GB + e], acc);
    out[e] = rt::Elem<T>::from_float(acc);
  }
}

// The last cluster's merge of a pair's n clusters' parts in cluster order,
// each (lse, then out) as the cluster's own merge wrote it, the LSE route's
// arithmetic (distributed/plan.py's merge_decode): M the largest lse, w_c =
// e^(lse_c - M), out = sum_c (w_c / sum w) out_c, lse = M + ln sum w; out 0
// and lse -inf where no cluster held a position. Other SMs wrote the parts
// in this launch: they are read through L2 (ld.global.cg).
template <typename T, int HD>
__device__ __forceinline__ void merge_lse(const float* parts, int n, int gb,
                                          float* wts, float* __restrict__ lse,
                                          T* __restrict__ out) {
  constexpr int PART_N = GB + GB * HD;
  for (int g = threadIdx.x; g < gb; g += NT) {
    float l[MAX_CLUSTERS], M = -INFINITY;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTERS; ++c)
      if (c < n) {
        l[c] = __ldcg(parts + c * PART_N + g);
        M = fmaxf(M, l[c]);
      }
    float w[MAX_CLUSTERS], L = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTERS; ++c)
      if (c < n) {
        w[c] = M == -INFINITY ? 0.f : rt::exp2_approx((l[c] - M) * LOG2E);
        L += w[c];
      }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    if (lse != nullptr) lse[g] = L > 0.f ? M + logf(L) : -INFINITY;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTERS; ++c)
      if (c < n) wts[g * MAX_CLUSTERS + c] = w[c] * inv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gb * HD; e += NT) {
    const int g = e / HD;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTERS; ++c)
      if (c < n)
        acc = fmaf(wts[g * MAX_CLUSTERS + c],
                   __ldcg(parts + c * PART_N + GB + e), acc);
    out[e] = rt::Elem<T>::from_float(acc);
  }
}

// Arrivals of a pair's clusters in the running launch (0 between launches):
// the last to arrive merges. Zero when the library loads on a device.
__device__ unsigned int arrivals[MAX_PAIRS];

// Rank 0's tail with several clusters a pair: its cluster's merge (lse,
// then out in f32, as the LSE route writes them; GB + GB HD floats a
// cluster) to the pair's slot of the workspace, then the arrival; the last
// cluster to arrive merges the pair's parts in cluster order into the
// output (and lse, where asked) and zeroes the counter.
template <typename T, int HD>
__device__ __forceinline__ void merge_clusters(const float* const (&pp)[NP],
                                               int cl, int gb, float* wts,
                                               float* lse_row, void* o,
                                               long long row, float* ws) {
  __shared__ bool last;  // this cluster arrived last of its pair
  constexpr int PART_N = GB + GB * HD;
  const int pair = blockIdx.z * gridDim.y + blockIdx.y;
  const int n_cl = gridDim.x / cl;
  float* parts = ws + (long long)pair * n_cl * PART_N;
  float* mine = parts + (blockIdx.x / cl) * PART_N;
  merge_weights(pp, cl * WARPS, gb, wts, mine);
  __syncthreads();
  merge_values<float, HD>(pp, cl * WARPS, gb, wts, mine + GB);
  __threadfence();  // the part is visible on the device before the arrival
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&arrivals[pair], 1u) == (unsigned)(n_cl - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();  // every cluster's part is read after its arrival
  if (lse_row != nullptr)
    merge_lse<float, HD>(parts, n_cl, gb, wts, lse_row,
                         static_cast<float*>(o) + row);
  else
    merge_lse<T, HD>(parts, n_cl, gb, wts, nullptr, static_cast<T*>(o) + row);
  if (threadIdx.x == 0) arrivals[pair] = 0u;  // ready for the next launch
}

// MULTI: several clusters a pair (the workspace, the arrival and the
// clusters' merge); without it the instance is the one-cluster kernel,
// compiled apart so that the other's code leaves its schedule as it was.
template <typename T, int HD, bool MULTI>
__global__ void __launch_bounds__(NT)
fd_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ length,
          void* __restrict__ o, float* __restrict__ lse,
          float* __restrict__ ws, int S, int H, int G, int split, int cl,
          long long q_sb,
          long long q_sh, long long k_sb, long long k_ss, long long k_sh,
          long long v_sb, long long v_ss, long long v_sh, float scale) {
  using Lay = Layout<T, HD>;
  using E = rt::Elem<T>;
  constexpr int R = Lay::R;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t pushed;  // rank 0: the other ranks' parts have landed
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ncl = MULTI ? cl : gridDim.x;         // blocks of the cluster
  const int rank = MULTI ? blockIdx.x % cl : blockIdx.x;  // in the cluster
  const int HG = (G + GB - 1) / GB;
  const int kh = blockIdx.y / HG, h0 = kh * G + (blockIdx.y % HG) * GB;
  const int gb = min(GB, kh * G + G - h0);  // the block's query heads
  const int slot_n = 2 * GB + gb * HD;      // floats of a pushed part
  const int b = blockIdx.z;
  const float c2 = scale * LOG2E;           // scores in log2 units
  // positions [0, length] attend (length >= -1 by contract: -1, none)
  const int nvalid = min(S, max(__ldg(length), -1) + 1);
  const int s0 = blockIdx.x * split, s1 = min(s0 + split, nvalid);
  const int ntiles = s1 > s0 ? (s1 - s0 + TP - 1) / TP : 0;
  const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;
  T* ring = reinterpret_cast<T*>(smem + warp * Lay::WARP_RING_B);
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  // the warp's i-th tile (the block's tile warp + i * WARPS) into slot i % R;
  // rows past s1 are zero-filled from a mapped address
  auto issue = [&](int i) {
    const int p0 = s0 + (warp + i * WARPS) * TP;
    T* sk = ring + (i % R) * Lay::STAGE;
    T* sv = sk + TP * Lay::LD;
#pragma unroll
    for (int u = 0; u < TP * Lay::CPR / 32; ++u) {
      const int ch = lane + 32 * u;
      const int r = ch / Lay::CPR, e = (ch % Lay::CPR) * Lay::VEC;
      const bool ok = p0 + r < s1;
      const long long p = ok ? p0 + r : s0;
      rt::cp_async16(sk + r * Lay::LD + e, kb + p * k_ss + e, ok);
      rt::cp_async16(sv + r * Lay::LD + e, vb + p * v_ss + e, ok);
    }
  };
  // the loads first: what follows runs while they are in flight
#pragma unroll 1
  for (int i = 0; i < R; ++i) {
    if (i < mine) issue(i);
    rt::cp_async_commit();
  }
  if (ncl > 1) {
    if (rank == 0 && threadIdx.x == 0) {
      rt::mbar_init(&pushed, 1);
      rt::mbar_init_fence();
      rt::mbar_expect_tx(&pushed, (ncl - 1) * WARPS * gb * (8 + 4 * HD));
    }
    // relaxed: a release here would wait for the loads just issued; the
    // mbarrier's init is released by its own fence
    rt::cluster_arrive_relaxed();  // waited for before the first push
  }
  // where this warp's part lands in rank 0's slots, when rank > 0
  const uint32_t slot = rt::smem_addr(smem + Lay::SLOTS_OFF) +
                        ((rank - 1) * WARPS + warp) * slot_n * 4;

  float* part = reinterpret_cast<float*>(smem + Lay::PARTS_OFF +
                                         warp * Lay::PART_STEP);
  if constexpr (!Lay::F32) {
    // lane (g, t) of mma.sync's fragments: row (head) g, columns 2t, 2t + 1
    // (and 2t + 8, 2t + 9); rows 8-15 of A are zero
    const int g = lane / 4, t = lane % 4;
    constexpr bool QREG = Lay::QREG;
    uint32_t qa[QREG ? HD / 16 : 1][4];  // q as A: a0 (g, 2t), a2 (g, 2t + 8)
    T* sq = reinterpret_cast<T*>(smem + Lay::RING_B);
    if constexpr (QREG) {
      const T* qr = q + b * q_sb + (h0 + g) * q_sh + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][0] = g < gb ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk)
                           : 0u;
        qa[kk][2] = g < gb ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk +
                                                                8)
                           : 0u;
        qa[kk][1] = qa[kk][3] = 0u;
      }
    } else {
      for (int e = threadIdx.x; e < GB * HD / 2; e += NT) {  // 2 a thread
        const int r = e / (HD / 2), c = 2 * (e % (HD / 2));
        *reinterpret_cast<uint32_t*>(sq + r * Lay::LDQ + c) =
            r < gb ? *reinterpret_cast<const uint32_t*>(
                         q + b * q_sb + (h0 + r) * q_sh + c)
                   : 0u;
      }
      __syncthreads();
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m = rt::NEG_INF, l = 0.f;
    // ldmatrix row addresses: K's matrices (positions 0-7 | 8-15) x (dims
    // +0 | +8) as B of S; V's (positions 0-7 | 8-15) x (dims +0 | +8),
    // transposed, as B of P V
    const int krow = lane % 8 + 8 * (lane / 16), kcol = 8 * (lane / 8 % 2);
    const int vrow = lane % 8 + 8 * (lane / 8 % 2), vcol = 8 * (lane / 16);

    for (int i = 0; i < mine; ++i) {
      rt::cp_async_wait<R - 1>();
      __syncwarp();
      const T* sk = ring + (i % R) * Lay::STAGE;
      const T* sv = sk + TP * Lay::LD;
      const int p0 = s0 + (warp + i * WARPS) * TP;
      // S: heads x positions 8 nt + 2t (+1), from two chains of products
      float ch[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kf[4], qf[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qf[i] = qa[kk][i];
        } else {
          const T* qs = sq + g * Lay::LDQ + 16 * kk + 2 * t;
          qf[0] = *reinterpret_cast<const uint32_t*>(qs);
          qf[2] = *reinterpret_cast<const uint32_t*>(qs + 8);
          qf[1] = qf[3] = 0u;
        }
        rt::ldsm_x4(kf, sk + krow * Lay::LD + 16 * kk + kcol);
        rt::mma_bf16(ch[kk % 2][0], qf, kf);
        rt::mma_bf16(ch[kk % 2][1], qf, kf + 2);
      }
      float sc[4];  // positions 2t, 2t + 1, 8 + 2t, 9 + 2t
      float mx = rt::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = j / 2, c = j % 2;
        const bool ok = p0 + 8 * nt + 2 * t + c < s1;
        sc[j] = ok ? (ch[0][nt][c] + ch[1][nt][c]) * c2 : rt::NEG_INF;
        mx = fmaxf(mx, sc[j]);
      }
      // over the quad: the row's 16 positions
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m, mx);
      const float al = rt::exp2_approx(m - mn);
      m = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = rt::exp2_approx(sc[j] - mn);
        ps += sc[j];
      }
      l = l * al + ps;  // this lane's share; the quad adds them last
      const uint32_t pa[4] = {rt::pack_bf16(sc[0], sc[1]), 0u,
                              rt::pack_bf16(sc[2], sc[3]), 0u};
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[j][0] *= al;
        acc[j][1] *= al;
      }
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t vf[4];
        rt::ldsm_x4_trans(vf, sv + vrow * Lay::LD + 16 * np + vcol);
        rt::mma_bf16(acc[2 * np], pa, vf);
        rt::mma_bf16(acc[2 * np + 1], pa, vf + 2);
      }
      __syncwarp();  // the slot is read: refill it
      if (i + R < mine) issue(i + R);
      rt::cp_async_commit();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rank > 0) {  // push the part to rank 0 and leave
      rt::cluster_wait();  // rank 0's barrier is ready
      const uint32_t bar = rt::mapa(rt::smem_addr(&pushed), 0);
      const uint32_t dst = rt::mapa(slot, 0);
      if (g < gb) {
        if (t == 0) rt::st_async(dst + 8 * g, make_float2(m, l), bar);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          rt::st_async(dst + 4 * (2 * GB + g * HD + 8 * j + 2 * t),
                       make_float2(acc[j][0], acc[j][1]), bar);
      }
      return;
    }
    rt::cp_async_wait<0>();
    __syncwarp();  // the ring is free: the part overwrites it
    if (t == 0) {
      part[2 * g] = m;
      part[2 * g + 1] = l;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(part + 2 * GB + g * HD + 8 * j + 2 * t) =
          make_float2(acc[j][0], acc[j][1]);
  } else {
    // f32 on CUDA cores: the warp's part holds its accumulators
    float* pacc = part + 2 * GB;
    float* sP = reinterpret_cast<float*>(smem + Lay::P_OFF) + warp * GB * TP;
    float* sA = reinterpret_cast<float*>(smem + Lay::A_OFF) + warp * GB;
    float* sQ = reinterpret_cast<float*>(smem + Lay::Q_OFF);
    for (int e = threadIdx.x; e < GB * HD; e += NT) {
      const int g = e / HD;
      sQ[e] = g < gb ? E::to_float(q[b * q_sb + (h0 + g) * q_sh + e % HD])
                     : 0.f;
    }
    for (int e = lane; e < GB * HD; e += 32) pacc[e] = 0.f;
    if (lane < GB) {
      part[2 * lane] = rt::NEG_INF;
      part[2 * lane + 1] = 0.f;
    }
    __syncthreads();
    const int pr = lane % TP, half = lane / TP;  // position, head parity
    for (int i = 0; i < mine; ++i) {
      rt::cp_async_wait<R - 1>();
      __syncwarp();
      const T* sk = ring + (i % R) * Lay::STAGE;
      const T* sv = sk + TP * Lay::LD;
      const bool ok = s0 + (warp + i * WARPS) * TP + pr < s1;
      for (int g = half; g < gb; g += 2) {
        const float* qg = sQ + g * HD;
        const float* kr = sk + pr * Lay::LD;
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          const float4 qv = *reinterpret_cast<const float4*>(qg + d);
          a = fmaf(qv.x, kv.x, a);
          a = fmaf(qv.y, kv.y, a);
          a = fmaf(qv.z, kv.z, a);
          a = fmaf(qv.w, kv.w, a);
        }
        sP[g * TP + pr] = ok ? a * c2 : rt::NEG_INF;
      }
      __syncwarp();
      for (int g = 0; g < gb; ++g) {  // online softmax, a head at a time
        const float x = sP[g * TP + pr];
        const float m_old = part[2 * g];
        const float mn = fmaxf(m_old, rt::max16(x));
        const float p = rt::exp2_approx(x - mn);
        const float sum = rt::sum16(p);
        __syncwarp();
        if (lane < TP) sP[g * TP + lane] = p;
        if (lane == 0) {
          const float al = rt::exp2_approx(m_old - mn);
          sA[g] = al;
          part[2 * g + 1] = part[2 * g + 1] * al + sum;
          part[2 * g] = mn;
        }
        __syncwarp();
      }
      for (int d = lane; d < HD; d += 32)
        for (int g = 0; g < gb; ++g) {
          float a = pacc[g * HD + d] * sA[g];
#pragma unroll
          for (int p = 0; p < TP; ++p)
            a = fmaf(sP[g * TP + p], sv[p * Lay::LD + d], a);
          pacc[g * HD + d] = a;
        }
      __syncwarp();  // the slot is read: refill it
      if (i + R < mine) issue(i + R);
      rt::cp_async_commit();
    }
    if (rank > 0) {  // push the part to rank 0 and leave
      rt::cluster_wait();  // rank 0's barrier is ready
      const uint32_t bar = rt::mapa(rt::smem_addr(&pushed), 0);
      const uint32_t dst = rt::mapa(slot, 0);
      if (lane < gb)
        rt::st_async(dst + 8 * lane,
                     make_float2(part[2 * lane], part[2 * lane + 1]), bar);
      for (int c = lane; c < gb * HD / 4; c += 32)
        rt::st_async(dst + 4 * (2 * GB + 4 * c),
                     *reinterpret_cast<const float4*>(pacc + 4 * c), bar);
      return;
    }
    rt::cp_async_wait<0>();
  }

  // rank 0: its warps' parts, then the other ranks' in (rank, warp) order,
  // merged into the output, or with several clusters a pair into the
  // cluster's part
  if (ncl > 1) {
    rt::cluster_wait();
    rt::mbar_wait(&pushed, 0);
  }
  __syncthreads();  // both warps' parts are in place
  const float* pp[NP];
#pragma unroll
  for (int r = 0; r < MAX_SPLIT; ++r)
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      pp[r * WARPS + w] =
          r == 0 ? reinterpret_cast<const float*>(smem + Lay::PARTS_OFF +
                                                  w * Lay::PART_STEP)
                 : reinterpret_cast<const float*>(smem + Lay::SLOTS_OFF) +
                       ((r - 1) * WARPS + w) * slot_n;
  float* wts = reinterpret_cast<float*>(smem + Lay::WTS_OFF);
  float* lse_row = lse != nullptr ? lse + (long long)b * H + h0 : nullptr;
  if constexpr (MULTI) {
    merge_clusters<T, HD>(pp, cl, gb, wts, lse_row, o,
                          ((long long)b * H + h0) * HD, ws);
  } else {
    merge_weights(pp, ncl * WARPS, gb, wts, lse_row);
    __syncthreads();
    const long long row = ((long long)b * H + h0) * HD;
    if (lse != nullptr)  // the LSE route: o in f32, for the ranks' merge
      merge_values<float, HD>(pp, ncl * WARPS, gb, wts,
                              static_cast<float*>(o) + row);
    else
      merge_values<T, HD>(pp, ncl * WARPS, gb, wts, static_cast<T*>(o) + row);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* o, void* lse, void* ws, int B, int S, int H, int K,
           long long q_sb, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, int split, int n_split, int cl, cudaStream_t stream) {
  static unsigned long long done[2] = {};  // devices with the limit raised
  const bool multi = n_split > cl;
  auto kern = multi ? fd_kernel<T, HD, true> : fd_kernel<T, HD, false>;
  const int G = H / K, HG = (G + GB - 1) / GB;
  if (multi && (ws == nullptr || (long long)B * K * HG > MAX_PAIRS))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes<T, HD>(cl, G < GB ? G : GB);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = rt::allow_smem(kern, smem_cap<T, HD>(), done[multi]);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, K * HG, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      o, static_cast<float*>(lse), static_cast<float*>(ws), S, H, G, split,
      cl, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of cl blocks (G query heads a KV head) that the card holds at
// once (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
template <typename T, int HD>
int max_clusters(int cl, int G) {
  static unsigned long long done = 0;
  auto kern = fd_kernel<T, HD, false>;
  const int smem = smem_bytes<T, HD>(cl, G < GB ? G : GB);
  if (smem > SMEM_MAX) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rt::allow_smem(kern, smem_cap<T, HD>(), done);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* length, void* o, void* lse, void* ws, int B, int S,
              int H, int K, long long q_sb, long long q_sh, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
              long long v_sh, float scale, int split, int n_split, int cl,
              cudaStream_t st) {
#define FD_LAUNCH(HD_)                                                       \
  launch<T, HD_>(q, k, v, length, o, lse, ws, B, S, H, K, q_sb, q_sh, k_sb, \
                 k_ss, k_sh, v_sb, v_ss, v_sh, scale, split, n_split, cl, st)
  switch (hd) {
    case 16: return FD_LAUNCH(16);
    case 32: return FD_LAUNCH(32);
    case 64: return FD_LAUNCH(64);
    case 128: return FD_LAUNCH(128);
    case 160: return FD_LAUNCH(160);
    case 256: return FD_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef FD_LAUNCH
}

// The routes a call can take, and the launches each has had.
enum Route { OUT, LSE, ROUTES };
std::atomic<unsigned long long> taken[ROUTES];

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides are in
// elements; the last dimension of q, k and v is contiguous; o is a
// contiguous (B, H, hd) tensor, of the cache's type or, with lse, f32; lse
// a contiguous f32 (B, H) one, or null (no LSE written); length points to
// one int32 on the device, in [-1, S).
// The cache is split over n_split blocks of `split` positions each (a
// multiple of 16, with (n_split - 1) * split < S <= n_split * split), in
// clusters of cl (1..8) blocks, at most 16 clusters a (batch, KV head, head
// group): kernels/flash_decode.py's plan. With more than one cluster, ws is
// an f32 workspace of B * K * ceil(H / K / 8) * (n_split / cl) * 8 * (1 +
// hd) floats (its contents on entry do not matter), else it may be null.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* length, void* o, void* lse,
                                void* ws, int B, int S, int H, int K, int hd,
                                long long q_sb,
                                long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss,
                                long long v_sh, int is_bf16, float scale,
                                int split, int n_split, int cl,
                                void* stream) {
  if (cl < 1 || cl > MAX_SPLIT || n_split < 1 || n_split % cl ||
      n_split / cl > MAX_CLUSTERS || split < TP || split % TP ||
      (long long)(n_split - 1) * split >= S ||
      (long long)n_split * split < S || K < 1 || H % K)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err =
      is_bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, length, o, lse, ws, B,
                                         S, H, K, q_sb, q_sh, k_sb, k_ss,
                                         k_sh, v_sb, v_ss, v_sh, scale, split,
                                         n_split, cl, st)
              : launch_hd<float>(hd, q, k, v, length, o, lse, ws, B, S, H, K,
                                 q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                 v_sh, scale, split, n_split, cl, st);
  if (err == 0)
    taken[lse != nullptr ? LSE : OUT].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// Copies the launches by route (out, lse) since the last reset into
// counts[2]; with reset, zeroes them.
extern "C" void flash_decode_routes(unsigned long long* counts, int reset) {
  for (int r = 0; r < ROUTES; ++r)
    counts[r] = reset ? taken[r].exchange(0) : taken[r].load();
}

// Clusters of cl blocks at (hd, dtype, G) that the card holds at once, or
// minus the cudaError_t: a grid of more clusters runs in waves.
extern "C" int flash_decode_max_clusters(int hd, int is_bf16, int cl,
                                         int G) {
  using bf16 = __nv_bfloat16;
  if (cl < 1 || cl > MAX_SPLIT || G < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (2 * hd + (is_bf16 != 0)) {
    case 32: return max_clusters<float, 16>(cl, G);
    case 33: return max_clusters<bf16, 16>(cl, G);
    case 64: return max_clusters<float, 32>(cl, G);
    case 65: return max_clusters<bf16, 32>(cl, G);
    case 128: return max_clusters<float, 64>(cl, G);
    case 129: return max_clusters<bf16, 64>(cl, G);
    case 256: return max_clusters<float, 128>(cl, G);
    case 257: return max_clusters<bf16, 128>(cl, G);
    case 320: return max_clusters<float, 160>(cl, G);
    case 321: return max_clusters<bf16, 160>(cl, G);
    case 512: return max_clusters<float, 256>(cl, G);
    case 513: return max_clusters<bf16, 256>(cl, G);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory bytes of a launch of clusters of cl blocks at (hd,
// dtype, G), or -1 for a head dim with no instance: what
// kernels/flash_decode.py's ``smem_bytes`` must equal.
extern "C" int flash_decode_smem(int hd, int is_bf16, int cl, int G) {
  using bf16 = __nv_bfloat16;
  const int gb = G < GB ? G : GB;
  switch (2 * hd + (is_bf16 != 0)) {
    case 32: return smem_bytes<float, 16>(cl, gb);
    case 33: return smem_bytes<bf16, 16>(cl, gb);
    case 64: return smem_bytes<float, 32>(cl, gb);
    case 65: return smem_bytes<bf16, 32>(cl, gb);
    case 128: return smem_bytes<float, 64>(cl, gb);
    case 129: return smem_bytes<bf16, 64>(cl, gb);
    case 256: return smem_bytes<float, 128>(cl, gb);
    case 257: return smem_bytes<bf16, 128>(cl, gb);
    case 320: return smem_bytes<float, 160>(cl, gb);
    case 321: return smem_bytes<bf16, 160>(cl, gb);
    case 512: return smem_bytes<float, 256>(cl, gb);
    case 513: return smem_bytes<bf16, 256>(cl, gb);
    default: return -1;
  }
}
