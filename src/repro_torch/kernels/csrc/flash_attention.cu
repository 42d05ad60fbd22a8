// Causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :93). Same contract: q (B,T,H,hd),
// k/v (B,S,K,hd), query head h reads KV head h / G; causal mask row >= col
// aligned at 0; masked scores are -1e30; m, l and the accumulator are f32;
// l is floored at 1e-30; output in q's dtype.
//
// Design (a simple kernel that is right; wgmma/TMA come later): one block of
// 256 threads per (64-row query tile, head, batch). Q and each 64-row K/V
// tile sit in shared memory in the input dtype; the block walks the K/V
// tiles up to the causal limit (fully masked tiles are never loaded) with an
// online softmax. Thread (ty, tx) of a 16x16 grid owns query rows ty+16i
// and, per tile, score columns tx+16j; it keeps its 4x4 scores, the rows'
// running max/denominator and a 4 x hd/16 slice of the output accumulator
// in registers. Products run on the f32 CUDA cores, not the tensor cores.
// What bounds it on the H100: at the serve shape (B 8, T 512, H 16, K 8,
// hd 128, bf16) moving q, k, v and o once takes 15 us at 3.35 TB/s and the
// causal products 8.7 us at 989 TFLOP/s, so bytes bound it up to T ~ 885 and
// operations beyond; the CUDA-core products keep it far above both.
// The layout is read through strides; the ragged tail (T or S not a multiple
// of 64) is zero-filled and masked.
#include "common.cuh"

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
                       const T* __restrict__ v, T* __restrict__ o, int T_,
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
    T* orow = o + ((long long)(b * T_ + row) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < DJ; ++d)
      orow[tx + 16 * d] = E::from_float(acc[i][d] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int T_, int S, int H, int K, long long q_sb, long long q_st,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, int causal,
           float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  const size_t smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), T_, S, H, H / K, q_sb,
      q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int T_, int S, int H, int K, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              int causal, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, T_, S, H, K, q_sb, q_st, q_sh, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, B, T_, S, H, K, q_sb, q_st, q_sh, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, T_, S, H, K, q_sb, q_st, q_sh, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, T_, S, H, K, q_sb, q_st, q_sh,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
                            st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides are in
// elements; the last dimension of q, k and v is contiguous; o is a
// contiguous (B, T, H, hd) tensor.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int T_,
                                   int S, int H, int K, int hd,
                                   long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss,
                                   long long v_sh, int is_bf16, int causal,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, T_, S, H, K, q_sb,
                                    q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                    v_sh, causal, scale, st);
  return launch_hd<float>(hd, q, k, v, o, B, T_, S, H, K, q_sb, q_st, q_sh,
                          k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
                          st);
}
