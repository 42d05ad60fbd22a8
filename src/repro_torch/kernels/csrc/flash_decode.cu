// One-query (decode) GQA attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, pallas_call at :84). Same contract: q (B,H,hd), caches
// k/v (B,S,K,hd), `length` an int32 scalar in device memory (the Pallas
// kernel's SMEM scalar): positions <= length attend, the rest are masked
// with -1e30; query head h reads KV head h / G; f32 softmax statistics and
// accumulator; l floored at 1e-30; output (B,H,hd) in q's dtype. Reading
// `length` on the device keeps decode free of host syncs.
//
// Design (simple first): one block of 128 threads per (KV head, batch). All
// G query heads of the group attend against each 64-position K/V tile,
// which is loaded into shared memory once. Tiles past `length` are never
// loaded, so a step reads only the filled prefix of the cache. The kernel is
// bound by bytes (the K/V prefix, 3.35 TB/s), but with B*K blocks (64 at the
// serve shape) it fills under half of the 132 SMs and waits on each tile's
// load before its math: split-KV with a combine pass is the first fix.
#include "common.cuh"

namespace {

constexpr int BS = 64;   // cache positions per tile
constexpr int NT = 128;  // 4 warps

template <typename T, int HD>
size_t smem_bytes(int G) {
  return 2 * BS * (HD + rt::Elem<T>::PAD) * sizeof(T) +
         (2 * G * HD + G * BS + 3 * G) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    T* __restrict__ o, int S, int H, int G, long long q_sb,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, float scale) {
  using E = rt::Elem<T>;
  constexpr int LD = HD + E::PAD;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BS * LD;
  float* sQ = reinterpret_cast<float*>(sV + BS * LD);  // G x HD
  float* sAcc = sQ + G * HD;                           // G x HD
  float* sS = sAcc + G * HD;                           // G x BS scores / p
  float* sM = sS + G * BS;                             // running max
  float* sL = sM + G;                                  // running denominator
  float* sA = sL + G;                                  // this tile's rescale

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // positions [0, length] attend (length >= 0 by contract)
  const int nvalid = min(S, max(*length, 0) + 1);
  const int ntiles = (nvalid + BS - 1) / BS;

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    sQ[i] = E::to_float(q[b * q_sb + (kh * G + g) * q_sh + d]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    sM[g] = rt::NEG_INF;
    sL[g] = 0.f;
  }
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int t = 0; t < ntiles; ++t) {
    const int s0 = t * BS;
    const int valid = min(BS, nvalid - s0);
    __syncthreads();  // the previous tile's reads are done
    rt::load_tile<T, HD, LD>(sK, kb + s0 * k_ss, k_ss, BS, valid);
    rt::load_tile<T, HD, LD>(sV, vb + s0 * v_ss, v_ss, BS, valid);
    __syncthreads();

    // scores: one (head, position) pair per thread and step
    for (int i = tid; i < G * BS; i += NT) {
      const int g = i / BS, c = i % BS;
      const float* qg = sQ + g * HD;
      const T* kr = sK + c * LD;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; d += 2) {
        const float2 kk = E::load2(kr + d);
        acc = fmaf(qg[d + 1], kk.y, fmaf(qg[d], kk.x, acc));
      }
      sS[i] = c < valid ? acc * scale : rt::NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per query head, two positions per lane
    for (int g = warp; g < G; g += NT / 32) {
      float* sg = sS + g * BS;
      const float x0 = sg[lane], x1 = sg[lane + 32];
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, rt::max32(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      sg[lane] = p0;
      sg[lane + 32] = p1;
      const float sum = rt::sum32(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // accumulator: one (head, dim) pair per thread and step
    for (int i = tid; i < G * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      const float* p = sS + g * BS;
      float acc = sAcc[i] * sA[g];
      for (int c = 0; c < valid; ++c)
        acc = fmaf(p[c], E::to_float(sV[c * LD + d]), acc);
      sAcc[i] = acc;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    o[((long long)b * H + kh * G + g) * HD + d] =
        E::from_float(sAcc[i] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* o, int B, int S, int H, int K, long long q_sb, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, float scale, cudaStream_t stream) {
  auto kern = flash_decode_kernel<T, HD>;
  const int G = H / K;
  const size_t smem = smem_bytes<T, HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(K, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      static_cast<T*>(o), S, H, G, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* length, void* o, int B, int S, int H, int K,
              long long q_sb, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, length, o, B, S, H, K, q_sb, q_sh, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, length, o, B, S, H, K, q_sb, q_sh, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, length, o, B, S, H, K, q_sb, q_sh, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, length, o, B, S, H, K, q_sb, q_sh, k_sb,
                            k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides are in
// elements; the last dimension of q, k and v is contiguous; o is a
// contiguous (B, H, hd) tensor; length points to one int32 on the device.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* length, void* o, int B, int S,
                                int H, int K, int hd, long long q_sb,
                                long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss,
                                long long v_sh, int is_bf16, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, length, o, B, S, H, K, q_sb,
                                    q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                    scale, st);
  return launch_hd<float>(hd, q, k, v, length, o, B, S, H, K, q_sb, q_sh,
                          k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
}
