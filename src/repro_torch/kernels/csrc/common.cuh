// Shared helpers for the port's kernels (sm_90a, plain C interface).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// The TPU kernels mask with -1e30, not -inf; keep that so fully masked
// tiles behave the same (exp(-1e30 - m) == 0 once m is finite).
constexpr float NEG_INF = -1e30f;

// Per-dtype traits. PAD makes the shared-memory row stride an odd number of
// 32-bit words, so 16 (or 32) threads reading the same column of 16 (or 32)
// different rows hit 16 (or 32) different banks.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int PAD = 1;
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static float2 load2(const float* p) {
    return make_float2(p[0], p[1]);
  }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int PAD = 2;
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  // p is 4-byte aligned: even element offset in a row of even stride
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// Copy a (rows x HD) tile whose row r starts at g + r*stride into shared
// memory with row stride LD; rows >= valid are zero-filled. 16-byte global
// loads (the wrapper checks 16-byte alignment of the base and strides), four
// 4-byte shared stores each (LD keeps every row 4-byte aligned).
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(g + r * stride + c);
    uint32_t* dst = reinterpret_cast<uint32_t*>(s + r * LD + c);
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }
}

// Reductions over the 16 lanes of a half-warp (xor offsets < 16 stay inside).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max32(float x) {
  return max16(fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16)));
}

__device__ __forceinline__ float sum32(float x) {
  return sum16(x + __shfl_xor_sync(0xffffffffu, x, 16));
}

// 2^x on the special function unit, subnormal results flushed to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 out) ------------
// A is 16 x 16 row-major, B 16 x 8 "col" (each of its 8 columns contiguous
// along k), C 16 x 8; lane l = 4g + t holds A rows g and g + 8, B column g,
// and C rows g and g + 8 at columns 2t and 2t + 1.

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, whose fragment lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, each matrix transposed (B fragments of a row-major [k][n] tile).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- asynchronous copies (cp.async, device memory -> shared memory) ---------

// 16 bytes from g to s, bypassing L1; with valid false nothing is read (the
// src-size operand is 0) and s is zero-filled. g must stay a mapped address.
__device__ __forceinline__ void cp_async16(void* s, const void* g,
                                           bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(g), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- warpgroup products (wgmma, sm_90a) --------------------------------------

// Byte offset of 16-byte chunk c (of HD / 8) of row r in a tile stored for
// the 128-byte swizzle: column halves of 64 bf16 (HALF bytes each, rows of
// 128 bytes), each row's 8 chunks XOR-permuted by r % 8. Halves must start
// 1024-byte aligned.
template <int HALF>
__device__ __forceinline__ uint32_t swizzle128(int r, int c) {
  return (c / 8) * HALF + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// A shared-memory matrix descriptor for the 128-byte swizzle: the start
// address, the leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers that an asynchronous
// wgmma owns across its issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// -- mbarriers and TMA (sm_90) ----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barrier inits visible to the async proxy (TMA) before first use.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and add bytes to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// -- thread block clusters ---------------------------------------------------

// The address of shared-memory address a in cluster rank r's block.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(r));
  return d;
}

// 16 (v4) or 8 (v2) bytes into another block's shared memory at dst (an
// address from mapa), completing on its mbarrier bar (likewise mapped).
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t dst, float2 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// Arrive on the cluster barrier without ordering this thread's memory
// operations (a release would wait for its loads in flight); a later
// cluster_wait acquires.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One TMA copy of a box of the 4-D tensor map at coordinates c0..c3 (c0
// innermost) into shared memory, completing bytes on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// The same for a box of a 2-D tensor map at (c0, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// One bulk copy (no tensor map) of bytes from src to dst, completing on
// bar; bytes, src and dst multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operand reads, TMA) before a barrier hands them over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- launch helpers (host) ----------------------------------------------------

// SMs of the current device, read once a device
inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = cache[dev & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Raise a kernel's dynamic shared-memory limit once a device (done: a bit
// per device, one word per kernel instance).
template <typename F>
cudaError_t allow_smem(F kern, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// Make the current device's primary context current on the calling thread.
// CUDA's cuTensorMapEncodeTiled needs a current context, and a thread
// that has launched nothing yet (autograd's device thread, say, or a worker)
// may have none: torch does not set a device that is already the thread's
// default, so no runtime call has bound one. Called before every encode; it
// binds once per thread and device, so later calls cost one cudaGetDevice.
inline cudaError_t bind_context() {
  thread_local int bound = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == bound) return err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) bound = dev;
  return err;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); null where the driver lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

}  // namespace rt
