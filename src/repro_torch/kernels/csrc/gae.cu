// Generalized advantage estimation (reverse-time scan), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gae_scan.py (gae, def at
// :56, pallas_call at :69). Same contract: rewards, values and dones of
// shape (B, T), last_value (B,), gamma and lam; advantages (B, T) in f32:
//
//   nt    = 1 - done_t
//   delta = r_t + gamma * V_{t+1} * nt - V_t
//   A_t   = delta + gamma * lam * nt * A_{t+1}
//
// with the carry (A_{t+1}, V_{t+1}) seeded with (0, last_value) and walked
// from t = T-1 down to 0, in the order of the Pallas body (gae_scan.py:43-44).
//
// What bounds it on the H100: bytes. It reads r, v (f32), dones (one byte
// each) and last_value once and writes A once, 13 bytes per element and
// about 8 FLOP, so at (B, T) = (4096, 64) the bound is 3.4 MB over 3.35 TB/s,
// about 1 us. The Pallas kernel blocks time in VMEM and carries (A', V')
// across a sequential grid axis; here the whole time loop lives in one
// thread, and the carry stays in registers.
//
// Design (simple first):
// - One thread per env; 32 threads per block, so 4096 envs make 128 blocks
//   over the 132 SMs. The tail threads of a ragged B exit.
// - Every input is read through its two strides (env, time), so the learner
//   passes the (B, T) transposed views of its (T, B) trajectory without a
//   copy. Then consecutive threads read consecutive envs at the same t:
//   coalesced loads. The output is written through strides as well.
// - dones are bool tensors, read directly as bytes.
// - The loop walks time in chunks of U steps: the U loads of each input are
//   started before the U dependent updates, so they are in flight together.
//
// nvcc contracts a*b + c into FMA by default, which rounds once where the
// Pallas body and the plain version round twice; the difference stays far
// inside the stated tolerance (atol = rtol = 1e-5).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 32;  // threads per block
constexpr int U = 8;    // time steps per chunk

__global__ void __launch_bounds__(NT)
gae_kernel(const float* __restrict__ r, const float* __restrict__ v,
           const uint8_t* __restrict__ d, const float* __restrict__ lv,
           float* __restrict__ out, int B, int T, long long r_sb,
           long long r_st, long long v_sb, long long v_st, long long d_sb,
           long long d_st, long long lv_s, long long o_sb, long long o_st,
           float gamma, float lam) {
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= B) return;
  const float* rb = r + b * r_sb;
  const float* vb = v + b * v_sb;
  const uint8_t* db = d + b * d_sb;
  float* ob = out + b * o_sb;
  const float gl = gamma * lam;

  float adv = 0.f;
  float v_next = lv[b * lv_s];
  int t = T - 1;
  // full chunks of U steps: loads first, then the dependent updates
  for (; t >= U - 1; t -= U) {
    float rr[U], vv[U], nt[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      rr[i] = rb[(t - i) * r_st];
      vv[i] = vb[(t - i) * v_st];
      nt[i] = db[(t - i) * d_st] ? 0.f : 1.f;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const float delta = rr[i] + gamma * v_next * nt[i] - vv[i];
      adv = delta + gl * nt[i] * adv;
      ob[(t - i) * o_st] = adv;
      v_next = vv[i];
    }
  }
  // the first T % U steps
  for (; t >= 0; --t) {
    const float rt = rb[t * r_st], vt = vb[t * v_st];
    const float nt = db[t * d_st] ? 0.f : 1.f;
    const float delta = rt + gamma * v_next * nt - vt;
    adv = delta + gl * nt * adv;
    ob[t * o_st] = adv;
    v_next = vt;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides are in
// elements: (env, time) for r, v, dones and out, and one for last_value.
extern "C" int gae_fwd(const void* r, const void* v, const void* d,
                       const void* lv, void* out, int B, int T,
                       long long r_sb, long long r_st, long long v_sb,
                       long long v_st, long long d_sb, long long d_st,
                       long long lv_s, long long o_sb, long long o_st,
                       float gamma, float lam, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gae_kernel<<<(B + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(v),
      static_cast<const uint8_t*>(d), static_cast<const float*>(lv),
      static_cast<float*>(out), B, T, r_sb, r_st, v_sb, v_st, d_sb, d_st,
      lv_s, o_sb, o_st, gamma, lam);
  return static_cast<int>(cudaGetLastError());
}
