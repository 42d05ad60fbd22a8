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
// from t = T-1 down to 0.
//
// What bounds it on the H100: bytes. It reads r, v (f32), dones (one byte
// each) and last_value once and writes A once, 13 bytes per element and
// about 8 FLOP, so at (B, T) = (4096, 64) the bound is 3.4 MB over 3.35 TB/s,
// about 1 us. A walk of T steps in one thread cannot reach it: each step's
// loads wait on device memory, and one thread per env issues a few loads at
// a time. Here every load of a row is issued before the first dependent
// update:
// - T is cut into SEG = 8 segments of L = ceil(T / 8) steps, one per warp of
//   a block; the 32 lanes are 32 consecutive envs (the learner passes the
//   (B, T) transposed views of its (T, B) trajectory, so a warp's loads at
//   one t are 128 contiguous bytes). At (4096, 64) a thread loads its 8
//   steps of r, v and dones, and V at its segment's end, all at once; 4096
//   envs make 128 blocks of 8 warps.
// - delta_t needs only V_{t+1}, so every step's delta is known at once, and
//   A_t = delta_t + c_t A_{t+1} (c_t = gamma lam nt_t) is affine in the
//   carry. Each segment composes its map A_in = a + b A_out from A_out = 0,
//   backward over its steps; the maps meet in shared memory; each thread
//   folds the maps of the segments after its own, from the last down (a
//   fixed order), into its carry A_out; then it walks its steps again from
//   that carry and writes A. Segments longer than U = 8 steps stream in
//   chunks of U, each chunk's loads issued together, and are read again for
//   the second walk.
// - Summation order: within a segment the recurrence of the Pallas body
//   (gae_scan.py:43-44); across segments the carry is a + b * carry of the
//   composed maps instead of the step-by-step walk. The last segment's
//   advantages are the step-by-step ones bit for bit; the others differ in
//   rounding only, far inside the stated tolerance (atol = rtol = 1e-5), and
//   the order is fixed, so two calls give the same bits.
//   tests/test_torch_ssd_route.py emulates this order against JAX.
// - Every input is read through its two strides (env, time) and dones as
//   bytes; the output is written through strides as well.
//
// nvcc contracts a*b + c into FMA by default, which rounds once where the
// Pallas body and the plain version round twice; the difference stays far
// inside the tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 8;            // segments of T: one per warp
constexpr int NT = 32 * SEG;      // threads per block: 32 envs x SEG
constexpr int U = 8;              // steps a thread loads at once

struct Row {                      // one env's inputs, through strides
  const float* r;
  const float* v;
  const uint8_t* d;
  long long r_st, v_st, d_st;
};

// Load steps t1 - n .. t1 - 1 (n <= U) of a row, newest first.
__device__ __forceinline__ void load_steps(const Row& w, int t1, int n,
                                           float (&rr)[U], float (&vv)[U],
                                           float (&nt)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int t = t1 - 1 - i;
    const bool ok = i < n;
    rr[i] = ok ? w.r[t * w.r_st] : 0.f;
    vv[i] = ok ? w.v[t * w.v_st] : 0.f;
    nt[i] = ok && !w.d[t * w.d_st] ? 1.f : 0.f;
  }
}

__global__ void __launch_bounds__(NT)
gae_kernel(const float* __restrict__ r, const float* __restrict__ v,
           const uint8_t* __restrict__ d, const float* __restrict__ lv,
           float* __restrict__ out, int B, int T, long long r_sb,
           long long r_st, long long v_sb, long long v_st, long long d_sb,
           long long d_st, long long lv_s, long long o_sb, long long o_st,
           float gamma, float lam) {
  __shared__ float2 maps[SEG][32];  // (a, b) of each segment, by lane
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  const int b = blockIdx.x * 32 + lane;
  const bool live = b < B;
  const int bl = live ? b : 0;      // dead lanes read env 0, write nothing
  const Row w{r + bl * r_sb, v + bl * v_sb, d + bl * d_sb, r_st, v_st, d_st};
  float* ob = out + bl * o_sb;
  const float gl = gamma * lam;
  const int L = (T + SEG - 1) / SEG;
  const int t0 = min(s * L, T), t1 = min(t0 + L, T);

  // V after the segment's last step, and its first chunk (the newest U
  // steps) with every load issued before the first update
  const float v_end = t1 < T ? w.v[t1 * v_st] : lv[bl * lv_s];
  float rr[U], vv[U], nt[U];
  load_steps(w, t1, min(U, t1 - t0), rr, vv, nt);

  // the segment's map A_in = a + c A_out, backward from A_out = 0
  float a = 0.f, c = 1.f, v_next = v_end;
  for (int hi = t1; hi > t0; hi -= U) {
    const int n = min(U, hi - t0);
    if (hi != t1) load_steps(w, hi, n, rr, vv, nt);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i < n) {
        const float delta = rr[i] + gamma * v_next * nt[i] - vv[i];
        a = delta + gl * nt[i] * a;
        c = gl * nt[i] * c;
        v_next = vv[i];
      }
    }
  }
  maps[s][lane] = make_float2(a, c);
  __syncthreads();

  // the carry into this segment: the later segments' maps, last first
  float adv = 0.f;
  for (int k = SEG - 1; k > s; --k) {
    const float2 m = maps[k][lane];
    adv = m.x + m.y * adv;
  }
  if (!live) return;

  // the segment again from its carry; a one-chunk segment (T <= 8 U) still
  // holds its inputs in registers
  v_next = v_end;
  for (int hi = t1; hi > t0; hi -= U) {
    const int n = min(U, hi - t0);
    if (t1 - t0 > U) load_steps(w, hi, n, rr, vv, nt);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i < n) {
        const float delta = rr[i] + gamma * v_next * nt[i] - vv[i];
        adv = delta + gl * nt[i] * adv;
        ob[(hi - 1 - i) * o_st] = adv;
        v_next = vv[i];
      }
    }
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
  gae_kernel<<<(B + 31) / 32, NT, 0, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(v),
      static_cast<const uint8_t*>(d), static_cast<const float*>(lv),
      static_cast<float*>(out), B, T, r_sb, r_st, v_sb, v_st, d_sb, d_st,
      lv_s, o_sb, o_st, gamma, lam);
  return static_cast<int>(cudaGetLastError());
}
