// Warpgroup products (wgmma) and TMA tiles of (rows x head dim) bf16
// tensors, shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu); sm_90a.
//
// Tiles are loaded by TMA into the 128-byte swizzle in column halves of 64
// bf16 (rows of 128 bytes, each half 1024-byte aligned). Accumulator
// layout of every m64nN wgmma: for warp w of the warpgroup and lane
// l = 4 g + t, element 4 n + e is row 16 w + g + 8 (e / 2), column
// 8 n + 2 t + e % 2. An A operand in registers is laid out per warp as
// mma.sync's m16n8k16 A fragment, so the accumulator's column tiles 2c and
// 2c + 1, packed to bf16 pair by pair, are the A fragment of k-step c.
#pragma once

#include "common.cuh"

namespace hop {

using bf16 = __nv_bfloat16;

// D (64 x 128, f32) = A B (+ D if scale_d): A (64 x 16) and B (128 x 16)
// both K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) = A B (+ D if scale_d): A (64 x 16) and B (64 x 16)
// both K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 32, f32) = A B (+ D if scale_d): A (64 x 16) and B (32 x 16)
// both K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_m64n32(float (&d)[16], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) += A B: A (64 x 16, bf16) in registers, laid out per
// warp as mma.sync's m16n8k16 A fragment; B (16 x 64) MN-major in shared
// memory (descriptor, imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_m64n64_t(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A B: A (64 x 16, bf16) in registers, laid out per
// warp as mma.sync's m16n8k16 A fragment; B (16 x 128) MN-major in shared
// memory (descriptor, imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_m64n128_t(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// TMA coordinates of a tensor map whose dims 1..3 hold head, sequence and
// batch in the order packed in ord (2 bits each: 0 head, 1 seq, 2 batch).
struct Coords {
  int c[3];
  __device__ Coords(int ord, int head, int seq, int batch) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int what = (ord >> (2 * i)) & 3;
      c[i] = what == 0 ? head : what == 1 ? seq : batch;
    }
  }
};

// Load the (rows x HD) tile at (head, seq, batch) as ceil(HD / 64) boxes,
// one per 64-column half of HALF bytes, into the 128-byte swizzle; rows
// past the tensor's end, and columns past HD (160's last half), arrive as
// zeros, and count towards the barrier's bytes like the rest of the box.
template <int HD, int HALF>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const void* map,
                                         int ord, uint64_t* bar, int head,
                                         int seq, int batch) {
  const Coords c(ord, head, seq, batch);
#pragma unroll
  for (int half = 0; half < (HD + 63) / 64; ++half)
    rt::tma_load_4d(dst + half * HALF, map, bar, half * 64, c.c[0], c.c[1],
                    c.c[2]);
}

// A 4-D bf16 tensor map over (hd, and head, seq, batch in the order of
// their strides) with boxes of 64 hd elements by rows seq elements, 128-byte
// swizzled; ord receives the order of the outer dims (see Coords). Strides
// are in elements; a dim of extent 1 takes any valid stride.
inline cudaError_t make_map(CUtensorMap* map, int* ord, const void* base,
                            int hd, int rows, int n_head, int n_seq,
                            int n_batch, long long s_head, long long s_seq,
                            long long s_batch) {
  auto encode = rt::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (cudaError_t err = rt::bind_context()) return err;
  struct Dim {
    long long stride;
    int n, what;
  } d[3] = {{s_head, n_head, 0}, {s_seq, n_seq, 1}, {s_batch, n_batch, 2}};
  for (auto& x : d)
    if (x.n == 1) x.stride = (long long)hd * n_head * n_seq;  // unused
  for (int i = 1; i < 3; ++i)  // order the outer dims by stride
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estr[4] = {1, 1, 1, 1};
  *ord = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)d[i].n;
    strides[i] = (cuuint64_t)d[i].stride * sizeof(bf16);
    box[i + 1] = d[i].what == 1 ? rows : 1;
    *ord |= d[i].what << (2 * i);
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hop
