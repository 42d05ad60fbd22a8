// Emulation's byte pack: K uint8 leaves (B, n_i) into one (B, sum n_i)
// buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pack.py (pack, def at
// :29, pallas_call at :37). Same contract: leaf i lands in columns
// [sum_{j<i} n_j, sum_{j<=i} n_j) of every output row; the bytes are copied,
// never converted.
//
// What bounds it on the H100: bytes. It reads every leaf once and writes the
// output once and computes nothing, so its bound is 2 * B * sum n_i bytes
// over 3.35 TB/s. The Pallas kernel DMAs a (block_b, n_i) tile of each leaf
// into VMEM and stores it at a static column offset; its grid needs
// B % block_b == 0. Here a block owns a tile of ROWS rows of any B (the tail
// block is masked), and walks the leaves one after the other.
//
// Design (simple first):
// - The leaf table (source pointer, row stride, width, column offset and
//   access width of each leaf) travels in the kernel's parameters as a
//   __grid_constant__ struct, MAX_LEAVES leaves per launch (32 bytes a leaf,
//   well inside the 4 KB of parameter space); the wrapper splits more
//   leaves over launches that write disjoint column ranges.
// - For each leaf the block's threads walk the tile's (row, chunk) pairs in
//   one flat index, so consecutive threads touch consecutive bytes of the
//   leaf, whatever its width.
// - A chunk is 16 bytes where the leaf's pointer, row stride, width and
//   column offset and the output's row stride are all 16-byte aligned, 4
//   bytes where they are 4-byte aligned, and 1 byte elsewhere; the host side
//   of this file picks it per leaf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 32;  // leaves per launch (keep in kernels/pack.py)
constexpr int NT = 256;         // threads per block
constexpr int ROWS = 32;        // output rows per block

struct Leaf {
  const uint8_t* src;
  long long stride;  // bytes between rows
  int width;         // bytes per row
  int col;           // column offset in the output row
  int vec;           // access width in bytes: 16, 4 or 1
  int pad;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
};

template <typename V, typename I>
__device__ __forceinline__ void copy_rows(const Leaf& l, uint8_t* out,
                                          long long out_stride,
                                          long long row0, int rows) {
  const I per_row = static_cast<I>(l.width / sizeof(V));
  const I n = static_cast<I>(rows) * per_row;
  for (I i = threadIdx.x; i < n; i += NT) {
    const long long r = row0 + static_cast<long long>(i / per_row);
    const I c = (i % per_row) * static_cast<I>(sizeof(V));
    *reinterpret_cast<V*>(out + r * out_stride + l.col + c) =
        *reinterpret_cast<const V*>(l.src + r * l.stride + c);
  }
}

template <typename V>
__device__ __forceinline__ void copy_leaf(const Leaf& l, uint8_t* out,
                                          long long out_stride,
                                          long long row0, int rows) {
  // 32-bit index arithmetic unless the tile's chunk count needs 64
  const unsigned long long n =
      static_cast<unsigned long long>(rows) * (l.width / sizeof(V));
  if (n <= 0xffffffffull)
    copy_rows<V, unsigned>(l, out, out_stride, row0, rows);
  else
    copy_rows<V, unsigned long long>(l, out, out_stride, row0, rows);
}

__global__ void __launch_bounds__(NT)
pack_kernel(const __grid_constant__ Table table, int K,
            uint8_t* __restrict__ out, long long out_stride, long long B) {
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(B - row0 < ROWS ? B - row0 : ROWS);
  for (int k = 0; k < K; ++k) {
    const Leaf& l = table.leaf[k];
    if (l.vec == 16)
      copy_leaf<uint4>(l, out, out_stride, row0, rows);
    else if (l.vec == 4)
      copy_leaf<uint32_t>(l, out, out_stride, row0, rows);
    else
      copy_leaf<uint8_t>(l, out, out_stride, row0, rows);
  }
}

int access_width(uintptr_t src, long long stride, long long width,
                 long long col, uintptr_t out, long long out_stride) {
  const unsigned long long bits =
      static_cast<unsigned long long>(src) | static_cast<unsigned long long>(
          stride) | static_cast<unsigned long long>(width) |
      static_cast<unsigned long long>(col) | static_cast<unsigned long long>(
          out) | static_cast<unsigned long long>(out_stride);
  if ((bits & 15ull) == 0) return 16;
  if ((bits & 3ull) == 0) return 4;
  return 1;
}

}  // namespace

// Copies K <= MAX_LEAVES leaves into ``out`` (B rows of out_stride bytes):
// leaf k's row r (srcs[k] + r * strides[k], widths[k] bytes) lands at
// out + r * out_stride + cols[k]. Widths are > 0 and below 2^31. Returns the
// cudaError_t of the launch (0 on success); B == 0 launches nothing.
extern "C" int pack_fwd(const unsigned long long* srcs,
                        const long long* strides, const long long* widths,
                        const long long* cols, int K, void* out, long long B,
                        long long out_stride, void* stream) {
  if (K < 1 || K > MAX_LEAVES) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  Table table = {};
  for (int k = 0; k < K; ++k) {
    if (widths[k] <= 0 || widths[k] > 0x7fffffffll)
      return cudaErrorInvalidValue;
    Leaf& l = table.leaf[k];
    l.src = reinterpret_cast<const uint8_t*>(srcs[k]);
    l.stride = strides[k];
    l.width = static_cast<int>(widths[k]);
    l.col = static_cast<int>(cols[k]);
    l.vec = access_width(static_cast<uintptr_t>(srcs[k]), strides[k],
                         widths[k], cols[k], o, out_stride);
  }
  const long long blocks = (B + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  pack_kernel<<<static_cast<unsigned>(blocks), NT, 0,
                static_cast<cudaStream_t>(stream)>>>(
      table, K, static_cast<uint8_t*>(out), out_stride, B);
  return static_cast<int>(cudaGetLastError());
}
