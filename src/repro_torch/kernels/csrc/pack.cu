// Emulation's byte pack: K uint8 leaves (B, n_i) into one (B, sum n_i)
// buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pack.py (pack, def at
// :29, pallas_call at :37). Same contract: leaf i lands in columns
// [sum_{j<i} n_j, sum_{j<=i} n_j) of every output row; the bytes are copied,
// never converted.
//
// What bounds it on the H100: bytes, 2 * B * sum n_i of them at 3.35 TB/s,
// and at the host tier's act shape (B 64, leaves of 4, 4 and 4 bytes: 1,536
// bytes) one round trip to device memory and the launch itself. The Pallas
// kernel DMAs a (block_b, n_i) tile of each leaf into VMEM and stores it at
// a static column offset, one leaf after the other; on the H100 that order
// would cost a round trip a leaf. So:
// - Every leaf has its own blocks (as torch.cat's batched copy gives each
//   input its own): block x belongs to the leaf whose first block is the
//   last one <= x, so all leaves' loads are in flight at once, and a thread
//   issues all of its loads before its stores.
// - A leaf is cut into chunks of its access width (16 bytes where the
//   leaf's pointer, row stride, width and column offset and the output's
//   row stride are 16-byte aligned, 4 where they are 4-byte aligned, 1
//   elsewhere); a block copies NT * IPT consecutive chunks of one leaf, so
//   neighbouring threads touch neighbouring bytes. A chunk's row and column
//   come from one 32-bit divmod by the leaf's chunks per row, by a
//   multiplier computed on the host (no 64-bit division on the card).
// - The leaf table travels in the kernel's parameters as a __grid_constant__
//   struct sized to K (4, 8 or MAX_LEAVES leaves, 40 bytes a leaf), so a
//   launch of three leaves ships 160 bytes of table, not 1.3 KB; the wrapper
//   splits more than MAX_LEAVES leaves over launches that write disjoint
//   columns. Leaves of more than 2^31 - 1 chunks are copied in bands of
//   rows, one launch a band.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 32;  // leaves per launch (keep in kernels/pack.py)
constexpr int NT = 256;         // threads per block
constexpr int IPT = 4;          // chunks per thread
constexpr int CHUNKS = NT * IPT;  // chunks per block
constexpr long long MAX_CHUNKS = 0x7fffffffll;  // a leaf's chunks a launch

struct Leaf {
  const uint8_t* src;
  long long stride;  // bytes between rows
  int col;           // column offset in the output row, in bytes
  int vec;           // access width in bytes: 16, 4 or 1
  unsigned cpr;      // chunks per row
  unsigned magic;    // chunk / cpr == (umulhi(chunk, magic) + chunk) >> shift
  int shift;
  int block0;        // the leaf's first block
};

template <int NL>
struct Table {
  Leaf leaf[NL];
  int K;
};

template <typename V>
__device__ __forceinline__ void copy_chunks(const Leaf& l,
                                            uint8_t* __restrict__ out,
                                            long long out_stride, unsigned n,
                                            unsigned c0) {
  V val[IPT];
  unsigned row[IPT], col[IPT];
#pragma unroll
  for (int u = 0; u < IPT; ++u) {  // the loads first
    const unsigned c = c0 + u * NT;
    row[u] = (__umulhi(c, l.magic) + c) >> l.shift;
    col[u] = c - row[u] * l.cpr;
    if (c < n)
      val[u] = *reinterpret_cast<const V*>(
          l.src + static_cast<long long>(row[u]) * l.stride +
          col[u] * sizeof(V));
  }
#pragma unroll
  for (int u = 0; u < IPT; ++u)
    if (c0 + u * NT < n)
      *reinterpret_cast<V*>(out + static_cast<long long>(row[u]) * out_stride +
                            l.col + col[u] * sizeof(V)) = val[u];
}

template <int NL>
__global__ void __launch_bounds__(NT)
pack_kernel(const __grid_constant__ Table<NL> table,
            uint8_t* __restrict__ out, long long out_stride, unsigned B) {
  int k = 0;  // the block's leaf: uniform over the block
#pragma unroll
  for (int j = 1; j < NL; ++j)
    if (j < table.K && table.leaf[j].block0 <= static_cast<int>(blockIdx.x))
      k = j;
  const Leaf& l = table.leaf[k];
  const unsigned n = B * l.cpr;
  const unsigned c0 = (blockIdx.x - l.block0) * CHUNKS + threadIdx.x;
  if (l.vec == 16)
    copy_chunks<uint4>(l, out, out_stride, n, c0);
  else if (l.vec == 4)
    copy_chunks<uint32_t>(l, out, out_stride, n, c0);
  else
    copy_chunks<uint8_t>(l, out, out_stride, n, c0);
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

// The round-up multiplier of unsigned division by d (1 <= d < 2^31), exact
// for dividends below 2^31: shift = ceil(log2 d),
// magic = floor(2^32 (2^shift - d) / d) + 1.
void divisor(unsigned d, unsigned& magic, int& shift) {
  shift = 0;
  while ((1ull << shift) < d) ++shift;
  magic = static_cast<unsigned>(
      ((1ull << 32) * ((1ull << shift) - d)) / d + 1);
}

template <int NL>
int launch(const Table<NL>& table, int blocks, uint8_t* out,
           long long out_stride, long long rows, cudaStream_t stream) {
  pack_kernel<NL><<<blocks, NT, 0, stream>>>(table, out, out_stride,
                                             static_cast<unsigned>(rows));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Copies K <= MAX_LEAVES leaves into ``out`` (B rows of out_stride bytes).
// ``leaves`` holds four numbers a leaf: its address, row stride, width and
// column offset in bytes; leaf k's row r (address + r * stride, width bytes)
// lands at out + r * out_stride + column. Widths are > 0 and below 2^31.
// Returns the cudaError_t of the launch (0 on success); B == 0 launches
// nothing.
extern "C" int pack_fwd(const long long* leaves, int K, void* out,
                        long long B, long long out_stride, void* stream) {
  if (K < 1 || K > MAX_LEAVES) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  Table<MAX_LEAVES> table;
  table.K = K;
  unsigned max_cpr = 1;
  for (int k = 0; k < K; ++k) {
    const long long* a = leaves + 4 * k;
    if (a[2] <= 0 || a[2] > 0x7fffffffll) return cudaErrorInvalidValue;
    Leaf& l = table.leaf[k];
    l.src = reinterpret_cast<const uint8_t*>(a[0]);
    l.stride = a[1];
    l.col = static_cast<int>(a[3]);
    l.vec = access_width(static_cast<uintptr_t>(a[0]), a[1], a[2], a[3], o,
                         out_stride);
    l.cpr = static_cast<unsigned>(a[2] / l.vec);
    divisor(l.cpr, l.magic, l.shift);
    if (l.cpr > max_cpr) max_cpr = l.cpr;
  }
  // rows a launch: every leaf's chunks below 2^31 (bands of rows past that)
  const long long band = MAX_CHUNKS / max_cpr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (long long r0 = 0; r0 < B; r0 += band) {
    const long long rows = B - r0 < band ? B - r0 : band;
    long long blocks = 0;
    for (int k = 0; k < K; ++k) {
      Leaf& l = table.leaf[k];
      l.block0 = static_cast<int>(blocks);
      blocks += (rows * l.cpr + CHUNKS - 1) / CHUNKS;
    }
    if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
    uint8_t* dst = static_cast<uint8_t*>(out) + r0 * out_stride;
    int err;
    if (K <= 4) {
      Table<4> t;
      t.K = K;
      for (int k = 0; k < K; ++k) t.leaf[k] = table.leaf[k];
      err = launch(t, static_cast<int>(blocks), dst, out_stride, rows, st);
    } else if (K <= 8) {
      Table<8> t;
      t.K = K;
      for (int k = 0; k < K; ++k) t.leaf[k] = table.leaf[k];
      err = launch(t, static_cast<int>(blocks), dst, out_stride, rows, st);
    } else {
      err = launch(table, static_cast<int>(blocks), dst, out_stride, rows,
                   st);
    }
    if (err != 0) return err;
    for (int k = 0; k < K; ++k)  // the next band's rows
      table.leaf[k].src += rows * table.leaf[k].stride;
  }
  return cudaSuccess;
}
