// Block-sparse (BSR) products for Hopper: Y = A @ U, and the fused
// (A @ U, U^T U) of one ALS half-step.
//
// Replaces the Pallas TPU kernels repro/kernels/bsr_spmm.py::_spmm_kernel
// (grid (row-block, k-tile, slot), slot axis sequential, accumulating in the
// output block) and repro/kernels/fused.py::_spmm_gram_kernel (the same
// sweep plus a k x k Gram accumulator fed by first-occurrence slabs).
//
// A is stored as tiles (nrb, bcap, bm, bk) f32 with block_cols (nrb, bcap)
// int32; U is (m, k) f32 row-major; Y is (n, k) f32.
//
// What bounds it: every stored tile is read once and each tile element feeds
// at most k multiply-adds, so the kernel is bound by the bytes of the tiles
// (about 0.61 GB per orientation at the paper's PubMed size, 0.18 ms at
// 3.35 TB/s); U and Y are a few hundred KB and stay in L2.
//
// Design:
//  * The TPU grid ran its slot axis in order on one core and carried the sum
//    in the output block.  Here one block owns kRows rows of one row-block
//    and one chunk of at most kCols factor columns, and loops over the bcap
//    slots itself; the sum lives in registers.  Splitting each row-block
//    over bm / kRows blocks puts more blocks on the 132 SMs than the
//    row-block count alone would (59 row-blocks for A^T at PubMed).
//  * The tile does not go through shared memory: lane l of a warp reads
//    columns l, l+32, l+64, l+96 of its rows, so every warp load is one
//    coalesced 128-byte line and every element is read exactly once.  Each
//    lane keeps per-row partial sums over its own columns; one warp-shuffle
//    tree per (row, column) at the end adds the 32 lanes in a fixed order.
//  * The (bk, kc) U slab at block_cols[i, s] * bk is staged in shared
//    memory once per slot (rows >= m read as zero, so U is never padded),
//    with rows padded to kc + 1 words so that 32 lanes reading 32 different
//    slab rows hit 32 different banks.
//  * The fused kernel stages the full-rank slab.  The block that owns rows
//    0..kRows-1 and column chunk 0 of each row-block also adds slab^T slab
//    into per-thread Gram registers at every slot whose first-occurrence
//    flag is set, and writes that row-block's partial Gram to a
//    (nrb, k, k) scratch buffer.  A second launch sums the partials in
//    row-block order: deterministic, with no float atomics.
//  * The fused and the plain product share one template, so their Y is
//    bitwise equal.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // tile rows per block
constexpr int kCols = 8;                      // factor columns per block
constexpr int kMaxJ = 4;                      // bk <= 32 * kMaxJ
constexpr int kGramPerThread = 4;             // k * k <= kThreads * 4

template <bool kGram>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const float* __restrict__ tiles,
            const int* __restrict__ block_cols,
            const int* __restrict__ flags,
            const float* __restrict__ u,
            float* __restrict__ y,
            float* __restrict__ gram_part,
            int n, int m, int k, int bcap, int bm, int bk, int row_splits) {
  extern __shared__ float slab[];
  const int i = blockIdx.x / row_splits;   // row-block
  const int rs = blockIdx.x % row_splits;  // row chunk within the tile
  const int c0 = blockIdx.y * kCols;       // first factor column
  const int kc = min(kCols, k - c0);
  // slab columns: every column for the fused kernel (its Gram needs them
  // all), this block's chunk otherwise
  const int s_c0 = kGram ? 0 : c0;
  const int s_w = kGram ? k : kc;
  const int ld = s_w + 1;
  const int y_off = kGram ? c0 : 0;  // this chunk's first column in the slab
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool gram_block = kGram && rs == 0 && blockIdx.y == 0;

  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[t][c] = 0.f;
  float gacc[kGramPerThread];
#pragma unroll
  for (int g = 0; g < kGramPerThread; ++g) gacc[g] = 0.f;

  const size_t tile_elems = static_cast<size_t>(bm) * bk;
  for (int s = 0; s < bcap; ++s) {
    const int slot = i * bcap + s;
    const int col_block = block_cols[slot];
    for (int e = threadIdx.x; e < bk * s_w; e += kThreads) {
      const int j = e / s_w;
      const int c = e - j * s_w;
      const int row = col_block * bk + j;
      slab[j * ld + c] =
          row < m ? u[static_cast<size_t>(row) * k + s_c0 + c] : 0.f;
    }
    __syncthreads();

    const float* tile = tiles + static_cast<size_t>(slot) * tile_elems;
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const int r = rs * kRows + warp * kRowsPerWarp + t;
      if (r < bm) {
#pragma unroll
        for (int q = 0; q < kMaxJ; ++q) {
          const int j = lane + 32 * q;
          if (j < bk) {
            const float a = tile[static_cast<size_t>(r) * bk + j];
            const float* srow = slab + j * ld + y_off;
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (c < kc) acc[t][c] = fmaf(a, srow[c], acc[t][c]);
          }
        }
      }
    }

    if (gram_block && flags[slot] != 0) {
#pragma unroll
      for (int g = 0; g < kGramPerThread; ++g) {
        const int e = threadIdx.x + g * kThreads;
        if (e < k * k) {
          const int c1 = e / k;
          const int c2 = e - c1 * k;
          float sum = 0.f;
          for (int j = 0; j < bk; ++j)
            sum = fmaf(slab[j * ld + c1], slab[j * ld + c2], sum);
          gacc[g] += sum;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int r = rs * kRows + warp * kRowsPerWarp + t;
    const long row = static_cast<long>(i) * bm + r;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = acc[t][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && c < kc && r < bm && row < n)
        y[row * k + c0 + c] = v;
    }
  }

  if (gram_block) {
#pragma unroll
    for (int g = 0; g < kGramPerThread; ++g) {
      const int e = threadIdx.x + g * kThreads;
      if (e < k * k) gram_part[static_cast<size_t>(i) * k * k + e] = gacc[g];
    }
  }
}

// gram[e] = sum over row-blocks p, in order, of gram_part[p, e]
__global__ void gram_reduce_kernel(const float* __restrict__ gram_part,
                                   float* __restrict__ gram, int nparts,
                                   int kk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kk) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p)
    s += gram_part[static_cast<size_t>(p) * kk + e];
  gram[e] = s;
}

int check_args(int n, int m, int k, int nrb, int bcap, int bm, int bk) {
  if (n <= 0 || m <= 0 || k <= 0 || nrb <= 0 || bcap <= 0 || bm <= 0 ||
      bk <= 0 || bk > 32 * kMaxJ)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" int bsr_spmm_f32(const float* tiles, const int* block_cols,
                            const float* u, float* y, int n, int m, int k,
                            int nrb, int bcap, int bm, int bk, void* stream) {
  if (int rc = check_args(n, m, k, nrb, bcap, bm, bk)) return rc;
  const int row_splits = (bm + kRows - 1) / kRows;
  const dim3 grid(nrb * row_splits, (k + kCols - 1) / kCols);
  const size_t smem =
      static_cast<size_t>(bk) * ((k < kCols ? k : kCols) + 1) * sizeof(float);
  spmm_kernel<false><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      tiles, block_cols, nullptr, u, y, nullptr, n, m, k, bcap, bm, bk,
      row_splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsr_spmm_gram_f32(const float* tiles, const int* block_cols,
                                 const int* flags, const float* u, float* y,
                                 float* gram_part, float* gram, int n, int m,
                                 int k, int nrb, int bcap, int bm, int bk,
                                 void* stream) {
  if (int rc = check_args(n, m, k, nrb, bcap, bm, bk)) return rc;
  if (k * k > kThreads * kGramPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_splits = (bm + kRows - 1) / kRows;
  const dim3 grid(nrb * row_splits, (k + kCols - 1) / kCols);
  const size_t smem = static_cast<size_t>(bk) * (k + 1) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  spmm_kernel<true><<<grid, kThreads, smem, s>>>(
      tiles, block_cols, flags, u, y, gram_part, n, m, k, bcap, bm, bk,
      row_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kk = k * k;
  gram_reduce_kernel<<<(kk + 255) / 256, 256, 0, s>>>(gram_part, gram, nrb,
                                                      kk);
  return static_cast<int>(cudaGetLastError());
}
