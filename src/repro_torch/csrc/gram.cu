// Gram matrix G = U^T U of a tall, skinny f32 U (n x k), in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::_gram_kernel
// (launched by _gram_impl), which streamed (bm, k) row slabs through VMEM
// and accumulated into one k x k output across its sequential grid.
//
// What bounds it: one read of U and one k x k write.  At PubMed size
// (20,112 x 5 f32) that is 0.4 MB, about 0.0001 ms at 3.35 TB/s, so a call
// costs what the host takes to launch it.  The design therefore keeps to one
// launch per call: no memset, no second pass, and the wrapper allocates
// only G.
//
// Design:
//  * grid = min(max_blocks, ceil(n / rows_per_block)) blocks of kThreads,
//    max_blocks being the card's SM count and rows_per_block
//    max(64, 32768 / k^2), so that each thread makes some hundred products.
//    Block b reduces its rows into a k x k f32 partial in shared memory.
//  * A chunk of rows is one contiguous span of U, staged in shared memory
//    by coalesced loads.  With E = k^2 entries, each pass over the chunk
//    takes min(E, kThreads) entries and splits the rows among
//    kThreads / min(E, kThreads) thread groups (10 groups of 25 at k = 5);
//    the group sums are added to the partial in group order.
//  * The partial goes to scratch[b].  After __threadfence() each block takes
//    an integer ticket with atomicAdd; the block that takes the last one
//    sums the partials in block order, writes G and resets the ticket to 0
//    for the next call (so the ticket is set to 0 once, when the wrapper
//    creates it).  No float atomics: for a given n, k and SM count the
//    result is bitwise the same from run to run.
//  * Calls that share one ticket and scratch must be ordered, as calls on
//    one stream are.
//  * n = 0 launches one block, which writes G = 0.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, returns cudaGetLastError(), or cudaErrorInvalidValue for a k
// whose partial does not fit in a block's shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkFloats = 4096;  // staged rows of U, 16 KB

int rows_per_block(int k) {
  const int per = 32768 / (k * k);
  return per > 64 ? per : 64;
}

int chunk_rows(int k) { return k < kChunkFloats ? kChunkFloats / k : 1; }

size_t smem_bytes(int k) {
  return sizeof(float) *
         (static_cast<size_t>(k) * k + kThreads + chunk_rows(k) * k);
}

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ u, float* __restrict__ g,
            float* __restrict__ scratch, unsigned int* __restrict__ ticket,
            int n, int k, int rows, int chunk) {
  extern __shared__ float smem[];
  const int e_total = k * k;
  float* part = smem;               // [E]: this block's partial
  float* red = part + e_total;      // [kThreads]: group sums of a pass
  float* buf = red + kThreads;      // [chunk][k]: staged rows of U
  __shared__ bool is_last;

  const int tid = threadIdx.x;
  const int per_pass = e_total < kThreads ? e_total : kThreads;
  const int groups = kThreads / per_pass;
  const int grp = tid / per_pass;
  const int slot = tid % per_pass;

  for (int e = tid; e < e_total; e += kThreads) part[e] = 0.f;

  const int r_begin = blockIdx.x * rows;
  const int r_end = min(n, r_begin + rows);
  for (int c0 = r_begin; c0 < r_end; c0 += chunk) {
    const int nrow = min(chunk, r_end - c0);
    __syncthreads();  // the previous chunk is no longer read
    const float* src = u + static_cast<long long>(c0) * k;
    for (int x = tid; x < nrow * k; x += kThreads) buf[x] = src[x];
    __syncthreads();
    for (int e0 = 0; e0 < e_total; e0 += per_pass) {
      const int e = e0 + slot;
      float s = 0.f;
      if (grp < groups && e < e_total) {
        const int i = e / k;
        const int j = e - i * k;
        for (int r = grp; r < nrow; r += groups)
          s = fmaf(buf[r * k + i], buf[r * k + j], s);
      }
      red[tid] = s;
      __syncthreads();
      if (tid < per_pass && e0 + tid < e_total) {
        float acc = part[e0 + tid];
        for (int gg = 0; gg < groups; ++gg) acc += red[gg * per_pass + tid];
        part[e0 + tid] = acc;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  float* mine = scratch + static_cast<long long>(blockIdx.x) * e_total;
  for (int e = tid; e < e_total; e += kThreads) mine[e] = part[e];
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  __threadfence();
  for (int e = tid; e < e_total; e += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b)
      acc += __ldcg(scratch + static_cast<long long>(b) * e_total + e);
    g[e] = acc;
  }
  if (tid == 0) *ticket = 0u;
}

}  // namespace

// u (n x k, contiguous f32), g (k x k f32), scratch (max_blocks * k * k f32),
// ticket (one uint32, 0 between calls).
extern "C" int gram_f32(const void* u, void* g, void* scratch, void* ticket,
                        int n, int k, int max_blocks, void* stream) {
  if (n < 0 || k < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  static int opt_in = 0;  // the same on every H100
  if (opt_in == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&opt_in, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  if (smem > static_cast<size_t>(opt_in))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t attr_bytes = 48 * 1024;
  if (smem > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = smem;
  }
  const int rows = rows_per_block(k);
  int grid = (n + rows - 1) / rows;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) grid = 1;
  const int rows_each = n > 0 ? (n + grid - 1) / grid : 0;
  gram_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(g),
      static_cast<float*>(scratch), static_cast<unsigned int*>(ticket), n, k,
      rows_each, chunk_rows(k));
  return static_cast<int>(cudaGetLastError());
}
