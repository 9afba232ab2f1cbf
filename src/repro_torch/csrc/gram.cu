// Gram matrix G = U^T U of a tall, skinny f32 or bf16 U (n x k), in one
// launch, for any k; G is f32 either way.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::_gram_kernel
// (launched by _gram_impl), which streamed (bm, k) row slabs through VMEM
// and accumulated into one k x k output across its sequential grid.
//
// What bounds it: at PubMed size (20,112 x 5 f32) one read of U, 0.4 MB,
// about 0.0001 ms at 3.35 TB/s, so a call costs what the host takes to
// launch it.  At k = 256 the 2 n k^2 f32 operations bound it instead
// (2.6 GFLOP at 20,112 rows, ~0.04 ms at 67 TFLOP/s).  The design keeps to
// one launch per call: no memset, no second pass, and the wrapper
// allocates only G.
//
// Design:
//  * bf16 entries are widened to f32 as they are staged in shared memory, and
//    every product and sum is an f32 FMA, as for f32 input.
//  * Up to k = kSingleMaxK one block's k x k partial fits in shared memory
//    and the kernel is gram_kernel below (the one-tile kernel from before
//    tiling, so its results at these k are bitwise what they were).  grid =
//    min(max_blocks, ceil(n / rows_per_block)) blocks of kThreads,
//    max_blocks being the card's SM count and rows_per_block
//    max(64, 32768 / k^2).  Block b reduces its rows into a k x k f32
//    partial in shared memory.  A chunk of rows is one contiguous span of
//    U, staged in shared memory by coalesced loads.  With E = k^2 entries,
//    each pass over the chunk takes min(E, kThreads) entries and splits
//    the rows among kThreads / min(E, kThreads) thread groups (10 groups
//    of 25 at k = 5); the group sums are added to the partial in group
//    order.
//  * Above it G is cut into kTile x kTile output tiles, and only the tiles
//    on and above the diagonal are computed (G is symmetric: an
//    off-diagonal tile is written to both of its places): gram_tiled_kernel,
//    grid = (row blocks, tiles), row blocks = ceil(max_blocks / tiles) so
//    the grid is about one block per SM.  Block (b, t) stages kTiledRows
//    rows of its tile's row and column panels (zero past U's width) in
//    shared memory; each thread keeps an 8 x 8 piece of the tile in
//    registers (rows and columns {4 ty .. 4 ty + 3, 64 + 4 ty .. 64 + 4 ty
//    + 3}, so the float4 loads of a quarter warp hit 8 distinct banks) and
//    adds the rows in order: 16 shared loads for 64 FMAs.  The tile's last
//    block sums the partials 16 float4 slots a thread at a time.
//  * Either way each block's partial goes to scratch[t][b].  After
//    __threadfence() each block takes tile t's integer ticket with
//    atomicAdd; the block that takes the last one sums tile t's partials in
//    block order, writes the tile of G and resets the ticket to 0 for the
//    next call (so the tickets are set to 0 once, when the wrapper creates
//    them).  No float atomics: for a given n, k and SM count the result is
//    bitwise the same from run to run.
//  * Calls that share tickets and scratch must be ordered, as calls on one
//    stream are.
//  * n = 0 launches one row block per tile, which writes G = 0.
//
// C interface (loaded with ctypes): gram_plan reports the tile width, the
// tile count and the scratch a call needs; gram_f32 launches on the given
// stream, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for bad arguments; gram_bf16 is the same for a
// bf16 U.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kThreads = 256;
constexpr int kChunkFloats = 4096;  // staged rows of U, 16 KB (one tile)
constexpr int kSingleMaxK = 224;    // one tile covers G up to this k
constexpr int kTile = 128;          // tile width above it
constexpr int kTiledRows = 32;      // staged rows of a tile's panels

struct Plan {
  int tile;    // T
  int panels;  // ceil(k / T)
  int tiles;   // panels * (panels + 1) / 2: the tiles on and above the diagonal
};

Plan plan_of(int k) {
  if (k <= kSingleMaxK) return {k, 1, 1};
  const int p = (k + kTile - 1) / kTile;
  return {kTile, p, p * (p + 1) / 2};
}

int rows_per_block(int k) {
  const int per = 32768 / (k * k);
  return per > 64 ? per : 64;
}

int chunk_rows(int k) { return k < kChunkFloats ? kChunkFloats / k : 1; }

size_t smem_bytes(int k) {
  return sizeof(float) *
         (static_cast<size_t>(k) * k + kThreads + chunk_rows(k) * k);
}

// True in the block that takes the ticket's last count (its partial and
// every other's are then visible to it); the others go on to return.
__device__ bool last_block(unsigned int* ticket) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ u, float* __restrict__ g,
            float* __restrict__ scratch, unsigned int* __restrict__ ticket,
            int n, int k, int rows, int chunk) {
  extern __shared__ float smem[];
  const int e_total = k * k;
  float* part = smem;               // [E]: this block's partial
  float* red = part + e_total;      // [kThreads]: group sums of a pass
  float* buf = red + kThreads;      // [chunk][k]: staged rows of U

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
    const T* src = u + static_cast<long long>(c0) * k;
    for (int x = tid; x < nrow * k; x += kThreads) buf[x] = to_f32(src[x]);
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
  if (!last_block(ticket)) return;

  for (int e = tid; e < e_total; e += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b)
      acc += __ldcg(scratch + static_cast<long long>(b) * e_total + e);
    g[e] = acc;
  }
  if (tid == 0) *ticket = 0u;
}

// column (or row) of a tile held by slot q in 0..7 of thread coordinate c
__device__ __forceinline__ int micro_index(int c, int q) {
  return q < 4 ? 4 * c + q : 64 + 4 * c + (q - 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_tiled_kernel(const T* __restrict__ u, float* __restrict__ g,
                  float* __restrict__ scratch,
                  unsigned int* __restrict__ tickets, int n, int k, int rows,
                  int panels) {
  __shared__ __align__(16) float pi[kTiledRows][kTile];
  __shared__ __align__(16) float pj[kTiledRows][kTile];

  // tile t -> (ti, tj), ti <= tj, row by row over the upper triangle
  const int t = blockIdx.y;
  int ti = 0, rem = t;
  while (rem >= panels - ti) {
    rem -= panels - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int ni = min(kTile, k - i0), nj = min(kTile, k - j0);
  const bool diag = ti == tj;
  float (*qj)[kTile] = diag ? pi : pj;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  const int r_begin = blockIdx.x * rows;
  const int r_end = min(n, r_begin + rows);
  for (int c0 = r_begin; c0 < r_end; c0 += kTiledRows) {
    const int nrow = min(kTiledRows, r_end - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int x = tid; x < nrow * kTile; x += kThreads) {
      const int r = x / kTile;
      const int c = x - r * kTile;
      const T* row = u + static_cast<long long>(c0 + r) * k;
      pi[r][c] = c < ni ? to_f32(row[i0 + c]) : 0.f;
      if (!diag) pj[r][c] = c < nj ? to_f32(row[j0 + c]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nrow; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(&pi[r][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&pi[r][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&qj[r][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&qj[r][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }

  constexpr int kStride = kTile * kTile;
  float* mine = scratch + (static_cast<long long>(t) * gridDim.x + blockIdx.x) *
                              kStride;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float* out = mine + micro_index(ty, a) * kTile;
    *reinterpret_cast<float4*>(out + 4 * tx) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    *reinterpret_cast<float4*>(out + 64 + 4 * tx) =
        make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
  }
  if (!last_block(tickets + t)) return;

  // the tile's partials are in L2: each thread sums 16 float4 slots of
  // them at once (64 KB of loads in flight in the block), in block order
  constexpr int kSlots = kStride / 4 / kThreads;
  const float4* parts = reinterpret_cast<const float4*>(
      scratch + static_cast<long long>(t) * gridDim.x * kStride);
  float4 sum[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
    const float4* part = parts + static_cast<long long>(b) * (kStride / 4);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const float4 x = __ldcg(part + q * kThreads + tid);
      sum[q].x += x.x;
      sum[q].y += x.y;
      sum[q].z += x.z;
      sum[q].w += x.w;
    }
  }
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int e = 4 * (q * kThreads + tid);
    const int i = e / kTile, j = e % kTile;
    const float v[4] = {sum[q].x, sum[q].y, sum[q].z, sum[q].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (i >= ni || j + c >= nj) continue;
      g[static_cast<long long>(i0 + i) * k + j0 + j + c] = v[c];
      if (!diag) g[static_cast<long long>(j0 + j + c) * k + i0 + i] = v[c];
    }
  }
  if (tid == 0) tickets[t] = 0u;
}

}  // namespace

// The tile width, the number of tiles (one ticket each) and the scratch
// floats of a call at this k on a card of max_blocks SMs.
extern "C" int gram_plan(int k, int max_blocks, int* tile, int* tiles,
                         long long* scratch_floats) {
  if (k < 1 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_of(k);
  *tile = p.tile;
  *tiles = p.tiles;
  // one partial per (row block, tile); the tiled grid has
  // ceil(max_blocks / tiles) row blocks at most
  const long long blocks = p.tiles > 1
      ? static_cast<long long>(p.tiles) * ((max_blocks + p.tiles - 1) / p.tiles)
      : max_blocks;
  *scratch_floats = blocks * p.tile * p.tile;
  return 0;
}

namespace {

template <typename T>
int launch(const void* u, void* g, void* scratch, void* tickets, int n, int k,
           int max_blocks, void* stream) {
  if (n < 0 || k < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_of(k);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto uf = static_cast<const T*>(u);
  const auto gf = static_cast<float*>(g);
  const auto sf = static_cast<float*>(scratch);
  const auto tk = static_cast<unsigned int*>(tickets);
  if (p.tiles > 1) {
    int grid = (max_blocks + p.tiles - 1) / p.tiles;
    const int most = (n + kTiledRows - 1) / kTiledRows;
    if (grid > most) grid = most;
    if (grid < 1) grid = 1;
    const int rows_each = n > 0 ? (n + grid - 1) / grid : 0;
    gram_tiled_kernel<T><<<dim3(grid, p.tiles), kThreads, 0, st>>>(
        uf, gf, sf, tk, n, k, rows_each, p.panels);
    return static_cast<int>(cudaGetLastError());
  }
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
  static size_t attr_bytes = 48 * 1024;  // per element type
  if (smem > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = smem;
  }
  const int rows = rows_per_block(k);
  int grid = (n + rows - 1) / rows;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) grid = 1;
  const int rows_each = n > 0 ? (n + grid - 1) / grid : 0;
  gram_kernel<T><<<grid, kThreads, smem, st>>>(uf, gf, sf, tk, n, k,
                                              rows_each, chunk_rows(k));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u (n x k, contiguous f32), g (k x k f32), scratch (gram_plan's floats),
// tickets (gram_plan's tiles uint32, 0 between calls).
extern "C" int gram_f32(const void* u, void* g, void* scratch, void* tickets,
                        int n, int k, int max_blocks, void* stream) {
  return launch<float>(u, g, scratch, tickets, n, k, max_blocks, stream);
}

// As gram_f32 for a contiguous bf16 u; g is f32.
extern "C" int gram_bf16(const void* u, void* g, void* scratch, void* tickets,
                         int n, int k, int max_blocks, void* stream) {
  return launch<__nv_bfloat16>(u, g, scratch, tickets, n, k, max_blocks,
                               stream);
}
