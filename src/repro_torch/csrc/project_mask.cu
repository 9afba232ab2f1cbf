// The relu + top-t epilogue of an ALS half-step, in one launch: the
// bisection threshold tau and the mask out = (y >= tau ? y : 0) of
// y = relu(x), for a factor x of numel f32.
//
// Replaces the Pallas TPU kernel repro/kernels/project_mask.py::
// _project_mask_kernel (launched by _project_mask_impl: the mask, with tau
// given) and, with it, the 40-step bisection that repro/core/topk.py::
// FusedReluTopK runs around it, which XLA fused into the ALS scan.  Run
// eagerly, that bisection was ~290 small launches per epilogue.
//
// What bounds it: the bytes are one read of x and one write of out (0.8 MB
// for PubMed's U, 20,112 x 5), a fraction of a microsecond at 3.35 TB/s.
// What sets the time is the chain of dependent count rounds: each round's
// midpoint needs the whole factor's count at the previous one.  So the
// design keeps the factor on chip for the whole search, and makes each
// round as short as the chip allows: one block-level reduction and one
// barrier across the blocks that share the factor.
//
// Design (search mode, relu_topk_f32):
//  * Cluster exchange, for a factor that fits in the shared memory of the
//    largest cluster the card places (16 blocks, non-portable, where a GPC
//    has 16 free SMs): one thread-block cluster per call.  Block r owns the
//    contiguous slice [r * slice, (r + 1) * slice) and loads relu(x) of it
//    into shared memory once, up to 227 KB a block; the cluster size grows
//    with numel (kTargetSlice floats a block).  Counts travel through
//    distributed shared memory: warp 0 writes the block's integers into
//    every peer's shared memory, two rounds of slots deep, and one cluster
//    barrier (arrive.release / wait.acquire) publishes them.
//  * Grid exchange, for a larger factor: one block per SM (a cooperative
//    launch, so all of them are resident), each keeping as much of its
//    slice as its shared memory holds and re-reading the rest from global
//    memory (L2 up to 50 MB, else HBM) in every round, so the whole card's
//    bandwidth streams it.  Counts travel through a global scratch: warp 0
//    writes the block's integers into its row, two rounds deep, and one
//    grid barrier (an arrival counter, released and acquired at gpu scope)
//    publishes them.  The last block out resets the counter for the next
//    call, in stream order; a barrier that never completes traps.
//  * Round 0: the largest |relu(x)| of every slice as integer bits (the
//    values are >= +0 or NaN, so integer order is float order and a NaN
//    wins, as torch.max propagates it): hi = that, lo = 0.
//  * Every later round resolves kSteps bisection steps.  Each block counts,
//    for all 2^kSteps - 1 midpoints of the next steps (a heap-ordered tree:
//    node j's children 2j+1 when the count at its midpoint exceeds t, 2j+2
//    when not) and for the round's incoming hi, the relu'd values >= each.
//    Warp sums (__reduce_add_sync) and a block sum give integers; after the
//    exchange every block adds all blocks' counts and walks the same steps.
//    Integer counts: no float atomics, no host, and every block holds the
//    same lo and hi.
//  * Midpoints are __fmul_rn(0.5f, __fadd_rn(lo, hi)), PyTorch's two
//    rounded ops with no FMA contraction, so tau is bitwise the plain
//    bisection's; count(y >= hi) at the end is the incoming hi's count of
//    the last round or the count at the midpoint hi took.
//  * Rounds: 1 + max(1, ceil(num_steps / kSteps)) barriers in all.
//  * Last, every block writes its masked slice (from shared memory where it
//    is resident) and block 0 writes tau.
//  * relu is torch.clamp_min's on the card (NaN stays NaN), so a NaN input
//    (a failed Cholesky, by design) gives the plain version's tau and out.
//
// Mask mode (project_mask_f32): tau is given; a grid of blocks applies the
// mask, one contiguous slice each, with 16-byte loads and stores.
//
// x must be contiguous; it is read with 16-byte loads where it is 16-byte
// aligned and with 4-byte loads otherwise.  out must be 16-byte aligned.
// Calls in grid mode share the device's scratch, so they must not run
// concurrently on two streams.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// bisection steps one count round resolves: 2^kSteps - 1 midpoints and the
// incoming hi are counted (measured on the H100 against 1, 2 and 4)
constexpr int kSteps = 3;
constexpr int kMids = (1 << kSteps) - 1;
constexpr int kCounts = kMids + 1;
static_assert(32 % kCounts == 0, "a warp adds the counts column-wise");
// floats a block of the cluster aims to hold: more blocks shorten each
// round's count, at the price of a wider cluster barrier
constexpr long long kTargetSlice = 8192;
constexpr int kMaskBlocksPerSm = 4;
constexpr int kMaskMinSlice = 4 * 4 * kThreads;
// grid barrier: polls of the arrival counter before the kernel traps
constexpr unsigned int kMaxPolls = 1u << 28;

// the kernel template's three functions
constexpr int kMask = 0;     // the mask with tau given
constexpr int kCluster = 1;  // the search, exchanged in one cluster
constexpr int kGrid = 2;     // the search, exchanged across the grid

struct Args {
  const float* x;
  float* out;
  float* tau;  // search mode: written by block 0; mask mode: read
  // grid exchange: [0] barrier arrivals and [1] exit tickets (0 between
  // calls), then the counts, [2][blocks][kCounts]
  unsigned int* sync;
  long long numel;
  long long t;
  int num_steps;
  int slice;     // elements of x per block, a multiple of 4
  int resident;  // of them held in shared memory, a multiple of 4
  int vec;       // x is 16-byte aligned
};

// torch.clamp_min(v, 0) as PyTorch computes it on the card
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
}

__device__ __forceinline__ float mask(float y, float tau) {
  return y >= tau ? y : 0.f;
}

__device__ __forceinline__ float4 mask4(float4 y, float tau) {
  return make_float4(mask(y.x, tau), mask(y.y, tau), mask(y.z, tau),
                     mask(y.w, tau));
}

// |y| as bits: y is >= +0 (or -0) or NaN, so the integer maximum is the
// float maximum, with any NaN above every number
__device__ __forceinline__ unsigned int abs_bits(float y) {
  return __float_as_uint(y) & 0x7fffffffu;
}

// Visits relu(p[0, n)): quad(y4, i) for every whole quad at i when p is
// 16-byte aligned, one(y, i) for the elements left (all of them when it is
// not).  The block's threads take neighbouring quads.
template <class Quad, class One>
__device__ __forceinline__ void visit(const float* __restrict__ p, int n,
                                      bool vec, Quad&& quad, One&& one) {
  int i0 = 0;
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const int nq = n >> 2;
#pragma unroll 4
    for (int q = threadIdx.x; q < nq; q += kThreads)
      quad(relu4(__ldg(p4 + q)), 4 * q);
    i0 = nq << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads)
    one(relu(__ldg(p + i)), i);
}

__device__ __forceinline__ void count1(unsigned int (&c)[kCounts],
                                       const float (&th)[kCounts], float y) {
#pragma unroll
  for (int j = 0; j < kCounts; ++j) c[j] += y >= th[j] ? 1u : 0u;
}

__device__ __forceinline__ void count4(unsigned int (&c)[kCounts],
                                       const float (&th)[kCounts], float4 y) {
#pragma unroll
  for (int j = 0; j < kCounts; ++j)
    c[j] += (y.x >= th[j] ? 1u : 0u) + (y.y >= th[j] ? 1u : 0u) +
            (y.z >= th[j] ? 1u : 0u) + (y.w >= th[j] ? 1u : 0u);
}

// Cluster barrier halves (not .aligned: warp 0 may arrive from a branch).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The n-th grid barrier of this call: every block's writes before it are
// seen by every block after it.
__device__ __forceinline__ void grid_sync(unsigned int* arrivals,
                                          unsigned int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrivals, 1u);
    const unsigned int target = n * gridDim.x;
    unsigned int polls = 0;
    while (load_acquire(arrivals) < target)
      if (++polls == kMaxPolls) __trap();
  }
  __syncthreads();
}

// Lane j of the warp gets the sum of v over the lanes j, j + kCounts, ...
__device__ __forceinline__ unsigned long long column_sum(
    unsigned long long v) {
#pragma unroll
  for (int off = kCounts; off < 32; off *= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The exchange of one round: warp 0 publishes the block's kCounts values
// (lane j holds value j) to every block, then all blocks meet.
template <int M>
struct Exchange {
  unsigned int (*xch)[kMaxCluster][kCounts];  // cluster: shared, per buffer
  unsigned int* counts;                       // grid: global, per buffer
  unsigned int* arrivals;
  unsigned int rank;
  int nranks;
  unsigned int barriers;

  __device__ __forceinline__ void publish(int buf, int lane,
                                          unsigned int v) const {
    if constexpr (M == kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int r = 0; r < nranks; ++r)
        if (lane < kCounts)
          *cluster.map_shared_rank(&xch[buf][rank][lane], r) = v;
    } else {
      if (lane < kCounts)
        __stcg(counts + (static_cast<size_t>(buf) * nranks + rank) *
                            kCounts + lane, v);
    }
  }

  __device__ __forceinline__ void meet() {
    if constexpr (M == kCluster)
      cluster_sync();
    else
      grid_sync(arrivals, ++barriers);
  }

  // value j of rank r
  __device__ __forceinline__ unsigned int read(int buf, int r, int j) const {
    if constexpr (M == kCluster)
      return xch[buf][r][j];
    else
      return __ldcg(counts + (static_cast<size_t>(buf) * nranks + r) *
                                 kCounts + j);
  }
};

template <int M>
__device__ __forceinline__ void search(const Args& a) {
  extern __shared__ float4 ys4[];  // relu'd resident part of the slice
  float* ys = reinterpret_cast<float*>(ys4);
  __shared__ unsigned int wpart[kWarps][kCounts];
  // grid: the warps' column sums of one round's counts
  __shared__ unsigned long long csum[kWarps][kCounts];

  Exchange<M> ex{};
  if constexpr (M == kCluster) {
    __shared__ unsigned int xch[2][kMaxCluster][kCounts];
    cg::cluster_group cluster = cg::this_cluster();
    ex.xch = xch;
    ex.rank = cluster.block_rank();
    ex.nranks = static_cast<int>(cluster.num_blocks());
    // the peers' first remote write into this block waits for this arrival
    cluster_arrive_relaxed();
  } else {
    ex.counts = a.sync + 2;
    ex.arrivals = a.sync;
    ex.rank = blockIdx.x;
    ex.nranks = static_cast<int>(gridDim.x);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = a.vec != 0;

  const long long begin = static_cast<long long>(ex.rank) * a.slice;
  const int n_here =
      begin >= a.numel
          ? 0
          : static_cast<int>(min(static_cast<long long>(a.slice),
                                 a.numel - begin));
  const int n_res = min(n_here, a.resident);
  const int n_str = n_here - n_res;
  const float* xs = a.x + begin + n_res;  // the part read every round

  // ---- round 0: load, and the largest |relu(x)| ----------------------------
  unsigned int mbits = 0;
  visit(
      a.x + begin, n_res, vec,
      [&](float4 y, int i) {
        ys4[i >> 2] = y;
        mbits = max(mbits, max(max(abs_bits(y.x), abs_bits(y.y)),
                               max(abs_bits(y.z), abs_bits(y.w))));
      },
      [&](float y, int i) {
        ys[i] = y;
        mbits = max(mbits, abs_bits(y));
      });
  // NaN in the last quad's unused lanes: it never counts
  if (threadIdx.x < ((4 - (n_res & 3)) & 3))
    ys[n_res + threadIdx.x] = __uint_as_float(0x7fc00000u);
  visit(
      xs, n_str, vec,
      [&](float4 y, int) {
        mbits = max(mbits, max(max(abs_bits(y.x), abs_bits(y.y)),
                               max(abs_bits(y.z), abs_bits(y.w))));
      },
      [&](float y, int) { mbits = max(mbits, abs_bits(y)); });
  mbits = __reduce_max_sync(0xffffffffu, mbits);
  if (lane == 0) wpart[warp][0] = mbits;
  __syncthreads();
  if constexpr (M == kCluster) cluster_wait();  // every peer has started
  if (warp == 0) {
    const unsigned int v = __reduce_max_sync(
        0xffffffffu, lane < kWarps ? wpart[lane][0] : 0u);
    ex.publish(0, lane, v);
  }
  ex.meet();
  unsigned int hbits = 0;
  for (int r = lane; r < ex.nranks; r += 32) hbits = max(hbits, ex.read(0, r, 0));
  hbits = __reduce_max_sync(0xffffffffu, hbits);

  // ---- bisection rounds, kSteps steps each --------------------------------
  float lo = 0.f;
  float hi = __uint_as_float(hbits);
  unsigned long long c_hi = 0;  // count(y >= hi)
  int left = a.num_steps;
  int buf = 1;
  do {
    const int s = left < kSteps ? left : kSteps;
    float th[kCounts];
    {
      float nlo[kMids], nhi[kMids];
      nlo[0] = lo;
      nhi[0] = hi;
#pragma unroll
      for (int j = 0; j < kMids; ++j) {
        th[j] = __fmul_rn(0.5f, __fadd_rn(nlo[j], nhi[j]));
        if (2 * j + 2 < kMids) {
          nlo[2 * j + 1] = th[j];  // count > t: lo = mid
          nhi[2 * j + 1] = nhi[j];
          nlo[2 * j + 2] = nlo[j];  // count <= t: hi = mid
          nhi[2 * j + 2] = th[j];
        }
      }
      th[kMids] = hi;
    }
    unsigned int c[kCounts];
#pragma unroll
    for (int j = 0; j < kCounts; ++j) c[j] = 0;
    const int nq = (n_res + 3) >> 2;
    for (int q = threadIdx.x; q < nq; q += kThreads) count4(c, th, ys4[q]);
    visit(
        xs, n_str, vec, [&](float4 y, int) { count4(c, th, y); },
        [&](float y, int) { count1(c, th, y); });
#pragma unroll
    for (int j = 0; j < kCounts; ++j) {
      const unsigned int v = __reduce_add_sync(0xffffffffu, c[j]);
      if (lane == 0) wpart[warp][j] = v;
    }
    __syncthreads();
    if (warp == 0) {
      // lane j publishes count j, the block's sum over its warps
      unsigned int v = 0;
      if (lane < kCounts)
        for (int w = 0; w < kWarps; ++w) v += wpart[w][lane];
      ex.publish(buf, lane, v);
    }
    ex.meet();
    // every warp ends with the cluster's or grid's count j in lane j, and
    // walks the same steps
    unsigned long long cj = 0;
    if constexpr (M == kCluster) {
      // lanes j, j + kCounts, ... add column j over the ranks
      for (int r = lane / kCounts; r < ex.nranks; r += 32 / kCounts)
        cj += ex.read(buf, r, lane % kCounts);
      cj = column_sum(cj);
    } else {
      // the block's threads share the loads from L2 (a few each), then
      // add the warps' column sums
      for (int r = threadIdx.x / kCounts; r < ex.nranks;
           r += kThreads / kCounts)
        cj += ex.read(buf, r, threadIdx.x % kCounts);
      cj = column_sum(cj);
      if (lane < kCounts) csum[warp][lane] = cj;
      __syncthreads();
      cj = 0;
      if (lane < kCounts)
        for (int w = 0; w < kWarps; ++w) cj += csum[w][lane];
    }
    c_hi = __shfl_sync(0xffffffffu, cj, kMids);
    int node = 0;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      if (step < s) {
        float mid = th[0];
#pragma unroll
        for (int j = 1; j < kMids; ++j)
          if (j == node) mid = th[j];
        const unsigned long long cn = __shfl_sync(0xffffffffu, cj, node);
        if (static_cast<long long>(cn) > a.t) {
          lo = mid;
          node = 2 * node + 1;
        } else {
          hi = mid;
          c_hi = cn;
          node = 2 * node + 2;
        }
      }
    }
    left -= s;
    buf ^= 1;
  } while (left > 0);
  const float tau = static_cast<long long>(c_hi) >= a.t ? hi : lo;
  if constexpr (M == kGrid) {
    // past its last barrier: the last block out resets the scratch
    if (threadIdx.x == 0 &&
        atomicAdd(a.sync + 1, 1u) == gridDim.x - 1) {
      atomicExch(a.sync, 0u);
      atomicExch(a.sync + 1, 0u);
    }
  }

  // ---- the mask ------------------------------------------------------------
  float* out = a.out + begin;
  const int nfull = n_res >> 2;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int q = threadIdx.x; q < nfull; q += kThreads)
    out4[q] = mask4(ys4[q], tau);
  for (int i = 4 * nfull + threadIdx.x; i < n_res; i += kThreads)
    out[i] = mask(ys[i], tau);
  float* outs = out + n_res;
  visit(
      xs, n_str, vec,
      [&](float4 y, int i) {
        *reinterpret_cast<float4*>(outs + i) = mask4(y, tau);
      },
      [&](float y, int i) { outs[i] = mask(y, tau); });
  if (ex.rank == 0 && threadIdx.x == 0) *a.tau = tau;
}

__device__ __forceinline__ void apply_mask(const Args& a) {
  const long long begin = static_cast<long long>(blockIdx.x) * a.slice;
  if (begin >= a.numel) return;
  const int n = static_cast<int>(
      min(static_cast<long long>(a.slice), a.numel - begin));
  const float tau = __ldg(a.tau);
  float* out = a.out + begin;
  visit(
      a.x + begin, n, a.vec != 0,
      [&](float4 y, int i) {
        *reinterpret_cast<float4*>(out + i) = mask4(y, tau);
      },
      [&](float y, int i) { out[i] = mask(y, tau); });
}

// One template, two functions: the whole epilogue (kCluster, kGrid) and
// the mask with tau given (kMask, a grid of plain blocks).
template <int M>
__global__ void __launch_bounds__(kThreads, 1) relu_topk_kernel(const Args a) {
  if constexpr (M == kMask)
    apply_mask(a);
  else
    search<M>(a);
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return 0;
  return v;
}

long long round4(long long v) { return (v + 3) / 4 * 4; }

struct Limits {
  int dyn;     // dynamic shared memory a block may take, bytes
  int blocks;  // cluster: the largest cluster the card places at dyn;
               // grid: one block per SM
};

// Once per exchange: opt in to the whole shared memory (and, for the
// cluster, to clusters of 16), and find how many blocks can share a factor.
template <int M>
cudaError_t limits(Limits* out) {
  static cudaError_t status = cudaErrorNotReady;
  static Limits lim{};
  if (status == cudaErrorNotReady) {
    auto kern = relu_topk_kernel<M>;
    cudaFuncAttributes attr{};
    status = cudaFuncGetAttributes(&attr, kern);
    if (status != cudaSuccess) return status;
    const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
    lim.dyn = (optin - static_cast<int>(attr.sharedSizeBytes)) / 16 * 16;
    if (lim.dyn < 16) return status = cudaErrorInvalidValue;
    status = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lim.dyn);
    if (status != cudaSuccess) return status;
    if constexpr (M == kGrid) {
      lim.blocks = device_attr(cudaDevAttrMultiProcessorCount);
    } else {
      status = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (status != cudaSuccess) return status;
      for (int c = kMaxCluster; c >= 1 && lim.blocks == 0; c /= 2) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute at[1];
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = c;
        at[0].val.clusterDim.y = 1;
        at[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(c);
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = lim.dyn;
        cfg.attrs = at;
        cfg.numAttrs = 1;
        int n = 0;
        if (cudaOccupancyMaxActiveClusters(
                &n, reinterpret_cast<const void*>(kern), &cfg) ==
                cudaSuccess &&
            n > 0)
          lim.blocks = c;
      }
      cudaGetLastError();  // a refused query leaves its error behind
    }
    status = lim.blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
  }
  *out = lim;
  return status;
}

struct Plan {
  int blocks, grid, slice, resident;
  size_t smem;
};

// The cluster when the factor fits in its shared memory, else the grid.
cudaError_t plan(long long numel, Plan* p) {
  Limits cl{}, gr{};
  cudaError_t err = limits<kCluster>(&cl);
  if (err != cudaSuccess) return err;
  const long long cl_cap = cl.dyn / 16 * 4;  // floats a block holds
  long long cap = cl_cap;
  int blocks = 1;
  p->grid = numel > cl.blocks * cl_cap;
  if (p->grid) {
    err = limits<kGrid>(&gr);
    if (err != cudaSuccess) return err;
    blocks = gr.blocks;
    cap = gr.dyn / 16 * 4;
  } else {
    while (blocks < cl.blocks &&
           (blocks * kTargetSlice < numel || blocks * cl_cap < numel))
      blocks *= 2;
  }
  const long long slice = round4((numel + blocks - 1) / blocks);
  if (slice > (1ll << 30)) return cudaErrorInvalidValue;
  p->blocks = blocks;
  p->slice = static_cast<int>(slice);
  p->resident = static_cast<int>(slice < cap ? slice : cap);
  p->smem = sizeof(float) * (p->resident > 4 ? p->resident : 4);
  return cudaSuccess;
}

cudaError_t launch_search(const Args& a, const Plan& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  if (p.grid) {
    at[0].id = cudaLaunchAttributeCooperative;
    at[0].val.cooperative = 1;
  } else {
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = p.blocks;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
  }
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return p.grid ? cudaLaunchKernelEx(&cfg, relu_topk_kernel<kGrid>, a)
                : cudaLaunchKernelEx(&cfg, relu_topk_kernel<kCluster>, a);
}

}  // namespace

// The launch plan of relu_topk_f32 for numel floats: plan[0] the blocks
// that share the factor, plan[1] 1 when they exchange across the grid (0:
// in one cluster), plan[2] the slice a block owns, plan[3] the part of it
// resident in shared memory (less than the slice: the rest is re-read
// every round), plan[4] the dynamic shared memory a block takes, in bytes.
extern "C" int relu_topk_plan(long long numel, int* plan_out) {
  if (numel < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  const cudaError_t err = plan(numel, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_out[0] = p.blocks;
  plan_out[1] = p.grid;
  plan_out[2] = p.slice;
  plan_out[3] = p.resident;
  plan_out[4] = static_cast<int>(p.smem);
  return 0;
}

// x (numel f32, contiguous), out (numel f32, 16-byte aligned), tau (one
// f32, written), sync (sync_words u32, zero between calls: the grid
// exchange's scratch, 2 + 2 * SMs * 8 words).
extern "C" int relu_topk_f32(const void* x, void* out, void* tau, void* sync,
                             long long sync_words, long long numel,
                             long long t, int num_steps, void* stream) {
  if (numel < 1 || num_steps < 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  cudaError_t err = plan(numel, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.grid && sync_words < 2 + 2ll * p.blocks * kCounts)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.tau = static_cast<float*>(tau);
  a.sync = static_cast<unsigned int*>(sync);
  a.numel = numel;
  a.t = t;
  a.num_steps = num_steps;
  a.slice = p.slice;
  a.resident = p.resident;
  a.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  err = launch_search(a, p, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x (numel f32, contiguous), tau (one f32), out (numel f32, 16-byte
// aligned): out = (relu(x) >= tau ? relu(x) : 0).
extern "C" int project_mask_f32(const void* x, const void* tau, void* out,
                                long long numel, void* stream) {
  if (numel < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int n_sm = 0;  // the same on every H100
  if (n_sm == 0) n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  if (n_sm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  long long grid = (numel + kMaskMinSlice - 1) / kMaskMinSlice;
  if (grid > static_cast<long long>(kMaskBlocksPerSm) * n_sm)
    grid = static_cast<long long>(kMaskBlocksPerSm) * n_sm;
  const long long slice = round4((numel + grid - 1) / grid);
  if (slice > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.tau = const_cast<float*>(static_cast<const float*>(tau));
  a.numel = numel;
  a.slice = static_cast<int>(slice);
  a.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  relu_topk_kernel<kMask><<<static_cast<unsigned int>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
