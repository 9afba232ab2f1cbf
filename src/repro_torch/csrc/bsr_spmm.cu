// Block-sparse (BSR) products for Hopper: Y = A @ U, and the fused
// (A @ U, U^T U) of one ALS half-step, in f32 or bf16.
//
// Replaces the Pallas TPU kernels repro/kernels/bsr_spmm.py::_spmm_kernel
// (launched by _bsr_spmm_impl: grid (row-block, k-tile, slot), slot axis
// sequential, accumulating in the output block) and
// repro/kernels/fused.py::_spmm_gram_kernel (launched by bsr_spmm_gram: the
// same sweep plus a k x k Gram accumulator fed by first-occurrence slabs).
//
// A is stored as tiles (nrb, bcap, bm, bk) with block_cols (nrb, bcap)
// int32; U is (m, k) row-major; Y is (n, k); tiles, U and Y are all f32 or
// all bf16.  bf16 entries are widened to f32 and every product and sum is an
// f32 FMA (IEEE, no TF32); Y is rounded to bf16 once, at the end.  The
// fused kernel's Gram is f32 either way.
//
// What bounds it: every stored tile is read once per column chunk and each
// tile element feeds at most k multiply-adds, so at a small rank the kernel
// is bound by the bytes of the tiles: about 0.61 GB per orientation at the
// paper's PubMed size in f32, 0.18 ms at 3.35 TB/s (half that in bf16).  At
// a large rank the multiply-adds bound it (k = 256: 1.16 ms in f32), if the
// tiles are streamed few enough times.  U and Y stay in L2.
//
// Design:
//  * Stream split.  The (row-block, slot) pairs, flattened in row-block
//    order, are cut into equal runs (their lengths differ by at most one
//    slot), one run per block of a persistent grid of one block per SM; the
//    plan (run bounds, and the first and last run of every row-block) is
//    fixed on the host at ingest (kernels/bsr.py::split_plan).  A long
//    row-block (A^T at PubMed: 59 row-blocks of 158 slots) spans several
//    runs, so both orientations fill the card.  A factor wider than one
//    column chunk adds a grid dimension of chunks, each streaming the tiles
//    again.
//  * Column chunks (kb, chosen per shape by the tile ledger).  kb = 8, and
//    any rank up to 8: a consumer lane owns one quad of tile columns (4
//    consecutive j) of up to kMaxRows rows and the chunk's 8 columns, so a
//    row's dot products are split over the lanes and added at the end of the
//    row-block by one shuffle tree per (row, column).  kb = 32 or 64 (the
//    wide chunks): a register tile per lane, up to 5 whole rows by kb / 8
//    columns; the 8 lanes that share rows read a quad of a tile row once
//    (one shared-memory wavefront) and each reads a quad of slab rows of
//    its own columns (128 contiguous bytes for the 8), so a quad of j feeds
//    20 kb / 8 multiply-adds per lane for 5 + kb / 8 loads, with no lane
//    split and no shuffles, and the tiles are streamed k / kb times
//    instead of k / 8.  The two layouts add a row's products in different
//    orders, so the fused kernel takes the same kb as the plain one: their
//    Y stays bitwise equal.
//  * Tile ring.  One producer warp keeps up to kMaxStages stages in flight
//    in shared memory (as many as fit: three at PubMed's 128 x 128 f32
//    tiles).  A stage is one slot's whole tile, a contiguous run of bm * bk
//    entries, moved by one bulk copy (cp.async.bulk ...
//    mbarrier::complete_tx::bytes, no tensor map), and that slot's (bk, w)
//    U slab in f32: in f32 moved by 4-byte cp.async with zero fill for rows
//    at or past m (U is never padded), in bf16 loaded, widened and stored by
//    the producer lanes.  Both complete on the stage's full barrier: one
//    expect_tx arrival for the tile's bytes plus one arrival per producer
//    lane (cp.async.mbarrier.arrive.noinc once its copies land, or a plain
//    arrive after its stores).  The tile copies carry an L2 evict-first
//    hint.  Each consumer warp arrives on the stage's empty barrier once it
//    has read the stage; there is no __syncthreads in the loop.
//  * Consumers.  Seven warps read the tile with 16-byte (f32) or 8-byte
//    (bf16) shared loads of a quad of columns; the slab is stored per quad
//    of rows, 4 * (w | 1) floats apart, so neither layout's slab reads
//    conflict.  Sums stay in registers across the slots of a row-block.
//  * Deterministic fix-up.  A row-block that lies inside one run is written
//    to Y directly.  A row-block cut by a run boundary leaves each of its
//    runs' (bm, kc) f32 partial in scratch (a run has at most two: its
//    first and its last row-block); the run that takes the last integer
//    ticket of that row-block adds the partials in run order and writes Y,
//    then resets the ticket.  No float atomics: for a given plan and kb the
//    result is bitwise the same from run to run.
//  * The Gram rides along.  In the fused kernel the blocks of column chunk
//    0 hold the full-rank slab (w = k; the other chunks only their own
//    columns) and add the Gram:
//    when a slot carries its first-occurrence flag (fixed at ingest), the
//    block's consumers add slab^T slab into a k x k f32 partial in shared
//    memory: up to k = 32 four entries per warp at a time, each bk-long dot
//    product split across the lanes and added by a shuffle tree; above it
//    4 x 4 register blocks of the upper triangle, one thread a block, each
//    written to both its places.  The runs'
//    partials are added in run order by the run that takes the last Gram
//    ticket.  So the fused kernel takes a rank k while its k x k partial
//    and two stages of (tile, full-rank slab) fit the block's shared memory
//    (kernels/autotune.py::fused_working_set): k <= 75 at 128 x 128 f32
//    tiles, 149 at 128 x 64, 193 at 128 x 32; a k x k partial alone is
//    256 KB at k = 256, past any block's shared memory.  Past that the
//    backend takes the separate launches.  A flagged slot costs bk k^2 / 2
//    multiply-adds, and ingest flags the first occurrence of each column
//    block, which at PubMed sits in the first row-blocks: a few runs add
//    the whole Gram, so its time grows as k^2 on those blocks.
//  * The fused and the plain product share one template and one plan, so
//    their Y is bitwise equal at the same kb.
//
// Limits (the wrapper refuses anything else): bm <= 128, bk <= 128 with a
// tile row of whole 16-byte vectors (bk a multiple of 4 in f32, of 8 in
// bf16), tiles 16-byte aligned, kb one of 8, 32, 64, the fused kernel's
// working set within the block's shared memory.
//
// Calls that share one ticket and scratch buffer must be ordered, as calls
// on one stream are.  Given a (runs, 2) buffer, the kernels write each
// block's start and end (%globaltimer, ns) there: the spread of the ends is
// the tail of the split.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Eight warps in all, two on each of the SM's four schedulers, so that a
// thread may hold up to 255 registers (a ninth warp would cap it at 168).
constexpr int kConsumerWarps = 7;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // plus one producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxBm = 128;
constexpr int kMaxRows =                    // rows of a row-block per lane
    (kMaxBm + kConsumerWarps - 1) / kConsumerWarps;
constexpr int kMaxBk = 128;                 // 32 lanes x one quad
constexpr int kQuadCols = 8;        // the split layout's column chunk
constexpr int kHeader = 256;        // barriers and the fix-up flag
constexpr int kConsumerBarrier = 1; // named barrier of the consumers
constexpr int kGramBatch = 4;       // Gram entries a warp takes at once
constexpr int kWarpGramMaxK = 32;   // the per-warp Gram up to this rank
constexpr int kLoadBatch = 8;       // partials read at once in a fix-up

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ size_t round128(size_t x) {
  return (x + 127) / 128 * 128;
}

// floats between two quads of slab rows: odd in 16-byte units
__host__ __device__ __forceinline__ int slab_quad(int w) {
  return 4 * (w | 1);
}

// the column chunk of a launch: 8 for a rank of at most 8 or kb = 8
__host__ __device__ __forceinline__ int column_chunk(int k, int kb) {
  return k <= kQuadCols || kb <= kQuadCols ? kQuadCols : kb;
}

// Four consecutive entries of a tile row, widened to f32: `e` is the
// entry's index in the tile, a multiple of 4 (16-byte or 8-byte aligned).
__device__ __forceinline__ float4 quad_of(const float* tile, int e) {
  return *reinterpret_cast<const float4*>(tile + e);
}

__device__ __forceinline__ float4 quad_of(const bf16* tile, int e) {
  const uint2 r = *reinterpret_cast<const uint2*>(tile + e);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* tiles;
  const int* block_cols;
  const int* flags;
  const void* u;
  void* y;
  float* part;       // (runs, 2, bm, k): partials of cut row-blocks
  float* gram_part;  // (runs, k, k)
  float* gram;
  const int* bounds;   // (runs + 1): first slot of each run
  const int* rb_runs;  // (nrb, 2): first and last run of each row-block
  unsigned int* tickets;  // nrb * nchunks row-block tickets, then the Gram's
  unsigned long long* stamps;  // optional (runs, 2): block start and end, ns
  int n, m, k, nrb, bcap, bm, bk, runs, kb, chunk, nchunks, stages, lpr;
  unsigned int tile_bytes, slab_off, stage_bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of the given parity has completed.  A phase that
// never completes (a transaction count that does not match the bytes sent)
// traps after about 2^28 polls instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// One contiguous run of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`'s transaction count.  The tiles are read once, so
// they are marked first to go from L2, which keeps U, Y and the partials.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 policy;\n"
      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], policy;\n}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Four bytes, or four zero bytes when src_bytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async have landed; the
// barrier's count includes it (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(kConsumers)
               : "memory");
}

// Takes the ticket `t` of `count` arrivals for the block's consumers after
// they wrote their part; true in the block that took the last one (which
// resets the ticket for the next call).
__device__ __forceinline__ bool last_ticket(unsigned int* t, int count,
                                            volatile int* flag) {
  __threadfence();
  consumer_sync();
  if (threadIdx.x == 0) {
    const unsigned int old = atomicAdd(t, 1u);
    const bool last = old == static_cast<unsigned int>(count - 1);
    if (last) *t = 0u;
    *flag = last;
  }
  consumer_sync();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// s + p[0] + p[stride] + ... + p[(count - 1) * stride], added in that
// order, read from L2 in batches of kLoadBatch independent loads
__device__ __forceinline__ float sum_in_order(float s, const float* p,
                                              size_t stride, int count) {
  for (int i = 0; i < count; i += kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q)
      v[q] = i + q < count ? __ldcg(p + (i + q) * stride) : 0.f;
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q)
      if (i + q < count) s += v[q];
  }
  return s;
}

// The producer lanes' share of one slot's U slab: rows j = lane, lane + 32,
// ... of the column block, w columns from c0, zero at or past row m.  f32
// goes by cp.async and arrives on `full` once it lands; bf16 is loaded,
// widened and stored, then arrives.
template <typename T>
__device__ __forceinline__ void load_slab(const Args& a, unsigned char* slab,
                                          int cb, int c0, int w, int qs,
                                          int lane, uint32_t full) {
  const int row0 = cb * a.bk;
  const T* u = static_cast<const T*>(a.u);
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t s = smem_u32(slab);
    for (int j = lane; j < a.bk; j += 32) {
      const int row = row0 + j;
      const bool in = row < a.m;
      const float* src = u + (in ? static_cast<size_t>(row) * a.k + c0 : 0);
      const uint32_t d = s + 4 * ((j >> 2) * qs + (j & 3));
      for (int c = 0; c < w; ++c) cp_async4(d + 16 * c, src + c, in ? 4 : 0);
    }
    cp_async_arrive(full);
  } else {
    float* sl = reinterpret_cast<float*>(slab);
    for (int j = lane; j < a.bk; j += 32) {
      const int row = row0 + j;
      const bool in = row < a.m;
      const T* src = u + (in ? static_cast<size_t>(row) * a.k + c0 : 0);
      float* d = sl + (j >> 2) * qs + (j & 3);
      for (int c = 0; c < w; ++c)
        d[4 * c] = in ? __bfloat162float(src[c]) : 0.f;
    }
    mbar_arrive(full);
  }
}

// KC <= 8: the split layout (a lane owns a quad of tile columns, a chunk of
// 8 factor columns, KC of them live).  KC = 32 or 64: the wide layout, a
// register tile a lane: 8 lanes that share kTileRows rows each own KC / 8
// columns (cg, cg + 8, ...), so a quad of tile entries, read once by the 8
// lanes (one shared-memory wavefront), feeds KC / 8 columns, and a quad of
// slab rows of one column, read by 8 lanes as 128 contiguous bytes, feeds
// kTileRows rows.
template <typename T, int KC, bool kGram>
__global__ void __launch_bounds__(kThreads, 1) spmm_kernel(const Args a) {
  constexpr bool kWide = KC > kQuadCols;
  constexpr int kRowSlots = 4 * kConsumerWarps;       // 8-lane row groups
  constexpr int kTileRows = (kMaxBm + kRowSlots - 1) / kRowSlots;
  constexpr int kRows = kWide ? kTileRows : kMaxRows;  // rows a lane holds
  constexpr int kCols = kWide ? KC / 8 : KC;           // columns it holds
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  volatile int* flag = reinterpret_cast<volatile int*>(smem + 16 * kMaxStages);
  float* g_s = reinterpret_cast<float*>(smem + kHeader);
  unsigned char* ring =
      smem + kHeader + (kGram ? round128(sizeof(float) * a.k * a.k) : 0);

  const int r = blockIdx.x;
  const int ch = blockIdx.y;
  const int c0 = ch * a.chunk;
  const int kc = min(a.chunk, a.k - c0);
  const bool gram_block = kGram && ch == 0;
  // slab columns held: the full rank where the Gram is added (chunk 0, whose
  // columns start at 0), the chunk's own elsewhere
  const int w = gram_block ? a.k : kc;
  const int qs = slab_quad(w);
  const int s_begin = a.bounds[r];
  const int s_end = a.bounds[r + 1];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kk = a.k * a.k;
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + kMaxStages);
  T* y = static_cast<T*>(a.y);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 33);  // expect_tx + 32 producer lanes
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (gram_block)
    for (int e = threadIdx.x; e < kk; e += kThreads) g_s[e] = 0.f;
  __syncthreads();
  if (a.stamps != nullptr && threadIdx.x == 0 && ch == 0)
    a.stamps[2 * r] = global_ns();

  if (warp == kConsumerWarps) {
    // ---- producer warp: tile by bulk copy, slab by cp.async or stores -----
    const uint32_t ring_u32 = smem_u32(ring);
    const unsigned char* tiles = static_cast<const unsigned char*>(a.tiles);
    int cb_next = a.block_cols[s_begin];
    for (int it = 0, slot = s_begin; slot < s_end; ++it, ++slot) {
      const int st = it % a.stages;
      const int cb = cb_next;
      if (slot + 1 < s_end) cb_next = a.block_cols[slot + 1];
      const uint32_t full = full0 + 8 * st;
      mbar_wait(empty0 + 8 * st, ((it / a.stages) & 1) ^ 1);
      const uint32_t dst = ring_u32 + st * a.stage_bytes;
      if (lane == 0) {
        mbar_expect_tx(full, a.tile_bytes);
        bulk_copy(dst, tiles + static_cast<size_t>(slot) * a.tile_bytes,
                  a.tile_bytes, full);
      }
      load_slab<T>(a, ring + st * a.stage_bytes + a.slab_off, cb, c0, w, qs,
                   lane, full);
    }
    if constexpr (std::is_same<T, float>::value)
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warps ------------------------------------------------------
  const int quads = a.bk / 4;
  // split layout: lanes per row (a power of two >= quads), this lane's quad
  // and first row; wide layout: this lane's row group and column group
  const int lpr = a.lpr;
  const int t = kWide ? 0 : lane & (lpr - 1);
  const bool active = kWide || t < quads;
  const int row_base = kWide ? warp * 4 + lane / 8
                             : warp * (32 / lpr) + lane / lpr;
  const int row_step = kWide ? kRowSlots : kConsumerWarps * (32 / lpr);
  const int cg = lane % 8;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  int cur_rb = s_begin / a.bcap;
  for (int it = 0, slot = s_begin;; ++it, ++slot) {
    const bool done = slot == s_end;
    const int rb = done ? -1 : slot / a.bcap;
    if (rb != cur_rb) {
      // The row-block ends: write its sums to Y, or, for a row-block cut by
      // a run boundary, to this run's partial; the last of its runs to
      // finish adds the partials in run order.
      const int first = a.rb_runs[2 * cur_rb];
      const int last = a.rb_runs[2 * cur_rb + 1];
      const bool split = first != last;
      const int nrow = min(a.bm, a.n - cur_rb * a.bm);
      const int rows_out = split ? a.bm : nrow;
      float* part = nullptr;
      T* yb = nullptr;
      if (split) {
        const int side = cur_rb == s_begin / a.bcap ? 0 : 1;
        part = a.part + static_cast<size_t>(2 * r + side) * a.bm * a.k + c0;
      } else {
        yb = y + static_cast<size_t>(cur_rb) * a.bm * a.k + c0;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = row_base + i * row_step;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float v = acc[i][c];
          int col = c;
          if constexpr (kWide) {
            col = cg + 8 * c;
          } else {
            // add the lanes of the row
            for (int off = lpr / 2; off > 0; off >>= 1)
              v += __shfl_xor_sync(0xffffffffu, v, off);
          }
          if ((kWide || t == 0) && col < kc && row < rows_out) {
            const size_t o = static_cast<size_t>(row) * a.k + col;
            if (split)
              part[o] = v;
            else
              store_out(yb + o, v);
          }
          acc[i][c] = 0.f;
        }
      }
      if (split && last_ticket(a.tickets + cur_rb * a.nchunks + ch,
                               last - first + 1, flag)) {
        for (int e = threadIdx.x; e < nrow * kc; e += kConsumers) {
          const int row = e / kc;
          const int c = e - row * kc;
          // run `first` holds the row-block as its last (side 1) unless it
          // starts there; every later run holds it as its first (side 0)
          const size_t plane = static_cast<size_t>(a.bm) * a.k;
          const int side = a.bounds[first] / a.bcap == cur_rb ? 0 : 1;
          const float* p0 = a.part + (2 * first + side) * plane +
                            static_cast<size_t>(row) * a.k + c0 + c;
          const float s = sum_in_order(
              0.f + __ldcg(p0),
              a.part + (2 * first + 2) * plane +
                  static_cast<size_t>(row) * a.k + c0 + c,
              2 * plane, last - first);
          store_out(y + (static_cast<size_t>(cur_rb) * a.bm + row) * a.k +
                        c0 + c,
                    s);
        }
      }
      if (done) break;
      cur_rb = rb;
    }
    const int st = it % a.stages;
    const int flagged = gram_block ? a.flags[slot] : 0;
    mbar_wait(full0 + 8 * st, (it / a.stages) & 1);
    const unsigned char* stage = ring + st * a.stage_bytes;
    const T* tile = reinterpret_cast<const T*>(stage);
    const float* slab = reinterpret_cast<const float*>(stage + a.slab_off);

    if constexpr (kWide) {
      // per quad of tile columns j: the lane's kRows x kCols register tile
      for (int q = 0; q < quads; ++q) {
        float4 sv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = cg + 8 * c;
          sv[c] = col < kc ? *reinterpret_cast<const float4*>(
                                 slab + q * qs + 4 * col)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float4 tv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int row = row_base + i * row_step;
          tv[i] = row < a.bm ? quad_of(tile, row * a.bk + 4 * q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float s = acc[i][c];
            s = fmaf(tv[i].x, sv[c].x, s);
            s = fmaf(tv[i].y, sv[c].y, s);
            s = fmaf(tv[i].z, sv[c].z, s);
            s = fmaf(tv[i].w, sv[c].w, s);
            acc[i][c] = s;
          }
      }
    } else {
      float sv[4][KC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          sv[jj][c] = active && c < kc ? slab[t * qs + 4 * c + jj] : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        const int row = row_base + i * row_step;
        if (active && row < a.bm) {
          const float4 v = quad_of(tile, row * a.bk + 4 * t);
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            float s = acc[i][c];
            s = fmaf(v.x, sv[0][c], s);
            s = fmaf(v.y, sv[1][c], s);
            s = fmaf(v.z, sv[2][c], s);
            s = fmaf(v.w, sv[3][c], s);
            acc[i][c] = s;
          }
        }
      }
    }

    if (gram_block && flagged && a.k > kWarpGramMaxK) {
      // 4 x 4 register blocks of the upper triangle, one consumer thread a
      // block: block (bi, bj) holds columns bi + nb p and bj + nb q, so the
      // lanes of a warp (mostly one bi, consecutive bj) read a quad of slab
      // rows of consecutive columns; an off-diagonal block writes both its
      // places
      const int nb = (a.k + 3) / 4;
      const int nblocks = nb * (nb + 1) / 2;
      for (int blk = threadIdx.x; blk < nblocks; blk += kConsumers) {
        int bi = 0, rem = blk;
        while (rem >= nb - bi) {
          rem -= nb - bi;
          ++bi;
        }
        const int bj = bi + rem;
        float g[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[p][q] = 0.f;
        for (int jq = 0; jq < quads; ++jq) {
          float4 x[4], z[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int ci = bi + nb * p, cj = bj + nb * p;
            const float* row = slab + jq * qs;
            x[p] = ci < a.k ? *reinterpret_cast<const float4*>(row + 4 * ci)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
            z[p] = cj < a.k ? *reinterpret_cast<const float4*>(row + 4 * cj)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float v = g[p][q];
              v = fmaf(x[p].x, z[q].x, v);
              v = fmaf(x[p].y, z[q].y, v);
              v = fmaf(x[p].z, z[q].z, v);
              v = fmaf(x[p].w, z[q].w, v);
              g[p][q] = v;
            }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ci = bi + nb * p, cj = bj + nb * q;
            if (ci >= a.k || cj >= a.k) continue;
            g_s[ci * a.k + cj] += g[p][q];
            if (bi != bj) g_s[cj * a.k + ci] += g[p][q];
          }
      }
    } else if (gram_block && flagged) {
      // entry e = (c1, c2) to warp e % 7, kGramBatch entries of a warp at a
      // time; each bk-long dot split across the lanes, added by a shuffle
      // tree
      for (int e0 = warp; e0 < kk; e0 += kGramBatch * kConsumerWarps) {
        float s[kGramBatch];
        int o1[kGramBatch], o2[kGramBatch];
#pragma unroll
        for (int q = 0; q < kGramBatch; ++q) {
          const int e = min(e0 + q * kConsumerWarps, kk - 1);
          o1[q] = 4 * (e / a.k);
          o2[q] = 4 * (e % a.k);
          s[q] = 0.f;
        }
#pragma unroll 4
        for (int j = lane; j < a.bk; j += 32) {
          const float* row = slab + (j >> 2) * qs + (j & 3);
#pragma unroll
          for (int q = 0; q < kGramBatch; ++q)
            s[q] = fmaf(row[o1[q]], row[o2[q]], s[q]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int q = 0; q < kGramBatch; ++q)
            s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < kGramBatch; ++q)
            if (e0 + q * kConsumerWarps < kk)
              g_s[e0 + q * kConsumerWarps] += s[q];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  if (gram_block) {
    consumer_sync();  // every warp's Gram entries are in g_s
    for (int e = threadIdx.x; e < kk; e += kConsumers)
      a.gram_part[static_cast<size_t>(r) * kk + e] = g_s[e];
    if (last_ticket(a.tickets + a.nrb * a.nchunks, a.runs, flag)) {
      for (int e = threadIdx.x; e < kk; e += kConsumers)
        a.gram[e] = sum_in_order(0.f, a.gram_part + e, kk, a.runs);
    }
  }
  if (a.stamps != nullptr && threadIdx.x == 0 && ch == 0)
    a.stamps[2 * r + 1] = global_ns();
}

int device_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <typename T, int KC, bool kGram>
int launch_kc(const Args& a, size_t smem, int optin, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        spmm_kernel<T, KC, kGram>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  spmm_kernel<T, KC, kGram>
      <<<dim3(a.runs, a.nchunks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kGram>
int launch(Args a, void* stream) {
  const int nrb = a.nrb;
  if (a.n <= 0 || a.m <= 0 || a.k <= 0 || nrb <= 0 || a.bcap <= 0 ||
      a.bm <= 0 || a.bm > kMaxBm || a.bk <= 0 || a.bk > kMaxBk ||
      (a.bk * sizeof(T)) % 16 != 0 || a.runs <= 0 ||
      a.runs > nrb * a.bcap ||
      (a.kb != 8 && a.kb != 32 && a.kb != 64) ||
      reinterpret_cast<uintptr_t>(a.tiles) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.chunk = column_chunk(a.k, a.kb);
  const int kc_max = a.k < a.chunk ? a.k : a.chunk;
  const int w = kGram ? a.k : kc_max;
  a.nchunks = (a.k + a.chunk - 1) / a.chunk;
  int lpr = 1;
  while (lpr < a.bk / 4) lpr *= 2;
  a.lpr = lpr;
  a.tile_bytes = static_cast<unsigned int>(sizeof(T) * a.bm * a.bk);
  a.slab_off = static_cast<unsigned int>(round128(a.tile_bytes));
  a.stage_bytes = static_cast<unsigned int>(
      a.slab_off + round128(sizeof(float) * (a.bk / 4) * slab_quad(w)));
  const size_t fixed =
      kHeader + (kGram ? round128(sizeof(float) * a.k * a.k) : 0);
  const int optin = device_smem_optin();
  if (optin <= static_cast<int>(fixed))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t fit = (optin - fixed) / a.stage_bytes;
  a.stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  if (a.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + static_cast<size_t>(a.stages) * a.stage_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.chunk == 64) return launch_kc<T, 64, kGram>(a, smem, optin, s);
  if (a.chunk == 32) return launch_kc<T, 32, kGram>(a, smem, optin, s);
  switch (kc_max) {
    case 1: return launch_kc<T, 1, kGram>(a, smem, optin, s);
    case 2: return launch_kc<T, 2, kGram>(a, smem, optin, s);
    case 3: return launch_kc<T, 3, kGram>(a, smem, optin, s);
    case 4: return launch_kc<T, 4, kGram>(a, smem, optin, s);
    case 5: return launch_kc<T, 5, kGram>(a, smem, optin, s);
    case 6: return launch_kc<T, 6, kGram>(a, smem, optin, s);
    case 7: return launch_kc<T, 7, kGram>(a, smem, optin, s);
    default: return launch_kc<T, 8, kGram>(a, smem, optin, s);
  }
}

Args make_args(const void* tiles, const int* block_cols, const void* u,
               void* y, float* part, const int* bounds, const int* rb_runs,
               unsigned int* tickets, unsigned long long* stamps, int n,
               int m, int k, int nrb, int bcap, int bm, int bk, int runs,
               int kb) {
  Args a{};
  a.stamps = stamps;
  a.tiles = tiles;
  a.block_cols = block_cols;
  a.u = u;
  a.y = y;
  a.part = part;
  a.bounds = bounds;
  a.rb_runs = rb_runs;
  a.tickets = tickets;
  a.n = n;
  a.m = m;
  a.k = k;
  a.bcap = bcap;
  a.bm = bm;
  a.bk = bk;
  a.runs = runs;
  a.nrb = nrb;
  a.kb = kb;
  return a;
}

}  // namespace

// The plain product.  `bf16` selects the element type of tiles, u and y
// (0: f32); kb is the column chunk (8, 32 or 64).
extern "C" int bsr_spmm_run(const void* tiles, const int* block_cols,
                            const void* u, void* y, float* part,
                            const int* bounds, const int* rb_runs,
                            unsigned int* tickets,
                            unsigned long long* stamps, int n, int m, int k,
                            int nrb, int bcap, int bm, int bk, int runs,
                            int kb, int bf16_operands, void* stream) {
  const Args a = make_args(tiles, block_cols, u, y, part, bounds, rb_runs,
                           tickets, stamps, n, m, k, nrb, bcap, bm, bk, runs,
                           kb);
  return bf16_operands ? launch<bf16, false>(a, stream)
                       : launch<float, false>(a, stream);
}

// The fused product and Gram (f32 gram_part and gram either way).
extern "C" int bsr_spmm_gram_run(const void* tiles, const int* block_cols,
                                 const int* flags, const void* u, void* y,
                                 float* part, float* gram_part, float* gram,
                                 const int* bounds, const int* rb_runs,
                                 unsigned int* tickets,
                                 unsigned long long* stamps, int n, int m,
                                 int k, int nrb, int bcap, int bm, int bk,
                                 int runs, int kb, int bf16_operands,
                                 void* stream) {
  Args a = make_args(tiles, block_cols, u, y, part, bounds, rb_runs, tickets,
                     stamps, n, m, k, nrb, bcap, bm, bk, runs, kb);
  a.flags = flags;
  a.gram_part = gram_part;
  a.gram = gram;
  return bf16_operands ? launch<bf16, true>(a, stream)
                       : launch<float, true>(a, stream);
}
