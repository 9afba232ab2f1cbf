// Causal online-softmax attention with grouped KV heads, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel (grid (B, H, Sq/bq, T/bk) with the KV axis innermost and
// sequential, the running max, sum and (bq, hd) accumulator carried in VMEM
// scratch across it).
//
// q is (B, H, Sq, hd), k and v are (B, Hkv, T, hd), out is (B, H, Sq, hd),
// each addressed through its own batch, head and row strides (the last axis
// must be contiguous), so the model's (B, S, H, hd) projections are read
// and written in place with no transposed copy.  Query head h reads KV head
// h / groups.  The function is the reference's, step for step:
//   s = (q . k in f32) * hd^-0.5, masked to -1e30 where key > row (causal,
//       absolute indices, top-left aligned when Sq != T);
//   m, l running in f32; p = exp(s - m_new); l sums the unrounded p;
//   p is rounded to v's type before P . V; out = acc / max(l, 1e-30),
//   rounded to q's type.
//
// What bounds it: the causal product is 2 * B * H * hd * Sq * (Sq + 1)
// FLOPs (QK^T and PV), against one read of q, k, v and one write of out.
// At the llama3.2-1b prefill shape (B=4, H=32, Hkv=8, S=4096, hd=64) that
// is 0.275 TFLOP against 0.17 GB in bf16: bound by operations (0.28 ms at
// the bf16 tensor-core peak of 989 TFLOP/s, 0.05 ms for the bytes).
//
// Two kernels, chosen by dtype in flash_attention_fwd:
//
// bf16: flash_fwd_bf16_wgmma, on the tensor cores.
//  * One block per (b, h, kRows = 128 query rows): two consumer warpgroups
//    of 64 rows each and one producer warp (288 threads).  Causal query
//    tiles are launched last-first, so the longest blocks start first.
//  * The producer thread issues TMA loads (cp.async.bulk.tensor, 4-D maps
//    over the strided views, encoded on the host for each call): the Q tile
//    once, then K and V tiles of kKeys = 128 keys into a ring of kStages = 2
//    stages, each with a full mbarrier (its expected bytes) and an empty
//    mbarrier (every consumer thread arrives when it has read the stage).
//    TMA zero-fills rows past Sq or T.
//  * Shared memory holds each tile as panels of 64 columns (128-byte rows,
//    128B swizzle; hd 32 and 16 take one panel of 64- and 32-byte rows with
//    the matching swizzle), the canonical layouts wgmma reads.
//  * S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory, both
//    K-major, f32 accumulators; hd / 16 steps, each advancing the
//    descriptors' start address by 32 bytes inside a swizzle row (and by a
//    panel past 64 columns).
//  * Softmax on the accumulator fragment: thread t of a warpgroup holds rows
//    16 * warp + lane / 4 and that + 8; scores are scaled by
//    hd^-0.5 * log2(e) so that p = exp2(x - m) is the reference's
//    exp(s - m); masked to -1e30 only on tiles that cross the diagonal or T
//    (tiles wholly above the diagonal are not visited); row max by two
//    shuffles in each row's quad; each thread keeps its own part of l and
//    the quad sums it at the end.
//  * O += P V: p rounded to bf16 in registers, where the accumulator's
//    layout is already wgmma's A-fragment layout; wgmma m64n{hd}k16 with A
//    from registers and B = V from shared memory, MN-major (transpose bit).
//  * Epilogue: acc / max(l, 1e-30), rounded to bf16, stored through the
//    output's strides.  No atomics and no split over keys: two calls give
//    bitwise the same output.
//
// f32: flash_fwd_kernel, on the CUDA cores (f32 FMAs; tensor-core f32 would
// be TF32, and the port's f32 kernels compute in IEEE f32).
//  * One block per (b, h, tile of kRows = 64 query rows), 8 warps of 8 rows
//    each.  The TPU's sequential KV grid axis becomes a loop inside the
//    block; m, l and the (8 rows x hd) accumulator of each warp live in
//    registers (each lane owns hd / 32 output columns).
//  * Per KV tile of kKeys = 64 keys, K (stored transposed, rows padded to
//    65 words so the transposing store hits 32 banks) and V are staged in
//    shared memory, zero-filled past T.  The Q tile is staged once.
//  * Scores: lane l owns keys l and l + 32 of the tile for its warp's 8
//    rows; Q rows are read as float4 broadcasts, K columns conflict-free.
//    Each row's max and sum are warp-shuffle reductions.
//  * P goes through shared memory (per warp, 8 x 64 f32) so that P . V
//    reads it as float4 broadcasts against contiguous V rows.
//  * Causal: KV tiles wholly above the diagonal are not visited.  With m
//    starting at -1e30 and l at 0 they would add exactly nothing, so the
//    result is bitwise the same.  Query tiles are launched last-first.
//  * Any Sq and T: rows past Sq are computed on zeros and not written; keys
//    past T score -1e30 and read zero V.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, returns cudaGetLastError(), cudaErrorInvalidValue for a head
// size or type it was not built for, or 1000 + the CUresult with which
// cuTensorMapEncodeTiled refused a bf16 operand.  cuTensorMapEncodeTiled is
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace simt {


constexpr int kRows = 64;                     // query rows per block
constexpr int kKeys = 64;                     // keys per KV tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kKeysPerLane = kKeys / 32;      // 2
constexpr int kKtLd = kKeys + 1;              // padded row of transposed K
constexpr float kNegInf = -1e30f;             // the reference's NEG_INF

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kRows * D + D * kKtLd + kKeys * D + kRows * kKeys);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int t,
                 int groups, int causal, float scale, long long qsb,
                 long long qsh, long long qss, long long ksb, long long ksh,
                 long long kss, long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss) {
  constexpr int kDPerLane = (D + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [kRows][D]
  float* kts = qs + kRows * D;     // [D][kKtLd]
  float* vs = kts + D * kKtLd;     // [kKeys][D]
  float* ps = vs + kKeys * D;      // [kRows][kKeys]

  const int n_qtiles = gridDim.x;
  const int tile = causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = tile * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / groups) * ksh;
  const float* vb = v + b * vsb + (h / groups) * vsh;

  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = q0 + r;
    qs[e] = row < sq ? qb[row * qss + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPerLane; ++j) acc[r][j] = 0.f;
  }

  // keys past the tile's last row are masked for every row: not visited
  const int last_row = min(q0 + kRows, sq);
  const int kv_end = causal ? min(t, last_row) : t;
  const int n_kt = (kv_end + kKeys - 1) / kKeys;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kKeys;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
      const int c = e / D;
      const int d = e - c * D;
      const int key = k0 + c;
      const bool ok = key < t;
      kts[d * kKtLd + c] = ok ? kb[key * kss + d] : 0.f;
      vs[c * D + d] = ok ? vb[key * vss + d] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) s[r][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float kv[4][kKeysPerLane];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j)
          kv[i][j] = kts[(d + i) * kKtLd + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * D + d);
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          s[r][j] = fmaf(qv.x, kv[0][j], s[r][j]);
          s[r][j] = fmaf(qv.y, kv[1][j], s[r][j]);
          s[r][j] = fmaf(qv.z, kv[2][j], s[r][j]);
          s[r][j] = fmaf(qv.w, kv[3][j], s[r][j]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + r0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int key = k0 + lane + 32 * j;
        const bool valid = key < t && (!causal || key <= row);
        s[r][j] = valid ? s[r][j] * scale : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const float p = expf(s[r][j] - m_new);
        sum += p;
        ps[(r0 + r) * kKeys + lane + 32 * j] = p;
      }
      l[r] = l[r] * alpha + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDPerLane; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kKeys; c += 4) {
      float vv[4][kDPerLane];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDPerLane; ++j) {
          const int d = lane + 32 * j;
          vv[i][j] = d < D ? vs[(c + i) * D + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + (r0 + r) * kKeys + c);
#pragma unroll
        for (int j = 0; j < kDPerLane; ++j) {
          acc[r][j] = fmaf(pv.x, vv[0][j], acc[r][j]);
          acc[r][j] = fmaf(pv.y, vv[1][j], acc[r][j]);
          acc[r][j] = fmaf(pv.z, vv[2][j], acc[r][j]);
          acc[r][j] = fmaf(pv.w, vv[3][j], acc[r][j]);
        }
      }
    }
  }

  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) ob[row * oss + d] = acc[r][j] / den;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int sq, int t, int groups, int causal, float scale,
           const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, t, groups,
      causal,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int b, int h, int sq, int t, int groups, int causal,
                float scale, const long long* st, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                        stream);
    case 32:
      return launch<32>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 128;        // query rows per block
constexpr int kKeys = 128;        // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kConsumers = 256;   // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of a tile of head size D: panels of kPanelCols
// columns, each row of a panel kSwizzle bytes, swizzled in kSwizzle bytes.
template <int D>
struct Geom {
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;
  static constexpr int kPanelCols = kSwizzle / 2;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kStepsPerPanel = kPanelCols / 16;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;   // one K or V tile
  static constexpr int kQPanelBytes = kRows * kSwizzle;
  static constexpr int kKVPanelBytes = kKeys * kSwizzle;
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kLayout =
      kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  // 8 rows of a panel, in 16-byte units (the descriptors' SBO)
  static constexpr uint32_t kSbo = 8 * kSwizzle / 16;
  // 1024 bytes of slack to align the tiles to the 128B swizzle's 1 KB atom
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes;
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

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The maps order their three outer dimensions by stride; perm holds the
// position (1-3) of the row, head and batch dimensions in 2-bit fields.
__device__ __forceinline__ int pick(int perm, int slot, int row, int head,
                                    int batch) {
  return (perm & 3) == slot ? row
                            : (((perm >> 2) & 3) == slot ? head : batch);
}

// One tile of kRows or kKeys rows from `row0`, every panel of it.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int perm, int row0,
                                          int head, int batch,
                                          int panel_bytes) {
  const int c1 = pick(perm, 1, row0, head, batch);
  const int c2 = pick(perm, 2, row0, head, batch);
  const int c3 = pick(perm, 3, row0, head, batch);
#pragma unroll
  for (int p = 0; p < Geom<D>::kPanels; ++p)
    tma_load_4d(dst + p * panel_bytes, map, bar, p * Geom<D>::kPanelCols, c1,
                c2, c3);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (Q or K): rows of the tile, hd along the row; k-step kk
// covers columns 16 kk .. 16 kk + 15.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk,
                                                int panel_bytes) {
  using G = Geom<D>;
  const uint32_t addr = tile + (kk / G::kStepsPerPanel) * panel_bytes +
                        (kk % G::kStepsPerPanel) * 32;
  return make_desc(addr, 1, G::kSbo, G::kLayout);
}

// MN-major operand (V as B of P V): k-step kk covers keys 16 kk ..
// 16 kk + 15, i.e. 16 rows; hd panels lie kKVPanelBytes apart (the LBO).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using G = Geom<D>;
  return make_desc(tile + kk * 16 * G::kSwizzle, G::kKVPanelBytes / 16,
                   G::kSbo, G::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the wait, and from reusing an A-fragment register before it.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma instructions, their accumulator registers written out.
// D(64 x 128, f32) (+)= A(64 x 16, smem) * B(16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 16, f32) += A(64 x 16, registers) * B(16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 32, f32) += A(64 x 16, registers) * B(16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64, f32) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_m64n16(d, a, db);
  if constexpr (D == 32) wgmma_rs_m64n32(d, a, db);
  if constexpr (D == 64) wgmma_rs_m64n64(d, a, db);
  if constexpr (D == 128) wgmma_rs_m64n128(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, int sq, int t,
                     int groups, int causal, float scale_log2, long long osb,
                     long long osh, long long oss, int perm_q, int perm_k,
                     int perm_v) {
  using G = Geom<D>;
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + G::kQBytes;
  const uint32_t s_v = s_k + kStages * G::kTileBytes;
  const uint32_t bar_full = smem_u32(&bars[0]);
  const uint32_t bar_empty = smem_u32(&bars[kStages]);
  const uint32_t bar_q = smem_u32(&bars[2 * kStages]);

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = tile * kRows;
  // keys past the block's last row are masked for every row: not visited
  const int kv_end = causal ? min(t, min(q0 + kRows, sq)) : t;
  const int n_kt = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == kConsumers) {
      const int hkv = h / groups;
      mbar_expect_tx(bar_q, G::kQBytes);
      load_tile<D>(s_q, &tq, bar_q, perm_q, q0, h, b, G::kQPanelBytes);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * G::kTileBytes);
        load_tile<D>(s_k + s * G::kTileBytes, &tk, bar_full + 8 * s, perm_k,
                     it * kKeys, hkv, b, G::kKVPanelBytes);
        load_tile<D>(s_v + s * G::kTileBytes, &tv, bar_full + 8 * s, perm_v,
                     it * kKeys, hkv, b, G::kKVPanelBytes);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 ----
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int wg_row0 = q0 + 64 * wg;
    const int row_lo = wg_row0 + 16 * warp + lane / 4;  // regs with i & 2 == 0
    const int row_hi = row_lo + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_wg = s_q + 64 * wg * G::kSwizzle;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kStages;
      const int k0 = it * kKeys;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      const uint32_t k_tile = s_k + s * G::kTileBytes;
      const uint32_t v_tile = s_v + s * G::kTileBytes;

      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n128(sc, kmajor_desc<D>(q_wg, kk, G::kQPanelBytes),
                         kmajor_desc<D>(k_tile, kk, G::kKVPanelBytes),
                         kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);

      // scale (log2 domain), mask, row max
      const bool edge =
          k0 + kKeys > t || (causal && k0 + kKeys - 1 > wg_row0);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
          const int row = (i & 2) ? row_hi : row_lo;
          if (key >= t || (causal && key > row)) x = kNegInf;
        }
        sc[i] = x;
        if (i & 2)
          mx_hi = fmaxf(mx_hi, x);
        else
          mx_lo = fmaxf(mx_lo, x);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      const float alpha_lo = exp2f(m_lo - mn_lo);
      const float alpha_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;

      // p = exp2(x - m): summed unrounded, rounded to bf16 for P V
      uint32_t p[32];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const float m = (i & 2) ? mn_hi : mn_lo;
        const float p0 = exp2f(sc[i] - m);
        const float p1 = exp2f(sc[i + 1] - m);
        if (i & 2)
          sum_hi += p0 + p1;
        else
          sum_lo += p0 + p1;
        p[i / 2] = pack_bf16(p0, p1);
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha_hi : alpha_lo;

      // O += P V: k-step kk takes keys 16 kk .. 16 kk + 15, which are the
      // accumulator registers 8 kk .. 8 kk + 7, i.e. p[4 kk .. 4 kk + 3]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_pv<D>(acc, a, mnmajor_desc<D>(v_tile, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(p[i]);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float den_lo = fmaxf(l_lo, 1e-30f);
    const float den_hi = fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + col0;
      if (row_lo < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * oss + col) =
            __floats2bfloat162_rn(acc[4 * j] / den_lo,
                                  acc[4 * j + 1] / den_lo);
      if (row_hi < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * oss + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / den_hi,
                                  acc[4 * j + 3] / den_hi);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over one (B, heads, rows, hd) operand given by element strides:
// dimension 0 is hd, dimensions 1-3 are rows, heads and batch ordered by
// stride; the box is one panel of `box_rows` rows.  Sets *perm (see pick).
template <int D>
int encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int rows,
           int heads, int batch, long long sb, long long sh, long long ss,
           int box_rows, int* perm) {
  using G = Geom<D>;
  struct Dim {
    long long stride;
    int size;
    int logical;  // 0 row, 1 head, 2 batch
  } d[3] = {{ss, rows, 0}, {sh, heads, 1}, {sb, batch, 2}};
  for (int i = 1; i < 3; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kPanelCols), 1, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(d[i].size);
    strides[i] = static_cast<cuuint64_t>(d[i].stride) * 2;
    if (d[i].logical == 0) box[i + 1] = static_cast<cuuint32_t>(box_rows);
    *perm |= (i + 1) << (2 * d[i].logical);
  }
  const CUtensorMapSwizzle swizzle =
      G::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : (G::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int sq, int t, int groups, int causal, float scale,
           const long long* st, cudaStream_t stream) {
  using G = Geom<D>;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  int perm_q, perm_k, perm_v, rc;
  const int hkv = h / groups;
  if ((rc = encode<D>(fn, &tq, q, sq, h, b, st[0], st[1], st[2], kRows,
                      &perm_q)))
    return rc;
  if ((rc = encode<D>(fn, &tk, k, t, hkv, b, st[3], st[4], st[5], kKeys,
                      &perm_k)))
    return rc;
  if ((rc = encode<D>(fn, &tv, v, t, hkv, b, st[6], st[7], st[8], kKeys,
                      &perm_v)))
    return rc;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_fwd_bf16_wgmma<D><<<grid, kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, t, groups, causal,
      scale * kLog2e, st[9], st[10], st[11], perm_q, perm_k, perm_v);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* o, int b, int h, int sq, int t, int groups, int causal,
                float scale, const long long* st, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                        stream);
    case 32:
      return launch<32>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, b, h, sq, t, groups, causal, scale, st,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel).  strides: 12 element strides, the (batch, head, row) strides of
// q, k, v and out in that order.
extern "C" int flash_attention_fwd(int dtype, int hd, const void* q,
                                   const void* k, const void* v, void* o,
                                   int b, int h, int sq, int t, int groups,
                                   int causal, float scale,
                                   const long long* strides, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || t <= 0 || groups <= 0 || h % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch_hd(hd, q, k, v, o, b, h, sq, t, groups, causal,
                             scale, strides, s);
  if (dtype == 1)
    return tc::dispatch_hd(hd, q, k, v, o, b, h, sq, t, groups, causal,
                           scale, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
