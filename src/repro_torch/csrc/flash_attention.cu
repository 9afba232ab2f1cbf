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
// the bf16 tensor-core peak of 989 TFLOP/s, 0.05 ms for the bytes).  This
// first version does them as f32 FMAs on the CUDA cores (peak 67 TFLOP/s,
// 4.1 ms for this work), not on the tensor cores; wgmma, TMA and a
// producer warp are later work.
//
// Design:
//  * One block per (b, h, tile of kRows = 64 query rows), 8 warps of 8 rows
//    each.  The TPU's sequential KV grid axis becomes a loop inside the
//    block; m, l and the (8 rows x hd) accumulator of each warp live in
//    registers (each lane owns hd / 32 output columns).
//  * Per KV tile of kKeys = 64 keys, K (stored transposed, rows padded to
//    65 words so the transposing store hits 32 banks) and V are staged in
//    shared memory as f32, zero-filled past T.  The Q tile is staged once.
//  * Scores: lane l owns keys l and l + 32 of the tile for its warp's 8
//    rows; Q rows are read as float4 broadcasts, K columns conflict-free.
//    Each row's max and sum are warp-shuffle reductions.
//  * P goes through shared memory (per warp, 8 x 64 f32) so that P . V
//    reads it as float4 broadcasts against contiguous V rows.
//  * Causal: KV tiles wholly above the diagonal are not visited.  With m
//    starting at -1e30 and l at 0 they would add exactly nothing, so the
//    result is bitwise the same.  Query tiles are launched last-first, so
//    the longest blocks start first.
//  * Any Sq and T: rows past Sq are computed on zeros and not written; keys
//    past T score -1e30 and read zero V.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, returns cudaGetLastError() (or cudaErrorInvalidValue for a
// head size or type it was not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                     // query rows per block
constexpr int kKeys = 64;                     // keys per KV tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kKeysPerLane = kKeys / 32;      // 2
constexpr int kKtLd = kKeys + 1;              // padded row of transposed K
constexpr float kNegInf = -1e30f;             // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int t,
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

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / groups) * ksh;
  const T* vb = v + b * vsb + (h / groups) * vsh;

  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = q0 + r;
    qs[e] = row < sq ? to_f32(qb[row * qss + d]) : 0.f;
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
      kts[d * kKtLd + c] = ok ? to_f32(kb[key * kss + d]) : 0.f;
      vs[c * D + d] = ok ? to_f32(vb[key * vss + d]) : 0.f;
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
        ps[(r0 + r) * kKeys + lane + 32 * j] = to_f32(from_f32<T>(p));
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

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) ob[row * oss + d] = from_f32<T>(acc[r][j] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int sq, int t, int groups, int causal, float scale,
           const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, t, groups, causal,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int b, int h, int sq, int t, int groups, int causal,
                float scale, const long long* st, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, h, sq, t, groups, causal, scale,
                           st, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, h, sq, t, groups, causal, scale,
                           st, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, h, sq, t, groups, causal, scale,
                           st, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, h, sq, t, groups, causal, scale,
                            st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, row) strides of q, k, v and out in that order.
extern "C" int flash_attention_fwd(int dtype, int hd, const void* q,
                                   const void* k, const void* v, void* o,
                                   int b, int h, int sq, int t, int groups,
                                   int causal, float scale,
                                   const long long* strides, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || t <= 0 || groups <= 0 || h % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, b, h, sq, t, groups, causal,
                              scale, strides, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, b, h, sq, t, groups,
                                      causal, scale, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
