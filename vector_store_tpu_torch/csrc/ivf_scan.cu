// IVF probe-scan kernels for Hopper (sm_90a), with a plain C interface
// (bound with ctypes by vector_store_tpu_torch/core/ivf_cuda.py).
//
// Replaces the two Pallas TPU kernels of vector_store_tpu/core/ivf_pallas.py:
//
//   ivf_search_fused  <- _kernel (ivf_pallas.py:128), called by search_fused
//                        (:418, pallas_call at :500).  Scores every live row
//                        of each query's p probed buckets and keeps the k
//                        best (k <= 32), in the TPU kernel's four score
//                        modes (:153-221):
//                          f32  (0) f32 dots of the row and the f32 query;
//                          qi8  (1) int8 rows x the int8-quantized query,
//                               s8 x s8 -> s32 with __dp4a (the Hopper
//                               counterpart of the MXU's s8 path), then
//                               dot * (scale[slot] * qscale[q]): an int32
//                               dot below 2^24 converts to f32 exactly, so
//                               the distances equal the TPU kernel's bit
//                               for bit;
//                          bf16 (2) int8 rows as exact floats x the query
//                               rounded to bf16 by the wrapper, products
//                               summed in f32: the f32 code path;
//                          stub (3) the copy-floor ablation: every 16-byte
//                               chunk of a live row is copied into shared
//                               memory by cp.async, as the TPU's DMA copied
//                               it, and the row scores element 0 x scale.
//   ivf_pool_scan     <- _pool_kernel (ivf_pallas.py:252), called by
//                        pool_scan_fused (:329, pallas_call at :396).  Same
//                        scoring, but writes the raw [Q, p*B] distance pool;
//                        also reads the int4 split-nibble bank.
//
// What bounds them on this card: device-memory bytes.  Each query reads the
// live prefix of its p probed [B, D] buckets once -- p*B*D bytes for an int8
// bank (half that packed) -- against two flops per byte, far below the
// H100's compute-to-bandwidth ratio.  The design keeps every other access
// out of device memory:
//   * one warp scores one bank row (row_dot, scan_common.cuh); each lane
//     loads 16 bytes at a time, so
//     a warp streams 512 contiguous bytes per step;
//   * the query is staged once per block in shared memory, transposed by
//     16-byte chunk so that the 32 lanes of a warp read 32 consecutive
//     floats (no bank conflicts);
//   * rows past a bucket's live prefix (nsb[c] * 128 rows) and tombstoned
//     rows (rowid == SENTINEL) are never read -- their distance is INF;
//   * B1 keeps the [p*B] candidate pool in shared memory and takes k
//     block-wide argmin passes, ties to the lowest pool position (the order
//     jnp.argmin gives), so only [k] results reach device memory.
//
// Distances (ascending): cosine 1 - s*(x.q), dot -s*(x.q),
// l2 |q|^2 + s^2|x|^2 - 2s*(x.q); the row scale s applies to int8 and
// packed banks only (packed: s * 127/7).  Sums are f32, in another order
// than the plain PyTorch versions.
//
// Neither kernel allocates: the caller passes every buffer.  Both launch on
// the caller's stream and return cudaGetLastError() of the launch.

#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "scan_common.cuh"

namespace {

constexpr int kSentinel = INT_MAX;  // "no row" id (vector_store_tpu core/topk.py)
constexpr int kSubBlock = 128;      // live-prefix granularity (ivf_pallas.SB)
constexpr int kFusedThreads = 512;
constexpr int kPoolThreads = 256;
constexpr float kInt4Scale = 127.0f / 7.0f;
enum Score { kScoreF32 = 0, kScoreQi8 = 1, kScoreBf16 = 2, kScoreStub = 3 };

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// qi8: this lane's share of the s8 x s8 -> s32 dot of an int8 row with the
// int8 query staged (in order) in shared memory, four bytes per __dp4a.
__device__ __forceinline__ int row_dot_i8(const int8_t* __restrict__ row,
                                          const int8_t* __restrict__ q8, int D, int n4,
                                          int lane) {
  int acc = 0;
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  const uint4* q4 = reinterpret_cast<const uint4*>(q8);
  for (int c = lane; c < n4; c += 32) {
    const uint4 u = __ldg(r4 + c);
    const uint4 v = q4[c];
    acc = __dp4a(static_cast<int>(u.x), static_cast<int>(v.x), acc);
    acc = __dp4a(static_cast<int>(u.y), static_cast<int>(v.y), acc);
    acc = __dp4a(static_cast<int>(u.z), static_cast<int>(v.z), acc);
    acc = __dp4a(static_cast<int>(u.w), static_cast<int>(v.w), acc);
  }
  for (int i = 16 * n4 + lane; i < D; i += 32) {
    acc += static_cast<int>(row[i]) * static_cast<int>(q8[i]);
  }
  return acc;
}

// stub: copy every 16-byte chunk of the row into shared memory with
// cp.async (a copy the compiler cannot drop), chunk 0 into the warp's own
// slot and the rest into the lane's; returns element 0 of the copy on lane 0.
template <typename T>
__device__ __forceinline__ float row_copy_first(const T* __restrict__ row, uint4* lane_slot,
                                                uint4* warp_slot, int n4, int lane) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  for (int c = lane; c < n4; c += 32) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(c == 0 ? warp_slot : lane_slot));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(r4 + c) : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  return lane == 0 ? to_f(reinterpret_cast<const T*>(warp_slot)[0]) : 0.0f;
}

// Lexicographic (distance, position) minimum across the warp.
__device__ __forceinline__ void warp_argmin(float& d, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (od < d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

// B1: one block per query.  grid (Q), block kFusedThreads, dynamic shared
// memory (D + p*B) floats; the stub mode adds a 16-byte copy slot per
// thread and per warp after it.  `queries` is [Q, D] f32, or int8 codes in
// the qi8 mode, whose per-query scales are `qscale`.
template <typename T, int SCORE>
__global__ void __launch_bounds__(kFusedThreads)
    search_fused_kernel(const T* __restrict__ vectors, const float* __restrict__ scales,
                        const int32_t* __restrict__ rowid, const void* __restrict__ queries,
                        const float* __restrict__ qsq, const float* __restrict__ qscale,
                        const int32_t* __restrict__ cids, const int32_t* __restrict__ nsb, int B,
                        int D, int n4, int p, int k, int space, int scaled,
                        float* __restrict__ out_d, int32_t* __restrict__ out_r) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;        // [D] staged query (int8 codes in the qi8 mode)
  float* pool = smem + D;  // [p*B] candidate distances
  __shared__ float red_d[kFusedThreads / 32];
  __shared__ int red_i[kFusedThreads / 32];

  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int P = p * B;
  uint4* slots = nullptr;  // stub: [nthreads] lane slots, then [nwarps] warp slots
  if constexpr (SCORE == kScoreQi8) {
    const int8_t* src = static_cast<const int8_t*>(queries) + static_cast<size_t>(qi) * D;
    int8_t* q8 = reinterpret_cast<int8_t*>(qs);
    for (int i = threadIdx.x; i < D; i += blockDim.x) q8[i] = src[i];
  } else if constexpr (SCORE == kScoreStub) {
    const size_t off = (static_cast<size_t>(D + P) * sizeof(float) + 15) & ~static_cast<size_t>(15);
    slots = reinterpret_cast<uint4*>(reinterpret_cast<char*>(smem) + off);
  } else {
    stage_query<T, false>(static_cast<const float*>(queries) + static_cast<size_t>(qi) * D, qs,
                          D, n4);
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) pool[i] = CUDART_INF_F;
  __syncthreads();

  const float q2 = qsq[qi];
  float qscl = 1.0f;
  if constexpr (SCORE == kScoreQi8) qscl = qscale[qi];
  for (int r = 0; r < p; ++r) {
    const int c = cids[qi * p + r];
    const int live = min(nsb[c] * kSubBlock, B);
    for (int j = warp; j < live; j += nwarps) {
      const size_t slot = static_cast<size_t>(c) * B + j;
      if (rowid[slot] == kSentinel) continue;  // tombstone: stays INF
      float d;
      if constexpr (SCORE == kScoreQi8) {
        const int dot = warp_sum_i(row_dot_i8(reinterpret_cast<const int8_t*>(vectors + slot * D),
                                              reinterpret_cast<const int8_t*>(qs), D, n4, lane));
        // the TPU kernel's order: (scale * qscale), then dot * that; no FMA
        const float v = __fmul_rn(static_cast<float>(dot), __fmul_rn(scales[slot], qscl));
        d = space == kDot ? -v : 1.0f - v;
      } else if constexpr (SCORE == kScoreStub) {
        const float x0 = row_copy_first<T>(vectors + slot * D, slots + threadIdx.x,
                                           slots + blockDim.x + warp, n4, lane);
        d = __fmul_rn(x0, scales[slot]);
      } else {
        float dot = 0.0f, sq = 0.0f;
        row_dot<T, false>(vectors + slot * D, qs, D, n4, lane, dot, sq);
        dot = warp_sum(dot);
        sq = warp_sum(sq);
        d = row_distance(dot, sq, scaled ? scales[slot] : 1.0f, q2, space);
      }
      if (lane == 0) pool[r * B + j] = d;
    }
  }
  __syncthreads();

  // k extract-min passes over the pool; ties go to the lowest position
  for (int t = 0; t < k; ++t) {
    float bd = CUDART_INF_F;
    int bi = INT_MAX;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      const float v = pool[i];
      if (v < bd) {
        bd = v;
        bi = i;
      }
    }
    warp_argmin(bd, bi);
    if (lane == 0) {
      red_d[warp] = bd;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bd = lane < nwarps ? red_d[lane] : CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmin(bd, bi);
      if (lane == 0) {
        int rid = kSentinel;
        if (bi < P) {  // a finite candidate was left
          pool[bi] = CUDART_INF_F;
          rid = rowid[static_cast<size_t>(cids[qi * p + bi / B]) * B + bi % B];
        }
        out_d[qi * k + t] = bd;
        out_r[qi * k + t] = rid;
      }
    }
    __syncthreads();
  }
}

// B2: one block per (probe rank, query).  grid (p, Q), block kPoolThreads,
// dynamic shared memory D floats.  out[q, r*B + j] scores row j of bucket
// cids[q, r]; INF past the live prefix and on tombstones.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(kPoolThreads)
    pool_scan_kernel(const T* __restrict__ vectors, const float* __restrict__ scales,
                     const int32_t* __restrict__ rowid, const float* __restrict__ queries,
                     const float* __restrict__ qsq, const int32_t* __restrict__ cids,
                     const int32_t* __restrict__ nsb, int B, int D, int dw, int n4, int p,
                     int space, int scaled, float* __restrict__ out) {
  extern __shared__ float qs[];
  const int r = blockIdx.x, qi = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  stage_query<T, PACKED>(queries + static_cast<size_t>(qi) * D, qs, dw, n4);
  __syncthreads();

  const int c = cids[qi * p + r];
  const int live = min(nsb[c] * kSubBlock, B);
  float* o = out + (static_cast<size_t>(qi) * p + r) * B;
  for (int j = live + threadIdx.x; j < B; j += blockDim.x) o[j] = CUDART_INF_F;
  const float q2 = qsq[qi];
  for (int j = warp; j < live; j += nwarps) {
    const size_t slot = static_cast<size_t>(c) * B + j;
    if (rowid[slot] == kSentinel) {
      if (lane == 0) o[j] = CUDART_INF_F;
      continue;
    }
    float dot = 0.0f, sq = 0.0f;
    row_dot<T, PACKED>(vectors + slot * dw, qs, dw, n4, lane, dot, sq);
    dot = warp_sum(dot);
    sq = warp_sum(sq);
    if (lane == 0) {
      float s = scaled ? scales[slot] : 1.0f;
      if (PACKED) s *= kInt4Scale;
      o[j] = row_distance(dot, sq, s, q2, space);
    }
  }
}

template <typename T, int SCORE>
cudaError_t launch_fused(const void* vectors, const float* scales, const int32_t* rowid,
                         const void* queries, const float* qsq, const float* qscale,
                         const int32_t* cids, const int32_t* nsb, int Q, int B, int D, int p,
                         int k, int space, int scaled, int vec, float* out_d, int32_t* out_r,
                         cudaStream_t stream) {
  const int n4 = vec ? D / (16 / static_cast<int>(sizeof(T))) : 0;
  size_t smem = (static_cast<size_t>(D) + static_cast<size_t>(p) * B) * sizeof(float);
  if (SCORE == kScoreStub) {
    if (!vec) return cudaErrorInvalidValue;  // the copy goes in 16-byte chunks
    smem = ((smem + 15) & ~static_cast<size_t>(15)) + (kFusedThreads + kFusedThreads / 32) * 16;
  }
  auto kern = search_fused_kernel<T, SCORE>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<Q, kFusedThreads, smem, stream>>>(static_cast<const T*>(vectors), scales, rowid,
                                           queries, qsq, qscale, cids, nsb, B, D, n4, p, k,
                                           space, scaled, out_d, out_r);
  return cudaGetLastError();
}

template <typename T, bool PACKED>
cudaError_t launch_pool(const void* vectors, const float* scales, const int32_t* rowid,
                        const float* queries, const float* qsq, const int32_t* cids,
                        const int32_t* nsb, int Q, int B, int D, int p, int space, int scaled,
                        int vec, float* out, cudaStream_t stream) {
  const int dw = PACKED ? D / 2 : D;
  const int n4 = vec ? dw / (16 / static_cast<int>(sizeof(T))) : 0;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  auto kern = pool_scan_kernel<T, PACKED>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(p, Q), kPoolThreads, smem, stream>>>(static_cast<const T*>(vectors), scales,
                                                   rowid, queries, qsq, cids, nsb, B, D, dw,
                                                   n4, p, space, scaled, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8 bank [K, B, D].  score: 0 f32,
// 1 qi8 (queries int8 [Q, D], qscale [Q]), 2 bf16 (queries f32, already
// rounded to bf16), 3 stub; qi8 and bf16 take int8 banks and cosine or dot
// only.  qscale may be null outside qi8.  vec: rows may be read with
// 16-byte loads (row bytes and base address multiples of 16); stub needs it.
int ivf_search_fused(int dtype, int score, const void* vectors, const float* scales,
                     const int32_t* rowid, const void* queries, const float* qsq,
                     const float* qscale, const int32_t* cids, const int32_t* nsb, int Q, int B,
                     int D, int p, int k, int space, int scaled, int vec, float* out_d,
                     int32_t* out_r, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (score == kScoreQi8 || score == kScoreBf16) {
    if (dtype != kI8 || space == kL2) return cudaErrorInvalidValue;
    if (score == kScoreQi8)
      return launch_fused<int8_t, kScoreQi8>(vectors, scales, rowid, queries, qsq, qscale, cids,
                                             nsb, Q, B, D, p, k, space, scaled, vec, out_d,
                                             out_r, st);
    return launch_fused<int8_t, kScoreF32>(vectors, scales, rowid, queries, qsq, qscale, cids,
                                           nsb, Q, B, D, p, k, space, scaled, vec, out_d, out_r,
                                           st);
  }
  if (score != kScoreF32 && score != kScoreStub) return cudaErrorInvalidValue;
  const bool stub = score == kScoreStub;
  switch (dtype) {
    case kF32:
      return (stub ? launch_fused<float, kScoreStub> : launch_fused<float, kScoreF32>)(
          vectors, scales, rowid, queries, qsq, qscale, cids, nsb, Q, B, D, p, k, space, scaled,
          vec, out_d, out_r, st);
    case kBF16:
      return (stub ? launch_fused<__nv_bfloat16, kScoreStub>
                   : launch_fused<__nv_bfloat16, kScoreF32>)(
          vectors, scales, rowid, queries, qsq, qscale, cids, nsb, Q, B, D, p, k, space, scaled,
          vec, out_d, out_r, st);
    case kI8:
      return (stub ? launch_fused<int8_t, kScoreStub> : launch_fused<int8_t, kScoreF32>)(
          vectors, scales, rowid, queries, qsq, qscale, cids, nsb, Q, B, D, p, k, space, scaled,
          vec, out_d, out_r, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype as above, or 3: packed int4 bank [K, B, D/2] uint8 (split layout).
int ivf_pool_scan(int dtype, const void* vectors, const float* scales, const int32_t* rowid,
                  const float* queries, const float* qsq, const int32_t* cids,
                  const int32_t* nsb, int Q, int B, int D, int p, int space, int scaled,
                  int vec, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_pool<float, false>(vectors, scales, rowid, queries, qsq, cids, nsb, Q, B, D,
                                       p, space, scaled, vec, out, st);
    case kBF16:
      return launch_pool<__nv_bfloat16, false>(vectors, scales, rowid, queries, qsq, cids, nsb,
                                               Q, B, D, p, space, scaled, vec, out, st);
    case kI8:
      return launch_pool<int8_t, false>(vectors, scales, rowid, queries, qsq, cids, nsb, Q, B,
                                        D, p, space, scaled, vec, out, st);
    case kPacked:
      return launch_pool<uint8_t, true>(vectors, scales, rowid, queries, qsq, cids, nsb, Q, B,
                                        D, p, space, scaled, vec, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
