// Device helpers shared by the kernels (ivf_scan.cu, graph_gather.cu,
// copy_probe.cu): widening stored elements to f32, staging a query in
// shared memory, one warp scoring one stored row against it.
//
// Each lane loads 16 bytes of the row at a time, so a warp streams 512
// contiguous bytes per step.  The query is staged transposed by 16-byte
// chunk so that the 32 lanes of a warp read 32 consecutive floats (no bank
// conflicts).  Distances (ascending): cosine 1 - s*(x.q), dot -s*(x.q),
// l2 |q|^2 + s^2|x|^2 - 2s*(x.q), sums in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmem = 232448;  // opt-in shared memory per block on sm_90
enum Space { kCosine = 0, kDot = 1, kL2 = 2 };
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kPacked = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
// sign-extend a 4-bit code
__device__ __forceinline__ float nibble(int v) { return static_cast<float>((v ^ 8) - 8); }

// Element i of a 32-bit word of T, widened to f32 by integer ops, after
// prep<T> on the word (no conversion instruction: I2F runs at a quarter
// of the FMA rate).
template <typename T>
__device__ __forceinline__ float elem(unsigned w, int i);
template <>
__device__ __forceinline__ float elem<float>(unsigned w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(unsigned w, int i) {
  return __uint_as_float(i == 0 ? w << 16 : w & 0xffff0000u);
}
// w holds four int8 with their sign bits flipped (w ^ 0x80808080): byte i
// goes into the mantissa of 2^23, which is 2^23 + 128 + x exactly
template <>
__device__ __forceinline__ float elem<int8_t>(unsigned w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440u + i)) - 8388736.0f;
}
template <typename T>
__device__ __forceinline__ unsigned prep(unsigned w) {
  return sizeof(T) == 1 ? w ^ 0x80808080u : w;
}

// Stage one query [D] into shared memory in the layout row_dot reads.
// A row of dw stored elements is n4 full 16-byte chunks of N = 16/sizeof(T)
// elements, then a tail.  Element t of chunk c is read by lane c % 32, so its
// query weight goes to qs[t * n4 + c]; tail elements keep their index.
template <typename T>
__device__ void stage_query(const float* __restrict__ q, float* qs, int dw, int n4) {
  constexpr int N = 16 / sizeof(T);
  for (int i = threadIdx.x; i < dw; i += blockDim.x) {
    const int c = i / N, t = i % N;
    qs[c < n4 ? t * n4 + c : i] = q[i];
  }
}

// This lane's share of x.q and |x|^2 for one stored row.
template <typename T>
__device__ __forceinline__ void row_dot(const T* __restrict__ row, const float* __restrict__ qs,
                                        int dw, int n4, int lane, float& dot, float& sq) {
  constexpr int N = 16 / sizeof(T);
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  for (int c = lane; c < n4; c += 32) {
    const uint4 u = __ldg(r4 + c);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const float x = to_f(e[t]);
      dot = fmaf(x, qs[t * n4 + c], dot);
      sq = fmaf(x, x, sq);
    }
  }
  for (int i = N * n4 + lane; i < dw; i += 32) {
    const float x = to_f(row[i]);
    dot = fmaf(x, qs[i], dot);
    sq = fmaf(x, x, sq);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_distance(float dot, float sq, float s, float q2, int space) {
  dot = dot * s;
  if (space == kL2) return q2 + sq * s * s - 2.0f * dot;
  if (space == kDot) return -dot;
  return 1.0f - dot;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
