// Graph beam-search gather+score kernel B3 for Hopper (sm_90a), with a plain
// C interface (bound with ctypes by vector_store_tpu_torch/core/graph_cuda.py).
//
// Replaces the Pallas TPU kernel _kernel of vector_store_tpu/core/graph_pallas.py
// (:89, called by gather_score_fused, pallas_call at :199).  For each query q
// and each of its BR candidate slots c = cand[q, j], it reads bank row c,
// dequantizes it in f32 (int8 banks: times scales[c]) and writes
//   cosine 1 - s*(x.q),  dot -s*(x.q),  l2 |q|^2 + s^2|x|^2 - 2s*(x.q)
// to out[q, j].  The caller clips sentinel ids into [0, C) before the call
// and masks their distances after (vector_store_tpu/core/search.py:84-98);
// the kernel clamps ids into range once more so a bad id cannot fault.
//
// What bounds it on this card: device-memory bytes.  Each (query, candidate)
// pair reads one row, D * itemsize bytes, for two flops a byte, far below
// the H100's compute-to-bandwidth ratio, and rows are scattered, so each is
// a separate short burst.  The design reads each candidate row once and
// nothing else: the TPU kernel's [C/T, T, D] tile-block DMA and one-hot
// sublane select (graph_pallas.py:11-23, :110-121) were Mosaic alignment
// workarounds and are not carried over.
//   * grid (Q, ceil(BR / kRowsPerBlock)): a block scores kRowsPerBlock
//     candidates of one query, one warp per row (row_dot, scan_common.cuh:
//     16-byte lane loads, the query staged in shared memory, a warp
//     reduction);
//   * the wrapper launches this kernel alone: |q|^2 for l2 is summed from
//     the staged query by one warp, not by a separate launch;
//   * any D: rows whose byte length or base is not 16-byte aligned take
//     the scalar path, and the last D % (16 / itemsize) elements of an
//     aligned row the scalar tail.
// Sums are f32, in another order than the plain PyTorch version.
//
// The kernel allocates nothing and launches on the caller's stream; the
// entry point returns cudaGetLastError() of the launch.

#include "scan_common.cuh"

namespace {

constexpr int kGatherThreads = 256;
constexpr int kRowsPerBlock = 64;

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
    gather_score_kernel(const T* __restrict__ vectors, const float* __restrict__ scales,
                        const float* __restrict__ queries, const int32_t* __restrict__ cand,
                        int BR, int C, int D, int n4, int space, int scaled,
                        float* __restrict__ out) {
  extern __shared__ float qs[];
  __shared__ float q2s;
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  stage_query<T, false>(queries + static_cast<size_t>(qi) * D, qs, D, n4);
  __syncthreads();
  if (space == kL2 && warp == 0) {  // |q|^2 of the staged query
    float s = 0.0f;
    for (int i = lane; i < D; i += 32) s = fmaf(qs[i], qs[i], s);
    s = warp_sum(s);
    if (lane == 0) q2s = s;
  }
  __syncthreads();

  const float q2 = space == kL2 ? q2s : 0.0f;
  const int j0 = blockIdx.y * kRowsPerBlock;
  const int j1 = min(j0 + kRowsPerBlock, BR);
  const int32_t* cq = cand + static_cast<size_t>(qi) * BR;
  float* oq = out + static_cast<size_t>(qi) * BR;
  for (int j = j0 + warp; j < j1; j += nwarps) {
    const int c = min(max(cq[j], 0), C - 1);
    float dot = 0.0f, sq = 0.0f;
    row_dot<T, false>(vectors + static_cast<size_t>(c) * D, qs, D, n4, lane, dot, sq);
    dot = warp_sum(dot);
    sq = warp_sum(sq);
    if (lane == 0) oq[j] = row_distance(dot, sq, scaled ? scales[c] : 1.0f, q2, space);
  }
}

template <typename T>
cudaError_t launch(const void* vectors, const float* scales, const float* queries,
                   const int32_t* cand, int Q, int BR, int C, int D, int space, int scaled,
                   int vec, float* out, cudaStream_t stream) {
  const int n4 = vec ? D / (16 / static_cast<int>(sizeof(T))) : 0;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  auto kern = gather_score_kernel<T>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(Q, (BR + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kGatherThreads, smem, stream>>>(static_cast<const T*>(vectors), scales, queries,
                                               cand, BR, C, D, n4, space, scaled, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8 bank [C, D].  cand [Q, BR] int32,
// queries [Q, D] f32, out [Q, BR] f32.  vec: rows may be read with 16-byte
// loads (row bytes and base address multiples of 16).
int graph_gather_score(int dtype, const void* vectors, const float* scales, const float* queries,
                       const int32_t* cand, int Q, int BR, int C, int D, int space, int scaled,
                       int vec, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(vectors, scales, queries, cand, Q, BR, C, D, space, scaled, vec, out,
                           st);
    case kBF16:
      return launch<__nv_bfloat16>(vectors, scales, queries, cand, Q, BR, C, D, space, scaled,
                                   vec, out, st);
    case kI8:
      return launch<int8_t>(vectors, scales, queries, cand, Q, BR, C, D, space, scaled, vec, out,
                            st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
