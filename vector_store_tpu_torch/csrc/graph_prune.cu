// The graph insert's alpha-RobustPrune for Hopper (sm_90a), with a plain C
// interface (bound with ctypes by vector_store_tpu_torch/core/graph_cuda.py).
//
// Replaces no Pallas kernel.  The JAX package runs this selection as one
// lax.scan over the sorted candidates (vector_store_tpu/core/build.py:
// 61-123), one loop that XLA compiles for the TPU; eager PyTorch runs the
// same scan as ~8 small launches a candidate, ~1,000 an insert block of 256
// nodes at 128 candidates, and the host's launches set the block's pace.
//
// Per node m (a row of the [M, C] candidate lists), candidates t = 0..C-1 in
// order: t is kept if cand_dist[t] < INF, fewer than W are kept yet, and
// t < n_keep or no kept candidate has removed t; a kept t removes every c
// with
//     alpha * pd_cmp[t][c] <= cd_cmp[c]
// in f32, the product rounded on its own (no fused multiply-add), where
// pd_cmp = pd - shift and cd_cmp = cand_dist - shift when a shift is given
// (the dot space), else pd and cand_dist.  Output [M, W]: the kept
// candidates sorted by (distance, position), then (INF, SENTINEL) pads; a
// kept -inf distance carries SENTINEL.  That is the plain version's loop
// followed by its stable top-W and isinf mask, bit for bit, for any input;
// for sorted input (both callers) the kept list is already in order and
// emitted as it stands.
//
// What bounds it on this card: each node is a chain of C dependent steps
// (whether t is kept depends on every kept row before it), and a kept row
// is a read of C floats of pd that the next step waits on.  The bytes it
// needs are small (at the insert shape M 256, C 128, R 32: cand_dist and
// cand_ids, ~R rows of pd a node, ~3 MB in all), so the chain's latency
// sets its time.  The design:
//   * one warp a node (4 a block), everything a node's scan touches in the
//     warp's slice of shared memory: cand_dist [C], the removed flags [C]
//     (bytes: lane c % 32 writes flag c, no atomics) and the kept list;
//   * the scan's decision reads two shared-memory words that every lane
//     reads alike, so the warp never diverges; only a kept candidate's row
//     is read from device memory (coalesced, columns > t only, the earlier
//     flags are never read again), and the scan stops at W kept;
//   * the kept list is compacted in the warp: for sorted input each kept
//     entry's rank is its position, else the rank is counted.
//
// The kernel allocates nothing and launches on the caller's stream; the
// entry point returns cudaGetLastError() of its launch.

#include <math_constants.h>

#include <climits>

#include "scan_common.cuh"

namespace {

constexpr int kMaxWarps = 4;  // nodes a block

// bytes of shared memory a node's scan takes: cand_dist [C] and the kept
// distances [W] (f32), the kept ids [W] (int32), the removed flags [C]
size_t smem_per_node(int C, int W) {
  return (static_cast<size_t>(C) * 5 + static_cast<size_t>(W) * 8 + 15) / 16 * 16;
}

template <bool SHIFT>
__global__ void __launch_bounds__(kMaxWarps * 32)
robust_prune_kernel(const float* __restrict__ pd, const float* __restrict__ cand_dist,
                    const int32_t* __restrict__ cand_ids, const float* __restrict__ shift,
                    float alpha, int M, int C, int W, int n_keep, size_t per_node,
                    float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= M) return;  // the whole warp: nothing below syncs the block
  float* cd = reinterpret_cast<float*>(smem + warp * per_node);
  float* kd = cd + C;
  int32_t* ki = reinterpret_cast<int32_t*>(kd + W);
  unsigned char* removed = reinterpret_cast<unsigned char*>(ki + W);
  const float* cd_g = cand_dist + static_cast<size_t>(m) * C;
  const int32_t* id_g = cand_ids + static_cast<size_t>(m) * C;
  const float* pd_m = pd + static_cast<size_t>(m) * C * C;
  const float s = SHIFT ? *shift : 0.0f;

  for (int c = lane; c < C; c += 32) {
    cd[c] = cd_g[c];
    removed[c] = 0;
  }
  __syncwarp();
  int kept = 0;
  for (int t = 0; t < C; ++t) {
    const float dt = cd[t];
    if (!(dt < CUDART_INF_F) || (t >= n_keep && removed[t])) continue;
    if (lane == 0) {
      kd[kept] = dt;
      ki[kept] = id_g[t];
    }
    if (++kept == W) break;
    const float* row = pd_m + static_cast<size_t>(t) * C;
    for (int c = ((t + 1) & ~31) + lane; c < C; c += 32) {
      const float a = SHIFT ? __fsub_rn(row[c], s) : row[c];
      const float b = SHIFT ? __fsub_rn(cd[c], s) : cd[c];
      if (__fmul_rn(alpha, a) <= b) removed[c] = 1;
    }
    __syncwarp();
  }
  __syncwarp();

  // a stable sort of the kept list by distance (no kept distance is NaN)
  bool in_order = true;
  for (int i = lane + 1; i < kept; i += 32) in_order &= !(kd[i] < kd[i - 1]);
  in_order = __all_sync(0xffffffffu, in_order);
  float* od = out_d + static_cast<size_t>(m) * W;
  int32_t* oi = out_i + static_cast<size_t>(m) * W;
  for (int i = lane; i < W; i += 32) {
    if (i >= kept) {
      od[i] = CUDART_INF_F;
      oi[i] = INT_MAX;
      continue;
    }
    const float d = kd[i];
    int r = i;
    if (!in_order) {
      r = 0;
      for (int j = 0; j < kept; ++j) r += kd[j] < d || (kd[j] == d && j < i);
    }
    od[r] = d;
    oi[r] = isinf(d) ? INT_MAX : ki[i];
  }
}

}  // namespace

extern "C" {

// pd [M, C, C] f32, cand_dist [M, C] f32, cand_ids [M, C] int32, shift a
// device f32 scalar or null -> out_d [M, W] f32, out_i [M, W] int32, with
// 1 <= W <= C the output width and the most kept a node.
int graph_robust_prune(const float* pd, const float* cand_dist, const int32_t* cand_ids,
                       const float* shift, float alpha, int M, int C, int W, int n_keep,
                       float* out_d, int32_t* out_i, void* stream) {
  if (M <= 0 || C <= 0 || W <= 0 || W > C) return cudaErrorInvalidValue;
  const size_t per_node = smem_per_node(C, W);
  if (per_node > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int warps = static_cast<int>(
      per_node * kMaxWarps <= static_cast<size_t>(kMaxSmem) ? kMaxWarps : kMaxSmem / per_node);
  const size_t smem = per_node * warps;
  auto kern = shift ? robust_prune_kernel<true> : robust_prune_kernel<false>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<(M + warps - 1) / warps, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      pd, cand_dist, cand_ids, shift, alpha, M, C, W, n_keep, per_node, out_d, out_i);
  return cudaGetLastError();
}

}  // extern "C"
