// The graph insert's reverse edges for Hopper (sm_90a), with a plain C
// interface (bound with ctypes by vector_store_tpu_torch/core/graph_cuda.py).
//
// Replaces no Pallas kernel.  The JAX package applies the reverse edges as
// a fori_loop of REVERSE_ROUNDS rounds over the edges sorted by (target,
// length) (vector_store_tpu/core/build.py:126-165), one loop that XLA
// compiles for the TPU; eager PyTorch runs the same rounds as ~15 small
// launches each, after a nonzero and a host read that size them: ~250 of an
// insert block's ~470 device operations, and the host's launches set the
// block's pace.
//
// The rounds exist only so that no round writes one target row twice.  Two
// facts make one warp per target exact: within a target the rounds apply
// its edges in rank order, and different targets never read or write each
// other's rows.  So per target, its first `rounds` edges by (length, edge
// index), in that order: the row's worst slot (the largest nbr_dist, the
// lowest slot among equals, NaN above every number, as torch.argmax picks
// it) takes (src, d) of the edge when d < its distance.  Later edges are
// dropped, dead edges (SENTINEL targets) skipped.  That is
// core/graph_cuda.py::reverse_edges_plain's result bit for bit.
//
// What bounds it on this card: nothing of note.  An insert block of 256
// nodes at degree 32 offers 8,192 edges to at most 8,192 rows (32 KB of
// ids and 32 KB of lengths, a row of 256 bytes read and at most once
// written back each); a launch is a few microseconds of device time.  What
// costs is the host's launches around it, so the caller sorts the edges by
// target alone (one stable sort) and the kernel orders each target's run
// by length itself.  The design:
//   * one warp a sorted edge; the warp whose edge starts a run (its target
//     differs from the edge before it) owns that target, the others exit;
//     the run's end is a ballot over the sorted targets;
//   * the target's row lives in registers, slot j in lane j % 32 (K slots a
//     lane for a degree R <= 32K); each step takes the run's next edge by a
//     shuffle arg-min of (length, index) over what follows the last one
//     taken, then the row's worst slot by a shuffle arg-max, so every lane
//     takes the same decision and the warp never diverges;
//   * the row is written back once, and only if an edge replaced a slot.
// The edges are read through the sort's permutation, so the caller gathers
// nothing.  Targets outside [0, C) change nothing.
//
// The kernel allocates nothing and launches on the caller's stream; the
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;  // sorted edges a block
constexpr int kMaxK = 8;   // slots a lane: degree <= 256
constexpr unsigned kFull = 0xffffffffu;

// true where (v1, s1) ranks above (v2, s2) in the worst-slot arg-max: a
// held slot (s >= 0) above none, NaN above every number, then the larger
// value, then the lower slot
__device__ __forceinline__ bool ranks_above(float v1, int s1, float v2, int s2) {
  if (s2 < 0) return s1 >= 0;
  if (s1 < 0) return false;
  const bool n1 = isnan(v1), n2 = isnan(v2);
  if (n1 || n2) return n1 && n2 ? s1 < s2 : n1;
  if (v1 != v2) return v1 > v2;
  return s1 < s2;
}

// true where edge (d1, e1) comes before (d2, e2) in a target's order: the
// stable sort by length of the plain version (NaN after every number,
// -0.0 equal to 0.0), ties by edge index; e < 0 is none, after every edge
__device__ __forceinline__ bool comes_before(float d1, int64_t e1, float d2, int64_t e2) {
  if (e2 < 0) return e1 >= 0;
  if (e1 < 0) return false;
  const bool n1 = isnan(d1), n2 = isnan(d2);
  if (n1 != n2) return n2;
  if (!n1 && d1 != d2) return d1 < d2;
  return e1 < e2;
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
reverse_edges_kernel(int32_t* __restrict__ neighbors, float* __restrict__ nbr_dist,
                     const int32_t* __restrict__ tgt_s, const int64_t* __restrict__ perm,
                     const int32_t* __restrict__ src, const float* __restrict__ d, int E, int C,
                     int R, int rounds) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= E) return;  // the whole warp: nothing below syncs the block
  const int32_t t = tgt_s[i];
  if (t == INT_MAX || (i > 0 && tgt_s[i - 1] == t)) return;
  if (t < 0 || t >= C) return;
  // the run [i, j) of target t: the sorted targets equal to t form a prefix
  int j = i;
  for (;;) {
    const int k = j + lane;
    const unsigned in = __ballot_sync(kFull, k < E && tgt_s[k] == t);
    j += __popc(in);
    if (in != kFull) break;
  }
  int32_t* row_n = neighbors + static_cast<size_t>(t) * R;
  float* row_d = nbr_dist + static_cast<size_t>(t) * R;
  int32_t n[K];
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane + 32 * k;
    n[k] = s < R ? row_n[s] : 0;
    v[k] = s < R ? row_d[s] : 0.0f;
  }
  bool changed = false;
  float last_d = 0.0f;
  int64_t last_e = -1;
  const int steps = min(j - i, rounds);
  for (int r = 0; r < steps; ++r) {
    // the run's next edge in order: the first after the last one taken
    float ed = 0.0f;
    int64_t e = -1;
    for (int k = i + lane; k < j; k += 32) {
      const int64_t ek = perm[k];
      const float dk = d[ek];
      if ((r == 0 || comes_before(last_d, last_e, dk, ek)) && comes_before(dk, ek, ed, e)) {
        ed = dk;
        e = ek;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, ed, off);
      const int64_t oe = __shfl_xor_sync(kFull, e, off);
      if (comes_before(od, oe, ed, e)) {
        ed = od;
        e = oe;
      }
    }
    last_d = ed;
    last_e = e;
    // the row's worst slot
    float worst = 0.0f;
    int slot = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = lane + 32 * k;
      if (s < R && ranks_above(v[k], s, worst, slot)) {
        worst = v[k];
        slot = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ow = __shfl_xor_sync(kFull, worst, off);
      const int os = __shfl_xor_sync(kFull, slot, off);
      if (ranks_above(ow, os, worst, slot)) {
        worst = ow;
        slot = os;
      }
    }
    if (!(ed < worst)) continue;  // every lane holds the same edge and slot
    changed = true;
    const int32_t se = src[e];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + 32 * k == slot) {
        n[k] = se;
        v[k] = ed;
      }
    }
  }
  if (!changed) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane + 32 * k;
    if (s < R) {
      row_n[s] = n[k];
      row_d[s] = v[k];
    }
  }
}

template <int K>
cudaError_t launch(int32_t* neighbors, float* nbr_dist, const int32_t* tgt_s,
                   const int64_t* perm, const int32_t* src, const float* d, int E, int C, int R,
                   int rounds, cudaStream_t stream) {
  reverse_edges_kernel<K><<<(E + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      neighbors, nbr_dist, tgt_s, perm, src, d, E, C, R, rounds);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// neighbors [C, R] int32 and nbr_dist [C, R] f32, updated in place; tgt_s
// [E] int32 the edges' targets sorted stably (SENTINEL where an edge is
// dead), perm [E] int64 that sort's permutation, src [E] int32 and d [E]
// f32 the edges in their own order; a target's edges ranked `rounds` or
// later by (length, index) are dropped.  1 <= R <= 256.
int graph_reverse_edges(int32_t* neighbors, float* nbr_dist, const int32_t* tgt_s,
                        const int64_t* perm, const int32_t* src, const float* d, int E, int C,
                        int R, int rounds, void* stream) {
  if (E <= 0 || C <= 0 || R <= 0 || R > 32 * kMaxK || rounds < 0) return cudaErrorInvalidValue;
  if (rounds == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const int k = (R + 31) / 32;
  if (k == 1) return launch<1>(neighbors, nbr_dist, tgt_s, perm, src, d, E, C, R, rounds, s);
  if (k == 2) return launch<2>(neighbors, nbr_dist, tgt_s, perm, src, d, E, C, R, rounds, s);
  if (k <= 4) return launch<4>(neighbors, nbr_dist, tgt_s, perm, src, d, E, C, R, rounds, s);
  return launch<kMaxK>(neighbors, nbr_dist, tgt_s, perm, src, d, E, C, R, rounds, s);
}

}  // extern "C"
