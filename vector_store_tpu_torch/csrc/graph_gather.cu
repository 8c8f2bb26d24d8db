// Graph beam-search kernel B3 for Hopper (sm_90a): the expand round's
// adjacency read and candidate scoring in one launch, with a plain C
// interface (bound with ctypes by vector_store_tpu_torch/core/graph_cuda.py).
//
// Replaces the Pallas TPU kernel _kernel of vector_store_tpu/core/graph_pallas.py
// (:89, called by gather_score_fused, pallas_call at :199), and with it the
// XLA ops around it in the expand round (vector_store_tpu/core/search.py:
// 66-98).  Two entry points, one kernel template:
//
//   graph_expand_score   the expand round (core/search.py::_expand_round):
//                        candidate j = b*R + r of query q is
//                        neighbors[clamp(sel_ids[q, b]), r] where sel_live[q, b],
//                        else SENTINEL; an id >= C (the SENTINEL padding of
//                        the adjacency included) comes out as (SENTINEL, INF),
//                        every other id with its row's distance;
//   graph_gather_score   the ids given ([Q, BR], clamped into [0, C) here),
//                        the counterpart of graph_pallas.gather_score_fused.
//
// A candidate row is read, dequantized in f32 (int8 banks: times scales[c])
// and scored: cosine 1 - s*(x.q), dot -s*(x.q), l2 |q|^2 + s^2|x|^2 - 2s*(x.q).
//
// What bounds it on this card: device-memory bytes, at 2 flops a byte
// (each query's candidates are its own: a batched GEMV, nothing for the
// tensor cores to reuse), and, at the expand round's sizes (~50 MB a
// launch), the latency of each warp's chain of dependent row reads.  The
// design (B3 was first written to score one row per warp at a time, its
// loads then two warp sums before the next row's loads, in grid (Q, BR/64)
// blocks that each staged the query again):
//   * one block per query: the query is staged once in shared memory, |q|^2
//     summed once and only for l2;
//   * the block reads the adjacency itself (graph_expand_score), so the
//     round's clamp / gather / mask / compare ops and their launches are gone;
//   * candidates are gathered 512 at a time into a shared-memory list of the
//     rows to read: ids >= C are never read, and a shared-memory hash keeps
//     one entry per distinct id, so each distinct row is read once and its
//     distance written to every position that holds it (on the graphs
//     measured, a query's candidates are 0.37-0.57 distinct at search and
//     0.10-0.48 at insert: two nodes expanded together share neighbours);
//   * the list is scored by sub-warps of L lanes (L = 16 where a row is not
//     a multiple of 32 16-byte chunks, as int8 at D = 768: no lane idles),
//     each with U rows in flight (8, or 2 for large grids: `launch`): every
//     16-byte load of the U rows' current span is in flight before the first
//     FMA, then the U dot products (and |x|^2 for l2) are summed across the
//     sub-warp together, halving the live values at each shuffle step;
//   * int8 and bf16 elements are widened by integer ops (a byte permute
//     into a float's mantissa, a shift), not by conversion instructions;
//   * outputs are written per position, coalesced, after the list.
// Rows whose byte length or base is not 16-byte aligned take a scalar path
// (one warp a row).  Sums are f32, in another order than the plain version.
//
// The kernel allocates nothing and launches on the caller's stream; each
// entry point returns cudaGetLastError() of its launch.

#include <math_constants.h>

#include <climits>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;  // candidate positions per pass: the list, the hash's bound
constexpr int kHashBits = 10;
constexpr int kHash = 1 << kHashBits;  // hash slots, at most half full
static_assert(kHash >= 2 * kChunk, "the dedup hash must stay at most half full");
constexpr int kSentinel = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// Sum each of v[0..V) over the L lanes of a sub-warp (V <= L, both powers
// of two).  Each step hands half of the still-live values to the partner
// lane, so V values take log2(V) + (log2(L) - log2(V)) shuffles per
// halving, not V * log2(L).  On return v[0] of lane li (its index in the
// sub-warp) holds the sum of value li / (L / V).
template <int V>
__device__ __forceinline__ float reduce_rows(float (&v)[V], int lane, int L) {
  int o = L >> 1;
#pragma unroll
  for (int w = V; w > 1; w >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const float send = up ? v[i] : v[i + w / 2];
      const float keep = up ? v[i + w / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(kFull, v[0], o);
  return v[0];
}

// Score list[0..n) (clamped row ids) into dist[0..n).  vec: 16-byte path,
// qs in stage_query's layout with n4 = D / (16 / sizeof(T)) chunks a row;
// else one warp a row, qs plain.
template <typename T, int U, bool L2>
__device__ void score_list(const T* __restrict__ vectors, const float* __restrict__ scales,
                           int scaled, const int* list, int n, const float* qs, int D, int n4,
                           int vec, float q2, int space, float* dist) {
  constexpr int N = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int P = U >= 8 ? 1 : 8 / U;  // chunks of a row per span: U * P loads in flight
  constexpr int V = L2 ? 2 * U : U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!vec) {
    for (int r = warp; r < n; r += kWarps) {
      const int c = list[r];
      const T* row = vectors + static_cast<size_t>(c) * D;
      float dot = 0.0f, sq = 0.0f;
      for (int i = lane; i < D; i += 32) {
        const float x = to_f(row[i]);
        dot = fmaf(x, qs[i], dot);
        if (L2) sq = fmaf(x, x, sq);
      }
      dot = warp_sum(dot);
      if (L2) sq = warp_sum(sq);
      if (lane == 0) dist[r] = row_distance(dot, sq, scaled ? scales[c] : 1.0f, q2, space);
    }
    return;
  }
  const int L = n4 % 32 == 0 ? 32 : 16;
  const int li = lane & (L - 1), sub = lane / L;
  const int per_group = (32 / L) * U;  // rows a warp scores at once
  const int cpl = (n4 + L - 1) / L;    // chunks of a row per lane
  for (int base = warp * per_group; base < n; base += kWarps * per_group) {
    const uint4* rows[U];
    float s[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + sub * U + u;
      ok[u] = r < n;
      const int c = ok[u] ? list[r] : 0;
      rows[u] = reinterpret_cast<const uint4*>(vectors + static_cast<size_t>(c) * D);
      s[u] = ok[u] && scaled ? scales[c] : 1.0f;
    }
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int c0 = 0; c0 < cpl; c0 += P) {
      uint4 x[U][P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = li + (c0 + p) * L;
#pragma unroll
        for (int u = 0; u < U; ++u)
          x[u][p] = ok[u] && c < n4 ? __ldg(rows[u] + c) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = li + (c0 + p) * L;
        if (c >= n4) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int i = 0; i < N / 4; ++i) {
            const float qv = qs[(k * (N / 4) + i) * n4 + c];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const unsigned w = prep<T>((&x[u][p].x)[k]);
              const float e = elem<T>(w, i);
              if constexpr (L2) {
                acc[2 * u] = fmaf(e, qv, acc[2 * u]);
                acc[2 * u + 1] = fmaf(e, e, acc[2 * u + 1]);
              } else {
                acc[u] = fmaf(e, qv, acc[u]);
              }
            }
          }
        }
      }
    }
    // lane li holds value li / (L / V): row u's dot at 2u (l2) or u, |x|^2 at 2u + 1
    const float v = reduce_rows<V>(acc, li, L);
    const int step = L / V;
    const float sq = L2 ? __shfl_down_sync(kFull, v, step) : 0.0f;
    const int vi = li / step;
    if (li % step == 0 && (!L2 || vi % 2 == 0)) {
      const int u = L2 ? vi / 2 : vi;
      float su = s[0];
      bool oku = ok[0];
#pragma unroll
      for (int w = 1; w < U; ++w) {
        if (u == w) {
          su = s[w];
          oku = ok[w];
        }
      }
      if (oku) dist[base + sub * U + u] = row_distance(v, sq, su, q2, space);
    }
  }
}

// One block per query.  ADJ: candidates through the adjacency (sel_ids,
// sel_live, neighbors; out_ids written); else cand [Q, BR].  Dynamic
// shared memory: the query, D floats.
template <typename T, int U, bool L2, bool ADJ>
__global__ void __launch_bounds__(kThreads)
    graph_score_kernel(const T* __restrict__ vectors, const float* __restrict__ scales,
                       const float* __restrict__ queries, const int32_t* __restrict__ cand,
                       const int32_t* __restrict__ neighbors, const int32_t* __restrict__ sel_ids,
                       const uint8_t* __restrict__ sel_live, int BR, int B, int R, int C, int D,
                       int n4, int vec, int space, int scaled, int32_t* __restrict__ out_ids,
                       float* __restrict__ out) {
  extern __shared__ float qs[];
  __shared__ int list[kChunk];    // distinct row ids to read
  __shared__ int slot[kChunk];    // each position's hash slot, -1 for none
  __shared__ float dist[kChunk];  // the list's distances
  __shared__ int hkey[kHash];     // row id per hash slot, -1 empty
  __shared__ int hval[kHash];     // its list entry
  __shared__ int n_list;
  __shared__ float q2s;
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_query<T>(queries + static_cast<size_t>(qi) * D, qs, D, n4);
  __syncthreads();
  if (L2 && warp == 0) {
    float s = 0.0f;
    for (int i = lane; i < D; i += 32) s = fmaf(qs[i], qs[i], s);
    s = warp_sum(s);
    if (lane == 0) q2s = s;
  }
  const size_t qb = static_cast<size_t>(qi) * BR;
  for (int j0 = 0; j0 < BR; j0 += kChunk) {
    const int m = min(kChunk, BR - j0);
    if (threadIdx.x == 0) n_list = 0;
    for (int h = threadIdx.x; h < kHash; h += kThreads) hkey[h] = -1;
    __syncthreads();
    // 1. this chunk's ids -> the list of rows to read
    for (int jj = threadIdx.x; jj < ((m + 31) / 32) * 32; jj += kThreads) {
      const int j = j0 + jj;
      int id = kSentinel;
      bool valid = false;
      if (jj < m) {
        if (ADJ) {
          const int b = j / R, r = j - b * R;
          if (sel_live[static_cast<size_t>(qi) * B + b]) {
            const int sel = min(max(sel_ids[static_cast<size_t>(qi) * B + b], 0), C - 1);
            id = neighbors[static_cast<size_t>(sel) * R + r];
          }
          valid = id < C;
          out_ids[qb + j] = valid ? id : kSentinel;
        } else {
          id = cand[qb + j];
          valid = true;
        }
      }
      const int c = min(max(id, 0), C - 1);
      bool fresh = valid;  // a new list entry
      int h = -1;
      if (valid) {
        h = static_cast<int>((static_cast<unsigned>(c) * 2654435761u) >> (32 - kHashBits));
        for (;;) {
          const int prev = atomicCAS(&hkey[h], -1, c);
          if (prev == -1) break;
          if (prev == c) {
            fresh = false;
            break;
          }
          h = (h + 1) & (kHash - 1);
        }
      }
      // warp-aggregated append of the fresh ids
      const unsigned mask = __ballot_sync(kFull, fresh);
      int first = 0;
      if (lane == 0 && mask) first = atomicAdd(&n_list, __popc(mask));
      first = __shfl_sync(kFull, first, 0);
      if (fresh) {
        const int e = first + __popc(mask & ((1u << lane) - 1));
        list[e] = c;
        hval[h] = e;
      }
      if (jj < m) slot[jj] = valid ? h : -1;
    }
    __syncthreads();
    // 2. score the list
    const float q2 = L2 ? q2s : 0.0f;
    if (L2)
      score_list<T, U, true>(vectors, scales, scaled, list, n_list, qs, D, n4, vec, q2, kL2, dist);
    else
      score_list<T, U, false>(vectors, scales, scaled, list, n_list, qs, D, n4, vec, q2, space,
                              dist);
    __syncthreads();
    // 3. every position's distance, coalesced
    for (int jj = threadIdx.x; jj < m; jj += kThreads) {
      const int sl = slot[jj];
      out[qb + j0 + jj] = sl < 0 ? CUDART_INF_F : dist[hval[sl]];
    }
    __syncthreads();  // the list and hash are rebuilt for the next chunk
  }
}

template <typename T, int U, bool ADJ>
cudaError_t launch_rows(const void* vectors, const float* scales, const float* queries,
                        const int32_t* cand, const int32_t* neighbors, const int32_t* sel_ids,
                        const uint8_t* sel_live, int Q, int BR, int B, int R, int C, int D,
                        int space, int scaled, int vec, int32_t* out_ids, float* out,
                        cudaStream_t stream) {
  const int n4 = vec ? D / (16 / static_cast<int>(sizeof(T))) : 0;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  auto kern = space == kL2 ? graph_score_kernel<T, U, true, ADJ> : graph_score_kernel<T, U, false, ADJ>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<Q, kThreads, smem, stream>>>(static_cast<const T*>(vectors), scales, queries, cand,
                                      neighbors, sel_ids, sel_live, BR, B, R, C, D, n4, vec, space,
                                      scaled, out_ids, out);
  return cudaGetLastError();
}

// Rows in flight per sub-warp, by the grid (measured on the H100, PERF.md):
// a batch of fewer than 4 blocks per SM (a search) is bound by each
// warp's chain of dependent reads, so 8 rows; a larger one (an insert
// block) by occupancy, so 2 (63 registers against 106-128 for 8).
template <typename T, bool ADJ>
cudaError_t launch(const void* vectors, const float* scales, const float* queries,
                   const int32_t* cand, const int32_t* neighbors, const int32_t* sel_ids,
                   const uint8_t* sel_live, int Q, int BR, int B, int R, int C, int D, int space,
                   int scaled, int vec, int32_t* out_ids, float* out, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  return Q >= 4 * sms
             ? launch_rows<T, 2, ADJ>(vectors, scales, queries, cand, neighbors, sel_ids,
                                      sel_live, Q, BR, B, R, C, D, space, scaled, vec, out_ids,
                                      out, stream)
             : launch_rows<T, 8, ADJ>(vectors, scales, queries, cand, neighbors, sel_ids,
                                      sel_live, Q, BR, B, R, C, D, space, scaled, vec, out_ids,
                                      out, stream);
}

template <bool ADJ>
cudaError_t launch_dtype(int dtype, const void* vectors, const float* scales,
                         const float* queries, const int32_t* cand, const int32_t* neighbors,
                         const int32_t* sel_ids, const uint8_t* sel_live, int Q, int BR, int B,
                         int R, int C, int D, int space, int scaled, int vec, int32_t* out_ids,
                         float* out, cudaStream_t stream) {
  if (Q <= 0 || BR <= 0 || C <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch<float, ADJ>(vectors, scales, queries, cand, neighbors, sel_ids, sel_live, Q,
                                BR, B, R, C, D, space, scaled, vec, out_ids, out, stream);
    case kBF16:
      return launch<__nv_bfloat16, ADJ>(vectors, scales, queries, cand, neighbors, sel_ids,
                                        sel_live, Q, BR, B, R, C, D, space, scaled, vec, out_ids,
                                        out, stream);
    case kI8:
      return launch<int8_t, ADJ>(vectors, scales, queries, cand, neighbors, sel_ids, sel_live, Q,
                                 BR, B, R, C, D, space, scaled, vec, out_ids, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8 bank [C, D].  queries [Q, D] f32.
// vec: rows may be read with 16-byte loads (row bytes and base address
// multiples of 16).

// cand [Q, BR] int32 (clamped into [0, C) here) -> out [Q, BR] f32.
int graph_gather_score(int dtype, const void* vectors, const float* scales, const float* queries,
                       const int32_t* cand, int Q, int BR, int C, int D, int space, int scaled,
                       int vec, float* out, void* stream) {
  return launch_dtype<false>(dtype, vectors, scales, queries, cand, nullptr, nullptr, nullptr, Q,
                             BR, 1, BR, C, D, space, scaled, vec, nullptr, out,
                             static_cast<cudaStream_t>(stream));
}

// neighbors [C, R] int32, sel_ids [Q, B] int32, sel_live [Q, B] uint8 ->
// out_ids [Q, B*R] int32, out [Q, B*R] f32.
int graph_expand_score(int dtype, const void* vectors, const float* scales, const float* queries,
                       const int32_t* neighbors, const int32_t* sel_ids, const uint8_t* sel_live,
                       int Q, int B, int R, int C, int D, int space, int scaled, int vec,
                       int32_t* out_ids, float* out, void* stream) {
  return launch_dtype<true>(dtype, vectors, scales, queries, nullptr, neighbors, sel_ids,
                            sel_live, Q, B * R, B, R, C, D, space, scaled, vec, out_ids, out,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
