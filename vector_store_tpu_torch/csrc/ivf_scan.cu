// IVF probe-scan kernels for Hopper (sm_90a), with a plain C interface
// (bound with ctypes by vector_store_tpu_torch/core/ivf_cuda.py).
//
// Replaces the two Pallas TPU kernels of vector_store_tpu/core/ivf_pallas.py:
//
//   ivf_search_fused  <- _kernel (ivf_pallas.py:128), called by search_fused
//                        (:418, pallas_call at :500).  Scores every live row
//                        of each query's p probed buckets and keeps the k
//                        best (k <= 32), in the TPU kernel's four score modes
//                        (:153-221): f32, qi8, bf16 and stub.
//   ivf_pool_scan     <- _pool_kernel (ivf_pallas.py:252), called by
//                        pool_scan_fused (:329, pallas_call at :396).  Same
//                        scoring (f32 mode), but writes the raw [Q, p*B]
//                        distance pool; also reads the int4 split-nibble
//                        bank.
//
// What bounds them on this card: device-memory bytes.  A probed bucket's
// live prefix is B*D bytes (int8) against a few operations per byte, far
// below the H100's ~300 operations per byte of bandwidth.
//
// B1 (ivf_search_fused) is three launches on the caller's stream:
//
//   1. b1_worklist (one block): groups the Q*p (query, rank) pairs by the
//      bucket they probe, in a shared-memory hash of the bucket ids, and cuts
//      each bucket's pairs into tiles of at most kTile = 16.  It writes the
//      tile list and its length to device memory: no size goes back to the
//      host, so the launch needs no synchronisation.  Which pairs share a
//      tile depends on the order of the atomics, never the results: each
//      pair's top-k is exact on its own.
//   2. tile_scan (persistent: one wave of blocks that take tiles from an
//      atomic counter): a tile reads its bucket's live prefix from device
//      memory ONCE for all its pairs.  The old design (one block per query)
//      read a bucket once per query that probed it: 7 of every 8 row bytes at
//      phase 1's shapes, 46% on the bench-geometry index.
//      Scoring on int8 banks runs on the tensor cores, mma.sync
//      m16n8k32 s8 x s8 -> s32: a warp takes 16 rows x the tile's queries,
//      each lane loading 16 contiguous bytes of a row per step straight into
//      its A fragment (the k order inside a step is permuted the same way on
//      the query side, which the dot product does not see), so no row byte
//      is converted, staged or read from shared memory:
//        qi8  the query's int8 codes (ivf_pallas.py:454-459, computed here
//             in the same f32 operations) are the B operand; the int32 dot
//             is exact and scaled as dot * (scale * qscale) by __fmul_rn,
//             so the distances equal the TPU kernel's bit for bit;
//        f32  the f32 query is cut into four signed int8 digits at a power
//             of two (q = 2^e * (d1 + d2/2^7 + d3/2^14 + d4/2^21), |d| <=
//             64), four MMAs per step whose exact int32 sums are combined in
//             int64 and rounded once to f32: 27 bits of the query's
//             significand, more than f32's 24, for the largest elements;
//             the error is ~1e-8 of a cosine distance.  No TF32.
//        bf16 the same path on the query rounded to bf16 (f32's RN, as the
//             wrapper of the TPU kernel rounds it);
//        l2   |x|^2 per row from __dp4a on the fragments already in
//             registers, only in the l2 instantiation;
//        stub the copy floor of this design: the same tiles and loads (their
//             words XOR-folded and stored to a device-memory sink, or the
//             compiler drops them), no MMA, a row scoring element 0 x scale.
//      bf16 and f32 banks keep CUDA-core scoring inside the same tiles and
//      top-k (their rows are not exact in int8 and they are not the serving
//      path): with 16-byte rows, a warp scores 4 rows at once, each query
//      element it reads from shared memory feeding the 4 rows' FMAs
//      (score_core_rows); otherwise, as for int8 rows that are not 16-byte
//      aligned, one warp per row.
//      Each tile keeps a running top-k of (distance, row) per pair in the
//      registers of one warp (lane i holds entry i; of each 32 rows, the
//      candidates that beat entry k-1 are inserted one by one by ballot and
//      shuffle, or, kMergeMin or more of them, sorted and merged
//      bitonically), fed 128 rows (one live-prefix sub-block) at a time
//      through a double-buffered score block in shared memory, and writes
//      [Q, p, k] partials.
//   3. b1_merge (one warp per query): the p sorted partial lists merge to k
//      in (distance, pool position r*B + j) order, ties to the lowest
//      position as jnp.argmin gives; position -> rowid, SENTINEL where INF.
//      Exact: the top k of a union under a total order is the top k of the
//      parts' top k.  The [p*B] pool in shared memory of the old design is
//      gone, and with it its cap on p*B: a block's shared memory now depends
//      on D alone (kMaxDims).
//
// Decided by measurement on the H100 (PERF.md, PR 4): rows go from device
// memory straight into registers, eight 16-byte loads in flight a lane,
// two blocks per SM.  A per-warp cp.async ring in shared memory was slower
// at every shape (its shared memory leaves one block per SM, and a tile's
// serial steps -- fetch, query staging, barriers -- lose the second
// block's overlap), and so were four or sixteen loads in flight a lane
// (U = 2, 8) and three blocks per SM (registers spill); tiles of 8 pairs
// were no faster.  What bounds the design: its copy alone (the stub) takes
// about 0.8 of B1's time, at 0.47-0.72 of the bound; the rest is scoring
// and the top-k.
//
// B2 (ivf_pool_scan) is B1's first two launches with another epilogue: the
// same work list, then the same persistent scan over its tiles (one scan
// body, tile_scan_kernel, serves both), so a tile reads its bucket's live
// prefix from device memory once for its <= 16 pairs (one block per (rank,
// query), as B2 was first written, read a bucket once for every query that
// probed it and scored each row with one warp's f32 FMAs).  Where B1 folds
// each 128-row score block into a top-k, B2 stores it straight to
// out[q, r*B + j], one warp a pair, coalesced, and writes INF past the live
// prefix, so the pool needs no memset.  Scoring is B1's f32 mode: int8 rows
// on the tensor cores with the query's four digits, bf16 and f32 rows on
// CUDA cores.  The packed int4 bank (byte j: dim j in its low nibble, dim
// j + D/2 in its high one, both sign-extended) runs on the tensor cores too:
// each 16-byte load splits in registers into two s8 fragments of nibbles
// (__vsub4), multiplied with the query digits of the two halves; its scale
// is scale * 127/7.  Past kMaxDims dims a tile's staged queries do not fit
// in shared memory, so B2 takes the row in chunks of `ec` elements (the
// wrapper's pool_chunk): each chunk stages its part of the queries, scores
// the bucket's rows over it on the same units, and adds its share of each
// distance to the pool (the last chunk adds the constant term: 1 for
// cosine, |q|^2 for l2).  The rows are still read once; only the pool is
// read back, once per chunk after the first.  So B2 takes any D.
//
// Rows past a bucket's live prefix (nsb[c] * 128 rows) and tombstoned rows
// (rowid == SENTINEL) are never read: their distance is INF.
//
// Distances (ascending): cosine 1 - s*(x.q), dot -s*(x.q),
// l2 |q|^2 + s^2|x|^2 - 2s*(x.q); the row scale s applies to int8 and
// packed banks only (packed: s * 127/7).  Sums are f32 (or exact integers),
// in another order than the plain PyTorch versions.
//
// No kernel allocates: the caller passes every buffer.  All launch on the
// caller's stream and the entry points return cudaGetLastError().

#include <math_constants.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "scan_common.cuh"

namespace {

constexpr int kSentinel = INT_MAX;  // "no row" id (vector_store_tpu core/topk.py)
constexpr int kSubBlock = 128;      // live-prefix granularity (ivf_pallas.SB)
constexpr float kInt4Scale = 127.0f / 7.0f;
enum Score { kScoreF32 = 0, kScoreQi8 = 1, kScoreBf16 = 2, kScoreStub = 3 };

// B1's geometry
constexpr int kTile = 16;                 // pairs per tile: two mma N-blocks of 8
constexpr int kScanWarps = kSubBlock / 16;  // a warp scores 16 rows (one mma M-block)
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kWorkThreads = 1024;
constexpr int kMaxPairs = 8192;           // Q*p of one work list (ivf_cuda.MAX_PAIRS)
constexpr int kPairsPerThread = kMaxPairs / kWorkThreads;
constexpr int kMergeWarps = 4;
constexpr int kDigits = 4;                // int8 digits of an f32 query
constexpr int kMaxDims = 3072;            // ivf_cuda.FUSED_MAX_DIMS
constexpr unsigned kFull = 0xffffffffu;
// candidates of a 32-row step that beat entry k-1: at least this many are
// merged by a bitonic sort and merge, fewer are inserted one at a time
constexpr int kMergeMin = 4;

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Lexicographic (distance, position) minimum across the warp.
__device__ __forceinline__ void warp_argmin(float& d, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (od < d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

// ---------------------------------------------------------------------------
// B1: work list

// Block-wide exclusive prefix sum of one int per thread (kWorkThreads
// threads); `total` receives the sum.  `scratch` holds 32 ints.
__device__ int block_exclusive_sum(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = scratch[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  total = scratch[31];
  const int out = incl - v + (warp > 0 ? scratch[warp - 1] : 0);
  __syncthreads();  // scratch is reused by the next call
  return out;
}

// One block of kWorkThreads; dynamic shared memory 2 * H ints (H a power of
// two >= 2N, 2^hbits).  Pair e = q*p + r probes bucket cids[e].  Writes
// order[N] (pairs grouped by bucket, each bucket's pairs contiguous),
// tile_start[t] / tile_n[t] for t < meta[0] (tile t is order[tile_start[t]
// .. + tile_n[t]), one bucket, at most kTile pairs), and meta[1] = 0 (the
// scan's tile counter).
__global__ void __launch_bounds__(kWorkThreads)
    b1_worklist_kernel(const int32_t* __restrict__ cids, int N, int hbits,
                       int32_t* __restrict__ order, int32_t* __restrict__ tile_start,
                       int32_t* __restrict__ tile_n, int32_t* __restrict__ meta) {
  extern __shared__ int32_t wsm[];
  const int H = 1 << hbits;
  int32_t* key = wsm;     // bucket id per hash slot (-1 empty); later the slot's first tile
  int32_t* cnt = wsm + H;  // pairs per slot
  __shared__ int scratch[32];
  for (int i = threadIdx.x; i < H; i += kWorkThreads) {
    key[i] = -1;
    cnt[i] = 0;
  }
  __syncthreads();

  int slot[kPairsPerThread], rank[kPairsPerThread];
#pragma unroll
  for (int m = 0; m < kPairsPerThread; ++m) {
    const int e = threadIdx.x + m * kWorkThreads;
    slot[m] = -1;
    rank[m] = 0;
    if (e < N) {
      const int c = cids[e];
      unsigned h = (static_cast<unsigned>(c) * 2654435761u) >> (32 - hbits);
      for (;;) {
        const int prev = atomicCAS(&key[h], -1, c);
        if (prev == -1 || prev == c) break;
        h = (h + 1) & (H - 1);
      }
      slot[m] = static_cast<int>(h);
      rank[m] = atomicAdd(&cnt[h], 1);
    }
  }
  __syncthreads();

  // each thread owns `per` consecutive slots: their tiles and pairs, scanned
  const int per = (H + kWorkThreads - 1) / kWorkThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, H), hi = min(lo + per, H);
  int tiles = 0, pairs = 0;
  for (int s = lo; s < hi; ++s) {
    tiles += (cnt[s] + kTile - 1) / kTile;
    pairs += cnt[s];
  }
  int n_tiles, n_pairs;  // n_pairs == N
  int tbase = block_exclusive_sum(tiles, scratch, n_tiles);
  int pbase = block_exclusive_sum(pairs, scratch, n_pairs);
  (void)n_pairs;
  for (int s = lo; s < hi; ++s) {  // key[s] becomes the slot's first pair; cnt keeps the count
    const int c = cnt[s];
    key[s] = pbase;
    pbase += c;
    for (int t = 0; t < c; t += kTile) {
      tile_start[tbase] = key[s] + t;
      tile_n[tbase] = min(kTile, c - t);
      ++tbase;
    }
  }
  if (threadIdx.x == 0) {
    meta[0] = n_tiles;
    meta[1] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kPairsPerThread; ++m) {
    if (slot[m] >= 0) order[key[slot[m]] + rank[m]] = threadIdx.x + m * kWorkThreads;
  }
}

// ---------------------------------------------------------------------------
// B1: scan

__device__ __forceinline__ bool lex_less(float ad, int aj, float bd, int bj) {
  return ad < bd || (ad == bd && aj < bj);
}

// Insert (xd, xj) into the sorted list held one entry per lane.
__device__ __forceinline__ void list_insert(float& md, int& mj, float xd, int xj, int lane) {
  const int pos = __popc(__ballot_sync(kFull, lex_less(md, mj, xd, xj)));
  const float ud = __shfl_up_sync(kFull, md, 1);
  const int uj = __shfl_up_sync(kFull, mj, 1);
  if (lane == pos) {
    md = xd;
    mj = xj;
  } else if (lane > pos) {
    md = ud;
    mj = uj;
  }
}

// Sort (d, j), one per lane, ascending across the warp (bitonic).
__device__ __forceinline__ void warp_sort(float& d, int& j, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, stride);
      const int oj = __shfl_xor_sync(kFull, j, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_min == lex_less(od, oj, d, j)) {
        d = od;
        j = oj;
      }
    }
  }
}

// Merge the candidates (d, j), one per lane (INF, INT_MAX where none), into
// the sorted list (md, mj): the lower half of the list against the sorted
// candidates reversed is bitonic and holds the 32 smallest; five steps sort it.
__device__ __forceinline__ void list_merge(float& md, int& mj, float d, int j, int lane) {
  warp_sort(d, j, lane);
  const float rd = __shfl_sync(kFull, d, 31 - lane);
  const int rj = __shfl_sync(kFull, j, 31 - lane);
  if (lex_less(rd, rj, md, mj)) {
    md = rd;
    mj = rj;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const float od = __shfl_xor_sync(kFull, md, stride);
    const int oj = __shfl_xor_sync(kFull, mj, stride);
    if (((lane & stride) == 0) == lex_less(od, oj, md, mj)) {
      md = od;
      mj = oj;
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// sum of the squares of 16 signed bytes, added to acc
__device__ __forceinline__ int sq_s8(uint4 u, int acc) {
  const int x = static_cast<int>(u.x), y = static_cast<int>(u.y);
  const int z = static_cast<int>(u.z), w = static_cast<int>(u.w);
  return __dp4a(x, x, __dp4a(y, y, __dp4a(z, z, __dp4a(w, w, acc))));
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the stub's copy: the same 16-byte load, folded into `fold`, which the
// caller stores to device memory (`sink`) so that no load is dead code
__device__ __forceinline__ unsigned ld16_fold(const void* p, unsigned fold) {
  const uint4 u = ld16(p);
  return fold ^ u.x ^ u.y ^ u.z ^ u.w;
}

// x * 2^e for any e, exact while the result is normal
__device__ __forceinline__ float scale2(float x, float f, int e) {
  return (e >= -126 && e <= 127) ? x * f : ldexpf(x, e);
}

__device__ __forceinline__ float query_value(float x, int score) {
  return score == kScoreBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

struct TileMeta {
  int e[kTile];      // pair id q*p + r
  int qrow[kTile];   // its query, e / p
  float fac[kTile];  // f32 digits: 2^(e - 21); qi8: the query's scale
  int ex[kTile];     // f32 digits: the exponent e
  float q2[kTile];   // |q|^2 (l2)
  int tile;
};

// Stage the tile's queries over one chunk of the row, row elements e0 ..
// e0 + ec of dw: L = ec staged values, element i from dim e0 + i; PACKED
// rows L = 2*ec, element i from dim e0 + i (i < ec, the low nibbles) or dw
// + e0 + i - ec (the high ones).  Warp w takes pairs w and w + kScanWarps.
//   MMA:  qd[digit][t][qstride] int8 digits (f32/bf16) or codes (qi8);
//   core: qf[t][L] f32 (rounded to bf16 in the bf16 mode) or int8 codes
//         (qi8);
//   core, n4 > 0 (the chunk is n4 16-byte pieces of N = L / n4 elements):
//         f32 transposed by piece, element i of piece c at qf[(t*N + i)*n4
//         + c], so the 32 lanes reading 32 pieces hit 32 banks.
// The first chunk also sets each pair's |q|^2 and the digits' or codes'
// factor, from the whole query.
template <bool MMA, int SCORE, bool PACKED>
__device__ void stage_tile(const float* __restrict__ queries, int D, int n, int qstride, int n4,
                           int e0, int ec, int dw, int8_t* qd, float* qf, TileMeta& tm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = PACKED ? 2 * ec : ec;
  for (int t = warp; t < n; t += kScanWarps) {
    const float* q = queries + static_cast<size_t>(tm.qrow[t]) * D;
    auto dim = [&](int i) { return PACKED && i >= ec ? dw + e0 + i - ec : e0 + i; };
    float fac;
    int ex;
    if (e0 == 0) {
      float m = 0.0f, s2 = 0.0f;
      for (int i = lane; i < D; i += 32) {
        const float x = query_value(q[i], SCORE);
        m = fmaxf(m, fabsf(x));
        s2 = fmaf(x, x, s2);
      }
      m = warp_max(m);
      s2 = warp_sum(s2);
      // qi8 (ivf_pallas.py:454-459): qs = max(max|q|, 1e-30) / 127;
      // digits: q = 2^e * (d1 + d2 2^-7 + d3 2^-14 + d4 2^-21), m * 2^-e in
      // [32, 64)
      ex = m > 0.0f ? ilogbf(m) - 5 : 0;
      fac = SCORE == kScoreQi8 ? __fdiv_rn(fmaxf(m, 1e-30f), 127.0f)
                               : ldexpf(1.0f, ex - 7 * (kDigits - 1));
      if (lane == 0) {
        tm.q2[t] = s2;
        tm.fac[t] = fac;
        tm.ex[t] = ex;
      }
    } else {
      fac = tm.fac[t];
      ex = tm.ex[t];
    }
    if constexpr (SCORE == kScoreStub) {
      // nothing to stage: a row scores element 0 x scale
    } else if constexpr (SCORE == kScoreQi8) {
      // codes = clip(round(q / qs), -127, 127), round half to even
      int8_t* dst = MMA ? qd + t * qstride : reinterpret_cast<int8_t*>(qf) + t * L;
      for (int i = lane; i < L; i += 32) {
        const float c = fminf(fmaxf(rintf(__fdiv_rn(q[dim(i)], fac)), -127.0f), 127.0f);
        dst[i] = static_cast<int8_t>(c);
      }
    } else if constexpr (MMA) {
      const float down = ldexpf(1.0f, -ex);
      for (int i = lane; i < L; i += 32) {
        float v = scale2(query_value(q[dim(i)], SCORE), down, -ex);
#pragma unroll
        for (int dg = 0; dg < kDigits; ++dg) {
          const float d = rintf(v);  // |d| <= 64
          qd[(dg * kTile + t) * qstride + i] = static_cast<int8_t>(d);
          v = (v - d) * 128.0f;  // both exact
        }
      }
    } else if (n4 > 0) {
      const int N = L / n4;
      for (int i = lane; i < L; i += 32) qf[(t * N + i % N) * n4 + i / N] = q[dim(i)];
    } else {
      for (int i = lane; i < L; i += 32) qf[t * L + i] = query_value(q[dim(i)], SCORE);
    }
  }
}

// A row's distance; with `part` (B2 over several chunks of the row), this
// chunk's share of it, without the constant term (1 for cosine, |q|^2 for
// l2) that the last chunk adds.
__device__ __forceinline__ float row_score(float dot, float sq, float s, float q2, int space,
                                           bool part) {
  if (!part) return row_distance(dot, sq, s, q2, space);
  dot = dot * s;
  return space == kL2 ? sq * s * s - 2.0f * dot : -dot;
}

// One step of warp_reduce_spread and the steps after it: W live values,
// partner lane at xor O.  Recursion on constants, so that every index of v
// is a constant and v stays in registers (a loop whose bound the unroller
// could not see put v in local memory).
template <int W, int O, int V>
__device__ __forceinline__ void halve(float (&v)[V], int lane) {
  if constexpr (O > 0) {
    if constexpr (W > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const float send = up ? v[i] : v[i + W / 2];
        const float keep = up ? v[i + W / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      halve<W / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      halve<1, O / 2>(v, lane);
    }
  }
}

// Sum each of v[0..V) over the warp's 32 lanes, by halving: at each step a
// lane keeps half of its live values (the upper half where its bit of the
// step is set) and adds its partner's copies of them, so V values take
// V - V/32 shuffles, not 5V.  V >= 32: lane l ends with the sums of values
// l*V/32 .. l*V/32 + V/32 - 1 in v[0 .. V/32); V < 32: the remaining steps
// sum v[0], which holds value l / (32/V), returned.
template <int V>
__device__ __forceinline__ float warp_reduce_spread(float (&v)[V], int lane) {
  halve<V, 16>(v, lane);
  return v[0];
}

// sign-extended nibbles of 16 packed bytes, as s8 fragments: the low
// nibbles (dims j) and the high ones (dims j + D/2), each (n ^ 8) - 8
__device__ __forceinline__ unsigned nib_lo(unsigned w) {
  return __vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint4 nib_lo4(uint4 u) {
  return make_uint4(nib_lo(u.x), nib_lo(u.y), nib_lo(u.z), nib_lo(u.w));
}
__device__ __forceinline__ uint4 nib_hi4(uint4 u) {
  return make_uint4(nib_lo(u.x >> 4), nib_lo(u.y >> 4), nib_lo(u.z >> 4), nib_lo(u.w >> 4));
}

// The core path for f32 and bf16 rows in 16-byte pieces, f32 mode: warp w
// scores rows base + w*16 .. +15 of the tile's bucket (slots from cbase,
// live prefix `live`) over their elements e0 .. e0 + 16*n4/sizeof(T) (the
// chunk), kCoreRows at a time, against the n pairs of the tile, into the
// score block scb [kTile][kSubBlock].  Lane l takes pieces l, l + 32, ...
// of those rows; each query element it reads from shared memory (qf,
// stage_tile's piece-transposed layout) feeds all their FMAs: one read per
// kCoreRows FMAs, the shared-memory rate against the FMA rate.  The
// kCoreRows * 16 sums (row u, pair t at u*16 + t) are reduced by halving:
// lane l ends with sums l*K .. l*K + K - 1.
constexpr int kCoreRows = 4;  // rows a warp scores at once (2 measured 1.4-1.6x slower)

template <typename T, bool L2>
__device__ __forceinline__ void score_core_rows(const T* __restrict__ vectors,
                                            const float* __restrict__ scales,
                                            const int32_t* __restrict__ rowid, const float* qf,
                                            const TileMeta& tm, size_t cbase, int base, int live,
                                            int n, int n4, int dw, int e0, bool part, int scaled,
                                            int space, float* scb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int N = 16 / sizeof(T);
  constexpr int R = kCoreRows;
  constexpr int K = R * kTile / 32;  // sums a lane ends with
  for (int g0 = 0; g0 < 16; g0 += R) {
    const int rl0 = warp * 16 + g0;
    const uint4* rp[R];
    bool ok[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int r = base + rl0 + u;
      ok[u] = r < live && rowid[cbase + r] != kSentinel;
      rp[u] = reinterpret_cast<const uint4*>(vectors + (cbase + (ok[u] ? r : 0)) * dw + e0);
    }
    float acc[R * kTile];
#pragma unroll
    for (int i = 0; i < R * kTile; ++i) acc[i] = 0.0f;
    float sq[R];
    bool any = false;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      sq[u] = 0.0f;
      any |= ok[u];
    }
    if (any) {  // warp-uniform
      for (int c = lane; c < n4; c += 32) {
        uint4 x[R];
#pragma unroll
        for (int u = 0; u < R; ++u) x[u] = ok[u] ? __ldg(rp[u] + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int i = 0; i < N / 4; ++i) {
            float xe[R];
#pragma unroll
            for (int u = 0; u < R; ++u) {
              xe[u] = elem<T>(prep<T>((&x[u].x)[w]), i);
              if constexpr (L2) sq[u] = fmaf(xe[u], xe[u], sq[u]);
            }
            const float* qcol = qf + (w * (N / 4) + i) * n4 + c;
#pragma unroll
            for (int t = 0; t < kTile; ++t) {
              if (t < n) {
                const float qv = qcol[t * N * n4];
#pragma unroll
                for (int u = 0; u < R; ++u)
                  acc[u * kTile + t] = fmaf(xe[u], qv, acc[u * kTile + t]);
              }
            }
          }
        }
      }
    }
    warp_reduce_spread(acc, lane);
    float sqv = 0.0f;
    if constexpr (L2) sqv = warp_reduce_spread(sq, lane);
    const int u = lane * R / 32;  // lane's row: sums lane*K .. lane*K + K - 1 are its
    bool oku = ok[0];
#pragma unroll
    for (int w = 1; w < R; ++w)
      if (u == w) oku = ok[w];
    const float su = oku && scaled ? scales[cbase + base + rl0 + u] : 1.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int t = (lane * K + j) % kTile;
      if (t < n)
        scb[t * kSubBlock + rl0 + u] =
            oku ? row_score(acc[j], sqv, su, tm.q2[t], L2 ? kL2 : space, part) : CUDART_INF_F;
    }
  }
}

// The scan block of B1 and B2.  MMA: int8 (or PACKED int4) rows on the
// tensor cores (vec); else CUDA-core scoring.  POOL: B2's epilogue (each
// pair's scores stored to pool[e * B + j]), else B1's (a running top-k per
// pair, written as [Q, p, k] partials).  v16 (f32 and bf16 rows read in
// 16-byte pieces, f32 mode): the core path is score_core_rows.  A row is dw
// elements of T (PACKED: D/2 bytes); CH (B2 past kMaxDims) scans it in
// chunks of ec elements, else in one (a constant, so that the tensor-core
// path keeps its registers).  Dynamic shared memory: sc [2][kTile][kSubBlock]
// f32, then one chunk's staged queries (b1_query_smem).
template <typename T, int SCORE, bool L2, bool MMA, bool PACKED, bool POOL, bool CH>
__global__ void __launch_bounds__(kScanThreads, 2)
    tile_scan_kernel(const T* __restrict__ vectors, const float* __restrict__ scales,
                     const int32_t* __restrict__ rowid, const float* __restrict__ queries,
                     const int32_t* __restrict__ cids, const int32_t* __restrict__ nsb,
                     const int32_t* __restrict__ order, const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_n, int32_t* __restrict__ meta, int B, int D,
                     int dw, int ec, int p, int k, int space, int scaled, int qstride, int v16,
                     float* __restrict__ part_d, int32_t* __restrict__ part_p,
                     unsigned* __restrict__ sink, float* __restrict__ pool) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sc = reinterpret_cast<float*>(smem_raw);
  void* qstage = smem_raw + 2 * kTile * kSubBlock * sizeof(float);
  int8_t* qd = static_cast<int8_t*>(qstage);
  float* qf = static_cast<float*>(qstage);
  __shared__ TileMeta tm;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int n_tiles = meta[0];
  const float rscale = PACKED ? kInt4Scale : 1.0f;
  constexpr bool kCore4 = !MMA && !PACKED && SCORE == kScoreF32 && sizeof(T) >= 2;  // f32, bf16
  constexpr bool part = CH;  // each chunk adds its share of the distances to the pool

  for (;;) {
    if (threadIdx.x == 0) tm.tile = atomicAdd(&meta[1], 1);
    __syncthreads();
    const int tile = tm.tile;
    if (tile >= n_tiles) break;
    const int s0 = tile_start[tile], n = tile_n[tile];
    if (threadIdx.x < n) {
      const int e = order[s0 + threadIdx.x];
      tm.e[threadIdx.x] = e;
      tm.qrow[threadIdx.x] = e / p;
    }
    __syncthreads();

    const int c = cids[tm.e[0]];  // every pair of a tile probes this bucket
    const int live = min(nsb[c] * kSubBlock, B);
    const size_t cbase = static_cast<size_t>(c) * B;
    // B1: warp w keeps the running top-k of pairs w and w + kScanWarps
    float ld[2] = {CUDART_INF_F, CUDART_INF_F}, td[2] = {CUDART_INF_F, CUDART_INF_F};
    int lj[2] = {INT_MAX, INT_MAX}, tj[2] = {INT_MAX, INT_MAX};
    int buf = 0;
    const int rw = warp * 16 + g;
    // chunk [e0, e0 + ecc) of the row; every sub-block's scoring of the
    // previous chunk ended at its barrier, so the stage may be rewritten
    const int step = CH ? ec : dw;
    for (int c0 = 0; c0 < dw; c0 += step) {
      const int e0 = CH ? c0 : 0;
      const int ecc = CH ? min(ec, dw - c0) : dw;
      const bool first = !CH || c0 == 0, last = !CH || c0 + ecc == dw;
      // the core path's 16-byte pieces in this chunk
      const int n4 = kCore4 && v16 ? ecc / (16 / static_cast<int>(sizeof(T))) : 0;
      stage_tile<MMA, SCORE, PACKED>(queries, D, n, qstride, n4, e0, ecc, dw, qd, qf, tm);
      __syncthreads();
      // tensor-core path: the rowids of rows g and g + 8 of this warp's 16,
      // read one sub-block ahead so that no row load waits on them
      int nrid0 = kSentinel, nrid1 = kSentinel;
      if constexpr (MMA) {
        if (rw < live) nrid0 = rowid[cbase + rw];
        if (rw + 8 < live) nrid1 = rowid[cbase + rw + 8];
      }
      for (int base = 0; base < live; base += kSubBlock) {
        float* scb = sc + buf * kTile * kSubBlock;
        if constexpr (MMA) {
          // rows g and g + 8 of this warp's 16-row block
          const int r0 = base + rw, r1 = r0 + 8;
          const bool v0 = r0 < live && nrid0 != kSentinel;
          const bool v1 = r1 < live && nrid1 != kSentinel;
          nrid0 = r0 + kSubBlock < live ? rowid[cbase + r0 + kSubBlock] : kSentinel;
          nrid1 = r1 + kSubBlock < live ? rowid[cbase + r1 + kSubBlock] : kSentinel;
          // the scales now, used after the dots
          const float s0r = v0 ? (scaled ? scales[cbase + r0] * rscale : 1.0f) : 0.0f;
          const float s1r = v1 ? (scaled ? scales[cbase + r1] * rscale : 1.0f) : 0.0f;
          const int8_t* row0 = reinterpret_cast<const int8_t*>(vectors) + (cbase + r0) * dw;
          const int8_t* row1 = reinterpret_cast<const int8_t*>(vectors) + (cbase + r1) * dw;
          float d[2][4];  // [row g, g+8][pair h*8 + tig*2 + {0,1}, h = 0, 1]
          constexpr bool kStub = SCORE == kScoreStub;
          constexpr int ND = SCORE == kScoreQi8 ? 1 : kDigits;
          int acc[ND][2][4];
#pragma unroll
          for (int dg = 0; dg < ND; ++dg)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[dg][h][i] = 0;
          int sq0 = 0, sq1 = 0;
          unsigned fold = 0;  // the stub's copy
          const bool two = n > 8;
          if (__any_sync(kFull, v0 || v1)) {
            // 64 bytes of each row per span, 4 spans per group: 8 loads in flight
            constexpr int U = 4;
            const int e1 = e0 + ecc;
            for (int span = e0; span < e1; span += 64 * U) {
              uint4 a[U], b[U];
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const int off = span + u * 64 + tig * 16;
                a[u] = (v0 && off < e1) ? ld16(row0 + off) : make_uint4(0, 0, 0, 0);
                b[u] = (v1 && off < e1) ? ld16(row1 + off) : make_uint4(0, 0, 0, 0);
              }
#pragma unroll
              for (int u = 0; u < U; ++u) {
                if (span + u * 64 >= e1) break;  // warp-uniform: the span is past the chunk
                if constexpr (kStub) {
                  fold ^= a[u].x ^ a[u].y ^ a[u].z ^ a[u].w ^ b[u].x ^ b[u].y ^ b[u].z ^ b[u].w;
                  continue;
                }
                const int off = span + u * 64 + tig * 16;
                // the halves: int8 one (the row's bytes), packed two (low
                // nibbles with dims off.., high nibbles with dims dw + off..,
                // staged from ecc on)
                constexpr int NH = PACKED ? 2 : 1;
#pragma unroll
                for (int half = 0; half < NH; ++half) {
                  const uint4 ra = PACKED ? (half ? nib_hi4(a[u]) : nib_lo4(a[u])) : a[u];
                  const uint4 rb = PACKED ? (half ? nib_hi4(b[u]) : nib_lo4(b[u])) : b[u];
                  const int qoff = off - e0 + half * ecc;
                  if constexpr (L2) {
                    sq0 = sq_s8(ra, sq0);
                    sq1 = sq_s8(rb, sq1);
                  }
#pragma unroll
                  for (int dg = 0; dg < ND; ++dg) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                      if (h == 1 && !two) break;
                      const uint4 qv = *reinterpret_cast<const uint4*>(
                          qd + (dg * kTile + h * 8 + g) * qstride + qoff);
                      // A: a0 row g, a1 row g+8, a2/a3 their next 4 bytes; the
                      // same byte order for the query (B) column g
                      mma_s8(acc[dg][h], ra.x, rb.x, ra.y, rb.y, qv.x, qv.y);
                      mma_s8(acc[dg][h], ra.z, rb.z, ra.w, rb.w, qv.z, qv.w);
                    }
                  }
                }
              }
            }
          }
          if constexpr (kStub) {
            sink[threadIdx.x] = fold;  // keeps the loads: the compiler drops unread ones
            const float x0 = v0 ? __fmul_rn(static_cast<float>(row0[0]), s0r) : 0.0f;
            const float x1 = v1 ? __fmul_rn(static_cast<float>(row1[0]), s1r) : 0.0f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              d[0][i] = v0 ? x0 : CUDART_INF_F;
              d[1][i] = v1 ? x1 : CUDART_INF_F;
            }
          } else {
            if constexpr (L2) {  // sum the four lanes of each row group
              sq0 += __shfl_xor_sync(kFull, sq0, 1);
              sq0 += __shfl_xor_sync(kFull, sq0, 2);
              sq1 += __shfl_xor_sync(kFull, sq1, 1);
              sq1 += __shfl_xor_sync(kFull, sq1, 2);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const int t = h * 8 + tig * 2 + cc;
#pragma unroll
                for (int ri = 0; ri < 2; ++ri) {
                  const int ci = ri * 2 + cc;
                  const bool v = ri == 0 ? v0 : v1;
                  float dist = CUDART_INF_F;
                  if (v && t < n) {
                    const float s = ri == 0 ? s0r : s1r;
                    if constexpr (SCORE == kScoreQi8) {
                      // the TPU kernel's order: (scale * qscale), then dot * that
                      const float val = __fmul_rn(static_cast<float>(acc[0][h][ci]),
                                                  __fmul_rn(s, tm.fac[t]));
                      dist = space == kDot ? -val : __fsub_rn(1.0f, val);
                    } else {
                      long long S = 0;
#pragma unroll
                      for (int dg = 0; dg < ND; ++dg) S = S * 128 + acc[dg][h][ci];
                      const float dot = __fmul_rn(__ll2float_rn(S), tm.fac[t]);
                      const float sq = static_cast<float>(ri == 0 ? sq0 : sq1);
                      dist = row_score(dot, sq, s, tm.q2[t], L2 ? kL2 : space, part);
                    }
                  }
                  d[ri][h * 2 + cc] = dist;
                }
              }
            }
          }
          const int rl = warp * 16 + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int t = h * 8 + tig * 2 + cc;
              if (t < n) {
                scb[t * kSubBlock + rl] = d[0][h * 2 + cc];
                scb[t * kSubBlock + rl + 8] = d[1][h * 2 + cc];
              }
            }
          }
        } else if (n4 > 0) {
          if constexpr (kCore4)
            score_core_rows<T, L2>(vectors, scales, rowid, qf, tm, cbase, base, live, n, n4, dw,
                                   e0, part, scaled, space, scb);
        } else {
          // CUDA cores: warp w scores rows base + w*16 .. +15, one at a time,
          // against every pair of the tile
          for (int i = 0; i < 16; ++i) {
            const int rl = warp * 16 + i, r = base + rl;
            const bool v = r < live && rowid[cbase + r] != kSentinel;
            const T* row = vectors + (cbase + r) * dw;
            if (!v) {
              if (lane < n) scb[lane * kSubBlock + rl] = CUDART_INF_F;
              continue;
            }
            const float s = scaled ? scales[cbase + r] * rscale : 1.0f;
            if constexpr (SCORE == kScoreStub) {
              unsigned fold = 0;
              for (int off = lane * 16; off < dw * static_cast<int>(sizeof(T)); off += 512)
                fold = ld16_fold(reinterpret_cast<const char*>(row) + off, fold);
              sink[threadIdx.x] = fold;
              const float x0 = __fmul_rn(to_f(row[0]), scales[cbase + r]);
              if (lane < n) scb[lane * kSubBlock + rl] = x0;
            } else if constexpr (SCORE == kScoreQi8) {
              // B1 only: one chunk, the whole row
              const int8_t* q8 = reinterpret_cast<const int8_t*>(qf);
              int acc[kTile];
#pragma unroll
              for (int t = 0; t < kTile; ++t) acc[t] = 0;
              for (int e = lane; e < D; e += 32) {
                const int x = static_cast<int>(row[e]);
#pragma unroll
                for (int t = 0; t < kTile; ++t)
                  if (t < n) acc[t] += x * static_cast<int>(q8[t * D + e]);
              }
#pragma unroll
              for (int t = 0; t < kTile; ++t) {
                if (t < n) {
                  const int dot = warp_sum_i(acc[t]);
                  const float val = __fmul_rn(static_cast<float>(dot), __fmul_rn(s, tm.fac[t]));
                  if (lane == 0)
                    scb[t * kSubBlock + rl] = space == kDot ? -val : __fsub_rn(1.0f, val);
                }
              }
            } else {
              // pair t's query over this chunk: qf[t * L ..], L staged values
              const int L = PACKED ? 2 * ecc : ecc;
              float acc[kTile];
#pragma unroll
              for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
              float sq = 0.0f;
              for (int e = lane; e < ecc; e += 32) {
                if constexpr (PACKED) {
                  const int b = static_cast<int>(row[e0 + e]);
                  const float lo = nibble(b & 15), hi = nibble(b >> 4);
                  if constexpr (L2) sq = fmaf(hi, hi, fmaf(lo, lo, sq));
#pragma unroll
                  for (int t = 0; t < kTile; ++t)
                    if (t < n)
                      acc[t] = fmaf(hi, qf[t * L + ecc + e], fmaf(lo, qf[t * L + e], acc[t]));
                } else {
                  const float x = to_f(row[e0 + e]);
                  if constexpr (L2) sq = fmaf(x, x, sq);
#pragma unroll
                  for (int t = 0; t < kTile; ++t)
                    if (t < n) acc[t] = fmaf(x, qf[t * L + e], acc[t]);
                }
              }
              if constexpr (L2) sq = warp_sum(sq);
#pragma unroll
              for (int t = 0; t < kTile; ++t) {
                if (t < n) {
                  const float dot = warp_sum(acc[t]);
                  if (lane == 0)
                    scb[t * kSubBlock + rl] =
                        row_score(dot, sq, s, tm.q2[t], L2 ? kL2 : space, part);
                }
              }
            }
          }
        }
        __syncthreads();

#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          const int t = warp + sl * kScanWarps;
          if (t >= n) continue;
          const float* col = scb + t * kSubBlock;
          if constexpr (POOL) {
            // B2: this sub-block of pair t's pool row, coalesced; in chunks,
            // each adds its share (this lane wrote the entry the chunk before)
            float* o = pool + static_cast<size_t>(tm.e[t]) * B;
            const float konst = L2 ? tm.q2[t] : space == kCosine ? 1.0f : 0.0f;
#pragma unroll
            for (int i = 0; i < kSubBlock / 32; ++i) {
              const int j = base + lane + 32 * i;
              if (j >= live) continue;
              float v = col[lane + 32 * i];
              if (part) {
                if (!first) v = o[j] + v;
                if (last) v = v + konst;
              }
              o[j] = v;
            }
          } else {
            // B1: fold this sub-block into pair t's running top-k
#pragma unroll
            for (int i = 0; i < kSubBlock / 32; ++i) {
              const float dv = col[lane + 32 * i];
              const int j = base + lane + 32 * i;
              const bool pass = dv != CUDART_INF_F && lex_less(dv, j, td[sl], tj[sl]);
              unsigned mask = __ballot_sync(kFull, pass);
              if (__popc(mask) >= kMergeMin) {
                list_merge(ld[sl], lj[sl], pass ? dv : CUDART_INF_F, pass ? j : INT_MAX, lane);
                td[sl] = __shfl_sync(kFull, ld[sl], k - 1);
                tj[sl] = __shfl_sync(kFull, lj[sl], k - 1);
                mask = 0;
              }
              while (mask) {
                const int src = __ffs(mask) - 1;
                mask &= mask - 1;
                const float xd = __shfl_sync(kFull, dv, src);
                const int xj = __shfl_sync(kFull, j, src);
                if (lex_less(xd, xj, td[sl], tj[sl])) {
                  list_insert(ld[sl], lj[sl], xd, xj, lane);
                  td[sl] = __shfl_sync(kFull, ld[sl], k - 1);
                  tj[sl] = __shfl_sync(kFull, lj[sl], k - 1);
                }
              }
            }
          }
        }
        buf ^= 1;  // the next sub-block scores into the other buffer
      }
    }

#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int t = warp + sl * kScanWarps;
      if (t >= n) continue;
      const int e = tm.e[t];
      if constexpr (POOL) {
        // B2: INF past the live prefix
        float* o = pool + static_cast<size_t>(e) * B;
        for (int j = live + lane; j < B; j += 32) o[j] = CUDART_INF_F;
      } else if (lane < k) {
        // B1's partials: entry i of pair e = q*p + r at e*k + i, position r*B + j
        const size_t o = static_cast<size_t>(e) * k + lane;
        part_d[o] = ld[sl];
        part_p[o] = ld[sl] == CUDART_INF_F ? INT_MAX : (e % p) * B + lj[sl];
      }
    }
    __syncthreads();  // tm and the staged queries are rewritten by the next tile
  }
}

// ---------------------------------------------------------------------------
// B1: merge

// One warp per query; dynamic shared memory kMergeWarps * p bytes (each
// partial list's head).  Lane l owns the lists r = l, l + 32, ...  Round t
// leaves its winner's position with lane t; the position -> rowid lookups
// (two dependent loads) run after the k rounds, all lanes at once, so no
// round waits on device memory for them.
__global__ void __launch_bounds__(kMergeWarps * 32)
    b1_merge_kernel(const float* __restrict__ part_d, const int32_t* __restrict__ part_p,
                    const int32_t* __restrict__ rowid, const int32_t* __restrict__ cids, int Q,
                    int B, int p, int k, float* __restrict__ out_d, int32_t* __restrict__ out_r) {
  extern __shared__ unsigned char heads_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= Q) return;  // warp-uniform; no block barrier below
  unsigned char* heads = heads_all + warp * p;
  for (int r = lane; r < p; r += 32) heads[r] = 0;
  __syncwarp();
  const size_t pbase = static_cast<size_t>(qi) * p;
  float my_d = CUDART_INF_F;
  int my_pos = INT_MAX;
  for (int t = 0; t < k; ++t) {
    float bd = CUDART_INF_F;
    int bp = INT_MAX, br = -1;
    for (int r = lane; r < p; r += 32) {
      const int h = heads[r];
      if (h < k) {
        const size_t o = (pbase + r) * k + h;
        const float d = part_d[o];
        const int pos = part_p[o];
        if (br < 0 || lex_less(d, pos, bd, bp)) {
          bd = d;
          bp = pos;
          br = r;
        }
      }
    }
    float wd = bd;
    int wp = bp;
    warp_argmin(wd, wp);
    const unsigned win = __ballot_sync(kFull, br >= 0 && bd == wd && bp == wp);
    if (win != 0 && lane == __ffs(win) - 1) heads[br] += 1;
    __syncwarp();
    if (lane == t) {
      my_d = wd;
      my_pos = wp;
    }
  }
  if (lane < k) {
    const bool none = my_d == CUDART_INF_F || my_pos == INT_MAX;
    out_d[static_cast<size_t>(qi) * k + lane] = my_d;
    out_r[static_cast<size_t>(qi) * k + lane] =
        none ? kSentinel : rowid[static_cast<size_t>(cids[pbase + my_pos / B]) * B + my_pos % B];
  }
}

// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// launchers

int hash_bits(int N) {
  int b = 6;
  while ((1 << b) < 2 * N) ++b;
  return b;
}

cudaError_t launch_worklist(const int32_t* cids, int N, int32_t* order, int32_t* tile_start,
                            int32_t* tile_n, int32_t* meta, cudaStream_t stream) {
  if (N <= 0 || N > kMaxPairs) return cudaErrorInvalidValue;
  const int hb = hash_bits(N);
  const size_t smem = 2 * sizeof(int32_t) * (static_cast<size_t>(1) << hb);
  const cudaError_t e = allow_smem(b1_worklist_kernel, smem);
  if (e != cudaSuccess) return e;
  b1_worklist_kernel<<<1, kWorkThreads, smem, stream>>>(cids, N, hb, order, tile_start, tile_n,
                                                         meta);
  return cudaGetLastError();
}

// bytes of the query stage of one scan block: L staged values a pair
size_t b1_query_smem(bool mma, int score, int L, int& qstride) {
  qstride = ((L + 127) / 128) * 128 + 64;  // 64 mod 128: conflict-free 16-byte reads
  if (score == kScoreStub) return 0;
  if (mma) return static_cast<size_t>(score == kScoreQi8 ? 1 : kDigits) * kTile * qstride;
  return static_cast<size_t>(kTile) * L * (score == kScoreQi8 ? 1 : sizeof(float));
}

// ec: row elements per chunk (CH), else the whole row
template <typename T, int SCORE, bool L2, bool MMA, bool PACKED, bool POOL, bool CH>
cudaError_t launch_scan(const void* vectors, const float* scales, const int32_t* rowid,
                        const float* queries, const int32_t* cids, const int32_t* nsb,
                        const int32_t* order, const int32_t* tile_start, const int32_t* tile_n,
                        int32_t* meta, int N, int B, int D, int ec, int p, int k, int space,
                        int scaled, int vec, float* part_d, int32_t* part_p, unsigned* sink,
                        float* pool, cudaStream_t stream) {
  const int dw = PACKED ? D / 2 : D;
  if (!CH) ec = dw;
  // a chunk's 16-byte loads start 16-byte aligned
  if (CH && (ec * static_cast<int>(sizeof(T))) % 16 != 0) return cudaErrorInvalidValue;
  int qstride = 0;
  const size_t stage = b1_query_smem(MMA, SCORE, PACKED ? 2 * ec : ec, qstride);
  const size_t smem = 2 * kTile * kSubBlock * sizeof(float) + stage;
  auto kern = tile_scan_kernel<T, SCORE, L2, MMA, PACKED, POOL, CH>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  // one wave of blocks; each takes tiles from meta[1] until none is left
  static int sms = 0;
  static size_t occ_smem = 0;
  static int occ = 0;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
  }
  if (occ_smem != smem || occ == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kScanThreads, smem);
    if (e != cudaSuccess) return e;
    occ_smem = smem;
  }
  const int grid = std::max(1, std::min(N, sms * std::max(occ, 1)));
  kern<<<grid, kScanThreads, smem, stream>>>(static_cast<const T*>(vectors), scales, rowid,
                                             queries, cids, nsb, order, tile_start, tile_n, meta,
                                             B, D, dw, ec, p, k, space, scaled, qstride, vec,
                                             part_d, part_p, sink, pool);
  return cudaGetLastError();
}

// ec: row elements per chunk; a chunk shorter than the row (B2 only: B1's
// D <= kMaxDims) takes the CH instantiation
template <typename T, int SCORE, bool MMA, bool PACKED, bool POOL>
cudaError_t launch_scan_space(int space, const void* vectors, const float* scales,
                              const int32_t* rowid, const float* queries, const int32_t* cids,
                              const int32_t* nsb, const int32_t* order, const int32_t* tile_start,
                              const int32_t* tile_n, int32_t* meta, int N, int B, int D, int ec,
                              int p, int k, int scaled, int vec, float* part_d, int32_t* part_p,
                              unsigned* sink, cudaStream_t stream, float* pool = nullptr) {
  auto go = [&](auto l2, auto ch) {
    return launch_scan<T, SCORE, decltype(l2)::value, MMA, PACKED, POOL, decltype(ch)::value>(
        vectors, scales, rowid, queries, cids, nsb, order, tile_start, tile_n, meta, N, B, D, ec,
        p, k, space, scaled, vec, part_d, part_p, sink, pool, stream);
  };
  using no = std::false_type;
  using ch = std::bool_constant<POOL>;  // B1 never instantiates CH
  const bool chunks = ec > 0 && ec < (PACKED ? D / 2 : D);
  if constexpr (SCORE == kScoreF32) {
    if (space == kL2) return chunks ? go(std::true_type{}, ch{}) : go(std::true_type{}, no{});
  }
  return chunks ? go(no{}, ch{}) : go(no{}, no{});
}

}  // namespace

extern "C" {

// B1.  dtype: 0 float32, 1 bfloat16, 2 int8 bank [K, B, D].  score: 0 f32,
// 1 qi8, 2 bf16, 3 stub; qi8 and bf16 take int8 banks and cosine or dot
// only.  queries [Q, D] f32 preprocessed, whatever the mode (the kernel
// quantizes or rounds it).  vec: rows may be read with 16-byte loads (row
// bytes and base address multiples of 16); stub needs it, and int8 banks
// score on the tensor cores with it.  ws: int32 workspace of
// 3*Q*p + 2 + 2*Q*p*k + 256 entries.  Q*p <= kMaxPairs, D <= kMaxDims,
// 1 <= k <= 32.  Three launches: work list, scan, merge.
int ivf_search_fused(int dtype, int score, const void* vectors, const float* scales,
                     const int32_t* rowid, const float* queries, const int32_t* cids,
                     const int32_t* nsb, int Q, int B, int D, int p, int k, int space, int scaled,
                     int vec, int32_t* ws, float* out_d, int32_t* out_r, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = Q * p;
  if (Q <= 0 || p <= 0 || N > kMaxPairs || D > kMaxDims || k < 1 || k > 32)
    return cudaErrorInvalidValue;
  if ((score == kScoreQi8 || score == kScoreBf16) && (dtype != kI8 || space == kL2))
    return cudaErrorInvalidValue;
  if (score == kScoreStub && !vec) return cudaErrorInvalidValue;
  int32_t* order = ws;
  int32_t* tile_start = ws + N;
  int32_t* tile_n = ws + 2 * N;
  int32_t* meta = ws + 3 * N;
  float* part_d = reinterpret_cast<float*>(ws + 3 * N + 2);
  int32_t* part_p = ws + 3 * N + 2 + static_cast<size_t>(N) * k;
  unsigned* sink = reinterpret_cast<unsigned*>(part_p + static_cast<size_t>(N) * k);
  cudaError_t e = launch_worklist(cids, N, order, tile_start, tile_n, meta, st);
  if (e != cudaSuccess) return e;

#define B1_SCAN(T, S, M)                                                                    \
  launch_scan_space<T, S, M, false, false>(space, vectors, scales, rowid, queries, cids, nsb,   \
                                           order, tile_start, tile_n, meta, N, B, D, 0, p, k,    \
                                           scaled, vec, part_d, part_p, sink, st)
  const bool mma = dtype == kI8 && vec;
  switch (dtype) {
    case kI8:
      if (mma) {
        e = score == kScoreQi8    ? B1_SCAN(int8_t, kScoreQi8, true)
            : score == kScoreBf16 ? B1_SCAN(int8_t, kScoreBf16, true)
            : score == kScoreStub ? B1_SCAN(int8_t, kScoreStub, true)
                                  : B1_SCAN(int8_t, kScoreF32, true);
      } else {
        e = score == kScoreQi8    ? B1_SCAN(int8_t, kScoreQi8, false)
            : score == kScoreBf16 ? B1_SCAN(int8_t, kScoreBf16, false)
                                  : B1_SCAN(int8_t, kScoreF32, false);
      }
      break;
    case kBF16:
      e = score == kScoreStub ? B1_SCAN(__nv_bfloat16, kScoreStub, false)
                              : B1_SCAN(__nv_bfloat16, kScoreF32, false);
      break;
    case kF32:
      e = score == kScoreStub ? B1_SCAN(float, kScoreStub, false)
                              : B1_SCAN(float, kScoreF32, false);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef B1_SCAN
  if (e != cudaSuccess) return e;
  const size_t msmem = static_cast<size_t>(kMergeWarps) * p;
  if ((e = allow_smem(b1_merge_kernel, msmem)) != cudaSuccess) return e;
  b1_merge_kernel<<<(Q + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, msmem, st>>>(
      part_d, part_p, rowid, cids, Q, B, p, k, out_d, out_r);
  return cudaGetLastError();
}

// B1's work list alone (for its check on the card): writes order, the tile
// list and meta as ivf_search_fused's first launch does.
int ivf_b1_worklist(const int32_t* cids, int N, int32_t* order, int32_t* tile_start,
                    int32_t* tile_n, int32_t* meta, void* stream) {
  return launch_worklist(cids, N, order, tile_start, tile_n, meta,
                         static_cast<cudaStream_t>(stream));
}

// B2.  dtype as above, or 3: packed int4 bank [K, B, D/2] uint8 (split
// layout).  queries [Q, D] f32 preprocessed.  vec: rows may be read with
// 16-byte loads (row bytes and base address multiples of 16); int8 and
// packed banks then score on the tensor cores.  ec: row elements per chunk
// of the scan (ivf_cuda.pool_chunk; 0 or dw: one chunk, D <= kMaxDims),
// a multiple of 16 bytes.  ws: int32 workspace of 3*Q*p + 2 + 256 entries.
// Q*p <= kMaxPairs, any D.  Two launches, work list and scan; out [Q, p*B]
// f32 is written in full.
int ivf_pool_scan(int dtype, const void* vectors, const float* scales, const int32_t* rowid,
                  const float* queries, const int32_t* cids, const int32_t* nsb, int Q, int B,
                  int D, int ec, int p, int space, int scaled, int vec, int32_t* ws, float* out,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = Q * p;
  if (Q <= 0 || p <= 0 || N > kMaxPairs || B <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (dtype == kPacked && D % 2 != 0) return cudaErrorInvalidValue;
  int32_t* order = ws;
  int32_t* tile_start = ws + N;
  int32_t* tile_n = ws + 2 * N;
  int32_t* meta = ws + 3 * N;
  unsigned* sink = reinterpret_cast<unsigned*>(ws + 3 * N + 2);
  cudaError_t e = launch_worklist(cids, N, order, tile_start, tile_n, meta, st);
  if (e != cudaSuccess) return e;

#define B2_SCAN(T, M, PK)                                                                       \
  launch_scan_space<T, kScoreF32, M, PK, true>(space, vectors, scales, rowid, queries, cids, nsb, \
                                               order, tile_start, tile_n, meta, N, B, D, ec, p, 1, \
                                               scaled, vec, nullptr, nullptr, sink, st, out)
  switch (dtype) {
    case kI8:
      e = vec ? B2_SCAN(int8_t, true, false) : B2_SCAN(int8_t, false, false);
      break;
    case kPacked:
      e = vec ? B2_SCAN(uint8_t, true, true) : B2_SCAN(uint8_t, false, true);
      break;
    case kBF16:
      e = B2_SCAN(__nv_bfloat16, false, false);
      break;
    case kF32:
      e = B2_SCAN(float, false, false);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef B2_SCAN
  return e;
}

}  // extern "C"
