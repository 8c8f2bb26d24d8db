// B4, the device copy-rate probe, for Hopper (sm_90a), with a plain C
// interface (bound with ctypes by vector_store_tpu_torch/probes/dma.py).
//
// Replaces the Pallas TPU kernel scripts/probe_dma.py::_kernel (:30,
// pallas_call at :71), the HBM -> VMEM copy-rate probe that gave the IVF
// probe-scan kernel its roofline.  What it computes is kept:
//   * q [8, D] f32 and an int8 bank [nblocks, B, D], nblocks a multiple of
//     64; group g is blocks g*64 .. g*64+63 (the TPU's grid program g);
//   * with `score`, block s of a group adds min over its rows of x . q[s % 8]
//     to all 8 lanes of the group's accumulator; without, row 0's first 8
//     values;
//   * the TPU's [1, 8] output was the LAST program's accumulator (every
//     program wrote the same output block, in grid order).  Here acc [G, 8]
//     holds every group's and the wrapper returns the last row.
//
// The decomposition is the card's own.  A [384..1536, 768] int8 block
// (288 KB - 1.1 MB) does not fit 227 KB of shared memory, and 64 blocks per
// program would leave 14 programs of work for 132 SMs.  So one CTA takes one
// bank block; the 64 block values of a group meet in acc by atomicAdd, in
// no fixed order, so a group's sum may differ from the in-order f32 sum by
// a few units of 64 * 2^-24 relative.
//   * Without `score` the block streams in tiles of kTileRows rows through
//     a ring of `nbuf` shared-memory stages filled by cp.async (16 bytes a
//     thread a copy, past L1): the copy rate, bound by device-memory bytes
//     (the probe's bank is >= 1 GiB, far past the 50 MB L2).
//   * With `score` it reads rows as B1 and B2 do: a warp per row, 16 bytes a
//     lane straight into registers, an int8 -> f32 conversion, a
//     shared-memory query read and an FMA per byte (B1 also sums |x|^2, one
//     more FMA).  That is the rate B1's access and arithmetic allow.
//
// The kernel allocates nothing: the caller passes acc, which this entry
// point zeroes on the caller's stream before the launch.

#include <math_constants.h>

#include <cstdint>

#include "scan_common.cuh"

namespace {

constexpr int kGroup = 64;    // blocks per group (probe_dma.UNROLL)
constexpr int kQRows = 8;     // query rows and accumulator lanes
constexpr int kTileRows = 32;  // rows per ring stage (24 KB at D=768)
constexpr int kProbeThreads = 256;
constexpr int kMaxStages = 8;

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0..7) of this thread's committed copy groups are
// still in flight; the PTX instruction takes n as an immediate.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// grid (nblocks), block kProbeThreads.  With SCORE: dynamic shared memory
// D floats (the staged query); a warp scores one row at a time, each lane
// loading 16 bytes of it straight into registers (B1's row_dot,
// scan_common.cuh).  Without: nbuf * kTileRows * D bytes (the ring).
template <bool SCORE>
__global__ void __launch_bounds__(kProbeThreads)
    copy_probe_kernel(const float* __restrict__ q, const int8_t* __restrict__ bank, int B, int D,
                      int nbuf, float* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kProbeThreads / 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const size_t blk = blockIdx.x;
  const int g = static_cast<int>(blk / kGroup), s = static_cast<int>(blk % kGroup);
  const int n4 = D / 16;
  const int8_t* src = bank + blk * static_cast<size_t>(B) * D;

  float v;
  if constexpr (SCORE) {
    float* qs = reinterpret_cast<float*>(smem);
    stage_query<int8_t>(q + (s % kQRows) * D, qs, D, n4);
    __syncthreads();
    float best = CUDART_INF_F;
    for (int r = warp; r < B; r += nwarps) {
      float dot = 0.0f, sq = 0.0f;  // sq is unused and compiled away
      row_dot<int8_t>(src + static_cast<size_t>(r) * D, qs, D, n4, lane, dot, sq);
      best = fminf(best, warp_sum(dot));
    }
    if (lane == 0) red[warp] = best;
    __syncthreads();
    v = red[0];
    for (int w = 1; w < nwarps; ++w) v = fminf(v, red[w]);
  } else {
    int8_t* ring = reinterpret_cast<int8_t*>(smem);
    const int tile_bytes = kTileRows * D;
    const int ntiles = (B + kTileRows - 1) / kTileRows;
    // one commit group per tile (empty past the last, so the count stays fixed)
    auto fetch_tile = [&](int t) {
      if (t < ntiles) {
        const int rows = min(kTileRows, B - t * kTileRows);
        int8_t* dst = ring + (t % nbuf) * tile_bytes;
        const int8_t* from = src + static_cast<size_t>(t) * tile_bytes;
        for (int i = threadIdx.x; i < rows * n4; i += blockDim.x) {
          cp_async16(dst + 16 * i, from + 16 * i);
        }
      }
      cp_async_commit();
    };
    for (int t = 0; t < nbuf - 1; ++t) fetch_tile(t);
    v = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      fetch_tile(t + nbuf - 1);  // into the stage tile t-1 used; freed by the sync below
      cp_async_wait(nbuf - 1);  // tile t has landed (for this thread's copies)
      __syncthreads();          // ... and for everyone's
      if (t == 0 && threadIdx.x < kQRows) v = static_cast<float>(ring[threadIdx.x]);  // row 0
      __syncthreads();
    }
  }
  if (threadIdx.x < kQRows) atomicAdd(acc + static_cast<size_t>(g) * kQRows + threadIdx.x, v);
}

}  // namespace

extern "C" {

// q [8, D] f32, bank [nblocks, B, D] int8 (contiguous, 16-byte aligned),
// acc [nblocks / 64, 8] f32.  D must be a multiple of 16, nbuf 1..8 (the
// ring's stages; used without score only).
int copy_probe_stream(const float* q, const int8_t* bank, int nblocks, int B, int D, int score,
                      int nbuf, float* acc, void* stream) {
  if (nblocks <= 0 || nblocks % kGroup || B <= 0 || D <= 0 || D % 16 || nbuf < 1 ||
      nbuf > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t groups = static_cast<size_t>(nblocks / kGroup);
  cudaError_t e = cudaMemsetAsync(acc, 0, groups * kQRows * sizeof(float), st);
  if (e != cudaSuccess) return e;
  const size_t smem = score ? static_cast<size_t>(D) * sizeof(float)
                           : static_cast<size_t>(nbuf) * kTileRows * D;
  auto kern = score ? copy_probe_kernel<true> : copy_probe_kernel<false>;
  e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<nblocks, kProbeThreads, smem, st>>>(q, bank, B, D, nbuf, acc);
  return cudaGetLastError();
}

}  // extern "C"
