// Harmonic summing for Hopper (sm_90a): the doubling ladder, normalised
// and max-reduced in the kernel, or written out rung by rung.
//
// Replaces the TPU kernels of src/repro/kernels/harmonic_sum/
// harmonic_sum_kernel.py:
//   repro_harmonic_sum_plane  <- harmonic_sum_plane_pallas (def :84; body
//                                _hsum_plane_body :56): (B, N) float32 power
//                                -> (B, N) best statistic + (B, N) int32
//                                rung, z_h = (S_h - h) * (1/sqrt(h)), the
//                                earliest rung winning ties
//   repro_harmonic_sum        <- harmonic_sum_pallas (def :108; body
//                                _hsum_body :44): (B, N) -> (B, L, N),
//                                every rung S_h, h = 1, 2, 4, ..., H
//                                (L = log2 H + 1)
// where S_h[k] = sum_{j <= h} P[j * k], with P[i] = 0 for i >= N.
//
// What bounds them: memory.  The plane reads P once and writes 8 bytes a
// bin (12 bytes a bin in all); the ladder writes L rungs (4 * (1 + L)
// bytes a bin).  A bin adds H values, far below the card's float32 rate.
//
// What the plane's design does about it.  The TPU keeps a whole row in
// VMEM and reads the stride-j decimations P[::j] from it; a row of 65537
// bins (256 KB) is more than a block's 227 KB of shared memory.  Gathered
// into registers one decimation after another, each P[j k] costs a round
// trip to L2 in turn.  Here a block takes a tile of K = 256 kBins bins
// [k0, k0 + K) of one row (kBins a thread) and copies the values its bins
// read, P[j k] for every decimation j, into shared memory with 4-byte
// cp.async (rows of odd N start only 4-byte aligned): the tile's whole
// gather is in flight at once, in no register, and the thread waits once.
// It then adds them in the reference's order.  Slot (j - 1) K + m holds
// bin k0 + m's value, copied and read by the same thread (consecutive
// lanes, consecutive slots: no bank conflict, no barrier).  Where H K
// values exceed the stage buffer (large H), the decimations go through it
// a stage at a time.  Blocks are numbered along the row, so a row's tiles
// run together and the row stays in L2.  The rung scales are computed in
// the kernel: a table indexed by the run-time rung would sit in each
// thread's local memory.  Copying instead each decimation's contiguous
// window P[j k0, j (k0 + K)) whole, as the TPU reads P[::j] from a resident
// row, copies j K values for the K a tile uses; on an H100 it took at
// least 1.6x this design's time at H = 8 (PERF.md section 6).
//
// The ladder (harmonic_sum) keeps its first design: one thread a bin,
// P[j * k] gathered from global memory.
//
// Arithmetic order, as the reference's: the rungs are added in its order
// (j = h/2 + 1 ... h), z is (acc - h) * s_h with s_h the float32 of the
// double 1/sqrt(h), and a rung replaces the best only when strictly
// greater.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

extern "C" const char* repro_hsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr size_t kMaxShared = 232448;
// Values of the plane's stage buffer (64 KB: three blocks an SM).
constexpr int kBuffer = 16384;

// The plane's rung bookkeeping once rung `lev` (h = 2^lev) is added: rung
// 0 sets the best, a later rung's z = (S_h - h) * s_h replaces it only
// when strictly greater.  s_h is the float32 of the double 1/sqrt(h), as
// the reference's table (sqrt and division round correctly in double);
// computing it here, rather than indexing a table by the run-time rung,
// keeps the table out of each thread's local memory.
template <int kBins>
__device__ __forceinline__ void rung(int lev, const float (&acc)[kBins],
                                     float (&best)[kBins],
                                     int (&best_lev)[kBins]) {
  const double h = static_cast<double>(1 << lev);
  const float scale = __double2float_rn(1.0 / sqrt(h));
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    if (lev == 0) {
      best[b] = acc[b] - 1.0f;  // z_1 = S_1 - 1
      best_lev[b] = 0;
    } else {
      const float z = __fmul_rn(acc[b] - static_cast<float>(h), scale);
      if (z > best[b]) {
        best[b] = z;
        best_lev[b] = lev;
      }
    }
  }
}

// One block a tile of kTile = 256 kBins bins [k0, k0 + kTile) of one row;
// block i covers tile i % tiles of row i / tiles.  Decimations go through
// the stage buffer `per_stage` at a time: slot (j - j0) kTile + m holds
// P[j (k0 + m)] (bin k0 + m of thread m % 256), copied there by that
// thread, so both the copies and the reads of a warp hit 32 banks.
template <int kBins>
__global__ void __launch_bounds__(kThreads)
    harmonic_sum_plane_kernel(const float* __restrict__ p,
                              float* __restrict__ stat,
                              int* __restrict__ level, int n, int levels,
                              int tiles, int per_stage) {
  constexpr int kTile = kThreads * kBins;
  extern __shared__ float sbuf[];
  const long long row = blockIdx.x / tiles;
  const int k0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int tid = threadIdx.x;
  const float* pr = p + row * n;
  const int h_max = 1 << (levels - 1);
  // Decimations j with j k0 < n (every j for the first tile: bin 0 reads
  // P[0] H times): no bin of the tile reads past the last.
  const int j_last = k0 == 0 ? h_max : min(h_max, (n - 1) / k0);

  float acc[kBins], best[kBins];
  int best_lev[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    acc[b] = 0.0f;
    best[b] = 0.0f;
    best_lev[b] = 0;
  }
  int lev = 0;  // rungs done: the next power of two is 1 << lev
  for (int j0 = 1; j0 <= j_last; j0 += per_stage) {
    const int j1 = min(j_last, j0 + per_stage - 1);
    for (int j = j0; j <= j1; ++j) {
      float* dst = sbuf + (j - j0) * kTile + tid;
#pragma unroll
      for (int b = 0; b < kBins; ++b) {
        const long long idx = static_cast<long long>(j) *
                              (k0 + tid + b * kThreads);
        if (idx < n)
          __pipeline_memcpy_async(dst + b * kThreads, pr + idx,
                                  sizeof(float));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    // A thread reads back only the slots it copied (visible to it once its
    // copies are waited for), so the block needs no barrier.
    for (int j = j0; j <= j1; ++j) {
      const float* src = sbuf + (j - j0) * kTile + tid;
#pragma unroll
      for (int b = 0; b < kBins; ++b) {
        if (static_cast<long long>(j) * (k0 + tid + b * kThreads) < n) {
          const float v = src[b * kThreads];
          acc[b] = j == 1 ? v : acc[b] + v;
        }
      }
      if ((j & (j - 1)) == 0) rung<kBins>(lev++, acc, best, best_lev);
    }
  }
  // Rungs past the last decimation add nothing but are normalised all the
  // same.
  for (; lev < levels; ++lev) rung<kBins>(lev, acc, best, best_lev);
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    const int k = k0 + tid + b * kThreads;
    if (k < n) {
      stat[row * n + k] = best[b];
      level[row * n + k] = best_lev[b];
    }
  }
}

// One thread per bin; block i covers bins [(i % tiles) * 256, +256) of row
// i / tiles.
__global__ void __launch_bounds__(kThreads)
    harmonic_sum_kernel(const float* __restrict__ p,
                        float* __restrict__ out, int n, int levels,
                        int tiles) {
  const long long row = blockIdx.x / tiles;
  const int k = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (k >= n) return;
  const float* pr = p + row * n;
  float acc = __ldg(pr + k);
  out[row * levels * static_cast<long long>(n) + k] = acc;
  int h = 1;
  for (int lev = 1; lev < levels; ++lev) {
    h *= 2;
    for (int j = h / 2 + 1; j <= h; ++j) {
      const long long idx = static_cast<long long>(j) * k;
      if (idx < n) acc += __ldg(pr + idx);
    }
    out[(row * levels + lev) * static_cast<long long>(n) + k] = acc;
  }
}

// The plane's launch: bins a block -> instance, decimations a stage and
// shared-memory bytes.
template <int kBins>
int launch_plane(const float* p, float* stat, int* level, long long batch,
                 int n, int levels, cudaStream_t stream) {
  constexpr int kTile = kThreads * kBins;
  // H = 2^(levels - 1) is an int.
  if (batch < 1 || n < 1 || levels < 1 || levels > 31)
    return cudaErrorInvalidValue;
  const int tiles = (n + kTile - 1) / kTile;
  const long long blocks = batch * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int h_max = 1 << (levels - 1);
  const int per_stage = h_max < kBuffer / kTile ? h_max : kBuffer / kTile;
  const size_t smem = sizeof(float) * static_cast<size_t>(per_stage) * kTile;
  auto kernel = harmonic_sum_plane_kernel<kBins>;
  if (smem > kDefaultShared) {
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kMaxShared)))
      return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      p, stat, level, n, levels, tiles, per_stage);
  return cudaGetLastError();
}

// The ladder's blocks, or an error for a shape it does not take.
int check_shape(long long batch, int n, int levels, int* tiles,
                unsigned* blocks) {
  if (batch < 1 || n < 1 || levels < 1 || levels > kMaxLevels)
    return cudaErrorInvalidValue;
  *tiles = (n + kThreads - 1) / kThreads;
  const long long b = batch * *tiles;
  if (b > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(b);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// A block covers ``bins_per_block`` bins (256, 512, 1024 or 2048) and
// stages their decimations in a buffer of 16384 values.
int repro_harmonic_sum_plane(const float* p, float* stat, int* level,
                             long long batch, int n, int levels,
                             int bins_per_block, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (bins_per_block) {
    case 256:
      return launch_plane<1>(p, stat, level, batch, n, levels, st);
    case 512:
      return launch_plane<2>(p, stat, level, batch, n, levels, st);
    case 1024:
      return launch_plane<4>(p, stat, level, batch, n, levels, st);
    case 2048:
      return launch_plane<8>(p, stat, level, batch, n, levels, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks of the plane kernel for ``bins_per_block`` bins and ``smem``
// bytes of stage buffer that one SM holds at once, or -1.
int repro_harmonic_sum_plane_blocks_per_sm(int bins_per_block, int smem) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (bins_per_block) {
    case 256:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, harmonic_sum_plane_kernel<1>, kThreads, smem);
      break;
    case 512:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, harmonic_sum_plane_kernel<2>, kThreads, smem);
      break;
    case 1024:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, harmonic_sum_plane_kernel<4>, kThreads, smem);
      break;
    case 2048:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, harmonic_sum_plane_kernel<8>, kThreads, smem);
      break;
  }
  return err == cudaSuccess ? blocks : -1;
}

int repro_harmonic_sum(const float* p, float* out, long long batch, int n,
                       int levels, void* stream) {
  int tiles;
  unsigned blocks;
  if (int err = check_shape(batch, n, levels, &tiles, &blocks)) return err;
  harmonic_sum_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, out, n,
                                                             levels, tiles);
  return cudaGetLastError();
}

}  // extern "C"
