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
// bytes a bin: 28 at H = 32).  A bin adds H values, far below the card's
// float32 rate.  What each moves beyond its bound is the gather: a value
// P[j k] of decimation j >= 8 costs a 32-byte L2 sector of its own.
//
// What the design does about it: one staged body for both kernels.  The
// TPU keeps a whole row in VMEM and reads the stride-j decimations P[::j]
// from it; a row of 65537 bins (256 KB) is more than a block's 227 KB of
// shared memory.  Gathered into registers one decimation after another,
// each P[j k] costs a round trip to L2 in turn.  Here a block takes a tile
// of K = 256 kBins bins [k0, k0 + K) of one row (kBins a thread) and
// copies the values its bins read, P[j k] for every decimation j, into
// shared memory with 4-byte cp.async (rows of odd N start only 4-byte
// aligned): the tile's whole gather is in flight at once, in no register,
// and the thread waits once.  It then adds them in the reference's order
// and hands each rung to the kernel's epilogue.  Slot (j - 1) K + m holds
// bin k0 + m's value, copied and read by the same thread (consecutive
// lanes, consecutive slots: no bank conflict, no barrier).  Where H K
// values exceed the stage buffer (large H), the decimations go through it
// a stage at a time.  Blocks are numbered along the row, so a row's tiles
// run together and the row stays in L2.  Copying instead each decimation's
// contiguous window P[j k0, j (k0 + K)) whole, as the TPU reads P[::j]
// from a resident row, copies j K values for the K a tile uses; on an H100
// it took at least 1.6x this design's time at H = 8 (PERF.md section 6).
//
// The epilogues.  The plane's (rung) normalises each rung and keeps the
// strict maximum and the earliest rung, computing the rung scales in the
// kernel: a table indexed by the run-time rung would sit in each thread's
// local memory.  The ladder's stores each rung S_h with a streaming store,
// the rungs past a tile's last decimation included.
//
// Arithmetic order, as the reference's: the rungs are added in its order
// (j = h/2 + 1 ... h), z is (acc - h) * s_h with s_h the float32 of the
// double 1/sqrt(h), and a rung replaces the best only when strictly
// greater.  So both kernels are bit-identical to their plain versions.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

extern "C" const char* repro_hsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr size_t kMaxShared = 232448;
// Values of the stage buffer (64 KB: three blocks an SM).
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

// The ladder of the tile of K = 256 kBins bins [k0, k0 + K) of row `pr`,
// every rung handed to `epilogue(lev, acc)` in turn (acc[b]: S_h of bin
// k0 + threadIdx.x + 256 b).  Decimations go through the stage buffer
// `per_stage` at a time: slot (j - j0) K + m holds P[j (k0 + m)] (bin
// k0 + m of thread m % 256), copied there by that thread, so both the
// copies and the reads of a warp hit 32 banks.
template <int kBins, class Epilogue>
__device__ __forceinline__ void staged_ladder(const float* __restrict__ pr,
                                              int n, int k0, int levels,
                                              int per_stage, float* sbuf,
                                              Epilogue&& epilogue) {
  constexpr int kTile = kThreads * kBins;
  const int tid = threadIdx.x;
  const int h_max = 1 << (levels - 1);
  // Decimations j with j k0 < n (every j for the first tile: bin 0 reads
  // P[0] H times): no bin of the tile reads past the last.
  const int j_last = k0 == 0 ? h_max : min(h_max, (n - 1) / k0);

  float acc[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) acc[b] = 0.0f;
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
      if ((j & (j - 1)) == 0) epilogue(lev++, acc);
    }
  }
  // Rungs past the last decimation add nothing but are handed on all the
  // same.
  for (; lev < levels; ++lev) epilogue(lev, acc);
}

// Block i covers tile i % tiles of row i / tiles (kBins bins a thread).
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
  float best[kBins];
  int best_lev[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    best[b] = 0.0f;
    best_lev[b] = 0;
  }
  staged_ladder<kBins>(p + row * n, n, k0, levels, per_stage, sbuf,
                       [&](int lev, const float (&acc)[kBins]) {
                         rung<kBins>(lev, acc, best, best_lev);
                       });
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    const int k = k0 + threadIdx.x + b * kThreads;
    if (k < n) {
      stat[row * n + k] = best[b];
      level[row * n + k] = best_lev[b];
    }
  }
}

// The same blocks as the plane's; rung `lev` of bin k goes to
// out[(row L + lev) N + k].
template <int kBins>
__global__ void __launch_bounds__(kThreads)
    harmonic_sum_kernel(const float* __restrict__ p, float* __restrict__ out,
                        int n, int levels, int tiles, int per_stage) {
  constexpr int kTile = kThreads * kBins;
  extern __shared__ float sbuf[];
  const long long row = blockIdx.x / tiles;
  const int k0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  float* const dst = out + row * levels * static_cast<long long>(n) + k0 +
                     threadIdx.x;
  const int left = n - k0 - static_cast<int>(threadIdx.x);
  staged_ladder<kBins>(p + row * n, n, k0, levels, per_stage, sbuf,
                       [&](int lev, const float (&acc)[kBins]) {
                         float* o = dst + static_cast<long long>(lev) * n;
#pragma unroll
                         for (int b = 0; b < kBins; ++b)
                           if (b * kThreads < left)
                             __stcs(o + b * kThreads, acc[b]);
                       });
}

// One launch of either kernel at K = 256 kBins bins a block: its blocks,
// tiles a row, decimations a stage and stage-buffer bytes.
struct Launch {
  unsigned blocks;
  int tiles, per_stage;
  size_t smem;
};

// The launch for a shape, or an error for a shape neither kernel takes.
template <int kBins>
int plan(long long batch, int n, int levels, Launch* l) {
  constexpr int kTile = kThreads * kBins;
  // H = 2^(levels - 1) is an int.
  if (batch < 1 || n < 1 || levels < 1 || levels > 31)
    return cudaErrorInvalidValue;
  l->tiles = (n + kTile - 1) / kTile;
  const long long blocks = batch * l->tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  l->blocks = static_cast<unsigned>(blocks);
  const int h_max = 1 << (levels - 1);
  l->per_stage = h_max < kBuffer / kTile ? h_max : kBuffer / kTile;
  l->smem = sizeof(float) * static_cast<size_t>(l->per_stage) * kTile;
  return cudaSuccess;
}

// Lets `kernel` take a stage buffer of `smem` bytes.
template <class Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= kDefaultShared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxShared));
}

// f(std::integral_constant<int, kBins>) for the instance of
// `bins_per_block` bins a block (256, 512, 1024 or 2048).
template <class F>
int dispatch(int bins_per_block, F&& f) {
  switch (bins_per_block) {
    case 256:
      return f(std::integral_constant<int, 1>());
    case 512:
      return f(std::integral_constant<int, 2>());
    case 1024:
      return f(std::integral_constant<int, 4>());
    case 2048:
      return f(std::integral_constant<int, 8>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// A block covers ``bins_per_block`` bins (256, 512, 1024 or 2048) and
// stages their decimations in a buffer of 16384 values.
int repro_harmonic_sum_plane(const float* p, float* stat, int* level,
                             long long batch, int n, int levels,
                             int bins_per_block, void* stream) {
  return dispatch(bins_per_block, [&](auto bins) {
    constexpr int kBins = decltype(bins)::value;
    Launch l;
    if (int err = plan<kBins>(batch, n, levels, &l)) return err;
    auto kernel = harmonic_sum_plane_kernel<kBins>;
    if (int err = allow_shared(kernel, l.smem)) return err;
    kernel<<<l.blocks, kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(
        p, stat, level, n, levels, l.tiles, l.per_stage);
    return static_cast<int>(cudaGetLastError());
  });
}

// The ladder on the plane's blocks and stages.
int repro_harmonic_sum(const float* p, float* out, long long batch, int n,
                       int levels, int bins_per_block, void* stream) {
  return dispatch(bins_per_block, [&](auto bins) {
    constexpr int kBins = decltype(bins)::value;
    Launch l;
    if (int err = plan<kBins>(batch, n, levels, &l)) return err;
    auto kernel = harmonic_sum_kernel<kBins>;
    if (int err = allow_shared(kernel, l.smem)) return err;
    kernel<<<l.blocks, kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(
        p, out, n, levels, l.tiles, l.per_stage);
    return static_cast<int>(cudaGetLastError());
  });
}

// Blocks of the plane kernel (``plane`` != 0) or the ladder kernel for
// ``bins_per_block`` bins and ``smem`` bytes of stage buffer that one SM
// holds at once, or -1.
int repro_harmonic_sum_blocks_per_sm(int plane, int bins_per_block,
                                     int smem) {
  int blocks = -1;
  const int err = dispatch(bins_per_block, [&](auto bins) {
    constexpr int kBins = decltype(bins)::value;
    return static_cast<int>(
        plane ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, harmonic_sum_plane_kernel<kBins>, kThreads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, harmonic_sum_kernel<kBins>, kThreads, smem));
  });
  return err == cudaSuccess ? blocks : -1;
}

}  // extern "C"
