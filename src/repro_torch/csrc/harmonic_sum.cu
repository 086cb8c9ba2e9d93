// Harmonic summing for Hopper (sm_90a): the doubling ladder, written out
// rung by rung or normalised and max-reduced in the kernel.
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
// What the design does about it: the TPU keeps a whole row in VMEM and
// reads the stride-j decimations P[::j] from it.  A row of 65537 bins is
// 256 KB, more than one block's 227 KB of shared memory, so here a thread
// takes one bin k of one row and reads P[j * k] for j <= H straight from
// global memory: the row (256 KB) stays in L2 while its blocks run, so HBM
// sees each row about once, and the strided gathers are L2 traffic.  One
// block covers 256 consecutive bins of one row; blocks are numbered along
// the row, so the blocks reading one row's harmonics run together.
//
// Arithmetic order, as the reference's: the rungs are added in its order
// (j = h/2 + 1 ... h), z is (acc - h) * s_h with s_h the float32 of the
// double 1/sqrt(h) (the wrapper passes the table), and a rung replaces the
// best only when strictly greater.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

extern "C" const char* repro_hsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;

struct Scales {
  float s[kMaxLevels];  // float32 of 1/sqrt(2^lev), lev = 0 .. levels-1
};

// One thread per bin; block i covers bins [(i % tiles) * 256, +256) of row
// i / tiles.  ``kPlane`` selects the statistic/rung outputs, else the
// ladder is written out rung by rung.
template <bool kPlane>
__device__ __forceinline__ void ladder(const float* __restrict__ p,
                                       float* __restrict__ out,
                                       int* __restrict__ level, int n,
                                       int levels, int tiles,
                                       const Scales& scales) {
  const long long row = blockIdx.x / tiles;
  const int k = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (k >= n) return;
  const float* pr = p + row * n;
  float acc = __ldg(pr + k);
  float best = acc - 1.0f;  // z_1 = S_1 - 1
  int best_lev = 0;
  if (!kPlane) out[row * levels * static_cast<long long>(n) + k] = acc;
  int h = 1;
  for (int lev = 1; lev < levels; ++lev) {
    h *= 2;
    for (int j = h / 2 + 1; j <= h; ++j) {
      const long long idx = static_cast<long long>(j) * k;
      if (idx < n) acc += __ldg(pr + idx);
    }
    if (kPlane) {
      const float z = __fmul_rn(acc - static_cast<float>(h), scales.s[lev]);
      if (z > best) {
        best = z;
        best_lev = lev;
      }
    } else {
      out[(row * levels + lev) * static_cast<long long>(n) + k] = acc;
    }
  }
  if (kPlane) {
    out[row * n + k] = best;
    level[row * n + k] = best_lev;
  }
}

__global__ void __launch_bounds__(kThreads)
    harmonic_sum_plane_kernel(const float* __restrict__ p,
                              float* __restrict__ stat,
                              int* __restrict__ level, int n, int levels,
                              int tiles, Scales scales) {
  ladder<true>(p, stat, level, n, levels, tiles, scales);
}

__global__ void __launch_bounds__(kThreads)
    harmonic_sum_kernel(const float* __restrict__ p,
                        float* __restrict__ out, int n, int levels,
                        int tiles) {
  ladder<false>(p, out, nullptr, n, levels, tiles, Scales{});
}

// The launch's blocks, or an error for a shape the kernels do not take.
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

// ``scales`` is a host array of ``levels`` floats.
int repro_harmonic_sum_plane(const float* p, float* stat, int* level,
                             long long batch, int n, int levels,
                             const float* scales, void* stream) {
  int tiles;
  unsigned blocks;
  if (int err = check_shape(batch, n, levels, &tiles, &blocks)) return err;
  Scales s{};
  for (int i = 0; i < levels; ++i) s.s[i] = scales[i];
  harmonic_sum_plane_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, stat, level, n, levels, tiles, s);
  return cudaGetLastError();
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
