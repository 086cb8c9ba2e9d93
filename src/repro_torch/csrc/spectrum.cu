// Fused power spectrum and row statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/spectrum/spectrum_kernel.py:
//   repro_power_spectrum_stats  <- power_spectrum_stats_pallas (def :32;
//                                  body _spectrum_body :21): (B, N)
//                                  spectra -> p = (re^2 + im^2) / N (B, N),
//                                  the row mean of p and its variance
//                                  E[p^2] - mean^2 (B,), all float32
//
// What bounds it: memory.  It reads 8 bytes a bin and writes 4, plus 8
// bytes a row: 12 bytes a bin over 3.35 TB/s.
//
// What the design does about it: one pass.  One block of 1024 threads per
// row reads the interleaved complex64 spectrum (the port keeps complex data
// interleaved; the TPU kernel reads split re/im planes), writes p, and sums
// p and p^2 as it goes; a warp-shuffle and shared-memory reduction gives
// the row's sums.  The sums are kept in double, so the mean and E[p^2] are
// the float32 roundings of nearly exact means, and the variance is the
// reference's formula E[p^2] - mean^2 in float32 on them, cancellation
// included.  Each product and sum of p is rounded as written (no FMA
// contraction), as the plain version computes it.
//
// Interface: a plain C function on device pointers, launched on the given
// stream; it returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

extern "C" const char* repro_spectrum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    power_spectrum_stats_kernel(const float2* __restrict__ x,
                                float* __restrict__ p,
                                float* __restrict__ mean,
                                float* __restrict__ var, int n) {
  const long long row = blockIdx.x;
  const float2* xr = x + row * n;
  float* pr = p + row * n;
  const float len = static_cast<float>(n);
  double s1 = 0.0, s2 = 0.0;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float2 v = __ldg(xr + k);
    const float pk = __fdiv_rn(
        __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), len);
    __stcs(pr + k, pk);
    s1 += pk;
    s2 += __fmul_rn(pk, pk);
  }
  __shared__ double part1[kWarps], part2[kWarps];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part1[warp] = s1;
    part2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = warp_sum(part1[lane]);
    s2 = warp_sum(part2[lane]);
    if (lane == 0) {
      const float m = static_cast<float>(s1 / n);
      const float m2 = static_cast<float>(s2 / n);
      mean[row] = m;
      var[row] = __fsub_rn(m2, __fmul_rn(m, m));
    }
  }
}

}  // namespace

extern "C" int repro_power_spectrum_stats(const void* x, float* p,
                                          float* mean, float* var,
                                          long long batch, int n,
                                          void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || n < 1)
    return cudaErrorInvalidValue;
  power_spectrum_stats_kernel<<<static_cast<unsigned>(batch), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), p, mean, var, n);
  return cudaGetLastError();
}
