// Shared device code of the port's FFT kernels (fft_c2c.cu, fft_real.cu):
// the radix schedule, the stage twiddle lookup, the in-shared-memory
// mixed-radix Stockham stages and the launch checks.  stockham() and its
// Schedule serve fft_c2c_mul alone; every other FFT kernel runs the
// register passes of stockham_regs.cuh, which take the complex helpers
// and limits from here.
//
// The arithmetic is the reference's, operation for operation: the radix
// schedule of repro_torch.fft.radix.radix_schedule (residual radix first,
// r in {2, 4, 8}), the packed forward twiddle table of
// packed_stage_twiddles (rows of stage branches, each row left-aligned,
// conjugated for the inverse), the explicit radix-2/4 butterflies and the
// radix-8 butterfly through its DFT matrix, then 1/n for the inverse.  The
// plain torch versions beside the wrappers (repro_torch/kernels/fft/
// fft_kernel.py) run the same schedule and tables.
//
// Each .cu file that includes this header is compiled into a library of
// its own, so everything here has internal linkage, except the error
// string lookup that each library exports.

#pragma once

#include <cuda_runtime.h>

#include <cstring>

extern "C" const char* repro_fft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kMaxStages = 16;
constexpr int kThreads = 256;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr size_t kMaxShared = 232448;  // 227 KB per block on Hopper

struct Schedule {
  int n;                  // transform length (a power of two)
  int nstages;
  int radix[kMaxStages];  // radix of each stage, in execution order
  float sign;             // -1 forward, +1 inverse
  float scale;            // 1 forward, 1/n inverse (exact: n is pow2)
  float dft_re[64];       // radix-8 butterfly matrix [p * 8 + k] of the
  float dft_im[64];       // direction (repro_torch.fft.radix.dft_matrix)
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Twiddle of packed row `row`, column j; the inverse conjugates it.
__device__ __forceinline__ float2 twiddle(const float* __restrict__ tw_re,
                                          const float* __restrict__ tw_im,
                                          int row, int n, int j, float sign) {
  const size_t at = static_cast<size_t>(row) * n + j;
  return make_float2(__ldg(tw_re + at), -sign * __ldg(tw_im + at));
}

// Runs every stage of `s` on `count` transforms held in shared memory at
// src[t * n + i], ping-ponging with dst.  Returns the buffer holding the
// result.  Stage with sub-length m and h = m / r: butterfly (t, li, j)
// reads src[t*n + li*m + p*h + j] for p < r and writes branch k to
// dst[t*n + k*(n/r) + li*h + j] — the Stockham autosort order.
__device__ __forceinline__ float2* stockham(float2* src, float2* dst,
                                            int count, const Schedule& s,
                                            const float* __restrict__ tw_re,
                                            const float* __restrict__ tw_im) {
  const int n = s.n;
  const float sign = s.sign;
  int m = n;
  int row = 0;
  for (int st = 0; st < s.nstages; ++st) {
    const int r = s.radix[st];
    const int h = m / r;
    const int per = n / r;
    const int log_h = __ffs(h) - 1;
    const int log_per = __ffs(per) - 1;
    const int total = count << log_per;
    for (int q = threadIdx.x; q < total; q += blockDim.x) {
      const int t = q >> log_per;
      const int u = q & (per - 1);
      const int li = u >> log_h;
      const int j = u & (h - 1);
      const float2* in = src + t * n + li * m + j;
      float2* out = dst + t * n + u;
      if (r == 2) {
        const float2 a = in[0], b = in[h];
        out[0] = cadd(a, b);
        out[per] = cmul(csub(a, b), twiddle(tw_re, tw_im, row, n, j, sign));
      } else if (r == 4) {
        const float2 x0 = in[0], x1 = in[h], x2 = in[2 * h], x3 = in[3 * h];
        const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2);
        const float2 t2 = cadd(x1, x3), t3 = csub(x1, x3);
        // sign * i * t3: b1/b3 = t1 -+ i*t3 forward, flipped for the inverse.
        const float2 u3 = make_float2(-sign * t3.y, sign * t3.x);
        out[0] = cadd(t0, t2);
        out[per] = cmul(cadd(t1, u3), twiddle(tw_re, tw_im, row, n, j, sign));
        out[2 * per] =
            cmul(csub(t0, t2), twiddle(tw_re, tw_im, row + 1, n, j, sign));
        out[3 * per] =
            cmul(csub(t1, u3), twiddle(tw_re, tw_im, row + 2, n, j, sign));
      } else {  // r == 8 (the host rejects any other radix)
        float2 x[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) x[p] = in[p * h];
        float2 acc = x[0];
#pragma unroll
        for (int p = 1; p < 8; ++p) acc = cadd(acc, x[p]);
        out[0] = acc;
#pragma unroll
        for (int k = 1; k < 8; ++k) {
          float ar = x[0].x, ai = x[0].y;
#pragma unroll
          for (int p = 1; p < 8; ++p) {
            const float cr = s.dft_re[p * 8 + k], ci = s.dft_im[p * 8 + k];
            ar = ar + x[p].x * cr - x[p].y * ci;
            ai = ai + x[p].x * ci + x[p].y * cr;
          }
          out[k * per] = cmul(make_float2(ar, ai),
                              twiddle(tw_re, tw_im, row + k - 1, n, j, sign));
        }
      }
    }
    __syncthreads();
    float2* tmp = src;
    src = dst;
    dst = tmp;
    row += r - 1;
    m = h;
  }
  return src;
}

__device__ __forceinline__ float2 scaled(float2 v, float scale) {
  return make_float2(v.x * scale, v.y * scale);
}

cudaError_t make_schedule(Schedule* s, int n, const int* radices,
                          int nstages, int inverse, const float* dft_re,
                          const float* dft_im) {
  if (n < 1 || (n & (n - 1)) != 0 || nstages < 0 || nstages > kMaxStages)
    return cudaErrorInvalidValue;
  long long prod = 1;
  for (int i = 0; i < nstages; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 4 && r != 8) return cudaErrorInvalidValue;
    s->radix[i] = r;
    prod *= r;
  }
  if (prod != n) return cudaErrorInvalidValue;
  s->n = n;
  s->nstages = nstages;
  s->sign = inverse ? 1.0f : -1.0f;
  s->scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;
  std::memcpy(s->dft_re, dft_re, sizeof(s->dft_re));
  std::memcpy(s->dft_im, dft_im, sizeof(s->dft_im));
  return cudaSuccess;
}

// Checks the launch shape and raises the kernel's dynamic shared-memory
// limit when it needs more than the default 48 KB.  A block holds two
// buffers of `points` complex values for each of its `per_block`
// transforms.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, long long blocks, int per_block,
                    int points, size_t* smem) {
  *smem = 2 * static_cast<size_t>(per_block) * points * sizeof(float2);
  if (per_block < 1 || blocks < 1 || blocks > 0x7fffffffLL ||
      *smem > kMaxShared)
    return cudaErrorInvalidValue;
  if (*smem > kDefaultShared)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

}  // namespace
