// Fused mixed-radix Stockham C2C FFT kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fft/fft_kernel.py:
//   repro_fft_c2c        <- fft_pallas (def :360; body _c2c_body :137;
//                           stages _mixed_radix_stages :68)
//   repro_fft_c2c_axis1  <- fft_axis1_twiddle_pallas (:515, body :202) and
//                           fft_axis1_pallas (:483): a null twiddle
//                           pointer selects the variant without twiddle
//   repro_fft_c2c_t      <- fft_t_pallas (:413, body :150) and
//                           fft_t_twiddle_pallas (:446), the same way
//
// What bounds them: memory.  A length-n transform does ~4.25 n log2 n
// float operations on 16 n bytes of device-memory traffic (one complex64
// read and one write per point), ~1-2 operations per byte at n <= 8192,
// against the H100's ~20 float32 operations per byte of HBM bandwidth.
// The least time of a launch is therefore bytes_moved / 3.35 TB/s.
//
// What the design does about it: each thread block loads whole transforms
// into shared memory once, runs every Stockham stage of the radix schedule
// there (ping-pong between two shared buffers, one __syncthreads per
// stage), applies the optional four-step twiddle in the epilogue and
// writes each point once — in the kernel's layout: natural (c2c), the same
// (B, R, C) layout for the column FFT (axis1), or transposed to (B, C, R)
// (t).  Device memory sees exactly one read and one write of the batch.
// Complex data stays interleaved (float2) end to end: the TPU kernels'
// split re/im planes would cost extra passes here.  A ragged batch is
// masked in the kernel (the last block runs fewer transforms), never
// padded.  Length 8192 needs 128 KB of shared memory per block, which is
// only available as dynamic shared memory after cudaFuncSetAttribute.
//
// The arithmetic is the reference's, operation for operation: the radix
// schedule of repro_torch.fft.radix.radix_schedule (residual radix first,
// r in {2, 4, 8}), the packed forward twiddle table of
// packed_stage_twiddles (rows of stage branches, each row left-aligned,
// conjugated for the inverse), the explicit radix-2/4 butterflies and the
// radix-8 butterfly through its DFT matrix, then 1/n for the inverse.  The
// plain torch version beside the wrapper (repro_torch/kernels/fft/
// fft_kernel.py) runs the same schedule and tables.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <cstring>

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

// (B, n) -> (B, n): block i transforms rows [i*per_block, ...) of the batch.
__global__ void __launch_bounds__(kThreads)
    fft_c2c_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   long long batch, int per_block,
                   const __grid_constant__ Schedule s,
                   const float* __restrict__ tw_re,
                   const float* __restrict__ tw_im) {
  extern __shared__ float2 smem[];
  const int n = s.n;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block),
                                         batch - first));
  const int elems = count * n;
  float2* a = smem;
  float2* b = smem + static_cast<size_t>(per_block) * n;
  const float2* src = x + first * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) a[e] = src[e];
  __syncthreads();
  const float2* res = stockham(a, b, count, s, tw_re, tw_im);
  float2* dst = y + first * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x)
    dst[e] = scaled(res[e], s.scale);
}

// (B, R, C) -> (B, C, R): FFT of each row (n = C), written transposed;
// optional (R, C) twiddle multiplied before the write.  Block i handles
// rows [r0, r0 + per_block) of one batch entry.
__global__ void __launch_bounds__(kThreads)
    fft_c2c_t_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                     int rows, int per_block, long long blocks_per_batch,
                     const float2* __restrict__ ftw,
                     const __grid_constant__ Schedule s,
                     const float* __restrict__ tw_re,
                     const float* __restrict__ tw_im) {
  extern __shared__ float2 smem[];
  const int n = s.n;
  const long long bid = blockIdx.x;
  const long long batch = bid / blocks_per_batch;
  const int r0 = static_cast<int>(bid - batch * blocks_per_batch) * per_block;
  const int count = min(per_block, rows - r0);
  const size_t base = static_cast<size_t>(batch) * rows * n;
  float2* a = smem;
  float2* b = smem + static_cast<size_t>(per_block) * n;
  const float2* src = x + base + static_cast<size_t>(r0) * n;
  const int elems = count * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) a[e] = src[e];
  __syncthreads();
  const float2* res = stockham(a, b, count, s, tw_re, tw_im);
  // Consecutive threads write consecutive rows of one output column.
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int k = e / count;
    const int t = e - k * count;
    float2 v = scaled(res[t * n + k], s.scale);
    if (ftw != nullptr) v = cmul(v, ftw[static_cast<size_t>(r0 + t) * n + k]);
    y[base + static_cast<size_t>(k) * rows + r0 + t] = v;
  }
}

// (B, R, C) -> (B, R, C): FFT of each column (n = R), layout kept;
// optional (C, R) twiddle: out[.., k, j] *= ftw[j, k].  Block i handles
// columns [c0, c0 + per_block) of one batch entry.
__global__ void __launch_bounds__(kThreads)
    fft_c2c_axis1_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                         int cols, int per_block, long long blocks_per_batch,
                         const float2* __restrict__ ftw,
                         const __grid_constant__ Schedule s,
                         const float* __restrict__ tw_re,
                         const float* __restrict__ tw_im) {
  extern __shared__ float2 smem[];
  const int n = s.n;
  const long long bid = blockIdx.x;
  const long long batch = bid / blocks_per_batch;
  const int c0 = static_cast<int>(bid - batch * blocks_per_batch) * per_block;
  const int count = min(per_block, cols - c0);
  const size_t base = static_cast<size_t>(batch) * n * cols;
  float2* a = smem;
  float2* b = smem + static_cast<size_t>(per_block) * n;
  const int elems = count * n;
  // Consecutive threads read consecutive columns of one input row.
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int i = e / count;
    const int t = e - i * count;
    a[t * n + i] = x[base + static_cast<size_t>(i) * cols + c0 + t];
  }
  __syncthreads();
  const float2* res = stockham(a, b, count, s, tw_re, tw_im);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int k = e / count;
    const int t = e - k * count;
    float2 v = scaled(res[t * n + k], s.scale);
    if (ftw != nullptr) v = cmul(v, ftw[static_cast<size_t>(c0 + t) * n + k]);
    y[base + static_cast<size_t>(k) * cols + c0 + t] = v;
  }
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
// limit when it needs more than the default 48 KB.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, long long blocks, int per_block, int n,
                    size_t* smem) {
  *smem = 2 * static_cast<size_t>(per_block) * n * sizeof(float2);
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

extern "C" {

const char* repro_fft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_fft_c2c(const void* x, void* y, long long batch, int n,
                  int per_block, const int* radices, int nstages,
                  int inverse, const float* dft_re, const float* dft_im,
                  const float* tw_re, const float* tw_im, void* stream) {
  Schedule s;
  cudaError_t err =
      make_schedule(&s, n, radices, nstages, inverse, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  const long long blocks = (batch + per_block - 1) / per_block;
  size_t smem = 0;
  err = prepare(fft_c2c_kernel, blocks, per_block, n, &smem);
  if (err != cudaSuccess) return err;
  fft_c2c_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch,
      per_block, s, tw_re, tw_im);
  return cudaGetLastError();
}

int repro_fft_c2c_t(const void* x, void* y, long long batch, int rows,
                    int cols, int per_block, const void* ftw,
                    const int* radices, int nstages, int inverse,
                    const float* dft_re, const float* dft_im,
                    const float* tw_re, const float* tw_im, void* stream) {
  Schedule s;
  cudaError_t err =
      make_schedule(&s, cols, radices, nstages, inverse, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  const long long per_batch = (rows + per_block - 1) / per_block;
  size_t smem = 0;
  err = prepare(fft_c2c_t_kernel, batch * per_batch, per_block, cols, &smem);
  if (err != cudaSuccess) return err;
  fft_c2c_t_kernel<<<static_cast<unsigned>(batch * per_batch), kThreads,
                     smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), rows,
      per_block, per_batch, static_cast<const float2*>(ftw), s, tw_re, tw_im);
  return cudaGetLastError();
}

int repro_fft_c2c_axis1(const void* x, void* y, long long batch, int rows,
                        int cols, int per_block, const void* ftw,
                        const int* radices, int nstages, int inverse,
                        const float* dft_re, const float* dft_im,
                        const float* tw_re, const float* tw_im,
                        void* stream) {
  Schedule s;
  cudaError_t err =
      make_schedule(&s, rows, radices, nstages, inverse, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  const long long per_batch = (cols + per_block - 1) / per_block;
  size_t smem = 0;
  err = prepare(fft_c2c_axis1_kernel, batch * per_batch, per_block, rows,
                &smem);
  if (err != cudaSuccess) return err;
  fft_c2c_axis1_kernel<<<static_cast<unsigned>(batch * per_batch), kThreads,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), cols,
      per_block, per_batch, static_cast<const float2*>(ftw), s, tw_re, tw_im);
  return cudaGetLastError();
}

}  // extern "C"
