// Packed real-input FFT kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fft/fft_kernel.py:
//   repro_fft_r2c    <- rfft_pallas (def :386; bodies _r2c_body :313,
//                       _r2c_tile :278)
//   repro_fft_r2c_t  <- rfft_t_pallas (def :547; body _r2c_t_body :297):
//                       the same packed R2C of each row of (B, R, C),
//                       written transposed to (B, C/2+1, R) — the first
//                       pass of a pow2 rfft2/rfftn plan graph
//   repro_fft_c2r    <- irfft_pallas (def :606; body _c2r_body :323)
//
// R2C: N reals are read as N/2 complex points z[k] = x[2k] + i*x[2k+1]
// (one float2 load each: the packing is free), a half-length Stockham FFT
// runs in shared memory, and the Hermitian split turns Z into the N/2+1
// bins X[k] = Ze[k] + W[k]*Zo[k].  C2R is the mirror: Hermitian merge
// Z[k] = Ze[k] + i*Zo[k] with the conjugated split table, the inverse
// half-length FFT (1/(N/2)), and each Z[k] written as one float2, which is
// the interleave into N reals.
//
// What bounds them: memory.  About 6 bytes of device-memory traffic per
// real point (4 read or written as reals, 4 per complex bin of the half
// spectrum), against a few float operations per byte.  The least time of a
// launch is bytes_moved / 3.35 TB/s.
//
// What the design does about it: one read and one write of the batch.  A
// block keeps whole transforms in shared memory, double-buffered for the
// stages (stockham.cuh), and does the split or merge there: bin k needs
// bin N/2 - k, so C2R stages all N/2+1 bins of a row before merging and
// sizes its buffers for N/2+1 points.  The output row of R2C is N/2+1
// float2 long (odd), so stores are per element and never vectorised
// across rows.  A ragged batch is masked in the kernel, never padded.  At
// N = 2^14 a block needs 128 KB of shared memory (as fft_c2c at 8192).
//
// R2C_T (the transposed write) splits straight from the stage buffer into
// the (C/2+1, R) output plane of its batch entry: consecutive threads take
// consecutive rows of one bin, so the store is coalesced along R over the
// block's tile of rows (per_block * 8 bytes per bin; one row per block at
// C = 8192, where the store degenerates to single 8-byte writes).  Bin C/2
// (Nyquist) is the plane's last row, read as Z[0] like bin 0, in the same
// loop.  A ragged R is masked (the last block of a batch entry runs fewer
// rows), never padded: the reference needs R % tile == 0, the port does
// not.
//
// The split and merge follow the reference kernel's operations in its
// order; the plain torch versions (repro_torch/kernels/fft/fft_kernel.py)
// run the torch engine's complex split and merge, which agree with them to
// rounding.  The split table W[k] = exp(-2*pi*i*k/N), k = 0..N/2, is the
// engine's complex64 table, read as float2.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include "stockham.cuh"

namespace {

// Bin k (0 <= k <= m) of the Hermitian split of one row's packed
// half-length spectrum z (m points): X[k] = Ze[k] + W[k] * Zo[k], in the
// reference's _r2c_tile order.  Bin m reads Z[0], as the reference's wrap.
__device__ __forceinline__ float2 split_bin(const float2* z, int k, int m,
                                            const float2* __restrict__ sw) {
  const float2 f = z[k & (m - 1)];                    // Z[k], Z[m] = Z[0]
  const float2 g = z[(m - k) & (m - 1)];              // Z[m-k]
  const float rr = g.x, ri = -g.y;                    // conj(Z[m-k])
  const float dr = f.x - rr, di = f.y - ri;
  const float qr = 0.5f * di, qi = -0.5f * dr;        // Zo = -i/2 * d
  const float2 w = __ldg(sw + k);
  const float wr = w.x, wi = w.y;
  const float pr = qr * wr - qi * wi, pi = qr * wi + qi * wr;
  return make_float2(0.5f * (f.x + rr) + pr, 0.5f * (f.y + ri) + pi);
}

// (B, N) f32 -> (B, N/2+1) c64.  s is the forward schedule of m = N/2;
// block i transforms rows [i*per_block, ...) of the batch.
__global__ void __launch_bounds__(kThreads)
    fft_r2c_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   long long batch, int per_block,
                   const __grid_constant__ Schedule s,
                   const float* __restrict__ tw_re,
                   const float* __restrict__ tw_im,
                   const float2* __restrict__ sw) {
  extern __shared__ float2 smem[];
  const int m = s.n;
  const int m1 = m + 1;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block),
                                         batch - first));
  float2* a = smem;
  float2* b = smem + static_cast<size_t>(per_block) * m;
  const float2* src = x + first * m;
  const int elems = count * m;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) a[e] = src[e];
  __syncthreads();
  const float2* z = stockham(a, b, count, s, tw_re, tw_im);
  float2* dst = y + first * m1;
  const int outs = count * m1;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int t = e / m1;
    const int k = e - t * m1;
    dst[e] = split_bin(z + t * m, k, m, sw);
  }
}

// (B, R, C) f32 -> (B, C/2+1, R) c64: the packed R2C of each row, written
// transposed.  s is the forward schedule of m = C/2; block i handles rows
// [r0, r0 + per_block) of one batch entry.
__global__ void __launch_bounds__(kThreads)
    fft_r2c_t_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                     int rows, int per_block, long long blocks_per_batch,
                     const __grid_constant__ Schedule s,
                     const float* __restrict__ tw_re,
                     const float* __restrict__ tw_im,
                     const float2* __restrict__ sw) {
  extern __shared__ float2 smem[];
  const int m = s.n;
  const int m1 = m + 1;
  const long long bid = blockIdx.x;
  const long long batch = bid / blocks_per_batch;
  const int r0 = static_cast<int>(bid - batch * blocks_per_batch) * per_block;
  const int count = min(per_block, rows - r0);
  float2* a = smem;
  float2* b = smem + static_cast<size_t>(per_block) * m;
  const float2* src = x + (static_cast<size_t>(batch) * rows + r0) * m;
  const int elems = count * m;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) a[e] = src[e];
  __syncthreads();
  const float2* z = stockham(a, b, count, s, tw_re, tw_im);
  float2* dst = y + static_cast<size_t>(batch) * m1 * rows + r0;
  const int outs = count * m1;
  // Consecutive threads write consecutive rows of one output bin.
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int k = e / count;
    const int t = e - k * count;
    dst[static_cast<size_t>(k) * rows + t] = split_bin(z + t * m, k, m, sw);
  }
}

// (B, N/2+1) c64 -> (B, N) f32.  s is the inverse schedule of m = N/2.
__global__ void __launch_bounds__(kThreads)
    fft_c2r_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   long long batch, int per_block,
                   const __grid_constant__ Schedule s,
                   const float* __restrict__ tw_re,
                   const float* __restrict__ tw_im,
                   const float2* __restrict__ sw) {
  extern __shared__ float2 smem[];
  const int m = s.n;
  const int m1 = m + 1;
  const int log_m = __ffs(m) - 1;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block),
                                         batch - first));
  float2* a = smem;                                     // merged Z
  float2* b = smem + static_cast<size_t>(per_block) * m1;  // staged bins
  const float2* src = x + first * m1;
  const int ins = count * m1;
  for (int e = threadIdx.x; e < ins; e += blockDim.x) b[e] = src[e];
  __syncthreads();
  const int elems = count * m;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int t = e >> log_m;
    const int k = e & (m - 1);
    const float2 v = b[t * m1 + k];                     // X[k]
    const float2 u = b[t * m1 + m - k];                 // X[m-k]
    const float rr = u.x, ri = -u.y;                    // conj(X[m-k])
    const float er = 0.5f * (v.x + rr), ei = 0.5f * (v.y + ri);  // Ze
    const float dr = v.x - rr, di = v.y - ri;
    const float2 w = __ldg(sw + k);
    const float wr = w.x, wi = -w.y;                    // conj(W)
    const float hr = 0.5f * dr, hi = 0.5f * di;
    const float qr = hr * wr - hi * wi, qi = hr * wi + hi * wr;  // Zo
    a[e] = make_float2(er - qi, ei + qr);               // Z = Ze + i * Zo
  }
  __syncthreads();
  // The stages ping-pong between a and b (both hold count * m points).
  const float2* res = stockham(a, b, count, s, tw_re, tw_im);
  float2* dst = y + first * m;
  for (int e = threadIdx.x; e < elems; e += blockDim.x)
    dst[e] = scaled(res[e], s.scale);
}

// Checks the real length and builds the schedule of its half length.
cudaError_t half_schedule(Schedule* s, int n, const int* radices,
                          int nstages, int inverse, const float* dft_re,
                          const float* dft_im) {
  if (n < 4 || (n & (n - 1)) != 0) return cudaErrorInvalidValue;
  return make_schedule(s, n / 2, radices, nstages, inverse, dft_re, dft_im);
}

}  // namespace

extern "C" {

int repro_fft_r2c(const void* x, void* y, long long batch, int n,
                  int per_block, const int* radices, int nstages,
                  const float* dft_re, const float* dft_im,
                  const float* tw_re, const float* tw_im,
                  const void* sw, void* stream) {
  Schedule s;
  cudaError_t err =
      half_schedule(&s, n, radices, nstages, 0, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  const long long blocks = (batch + per_block - 1) / per_block;
  size_t smem = 0;
  err = prepare(fft_r2c_kernel, blocks, per_block, n / 2, &smem);
  if (err != cudaSuccess) return err;
  fft_r2c_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch,
      per_block, s, tw_re, tw_im, static_cast<const float2*>(sw));
  return cudaGetLastError();
}

int repro_fft_r2c_t(const void* x, void* y, long long batch, int rows,
                    int cols, int per_block, const int* radices, int nstages,
                    const float* dft_re, const float* dft_im,
                    const float* tw_re, const float* tw_im, const void* sw,
                    void* stream) {
  Schedule s;
  cudaError_t err =
      half_schedule(&s, cols, radices, nstages, 0, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  if (rows < 1 || per_block < 1) return cudaErrorInvalidValue;
  const long long per_batch = (rows + per_block - 1) / per_block;
  size_t smem = 0;
  err = prepare(fft_r2c_t_kernel, batch * per_batch, per_block, cols / 2,
                &smem);
  if (err != cudaSuccess) return err;
  fft_r2c_t_kernel<<<static_cast<unsigned>(batch * per_batch), kThreads,
                     smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), rows,
      per_block, per_batch, s, tw_re, tw_im, static_cast<const float2*>(sw));
  return cudaGetLastError();
}

int repro_fft_c2r(const void* x, void* y, long long batch, int n,
                  int per_block, const int* radices, int nstages,
                  const float* dft_re, const float* dft_im,
                  const float* tw_re, const float* tw_im,
                  const void* sw, void* stream) {
  Schedule s;
  cudaError_t err =
      half_schedule(&s, n, radices, nstages, 1, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  const long long blocks = (batch + per_block - 1) / per_block;
  size_t smem = 0;
  err = prepare(fft_c2r_kernel, blocks, per_block, n / 2 + 1, &smem);
  if (err != cudaSuccess) return err;
  fft_c2r_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch,
      per_block, s, tw_re, tw_im, static_cast<const float2*>(sw));
  return cudaGetLastError();
}

}  // extern "C"
