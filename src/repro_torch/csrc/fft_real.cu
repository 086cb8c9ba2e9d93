// Packed real-input FFT kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fft/fft_kernel.py:
//   repro_fft_r2c    <- rfft_pallas (def :386; bodies _r2c_body :313,
//                       _r2c_tile :278), in register passes
//   repro_fft_r2c_t  <- rfft_t_pallas (def :547; body _r2c_t_body :297):
//                       the same packed R2C of each row of (B, R, C),
//                       written transposed to (B, C/2+1, R) — the first
//                       pass of a pow2 rfft2/rfftn plan graph
//   repro_fft_c2r    <- irfft_pallas (def :606; body _c2r_body :323)
//
// R2C: N reals are read as N/2 complex points z[k] = x[2k] + i*x[2k+1]
// (one float2 load each: the packing is free), a half-length Stockham FFT
// runs, and the Hermitian split turns Z into the N/2+1 bins X[k] = Ze[k]
// + W[k]*Zo[k].  C2R is the mirror: Hermitian merge Z[k] = Ze[k] + i*Zo[k]
// with the conjugated split table, the inverse half-length FFT (1/(N/2)),
// and each Z[k] written as one float2, which is the interleave into N
// reals.
//
// What bounds them: memory.  About 6 bytes of device-memory traffic per
// real point (4 read or written as reals, 8 per complex bin of the half
// spectrum), against a few float operations per byte.  The least time of
// a launch is bytes_moved / 3.35 TB/s.
//
// What the designs do about it: one read and one write of the batch; a
// ragged batch is masked in the kernel, never padded.  The output row of
// R2C is N/2+1 float2 long (odd), so stores are per element and never
// vectorised across rows.
//
// repro_fft_r2c runs the half-length FFT in register-resident Stockham
// passes (stockham_regs.cuh, as repro_fft_c2c): the packed reals go
// straight from device memory into registers, 16 points a thread (32 at
// N = 2^14), passes exchange through one padded shared buffer a
// transform, and the last pass writes Z to that buffer in natural order;
// after one __syncthreads the block's threads split the bins, consecutive
// threads on consecutive bins of a row (bin k needs Z[k] and Z[N/2 - k],
// which other threads hold).  At N = 2^14 a block needs 68 KB of shared
// memory and two blocks share an SM, so one block's loads overlap
// another's passes; the split costs one exchange more than fft_c2c.
//
// repro_fft_r2c_t and repro_fft_c2r keep the shared-memory stages of
// stockham(): a block keeps whole transforms in shared memory,
// double-buffered, and does the split or merge there: bin k needs bin
// N/2 - k, so C2R stages all N/2+1 bins of a row before merging and sizes
// its buffers for N/2+1 points.
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

#include "stockham_regs.cuh"

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

// (B, N) f32 -> (B, N/2+1) c64.  s is the forward plan of m = N/2 in
// register passes (stockham_regs.cuh); block i transforms rows
// [i*per_block, ...), each on m / P threads.  The last pass writes Z to
// shared memory in natural order; after one __syncthreads the block's
// threads split the N/2+1 bins of its rows, consecutive threads on
// consecutive bins.  F is the schedule's largest radix.
template <int P, int F>
__global__ void __launch_bounds__(kPassThreads, pass_min_blocks(P, F))
    fft_r2c_regs_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                        long long batch, int per_block,
                        const __grid_constant__ RegPlan s,
                        const float2* __restrict__ tw,
                        const float2* __restrict__ sw) {
  extern __shared__ float2 smem[];
  const int m = s.n;
  const int m1 = m + 1;
  const int stride = padded(m);
  const int tr = threadIdx.x >> s.log_t;
  const int lane = threadIdx.x & ((1 << s.log_t) - 1);
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block),
                                         batch - first));
  float2 v[P];
  if (tr < count) {
    load_global<P, F>(v, x + (first + tr) * m, s, lane);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = make_float2(0.f, 0.f);
  }
  float2* buf = smem + tr * stride;
  reg_passes_but_last<P, F>(v, buf, s, tw, lane);
  run_pass<P, F>(v, s, s.npasses - 1, tw, lane);
  if (s.npasses > 1) __syncthreads();  // every read of the buffer is done
  store_shared<P, F, false>(v, buf, s, s.npasses - 1, lane);
  __syncthreads();
  // Bin k of row t is output e = t * m1 + k; the threads step through e,
  // carrying (t, k) instead of dividing.
  float2* dst = y + first * m1;
  int t = threadIdx.x / m1;
  int k = threadIdx.x - t * m1;
  while (t < count) {
    __stcs(dst + t * m1 + k, split_bin(smem + t * stride, k, m, sw));
    k += blockDim.x;
    while (k >= m1) {
      k -= m1;
      ++t;
    }
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
                  int points, int per_block, const int* table, int npasses,
                  const float* dft_re, const float* dft_im, const void* tw,
                  const void* sw, void* stream) {
  if (n < 4 || (n & (n - 1)) != 0) return cudaErrorInvalidValue;
  const int m = n / 2;
  RegPlan s;
  cudaError_t err =
      make_reg_plan(&s, m, points, table, npasses, 0, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  if (per_block < 1) return cudaErrorInvalidValue;
  const long long blocks = (batch + per_block - 1) / per_block;
  const int threads = per_block << s.log_t;
  const size_t smem =
      static_cast<size_t>(per_block) * padded(m) * sizeof(float2);
  return with_instance(points, s.family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    cudaError_t e =
        prepare_passes(fft_r2c_regs_kernel<P, F>, blocks, threads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fft_r2c_regs_kernel<P, F><<<static_cast<unsigned>(blocks), threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), batch,
        per_block, s, static_cast<const float2*>(tw),
        static_cast<const float2*>(sw));
    return static_cast<int>(cudaGetLastError());
  });
}

// Blocks of `threads` threads and `smem` bytes that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for the instance of
// `points` points and family `family`, or -1 on error.
int repro_fft_r2c_resident_blocks(int points, int family, int threads,
                                  long long smem) {
  int blocks = -1;
  with_instance(points, family, [&](auto pf) {
    blocks = resident_blocks(
        fft_r2c_regs_kernel<decltype(pf)::kP, decltype(pf)::kF>, threads,
        smem);
    return 0;
  });
  return blocks;
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
