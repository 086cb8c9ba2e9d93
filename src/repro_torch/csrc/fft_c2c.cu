// Fused mixed-radix Stockham C2C FFT kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fft/fft_kernel.py:
//   repro_fft_c2c_run    <- fft_pallas (def :360; body _c2c_body :137;
//                           stages _mixed_radix_stages :68), in register
//                           passes planned by repro_fft_c2c_plan
//   repro_fft_c2c_axis1  <- fft_axis1_twiddle_pallas (:515, body :202) and
//                           fft_axis1_pallas (:483): a null twiddle
//                           pointer selects the variant without twiddle
//   repro_fft_c2c_t      <- fft_t_pallas (:413, body :150) and
//                           fft_t_twiddle_pallas (:446), the same way
//   repro_fft_c2c_mul    <- fft_mul_pallas (:243, body _c2c_mul_body :220):
//                           the C2C FFT of each row times every row of a
//                           (T, n) filter bank, (B, n) -> (B, T, n)
//
// What bounds them: memory.  A length-n transform does ~4.25 n log2 n
// float operations on 16 n bytes of device-memory traffic (one complex64
// read and one write per point, 16 B a point), ~1-2 operations per byte
// at n <= 8192, against the H100's ~20 float32 operations per byte of HBM
// bandwidth.  The least time of a launch is therefore bytes_moved /
// 3.35 TB/s.
//
// What the designs do about it: device memory sees exactly one read and
// one write of the batch; complex data stays interleaved (float2) end to
// end, since the TPU kernels' split re/im planes would cost extra passes;
// a ragged batch is masked in the kernel (the last block runs fewer
// transforms), never padded.
//
// repro_fft_c2c_run runs register-resident Stockham passes
// (stockham_regs.cuh): each thread loads 16 points of a transform (32 at
// n = 8192, where a transform takes 256 threads) straight from device
// memory into registers, coalesced, runs up to five stages on them, and
// exchanges with the other threads of its transform through one padded
// shared buffer (n + n/16 slots, 68 KB at 8192) between passes: 2 or 3
// exchanges at n = 8192 instead of the 7 shared round trips of one stage
// each.  The last pass stores straight from registers, in natural order.
// The twiddles are one compact table of n - 1 float2 read through L1.
// With 256 threads a block, a launch bound that keeps every instance
// without spills, and one buffer, three blocks share an SM at 16 points a
// thread and two at n = 8192 (radix-8 schedules, a tuning option: two
// and one), so one block's loads overlap another's passes.  The plan (the
// stages grouped into passes) comes from the host (fft_kernel.pass_table),
// once per shape (repro_fft_c2c_plan); each (points, family) instance is
// compiled for its own passes only.
//
// repro_fft_c2c_t, _axis1 and _mul keep the shared-memory stages of
// stockham(): each thread block loads whole transforms into shared memory
// once, runs every Stockham stage of the radix schedule there (ping-pong
// between two shared buffers, one __syncthreads per stage), applies the
// optional four-step twiddle in the epilogue and writes each point once —
// in the kernel's layout: the same (B, R, C) layout for the column FFT
// (axis1), or transposed to (B, C, R) (t).  Length 8192 needs 128 KB of
// shared memory per block, which is only available as dynamic shared
// memory after cudaFuncSetAttribute.
//
// The bank multiply (c2c_mul) is the overlap-save/FDAS forward pass.  It
// writes T times what it reads — 8 n (B + T + B T) bytes, write-bound —
// so its least time is the product plane's write.  The TPU kernel pins the
// whole bank in VMEM across grid steps; at the FDAS size (T = 85,
// n = 2048, 1.39 MB) no SM's shared memory holds it.  Here a block keeps
// only its transformed rows in shared memory and streams the bank from
// global memory, one template after another: every block reads the same
// bank, so it stays in the 50 MB L2, and the products go out with
// evict-first stores (__stcs) so that the plane does not push it out.
// Consecutive threads write consecutive points of one (row, template)
// product, so the store is fully coalesced.
//
// The stages themselves (stockham.cuh, stockham_regs.cuh) are the
// reference's arithmetic, operation for operation; the plain torch
// version beside the wrapper (repro_torch/kernels/fft/fft_kernel.py) runs
// the same schedule and tables.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include "stockham_regs.cuh"

namespace {

// (B, n) -> (B, n) in register passes (stockham_regs.cuh): block i
// transforms rows [i*per_block, ...), each on n / P threads; F is the
// schedule's largest radix.
template <int P, int F>
__global__ void __launch_bounds__(kPassThreads, pass_min_blocks(P, F))
    fft_c2c_regs_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                        long long batch, int per_block,
                        const __grid_constant__ RegPlan s,
                        const float2* __restrict__ tw) {
  extern __shared__ float2 smem[];
  const int n = s.n;
  const int tr = threadIdx.x >> s.log_t;
  const int lane = threadIdx.x & ((1 << s.log_t) - 1);
  const long long row = static_cast<long long>(blockIdx.x) * per_block + tr;
  const bool live = row < batch;  // the last block may be ragged
  float2 v[P];
  if (live) {
    load_global<P, F>(v, x + row * n, s, lane);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = make_float2(0.f, 0.f);
  }
  reg_passes_but_last<P, F>(v, smem + tr * padded(n), s, tw, lane);
  run_pass<P, F>(v, s, s.npasses - 1, tw, lane);
  if (live) store_global<P, F>(v, y + row * n, s, lane);
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

// (B, n) -> (B, T, n): y[b, t] = FFT(x[b]) * bank[t] (the inverse FFT,
// 1/n, when the schedule is inverse).  Block i transforms rows
// [i*per_block, ...) and writes their T products each; the launch checks
// that per_block * T * n fits an int.
__global__ void __launch_bounds__(kThreads)
    fft_c2c_mul_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                       long long batch, int per_block, int templates,
                       const float2* __restrict__ bank,
                       const __grid_constant__ Schedule s,
                       const float* __restrict__ tw_re,
                       const float* __restrict__ tw_im) {
  extern __shared__ float2 smem[];
  const int n = s.n;
  const int log_n = __ffs(n) - 1;
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
  // Output element e of the block is (row, t, i) with e = (row*T + t)*n + i.
  float2* dst = y + first * templates * n;
  const int outs = elems * templates;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int q = e >> log_n;
    const int i = e & (n - 1);
    const int row = q / templates;
    const int t = q - row * templates;
    const float2 v = scaled(res[row * n + i], s.scale);
    __stcs(dst + e, cmul(v, __ldg(bank + static_cast<size_t>(t) * n + i)));
  }
}

}  // namespace

extern "C" {

// Plans fft_c2c's launch of length-n transforms, per_block a block, into
// `plan` (repro_pass_plan_bytes() bytes, kept by the caller with the
// tables it points into): checks the plan table, sizes the launch and
// raises the instance's shared-memory limit, once per shape.
int repro_fft_c2c_plan(void* plan, int n, int points, int per_block,
                       const int* table, int npasses, int inverse,
                       const float* dft_re, const float* dft_im,
                       const void* tw) {
  PassLaunchPlan* p = static_cast<PassLaunchPlan*>(plan);
  cudaError_t err = make_reg_plan(&p->s, n, points, table, npasses, inverse,
                                  dft_re, dft_im);
  if (err == cudaSuccess)
    err = size_launch(p, points, per_block, padded(n), npasses > 1);
  if (err != cudaSuccess) return err;
  p->tw = static_cast<const float2*>(tw);
  p->sw = nullptr;
  return with_instance(points, p->s.family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    return static_cast<int>(
        prepare_passes(fft_c2c_regs_kernel<P, F>, 1, p->threads, p->smem));
  });
}

// (B, n) -> (B, n) by a plan of repro_fft_c2c_plan.
int repro_fft_c2c_run(const void* plan, const void* x, void* y,
                      long long batch, void* stream) {
  const PassLaunchPlan& p = *static_cast<const PassLaunchPlan*>(plan);
  unsigned blocks = 0;
  const cudaError_t err = planned_blocks(p, batch, &blocks);
  if (err != cudaSuccess) return err;
  return with_instance(p.points, p.s.family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    fft_c2c_regs_kernel<P, F><<<blocks, p.threads, p.smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), batch,
        p.per_block, p.s, p.tw);
    return static_cast<int>(cudaGetLastError());
  });
}

// Blocks of `threads` threads and `smem` bytes that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for the instance of
// `points` points and family `family`, or -1 on error.
int repro_fft_c2c_resident_blocks(int points, int family, int threads,
                                  long long smem) {
  int blocks = -1;
  with_instance(points, family, [&](auto pf) {
    blocks = resident_blocks(
        fft_c2c_regs_kernel<decltype(pf)::kP, decltype(pf)::kF>, threads,
        smem);
    return 0;
  });
  return blocks;
}

int repro_fft_c2c_mul(const void* x, void* y, long long batch, int n,
                      int per_block, int templates, const void* bank,
                      const int* radices, int nstages, int inverse,
                      const float* dft_re, const float* dft_im,
                      const float* tw_re, const float* tw_im, void* stream) {
  Schedule s;
  cudaError_t err =
      make_schedule(&s, n, radices, nstages, inverse, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  if (templates < 1 ||
      static_cast<long long>(per_block) * templates * n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long blocks = (batch + per_block - 1) / per_block;
  size_t smem = 0;
  err = prepare(fft_c2c_mul_kernel, blocks, per_block, n, &smem);
  if (err != cudaSuccess) return err;
  fft_c2c_mul_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch,
      per_block, templates, static_cast<const float2*>(bank), s, tw_re,
      tw_im);
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
