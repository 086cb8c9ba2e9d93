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
// repro_fft_c2c_t and repro_fft_c2c_axis1 run the same register passes,
// the passes of the four-step transform and of every pow2 N-D axis.
// Their strided side is the cost: one row a block at C = 4096 stores each
// output point as a lone 8-byte write R apart, a partial 32-byte sector
// each.  So a thread-block cluster of G blocks (cudaLaunchKernelEx, G <=
// 8 from the host's fft_kernel.c2c_cluster) holds G * per_block
// consecutive rows (t) or columns (axis1) of one batch entry, and the
// strided side moves each of their rows as one contiguous run through
// the blocks' buffers and distributed shared memory (stockham_regs.cuh,
// cluster_store, cluster_load):
//
// t: the rows are contiguous, so the first pass loads straight into
// registers as repro_fft_c2c_run's does; after the last pass each thread
// scales its results and multiplies the optional (R, C) twiddle (read
// along k, coalesced), writes them to its transform's buffer in natural
// order, and the cluster stores the transposed output.
//
// axis1: both sides are strided.  The cluster's blocks load the tile's
// rows (G * per_block columns each) as runs, four loads in flight a
// thread, and store each point in its column's owner's buffer through
// distributed shared memory (cp.async cannot write another block's
// shared memory); after cluster.sync() each block gathers its first pass
// from its own buffer, runs the passes, multiplies the (C, R) twiddle
// (contiguous along k for each column) and stores through the cluster as
// t does, with runs along C.
//
// A ragged last row or column tile is masked, never padded; a masked
// block still reaches every cluster barrier.
//
// repro_fft_c2c_mul keeps the shared-memory stages of stockham(): each
// thread block loads whole transforms into shared memory once, runs every
// Stockham stage of the radix schedule there (ping-pong between two
// shared buffers, one __syncthreads per stage), multiplies the bank in
// the epilogue and writes each point once.  Length 8192 needs 128 KB of
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

// (B, R, C) -> (B, C, R): the FFT of each row (n = C) in register
// passes, times the optional (R, C) twiddle, written transposed.  The
// launch is a grid of clusters of G blocks: cluster c takes rows [r0c,
// r0c + G * per_block) of batch entry c / tiles (tiles clusters a batch
// entry), its block of rank j the rows [r0c + j * per_block, ...), each
// in a buffer of `stride` slots (line_slots).  Rows past R are masked; a
// masked block still reaches every barrier.
template <int P, int F>
__global__ void __launch_bounds__(kPassThreads, pass_min_blocks(P, F))
    fft_c2c_t_regs_kernel(const float2* __restrict__ x,
                          float2* __restrict__ y, int rows, int per_block,
                          int tiles, int stride,
                          const __grid_constant__ RegPlan s,
                          const float2* __restrict__ tw,
                          const float2* __restrict__ ftw) {
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int n = s.n;
  const int tr = threadIdx.x >> s.log_t;
  const int lane = threadIdx.x & ((1 << s.log_t) - 1);
  const LineTile tile = line_tile(blockIdx.x, g, tiles, per_block);
  const int batch = tile.batch, r0c = tile.first;
  const int r = r0c + static_cast<int>(cluster.block_rank()) * per_block + tr;
  const bool live = r < rows;
  float2 v[P];
  if (live) {
    load_global<P, F>(v, x + (static_cast<long long>(batch) * rows + r) * n,
                      s, lane);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = make_float2(0.f, 0.f);
  }
  float2* buf = smem + tr * stride;
  reg_passes_but_last<P, F>(v, buf, s, tw, lane);
  run_pass<P, F>(v, s, s.npasses - 1, tw, lane);
  if (s.npasses > 1) __syncthreads();  // every read of the buffer is done
  store_finished<P, F>(
      v, buf, s,
      live && ftw ? ftw + static_cast<long long>(r) * n : nullptr, lane);
  // Each output point of the cluster's rows is one contiguous run.
  cluster_store(smem, stride, per_block, n,
                y + static_cast<long long>(batch) * n * rows + r0c, rows,
                rows - r0c);
}

// (B, R, C) -> (B, R, C): the FFT of each column (n = R) in register
// passes, layout kept; optional (C, R) twiddle: out[.., k, j] *= ftw[j,
// k].  Clusters of G blocks as fft_c2c_t's, over columns: cluster c takes
// columns [c0c, c0c + G * per_block) of batch entry c / tiles.  Both
// sides go through the cluster: each input row and each output row of
// the cluster's columns is one contiguous run.  Columns past C are
// masked.
template <int P, int F>
__global__ void __launch_bounds__(kPassThreads, pass_min_blocks(P, F))
    fft_c2c_axis1_regs_kernel(const float2* __restrict__ x,
                              float2* __restrict__ y, int cols,
                              int per_block, int tiles, int stride,
                              const __grid_constant__ RegPlan s,
                              const float2* __restrict__ tw,
                              const float2* __restrict__ ftw) {
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int n = s.n;
  const int tr = threadIdx.x >> s.log_t;
  const int lane = threadIdx.x & ((1 << s.log_t) - 1);
  const LineTile tile = line_tile(blockIdx.x, g, tiles, per_block);
  cluster_load<P>(smem, stride, per_block, n,
                  x + static_cast<long long>(tile.batch) * n * cols +
                      tile.first,
                  cols, cols - tile.first);
  float2* buf = smem + tr * stride;
  float2 v[P];
  load_shared<P, F>(v, buf, s, 0, lane);
  reg_passes_but_last<P, F>(v, buf, s, tw, lane, /*staged=*/true);
  run_pass<P, F>(v, s, s.npasses - 1, tw, lane);
  __syncthreads();  // every read of the buffer is done
  // The tile again from a fresh read of the block index: nothing derived
  // from it stays live across the passes (the 16-point radix-4 instance
  // has no register to spare for it).
  const LineTile end = line_tile(block_index(), g, tiles, per_block);
  const int c =
      end.first + static_cast<int>(cluster.block_rank()) * per_block + tr;
  store_finished<P, F>(
      v, buf, s,
      c < cols && ftw ? ftw + static_cast<long long>(c) * n : nullptr, lane);
  cluster_store(smem, stride, per_block, n,
                y + static_cast<long long>(end.batch) * n * cols + end.first,
                cols, cols - end.first);
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

// (B, R, C) -> (B, C, R) (fft_c2c_t, n = C) or (B, R, C) (fft_c2c_axis1,
// n = R) in clusters of `cluster` blocks of per_block transforms each;
// ftw: the optional four-step twiddle, or null.
template <typename Kernel>
int launch_strided(Kernel kernel, const void* x, void* y, long long batch,
                   int n, int count, int cluster, int per_block,
                   const RegPlan& s, const void* tw, const void* ftw,
                   void* stream) {
  if (batch < 1 || count < 1 || per_block < 1 || cluster < 1 ||
      cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  const int lines = per_block * cluster;
  const long long tiles = (count + lines - 1) / lines;
  const int stride = line_slots(n, per_block);
  return launch_clusters(
      kernel, batch * tiles * cluster, per_block << s.log_t,
      static_cast<size_t>(per_block) * stride * sizeof(float2), cluster,
      stream, static_cast<const float2*>(x), static_cast<float2*>(y), count,
      per_block, static_cast<int>(tiles), stride, s,
      static_cast<const float2*>(tw), static_cast<const float2*>(ftw));
}

// Calls f(kernel) with the instance (P, F) of kernel `which` (0
// fft_c2c_t, 1 fft_c2c_axis1).
template <typename Fn>
int with_strided_kernel(int which, int points, int family, Fn&& f) {
  return with_instance(points, family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    if (which == 0) return f(fft_c2c_t_regs_kernel<P, F>);
    if (which == 1) return f(fft_c2c_axis1_regs_kernel<P, F>);
    return static_cast<int>(cudaErrorInvalidValue);
  });
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
                    int cols, int cluster, int points, int per_block,
                    const int* table, int npasses, int inverse,
                    const float* dft_re, const float* dft_im, const void* tw,
                    const void* ftw, void* stream) {
  RegPlan s;
  const cudaError_t err = make_reg_plan(&s, cols, points, table, npasses,
                                        inverse, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  return with_strided_kernel(0, points, s.family, [&](auto kernel) {
    return launch_strided(kernel, x, y, batch, cols, rows, cluster,
                          per_block, s, tw, ftw, stream);
  });
}

int repro_fft_c2c_axis1(const void* x, void* y, long long batch, int rows,
                        int cols, int cluster, int points, int per_block,
                        const int* table, int npasses, int inverse,
                        const float* dft_re, const float* dft_im,
                        const void* tw, const void* ftw, void* stream) {
  RegPlan s;
  const cudaError_t err = make_reg_plan(&s, rows, points, table, npasses,
                                        inverse, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  return with_strided_kernel(1, points, s.family, [&](auto kernel) {
    return launch_strided(kernel, x, y, batch, rows, cols, cluster,
                          per_block, s, tw, ftw, stream);
  });
}

// Clusters of `cluster` blocks of kernel `which` (0 fft_c2c_t, 1
// fft_c2c_axis1) that the card can run at once
// (cudaOccupancyMaxActiveClusters), or -1 on error.
int repro_fft_c2c_active_clusters(int which, int points, int family,
                                  int threads, long long smem, int cluster) {
  int clusters = -1;
  with_strided_kernel(which, points, family, [&](auto kernel) {
    clusters = active_clusters(kernel, threads, smem, cluster);
    return 0;
  });
  return clusters;
}

}  // extern "C"
