// Packed real-input FFT kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fft/fft_kernel.py:
//   repro_fft_r2c_run <- rfft_pallas (def :386; bodies _r2c_body :313,
//                       _r2c_tile :278), planned by repro_fft_r2c_plan
//   repro_fft_r2c_t  <- rfft_t_pallas (def :547; body _r2c_t_body :297):
//                       the same packed R2C of each row of (B, R, C),
//                       written transposed to (B, C/2+1, R) — the first
//                       pass of a pow2 rfft2/rfftn plan graph
//   repro_fft_c2r    <- irfft_pallas (def :606; body _c2r_body :323)
//
// and two kernels that replace no Pallas kernel, for the real lengths
// whose half does not fit one pass (N/2 > 2^13): the reference packs, runs
// its four-step C2C and does the Hermitian split or merge in jnp ops that
// XLA fuses (repro/fft/plan.py, _r2c_fn and _c2r_fn).  In eager PyTorch
// those ops are a dozen passes over the batch, so the port gives each step
// a kernel of its own:
//   repro_fft_r2c_split  (B, N/2) c64 Z -> (B, N/2+1) c64 X, the split
//   repro_fft_c2r_merge  (B, N/2+1) c64 X -> (B, N/2) c64 Z, the merge
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
// ragged batch is masked in the kernel, never padded.  All three run the
// half-length FFT in register-resident Stockham passes (stockham_regs.cuh,
// as repro_fft_c2c_run): 16 points a thread (32 at N = 2^14), passes exchange
// through one padded shared buffer a transform, of split_slots(N/2) slots
// so that it also holds the N/2+1 bins in natural order (68 KB at N =
// 2^14: two blocks share an SM, so one block's loads overlap another's
// passes).  Bin k of the split or merge needs bin N/2 - k, which another
// thread holds, so each kernel goes through that buffer once more than
// fft_c2c:
//
// R2C: the packed reals go straight from device memory into registers;
// the last pass writes Z to the buffer in natural order and, after one
// __syncthreads, consecutive threads split consecutive bins of a row.
//
// C2R: the block's rows' N/2+1 bins are staged in the buffer in natural
// order by asynchronous copies (cp.async; consecutive threads on
// consecutive bins), so that a thread has all its loads in flight at
// once without holding them in registers.  After one __syncthreads the
// threads merge the rows in place, a thread taking the pair k, N/2 - k,
// which no other thread reads (merging inside the first pass's gather
// held more registers than the launch bounds of the 16- and 32-point
// instances allow, and a lower bound cost more than this pass).  After a second __syncthreads
// the first pass gathers Z, the inverse passes run, and the last pass
// stores each Z[k] straight from registers as one float2, which is the
// interleave.  The first pass's store into the buffer waits for every
// thread's reads.
//
// R2C_T (the transposed write): one row a block at C = 8192 would store
// each output bin as a lone 8-byte write R apart, a whole 32-byte sector
// each (4x the 2.15 GB output's traffic).  So a thread-block cluster of G
// blocks (cudaLaunchKernelEx, G a runtime value <= 8) takes G consecutive
// row tiles of one batch entry.  Each block runs its rows as R2C does and
// splits them in place in its buffer (a thread takes the pair k, N/2 - k,
// which no other thread reads); after cluster.sync() block j of the
// cluster stores the j-th share of the bins of all G * per_block rows,
// reading the other blocks' buffers through distributed shared memory:
// consecutive threads take consecutive rows of one bin, so one bin is a
// contiguous run of G * per_block * 8 bytes (64 B at 8 rows).  A second
// cluster.sync() keeps every buffer alive until the others have read it.
// Rows past R are masked; a masked block still reaches both barriers.
// Bin C/2 (Nyquist) is the plane's last row, split from Z[0] like bin 0.
//
// SPLIT and MERGE: no FFT, so bytes alone bound them: 8 * B * (N + 1)
// bytes read and written, at 3.35 TB/s 1.19 ms at B = 476, N = 2^20.  Each
// reads its input once and writes its output once; the split table (4 MB
// at N = 2^20) is read from L2, where it stays across rows because the
// batch is read and written with evict-first hints (__ldcs, __stcs).  Bin k
// needs point N/2 - k, so a block takes a span of 1024 points k of one row
// and their mirrors N/2 - k, loads both spans into shared memory, and each
// thread turns pairs k, N/2 - k, which no other thread reads, into their
// bins in place; then the block stores both spans.  Loads and stores move
// 16 bytes a thread: a span at an address that is not 16-byte aligned (the
// mirror spans, the odd rows of the N/2+1-point side, an input at an odd
// element offset) moves its first and last point singly and the aligned
// body as float4, and shared memory keeps the span's device-memory
// alignment, so that the body's slots are aligned too.  256 threads and
// 16 KB a block: eight blocks fill an SM, and a row of 2^19 points is 256
// blocks, 121856 at B = 476.  The bin N/4 is its own mirror; the block that
// ends at it computes it from device memory.
//
// The split and merge follow the reference kernel's operations in its
// order; the plain torch versions (repro_torch/kernels/fft/fft_kernel.py)
// run the torch engine's complex split and merge, which agree with them to
// rounding.  The split table W[k] = exp(-2*pi*i*k/N), k = 0..N/2, is the
// engine's complex64 table, read as float2.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include <cuda_pipeline.h>

#include <cstdint>

#include "stockham_regs.cuh"

namespace {

// Bin X[k] of the Hermitian split from f = Z[k], g = Z[m-k] and w = W[k],
// in the reference's _r2c_tile order.
__device__ __forceinline__ float2 split_of(float2 f, float2 g, float2 w) {
  const float rr = g.x, ri = -g.y;                    // conj(Z[m-k])
  const float dr = f.x - rr, di = f.y - ri;
  const float qr = 0.5f * di, qi = -0.5f * dr;        // Zo = -i/2 * d
  const float pr = qr * w.x - qi * w.y, pi = qr * w.y + qi * w.x;
  return make_float2(0.5f * (f.x + rr) + pr, 0.5f * (f.y + ri) + pi);
}

// Point Z[k] of the Hermitian merge from v = X[k], u = X[m-k] and w =
// W[k], in the reference's _c2r_body order: Z = Ze + i * Zo, Zo with the
// conjugated split table.
__device__ __forceinline__ float2 merge_of(float2 v, float2 u, float2 w) {
  const float rr = u.x, ri = -u.y;                    // conj(X[m-k])
  const float er = 0.5f * (v.x + rr), ei = 0.5f * (v.y + ri);  // Ze
  const float dr = v.x - rr, di = v.y - ri;
  const float wr = w.x, wi = -w.y;                    // conj(W)
  const float hr = 0.5f * dr, hi = 0.5f * di;
  const float qr = hr * wr - hi * wi, qi = hr * wi + hi * wr;  // Zo
  return make_float2(er - qi, ei + qr);               // Z = Ze + i * Zo
}

// Bin k (0 <= k <= m) of the split of one row's spectrum z (m points);
// bin m reads Z[0], as the reference's wrap.
__device__ __forceinline__ float2 split_bin(const float2* z, int k, int m,
                                            const float2* __restrict__ sw) {
  return split_of(z[k & (m - 1)], z[(m - k) & (m - 1)], __ldg(sw + k));
}

// (B, N) f32 -> (B, N/2+1) c64.  s is the forward plan of m = N/2 in
// register passes; block i transforms rows [i*per_block, ...), each on
// m / P threads.  F is the schedule's largest radix.
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
  const int stride = split_slots(m);
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

// (B, N/2+1) c64 -> (B, N) f32.  s is the inverse plan of m = N/2 (scale
// 1/m); block i transforms rows [i*per_block, ...), each on m / P threads.
template <int P, int F>
__global__ void __launch_bounds__(kPassThreads, pass_min_blocks(P, F))
    fft_c2r_regs_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                        long long batch, int per_block,
                        const __grid_constant__ RegPlan s,
                        const float2* __restrict__ tw,
                        const float2* __restrict__ sw) {
  extern __shared__ float2 smem[];
  const int m = s.n;
  const int m1 = m + 1;
  const int stride = split_slots(m);
  const int tr = threadIdx.x >> s.log_t;
  const int lane = threadIdx.x & ((1 << s.log_t) - 1);
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block),
                                         batch - first));
  // Bin k of row t is input e = t * m1 + k, staged at t * stride + k by
  // asynchronous copies (cp.async): a thread keeps all its loads in
  // flight without holding them in registers.  The threads step through
  // e, carrying (t, k).
  const float2* src = x + first * m1;
  const int dt = blockDim.x / m1, dk = blockDim.x - dt * m1;
  int t = threadIdx.x / m1;
  int k = threadIdx.x - t * m1;
  while (t < count) {
    __pipeline_memcpy_async(smem + t * stride + k, src + t * m1 + k,
                            sizeof(float2));
    t += dt;
    k += dk;
    if (k >= m1) {
      k -= m1;
      ++t;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // Merge the rows in place: pair k of row t (k = 0..m/2) turns X[k],
  // X[m-k] into Z[k], Z[m-k] (pair 0: Z[0] from X[0] and X[m]).
  const int pairs = m / 2 + 1;
  t = threadIdx.x / pairs;
  k = threadIdx.x - t * pairs;
  while (t < count) {
    float2* z = smem + t * stride;
    const float2 f = z[k], h = z[m - k];
    const float2 lo = merge_of(f, h, __ldg(sw + k));
    const float2 hi = merge_of(h, f, __ldg(sw + m - k));
    z[k] = lo;
    if (k > 0) z[m - k] = hi;
    k += blockDim.x;
    while (k >= pairs) {
      k -= pairs;
      ++t;
    }
  }
  __syncthreads();
  float2* buf = smem + tr * stride;
  float2 v[P];
  if (tr < count) {
    with_shape<P, F>(s.pass[0].code, [&](auto sh) {
      gather<P, decltype(sh)>(v, s.pass[0], lane, s.log_t,
                              [&](int at) { return buf[at]; });
    });
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = make_float2(0.f, 0.f);
  }
  reg_passes_but_last<P, F>(v, buf, s, tw, lane, /*staged=*/true);
  run_pass<P, F>(v, s, s.npasses - 1, tw, lane);
  if (tr < count) store_global<P, F>(v, y + (first + tr) * m, s, lane);
}

// (B, R, C) f32 -> (B, C/2+1, R) c64: the packed R2C of each row, written
// transposed.  s is the forward plan of m = C/2.  The launch is a grid of
// clusters of G blocks: cluster c takes rows [r0c, r0c + G * per_block)
// of batch entry c / tiles (tiles clusters a batch entry), its block of
// rank j the rows [r0c + j * per_block, ...).
template <int P, int F>
__global__ void __launch_bounds__(kPassThreads, pass_min_blocks(P, F))
    fft_r2c_t_regs_kernel(const float2* __restrict__ x,
                          float2* __restrict__ y, int rows, int per_block,
                          int tiles, const __grid_constant__ RegPlan s,
                          const float2* __restrict__ tw,
                          const float2* __restrict__ sw) {
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = s.n;
  const int m1 = m + 1;
  const int pairs = m / 2 + 1;
  const int stride = split_slots(m);
  const int tr = threadIdx.x >> s.log_t;
  const int lane = threadIdx.x & ((1 << s.log_t) - 1);
  const LineTile tile = line_tile(blockIdx.x, g, tiles, per_block);
  const int batch = tile.batch, r0c = tile.first;
  const int r0 = r0c + rank * per_block;
  const int count = max(0, min(per_block, rows - r0));
  float2 v[P];
  if (tr < count) {
    load_global<P, F>(
        v, x + (static_cast<long long>(batch) * rows + r0 + tr) * m, s, lane);
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
  // Split the block's rows in place: pair k of row t (k = 0..m/2) turns
  // Z[k], Z[m-k] into X[k], X[m-k] (pair 0: X[0] and X[m] from Z[0]).
  {
    int t = threadIdx.x / pairs;
    int k = threadIdx.x - t * pairs;
    while (t < count) {
      float2* z = smem + t * stride;
      const float2 f = z[k], h = z[(m - k) & (m - 1)];
      const float2 lo = split_of(f, h, __ldg(sw + k));
      const float2 hi = split_of(h, f, __ldg(sw + m - k));
      z[k] = lo;
      z[m - k] = hi;
      k += blockDim.x;
      while (k >= pairs) {
        k -= pairs;
        ++t;
      }
    }
  }
  // Each bin of the cluster's G * per_block rows is one contiguous run.
  cluster_store(smem, stride, per_block, m1,
                y + static_cast<long long>(batch) * m1 * rows + r0c, rows,
                rows - r0c);
}

// Threads of a split or merge block, and the points k of one row it takes
// (with as many mirrors m - k).
constexpr int kSpanThreads = 256;
constexpr int kSpanPoints = 1024;

// The shared-memory slot of point 0 of a span at p: 1 where p is not
// 16-byte aligned, so that the span's aligned points take aligned slots.
__device__ __forceinline__ int span_lead(const float2* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 3) & 1);
}

// Points src[0, count) into buf[lead + j]: a first point off 16-byte
// alignment and an odd last point singly, the body as float4.
__device__ __forceinline__ void load_span(float2* buf,
                                          const float2* __restrict__ src,
                                          int count) {
  const int lead = span_lead(src);
  const int head = min(lead, count);
  const int pairs = (count - head) >> 1;
  const float4* body = reinterpret_cast<const float4*>(src + head);
  float4* slots = reinterpret_cast<float4*>(buf + lead + head);
  for (int i = threadIdx.x; i < pairs; i += blockDim.x)
    slots[i] = __ldcs(body + i);
  if (threadIdx.x == 0) {
    if (head) buf[lead] = __ldcs(src);
    if ((count - head) & 1) buf[lead + count - 1] = __ldcs(src + count - 1);
  }
}

// buf[lead + j] into dst[0, count), as load_span moves them; the body's
// slots are read as float4 where they are aligned, else as two float2.
__device__ __forceinline__ void store_span(float2* __restrict__ dst,
                                           const float2* buf, int lead,
                                           int count) {
  const int head = min(span_lead(dst), count);
  const int pairs = (count - head) >> 1;
  float4* body = reinterpret_cast<float4*>(dst + head);
  const float2* from = buf + lead + head;
  if (((lead + head) & 1) == 0) {
    const float4* slots = reinterpret_cast<const float4*>(from);
    for (int i = threadIdx.x; i < pairs; i += blockDim.x)
      __stcs(body + i, slots[i]);
  } else {
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const float2 a = from[2 * i], b = from[2 * i + 1];
      __stcs(body + i, make_float4(a.x, a.y, b.x, b.y));
    }
  }
  if (threadIdx.x == 0) {
    if (head) __stcs(dst, buf[lead]);
    if ((count - head) & 1) __stcs(dst + count - 1, buf[lead + count - 1]);
  }
}

// The split (kSplit: (B, m) Z -> (B, m+1) X) or the merge ((B, m+1) X ->
// (B, m) Z) of one block's span: row blockIdx.x / tiles, points k in [k0,
// k0 + count) of [0, m/2) and their mirrors m - k, the span [lo, m - k0].
// On the m-point side the first span's mirror stops at m - 1: the split
// reads Z[m] as Z[0], and the merge has no Z[m] to write.
template <bool kSplit>
__device__ __forceinline__ void hermitian_span(
    const float2* __restrict__ x, float2* __restrict__ y, int m, int tiles,
    const float2* __restrict__ sw) {
  __shared__ __align__(16) float2 front[kSpanPoints + 2];
  __shared__ __align__(16) float2 back[kSpanPoints + 2];
  const int half = m >> 1;
  const long long row = blockIdx.x / tiles;
  const int k0 = static_cast<int>(blockIdx.x - row * tiles) * kSpanPoints;
  const int count = min(kSpanPoints, half - k0);
  const int lo = m - k0 - count + 1;
  const int wrap = k0 == 0;
  const float2* src = x + row * (kSplit ? m : m + 1);
  float2* dst = y + row * (kSplit ? m + 1 : m);
  const int lf = span_lead(src + k0), lb = span_lead(src + lo);
  load_span(front, src + k0, count);
  load_span(back, src + lo, kSplit ? count - wrap : count);
  __syncthreads();
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int k = k0 + j;
    float2* f = front + lf + j;
    float2* g = back + lb + count - 1 - j;  // point m - k
    const float2 a = *f;
    const float2 b = kSplit && k == 0 ? a : *g;
    const float2 w = __ldg(sw + k), wm = __ldg(sw + m - k);
    *f = kSplit ? split_of(a, b, w) : merge_of(a, b, w);
    *g = kSplit ? split_of(b, a, wm) : merge_of(b, a, wm);
  }
  if (k0 + count == half && threadIdx.x == 0) {  // point m/2: its own mirror
    const float2 v = __ldcs(src + half), w = __ldg(sw + half);
    __stcs(dst + half, kSplit ? split_of(v, v, w) : merge_of(v, v, w));
  }
  __syncthreads();
  store_span(dst + k0, front, lf, count);
  store_span(dst + lo, back, lb, kSplit ? count : count - wrap);
}

// (B, m) c64 -> (B, m+1) c64: X[k] = split_of(Z[k], Z[m-k mod m], W[k]).
__global__ void __launch_bounds__(kSpanThreads, 8)
    fft_r2c_split_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                         int m, int tiles, const float2* __restrict__ sw) {
  hermitian_span<true>(x, y, m, tiles, sw);
}

// (B, m+1) c64 -> (B, m) c64: Z[k] = merge_of(X[k], X[m-k], W[k]).
__global__ void __launch_bounds__(kSpanThreads, 8)
    fft_c2r_merge_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                         int m, int tiles, const float2* __restrict__ sw) {
  hermitian_span<false>(x, y, m, tiles, sw);
}

// Launches a split or merge kernel over `batch` rows of the real length
// n (a multiple of 4): one block a span of kSpanPoints points a row.
template <typename Kernel>
int launch_spans(Kernel kernel, const void* x, void* y, long long batch,
                 int n, const void* sw, void* stream) {
  if (n < 4 || n % 4 != 0 || batch < 1) return cudaErrorInvalidValue;
  const int m = n / 2;
  const long long tiles = (m / 2 + kSpanPoints - 1) / kSpanPoints;
  const long long blocks = batch * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kSpanThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), m,
      static_cast<int>(tiles), static_cast<const float2*>(sw));
  return static_cast<int>(cudaGetLastError());
}

// The register plan of a packed real transform of length n (pow2 >= 4):
// the plan of its half length.
cudaError_t half_plan(RegPlan* s, int n, int points, const int* table,
                      int npasses, int inverse, const float* dft_re,
                      const float* dft_im) {
  if (n < 4 || (n & (n - 1)) != 0) return cudaErrorInvalidValue;
  return make_reg_plan(s, n / 2, points, table, npasses, inverse, dft_re,
                       dft_im);
}

size_t split_shared(int per_block, int m) {
  return static_cast<size_t>(per_block) * split_slots(m) * sizeof(float2);
}

// Calls f(kernel) with the instance (P, F) of kernel `which` (0 fft_r2c,
// 1 fft_c2r, 2 fft_r2c_t).
template <typename Fn>
int with_real_kernel(int which, int points, int family, Fn&& f) {
  return with_instance(points, family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    if (which == 0) return f(fft_r2c_regs_kernel<P, F>);
    if (which == 1) return f(fft_c2r_regs_kernel<P, F>);
    if (which == 2) return f(fft_r2c_t_regs_kernel<P, F>);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

}  // namespace

extern "C" {

// Plans fft_r2c's launch of length-n real transforms, per_block a block,
// into `plan` (repro_pass_plan_bytes() bytes, kept by the caller with the
// tables it points into): checks the plan table of n / 2, sizes the
// launch and raises the instance's shared-memory limit, once per shape.
int repro_fft_r2c_plan(void* plan, int n, int points, int per_block,
                       const int* table, int npasses, const float* dft_re,
                       const float* dft_im, const void* tw, const void* sw) {
  PassLaunchPlan* p = static_cast<PassLaunchPlan*>(plan);
  cudaError_t err =
      half_plan(&p->s, n, points, table, npasses, 0, dft_re, dft_im);
  if (err == cudaSuccess)
    err = size_launch(p, points, per_block, split_slots(p->s.n), true);
  if (err != cudaSuccess) return err;
  p->tw = static_cast<const float2*>(tw);
  p->sw = static_cast<const float2*>(sw);
  return with_instance(points, p->s.family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    return static_cast<int>(
        prepare_passes(fft_r2c_regs_kernel<P, F>, 1, p->threads, p->smem));
  });
}

// (B, N) f32 -> (B, N/2+1) c64 by a plan of repro_fft_r2c_plan.
int repro_fft_r2c_run(const void* plan, const void* x, void* y,
                      long long batch, void* stream) {
  const PassLaunchPlan& p = *static_cast<const PassLaunchPlan*>(plan);
  unsigned blocks = 0;
  const cudaError_t err = planned_blocks(p, batch, &blocks);
  if (err != cudaSuccess) return err;
  return with_instance(p.points, p.s.family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    fft_r2c_regs_kernel<P, F><<<blocks, p.threads, p.smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), batch,
        p.per_block, p.s, p.tw, p.sw);
    return static_cast<int>(cudaGetLastError());
  });
}

int repro_fft_c2r(const void* x, void* y, long long batch, int n,
                  int points, int per_block, const int* table, int npasses,
                  const float* dft_re, const float* dft_im, const void* tw,
                  const void* sw, void* stream) {
  RegPlan s;
  cudaError_t err =
      half_plan(&s, n, points, table, npasses, 1, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  if (per_block < 1) return cudaErrorInvalidValue;
  const long long blocks = (batch + per_block - 1) / per_block;
  const int threads = per_block << s.log_t;
  const size_t smem = split_shared(per_block, s.n);
  return with_instance(points, s.family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    cudaError_t e =
        prepare_passes(fft_c2r_regs_kernel<P, F>, blocks, threads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fft_c2r_regs_kernel<P, F><<<static_cast<unsigned>(blocks), threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), batch,
        per_block, s, static_cast<const float2*>(tw),
        static_cast<const float2*>(sw));
    return static_cast<int>(cudaGetLastError());
  });
}

// (B, R, C) f32 -> (B, C/2+1, R) c64 in clusters of `cluster` blocks of
// per_block rows each.
int repro_fft_r2c_t(const void* x, void* y, long long batch, int rows,
                    int cols, int cluster, int points, int per_block,
                    const int* table, int npasses, const float* dft_re,
                    const float* dft_im, const void* tw, const void* sw,
                    void* stream) {
  RegPlan s;
  cudaError_t err =
      half_plan(&s, cols, points, table, npasses, 0, dft_re, dft_im);
  if (err != cudaSuccess) return err;
  if (batch < 1 || rows < 1 || per_block < 1 || cluster < 1 ||
      cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  const int rows_c = per_block * cluster;
  const long long tiles = (rows + rows_c - 1) / rows_c;
  const long long blocks = batch * tiles * cluster;
  const int threads = per_block << s.log_t;
  const size_t smem = split_shared(per_block, s.n);
  return with_instance(points, s.family, [&](auto pf) {
    constexpr int P = decltype(pf)::kP, F = decltype(pf)::kF;
    return launch_clusters(fft_r2c_t_regs_kernel<P, F>, blocks, threads,
                           smem, cluster, stream,
                           static_cast<const float2*>(x),
                           static_cast<float2*>(y), rows, per_block,
                           static_cast<int>(tiles), s,
                           static_cast<const float2*>(tw),
                           static_cast<const float2*>(sw));
  });
}

// (B, N/2) c64 -> (B, N/2+1) c64: the Hermitian split of the packed
// spectra of B rows of N reals, sw the split table of N (N/2+1 points).
int repro_fft_r2c_split(const void* x, void* y, long long batch, int n,
                        const void* sw, void* stream) {
  return launch_spans(fft_r2c_split_kernel, x, y, batch, n, sw, stream);
}

// (B, N/2+1) c64 -> (B, N/2) c64: the Hermitian merge, the packed input of
// the inverse half-length C2C, sw the split table of N.
int repro_fft_c2r_merge(const void* x, void* y, long long batch, int n,
                        const void* sw, void* stream) {
  return launch_spans(fft_c2r_merge_kernel, x, y, batch, n, sw, stream);
}

// Blocks of `threads` threads and `smem` bytes that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for the instance of
// `points` points and family `family` of kernel `which` (0 fft_r2c, 1
// fft_c2r, 2 fft_r2c_t), or -1 on error.
int repro_fft_real_resident_blocks(int which, int points, int family,
                                   int threads, long long smem) {
  int blocks = -1;
  with_real_kernel(which, points, family, [&](auto kernel) {
    blocks = resident_blocks(kernel, threads, smem);
    return 0;
  });
  return blocks;
}

// Clusters of `cluster` fft_r2c_t blocks that the card can run at once
// (cudaOccupancyMaxActiveClusters), or -1 on error.
int repro_fft_r2c_t_active_clusters(int points, int family, int threads,
                                    long long smem, int cluster) {
  int clusters = -1;
  with_real_kernel(2, points, family, [&](auto kernel) {
    clusters = active_clusters(kernel, threads, smem, cluster);
    return 0;
  });
  return clusters;
}

}  // extern "C"
