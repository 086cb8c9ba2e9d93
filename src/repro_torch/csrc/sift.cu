// Exact selection of a statistic plane's strongest cells for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference pools a volume's strongest cells
// with one lax.top_k (src/repro/search/sift.py), which the port first
// carried over as one torch.topk over every cell of a sub-block (1.43e9
// cells, 5.7 GB, in a survey's search), followed by a second pass that
// counted the cells over the sift's threshold.
//
//   repro_sift_select  (R, M) float32 statistic, (R, M) int32 level ->
//                      every cell of the row's strongest `pool` at or above
//                      the row's floor, as (value, index in the row,
//                      level) in a buffer of `capacity` entries a row; the
//                      cells at or above the threshold, counted per row
//
// What bounds it: memory.  A read of the plane is 4 bytes a cell over
// 3.35 TB/s; the buffer is a few MB.
//
// What the design does about it: the cells are ordered by a 32-bit key
// that preserves the floats' order (key_of), and the plane is read once or
// twice.  The first read (sift_first_kernel) counts the cells over the
// threshold and builds, in shared memory a block and then in a global
// histogram a row, the histogram of the key's top 12 bits over the cells
// at or above the floor (the running pool's weakest value, or none).
// Where a floor is given, the same read also appends those cells to the
// buffer: below the floor few cells remain, and where they fit, that one
// read is all (mode kDone).  A one-block scan a row (sift_scan_kernel)
// finds the bin that holds the pool-th strongest cell; every cell from
// that bin's lower edge up is then kept by a second read
// (sift_compact_kernel), warp-aggregated appends to a per-row counter.
// Where those cells would overflow the buffer, the scan asks for a
// refinement: a further read histograms the next 10 bits of the keys in
// that bin (sift_refine_kernel), twice at most (12 + 10 + 10 = 32 bits).
// At full resolution the bin is one key: the cells above it are kept, and
// as many of its ties as the pool still needs fill the remaining slots,
// in the order the appends reach the counter.  So the buffer always holds
// every cell of the row's strongest `pool` at or above the floor (one of
// each tie at the boundary), for any plane.  Every kernel is launched
// every time; one that a row's state does not ask for returns at once, so
// the host never waits for a decision.
//
// NaN is ordered above every other value, as torch.topk orders it; -0.0
// below +0.0 (equal as floats: a tie).
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launches (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

extern "C" const char* repro_sift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// float4 loads a thread has in flight before it looks at them.
constexpr int kUnroll = 4;
// The first histogram: the key's top 12 bits; each refinement 10 more.
constexpr int kBits0 = 12;
constexpr int kBins0 = 1 << kBits0;
constexpr int kBitsR = 10;
constexpr int kBinsR = 1 << kBitsR;
constexpr int kRefines = 2;  // 12 + 2 x 10 = 32 bits

// A row's workspace, in int64 words: its state, then the first histogram
// and the two refinements' (sift_kernel.py's STATE_WORDS, WORKSPACE_WORDS).
constexpr int kStateWords = 16;
constexpr int kWords = kStateWords + kBins0 + kRefines * kBinsR;

enum Mode : long long { kDone = 0, kCompact = 1, kRefine = 2 };

// A row's state; every field starts at 0.
struct Row {
  long long over;        // cells >= the threshold
  long long fill;        // appends of the first read (cells >= the floor)
  long long taken;       // the second read's appends of cells >= cut
  long long tied;        // ... and of ties at tie_key
  long long mode;        // Mode: what the next kernels do
  long long prefix;      // key bits fixed so far (right-aligned)
  long long bits;        // how many
  long long need;        // cells still wanted from the prefix's bucket
  long long above;       // cells above the bucket (every one kept)
  long long cut;         // the second read keeps every key >= cut
  long long tie_key;     // ... and tie_budget cells of this key
  long long tie_budget;
  long long compacted;   // valid entries at the front of the buffer
  long long refines;     // refinement reads that ran
  long long reads;       // reads of the plane
  long long unused;
};
static_assert(sizeof(Row) == kStateWords * sizeof(long long), "Row size");

// The float's place in the order of all floats (NaN at the top).
__device__ __forceinline__ unsigned key_of(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned floor_key(const float* floors,
                                              long long row) {
  return floors != nullptr ? key_of(floors[row]) : 0u;
}

__device__ __forceinline__ Row* row_state(long long* ws, long long row) {
  return reinterpret_cast<Row*>(ws + row * kWords);
}

__device__ __forceinline__ unsigned long long* row_hist(long long* ws,
                                                        long long row,
                                                        int level) {
  long long* h = ws + row * kWords + kStateWords;
  if (level > 0) h += kBins0 + (level - 1) * kBinsR;
  return reinterpret_cast<unsigned long long*>(h);
}

// Calls f(value, index in the row, ok) on the block's share of row x's m
// cells: 16-byte loads between a head and a tail of at most 3 cells each,
// which warp 0 of block 0 takes in one more call (lanes 0-3 the head, 4-7
// the tail).  Every call is made by whole warps, ok false past the end,
// so that f may vote across the warp.
template <class F>
__device__ __forceinline__ void for_each_cell(const float* __restrict__ x,
                                              long long m, F&& f) {
  const int tid = threadIdx.x;
  const long long lead = static_cast<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / sizeof(float));
  const long long head = lead < m ? lead : m;
  const long long nvec = (m - head) / 4;
  const long long tail = head + 4 * nvec;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const long long per = (nvec + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * per;
  const long long hi = lo + per < nvec ? lo + per : nvec;
  for (long long j = lo; j < hi; j += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = j + tid + u * kThreads;
      v[u] = k < hi ? __ldcs(x4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = j + tid + u * kThreads;
      const bool ok = k < hi;
      const long long i = head + 4 * k;
      f(v[u].x, i, ok);
      f(v[u].y, i + 1, ok);
      f(v[u].z, i + 2, ok);
      f(v[u].w, i + 3, ok);
    }
  }
  if (blockIdx.x == 0 && tid < 32) {
    const long long i = tid < 4 ? tid : tail + (tid - 4);
    const bool ok = tid < 4 ? tid < head : (tid < 8 && i < m);
    f(ok ? x[i] : 0.f, i, ok);
  }
}

// Appends the warp's cells that `take` into slots counter, counter + 1,
// ... (one atomic a warp), writing those below `limit` at offset + slot.
// Called by whole warps.
__device__ __forceinline__ void append(bool take, float v, long long i,
                                       const int* __restrict__ level,
                                       long long* counter, long long offset,
                                       long long limit, float* vals,
                                       long long* idx, int* lev) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  unsigned long long base = 0;
  if (lane == 0)
    base = atomicAdd(reinterpret_cast<unsigned long long*>(counter),
                     static_cast<unsigned long long>(__popc(mask)));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (!take) return;
  const long long slot = static_cast<long long>(
      base + __popc(mask & ((1u << lane) - 1u)));
  if (slot < limit) {
    vals[offset + slot] = v;
    idx[offset + slot] = i;
    lev[offset + slot] = __ldg(level + i);
  }
}

// Adds each nonzero shared bin to the row's global histogram.
__device__ __forceinline__ void flush(const unsigned* bins, int n,
                                      unsigned long long* hist) {
  for (int j = threadIdx.x; j < n; j += kThreads)
    if (bins[j] != 0u)
      atomicAdd(hist + j, static_cast<unsigned long long>(bins[j]));
}

// The first read: the count over the threshold, the histogram of the top
// 12 key bits of the cells >= the floor, and, where a floor is given,
// those cells appended to the buffer.  Block (c, r): chunk c of row r.
__global__ void __launch_bounds__(kThreads)
    sift_first_kernel(const float* __restrict__ stat,
                      const int* __restrict__ level, long long m,
                      const float* __restrict__ floors, float threshold,
                      int count, long long capacity, long long* ws,
                      float* vals, long long* idx, int* lev) {
  __shared__ unsigned bins[kBins0];
  __shared__ unsigned long long warp_over[kWarps];
  for (int j = threadIdx.x; j < kBins0; j += kThreads) bins[j] = 0u;
  __syncthreads();
  const long long row = blockIdx.y;
  Row* st = row_state(ws, row);
  const unsigned lo = floor_key(floors, row);
  const bool compact = floors != nullptr;
  const long long out = row * capacity;
  unsigned over = 0;
  for_each_cell(stat + row * m, m, [&](float v, long long i, bool ok) {
    over += (count && ok && v >= threshold) ? 1u : 0u;
    const unsigned k = key_of(v);
    const bool cand = ok && k >= lo;
    if (cand) atomicAdd(&bins[k >> (32 - kBits0)], 1u);
    if (compact)
      append(cand, v, i, level + row * m, &st->fill, out, capacity, vals,
             idx, lev);
  });
  __syncthreads();
  flush(bins, kBins0, row_hist(ws, row, 0));
  if (!count) return;
  unsigned long long s = over;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_over[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) s += warp_over[w];
    atomicAdd(reinterpret_cast<unsigned long long*>(&st->over), s);
  }
}

// A refinement read: the histogram of the next 10 key bits of the cells
// >= the floor in the bucket the scan before it chose.  Runs only where
// that scan asked for it.
__global__ void __launch_bounds__(kThreads)
    sift_refine_kernel(const float* __restrict__ stat, long long m,
                       const float* __restrict__ floors, int level,
                       long long* ws) {
  const long long row = blockIdx.y;
  const Row* st = row_state(ws, row);
  const int resolved = kBits0 + kBitsR * (level - 1);
  if (st->mode != kRefine || st->bits != resolved) return;
  __shared__ unsigned bins[kBinsR];
  for (int j = threadIdx.x; j < kBinsR; j += kThreads) bins[j] = 0u;
  __syncthreads();
  const unsigned lo = floor_key(floors, row);
  const unsigned prefix = static_cast<unsigned>(st->prefix);
  const int shift = 32 - resolved - kBitsR;
  for_each_cell(stat + row * m, m, [&](float v, long long, bool ok) {
    const unsigned k = key_of(v);
    if (ok && k >= lo && (k >> (32 - resolved)) == prefix)
      atomicAdd(&bins[(k >> shift) & (kBinsR - 1)], 1u);
  });
  __syncthreads();
  flush(bins, kBinsR, row_hist(ws, row, level));
}

// Exclusive prefix sum of s over the block's threads in thread order, and
// the block's total.
__device__ __forceinline__ void block_scan(unsigned long long s,
                                           unsigned long long& before,
                                           unsigned long long& total) {
  __shared__ unsigned long long warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  unsigned long long inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  unsigned long long warps_before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) warps_before += warp_sum[w];
    all += warp_sum[w];
  }
  before = warps_before + inc - s;
  total = all;
}

// One block a row: reads the histogram of `level` (0 the first read's, 1
// and 2 the refinements') from the strongest bin down and decides what the
// later kernels do.  At level 0 it always runs; at a refinement's level
// only where that refinement ran.
__global__ void __launch_bounds__(kThreads)
    sift_scan_kernel(const float* __restrict__ floors, int level,
                     long long pool, long long capacity, long long* ws) {
  const long long row = blockIdx.x;
  Row* st = row_state(ws, row);
  const int width = level == 0 ? kBits0 : kBitsR;
  const int bins = 1 << width;
  const int resolved = level == 0 ? 0 : kBits0 + kBitsR * (level - 1);
  // Every thread reads the state before the barriers of the scan; one
  // thread writes it after them.
  if (level > 0 && (st->mode != kRefine || st->bits != resolved)) return;
  const long long prefix = level > 0 ? st->prefix : 0;
  const long long need = level > 0 ? st->need : pool;
  const long long above = level > 0 ? st->above : 0;
  const unsigned lo = floor_key(floors, row);
  const unsigned long long* hist = row_hist(ws, row, level);
  // Thread t holds bins bins - 1 - (per t + k), k < per: the strongest
  // first.
  const int per = bins / kThreads;
  unsigned long long c[kBins0 / kThreads];
  unsigned long long s = 0;
  for (int k = 0; k < per; ++k) {
    c[k] = hist[bins - 1 - (per * threadIdx.x + k)];
    s += c[k];
  }
  unsigned long long before, total;
  block_scan(s, before, total);
  const long long reads = 1 + level;
  if (level == 0 && static_cast<long long>(total) <= capacity) {
    // Every cell >= the floor fits: the first read appended them where a
    // floor was given; else the second read takes them all.
    if (threadIdx.x == 0) {
      st->mode = floors != nullptr ? kDone : kCompact;
      st->cut = lo;
      st->tie_budget = 0;
      st->compacted = static_cast<long long>(total);
      st->reads = floors != nullptr ? 1 : 2;
    }
    return;
  }
  unsigned long long r = before;
  for (int k = 0; k < per; ++k) {
    if (static_cast<long long>(r) < need &&
        static_cast<long long>(r + c[k]) >= need) {
      const long long bin = bins - 1 - (per * threadIdx.x + k);
      const long long a = above + static_cast<long long>(r);
      const long long kept = a + static_cast<long long>(c[k]);
      const long long key = (prefix << width) | bin;
      const int rest = 32 - resolved - width;
      st->refines = level;
      if (kept <= capacity) {
        // Every cell from the bin's lower edge (and the floor) up.
        const long long edge = key << rest;
        st->mode = kCompact;
        st->cut = edge > static_cast<long long>(lo) ? edge : lo;
        st->tie_budget = 0;
        st->compacted = kept;
        st->reads = reads + 1;
      } else if (rest > 0) {
        st->mode = kRefine;
        st->prefix = key;
        st->bits = resolved + width;
        st->need = need - static_cast<long long>(r);
        st->above = a;
        st->reads = reads;
      } else {
        // One key: the cells above it, and as many of its ties as needed.
        st->mode = kCompact;
        st->cut = key + 1;
        st->tie_key = key;
        st->tie_budget = need - static_cast<long long>(r);
        st->above = a;
        st->compacted = a + st->tie_budget;
        st->reads = reads + 1;
      }
    }
    r += c[k];
  }
}

// The second read, where the scans asked for it: every cell whose key is
// >= cut into slots 0, 1, ...; where a tie budget is set, that many cells
// of the tie key after them.
__global__ void __launch_bounds__(kThreads)
    sift_compact_kernel(const float* __restrict__ stat,
                        const int* __restrict__ level, long long m,
                        long long capacity, long long* ws, float* vals,
                        long long* idx, int* lev) {
  const long long row = blockIdx.y;
  Row* st = row_state(ws, row);
  if (st->mode != kCompact) return;
  const unsigned long long cut = static_cast<unsigned long long>(st->cut);
  const unsigned tie = static_cast<unsigned>(st->tie_key);
  const long long budget = st->tie_budget, above = st->above;
  const long long out = row * capacity;
  const int* lv = level + row * m;
  for_each_cell(stat + row * m, m, [&](float v, long long i, bool ok) {
    const unsigned k = key_of(v);
    append(ok && k >= cut, v, i, lv, &st->taken, out, capacity, vals, idx,
           lev);
    if (budget > 0)
      append(ok && k == tie, v, i, lv, &st->tied, out + above, budget, vals,
             idx, lev);
  });
}

}  // namespace

extern "C" {

// `ws` holds rows x (16 + 4096 + 2 x 1024) int64 words, all 0; `vals`,
// `idx`, `lev` rows x capacity entries.  `floors` (rows float32) may be
// null; `count` 0 leaves the count over the threshold at 0.
int repro_sift_select(const float* stat, const int* level, const float* floors,
                      long long rows, long long m, float threshold, int count,
                      long long pool, long long capacity, int chunks,
                      long long* ws, float* vals, long long* idx, int* lev,
                      void* stream) {
  if (rows < 1 || rows > 65535 || m < 1 || pool < 1 || capacity < pool ||
      chunks < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(rows));
  const unsigned r = static_cast<unsigned>(rows);
  sift_first_kernel<<<grid, kThreads, 0, s>>>(stat, level, m, floors,
                                              threshold, count, capacity, ws,
                                              vals, idx, lev);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sift_scan_kernel<<<r, kThreads, 0, s>>>(floors, 0, pool, capacity, ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int level = 1; level <= kRefines; ++level) {
    sift_refine_kernel<<<grid, kThreads, 0, s>>>(stat, m, floors, level, ws);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sift_scan_kernel<<<r, kThreads, 0, s>>>(floors, level, pool, capacity,
                                            ws);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  sift_compact_kernel<<<grid, kThreads, 0, s>>>(stat, level, m, capacity, ws,
                                                vals, idx, lev);
  return cudaGetLastError();
}

// Blocks of the first read that one SM holds at once, or -1.
int repro_sift_blocks_per_sm() {
  int blocks = -1;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, sift_first_kernel, kThreads, 0) == cudaSuccess
             ? blocks
             : -1;
}

}  // extern "C"
