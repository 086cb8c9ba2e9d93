// Register-resident Stockham passes: the device routine of the fft_c2c,
// fft_c2c_t and fft_c2c_axis1 (fft_c2c.cu) and fft_r2c, fft_r2c_t and
// fft_c2r (fft_real.cu) kernels.
//
// The arithmetic is stockham()'s (stockham.cuh), operation for operation:
// the same radix schedule, butterflies and twiddle values.  What differs
// is where the data sits between stages.  Consecutive stages are grouped
// into passes on the host (repro_torch/kernels/fft/fft_kernel.py,
// register_passes and pass_table): a pass of radices r1..rk, R = r1*..*rk,
// at sub-length M leaves sub-length H = M / R, and one item (li, jj),
// jj < H, holds the R points li*M + q*H + jj in registers of one thread.
// Stage i butterflies the digit of q at register stride
// S_i = r_{i+1}*..*rk; its twiddle column is b*H + jj (b the lower,
// not yet transformed digits of q).  After the pass, register
// k1*S_1 + .. + kk*S_k holds output k1 + r1*k2 + .. of the item, which
// goes to item + (that) * n/R: the Stockham (autosort) order, so the last
// pass writes natural order.
//
// A thread holds P points (P = min(n, 16), and 32 at n = 8192 so that a
// transform takes at most 256 threads; a template argument, so that every
// register index is a constant): P / R items of each pass, items lane,
// lane + T, .. of its transform's T = n / P threads.  At most 256 threads
// a block and two blocks an SM leave up to 128 registers a thread: 32
// points are 64 of them.  The first
// pass loads straight from device memory and the last stores straight to
// it, both coalesced (neighbouring lanes take neighbouring items).
// Between passes the points go through one shared buffer a transform:
// each thread reads its next pass's points into registers, the block
// synchronises, and only then writes its results over the buffer.  The
// buffer is padded by one slot every 16 points (pad()), against the bank
// conflicts of the strided reads of the late passes.
//
// The twiddles are one compact float2 table of n - 1 entries (the rows a
// stage reads: stage after stage, branch k = 1..r-1, h = M/r columns
// each; fft_kernel.compact_twiddles), read once per butterfly branch
// through the read-only cache; the inverse conjugates them here.
//
// The strided side (fft_r2c_t's and fft_c2c_t's transposed write, both
// sides of fft_c2c_axis1) goes through a thread-block cluster of G <= 8
// blocks that hold G * per_block consecutive lines (rows or columns) of
// one batch entry: cluster_store writes each output point of all those
// lines as one contiguous run, reading the other blocks' buffers through
// distributed shared memory, and cluster_load reads each input row of
// the lines as one run into the owners' buffers.  Both step one walk
// (TileWalk) over the cluster's (points x lines) tile.

#pragma once

#include <cooperative_groups.h>

#include "stockham.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPassPoints = 32;   // most points a thread holds
constexpr int kPassStages = 5;    // most stages of one pass (2**5 = 32)
constexpr int kPassThreads = 256; // most threads of a block
constexpr int kPassFields = 3 + 2 * kPassStages;

// Blocks per SM the launch bound of instance (P, F) sizes its registers
// for (65536 / (256 * blocks) a thread: 85, 128 or 255): the most blocks
// at which ptxas keeps the instance's points and twiddles without
// spilling (fft_kernel.PASS_MIN_BLOCKS).  The radix-8 butterflies need
// more registers; at 32 points (n = 8192) more than 128.
__host__ __device__ constexpr int pass_min_blocks(int points, int family) {
  if (points <= 8) return 3;
  if (points == 16) return family == 8 ? 2 : 3;
  return family == 8 ? 1 : 2;
}

__host__ __device__ constexpr int ilog2(int x) {
  return x > 1 ? 1 + ilog2(x / 2) : 0;
}

template <int... Rs>
__host__ __device__ constexpr int shape_code() {
  constexpr int r[] = {Rs...};
  int code = 0;
  for (int i = 0; i < static_cast<int>(sizeof...(Rs)); ++i)
    code |= ilog2(r[i]) << (2 * i);
  return code;
}

// The radices of one pass, known to the compiler: its points R, its
// stage strides and where each register's result goes.
template <int... Rs>
struct Shape {
  static constexpr int kStages = sizeof...(Rs);
  static constexpr int kR = (Rs * ...);
  // Two bits of log2(r) per stage, first stage lowest.
  static constexpr int kCode = shape_code<Rs...>();
  __host__ __device__ static constexpr int radix(int i) {
    constexpr int r[] = {Rs...};
    return r[i];
  }
  // Register stride of stage i's digit: the radices after it.
  __host__ __device__ static constexpr int stride(int i) {
    int s = 1;
    for (int j = i + 1; j < kStages; ++j) s *= radix(j);
    return s;
  }
  // Register q = k1*S_1 + .. + kk*S_k holds output k1 + r1*k2 + .. .
  __host__ __device__ static constexpr int out(int q) {
    int kk = 0, place = 1;
    for (int i = 0; i < kStages; ++i) {
      kk += (q / stride(i)) % radix(i) * place;
      place *= radix(i);
    }
    return kk;
  }
};

// The passes the host plans (fft_kernel.PASS_SHAPES): X(P, F, radices..)
// for each pass of a plan of P points a thread whose schedule's largest
// radix (its family) is F, over every set of radices and every length.
// The kernel instance of (P, F) is compiled for its own passes only, so
// that its registers hold nothing another plan's passes keep live.
#define REPRO_PASS_SHAPES(X)                                              \
  X(2, 2, 2) X(4, 2, 2, 2) X(4, 4, 4) X(8, 2, 2, 2, 2) X(8, 4, 2, 4)      \
  X(8, 8, 8) X(16, 2, 2) X(16, 2, 2, 2) X(16, 2, 2, 2, 2)                 \
  X(16, 2, 2, 2, 2, 2) X(16, 4, 4) X(16, 4, 2, 4) X(16, 4, 4, 4)          \
  X(16, 8, 4) X(16, 8, 8) X(16, 8, 2, 2) X(16, 8, 2, 8)                   \
  X(32, 2, 2, 2, 2) X(32, 2, 2, 2, 2, 2, 2) X(32, 4, 4, 4)                \
  X(32, 4, 2, 4, 4) X(32, 8, 8) X(32, 8, 2, 8)

// The kernel instances: every (P, F) of REPRO_PASS_SHAPES.
#define REPRO_PASS_INSTANCES(X)                                           \
  X(2, 2) X(4, 2) X(4, 4) X(8, 2) X(8, 4) X(8, 8) X(16, 2) X(16, 4)       \
  X(16, 8) X(32, 2) X(32, 4) X(32, 8)

// One pass, as the host's plan gives it (fft_kernel.pass_table).
struct RegPass {
  int log_r;                  // log2 R: points of one item
  int log_h;                  // log2 H: sub-length after the pass
  int code;                   // Shape<..>::kCode of its radices
  int tw[kPassStages];        // offset of each stage's rows in the table
};

struct RegPlan {
  int n;
  int family;                 // the schedule's largest radix
  int log_t;                  // log2 threads per transform (n / P)
  int npasses;
  float sign;                 // -1 forward, +1 inverse
  float scale;                // 1 forward, 1/n inverse (exact: n is pow2)
  float dft_re[64];           // radix-8 butterfly matrix [p * 8 + k] of
  float dft_im[64];           // the direction
  RegPass pass[kMaxStages];
};

// Calls f(Shape<..>{}) for the pass shape `code` of instance (P, F).
template <int P, int F, typename Fn>
__device__ __forceinline__ void with_shape(int code, Fn&& f) {
#define REPRO_CASE(kP, kF, ...)                                         \
  if constexpr (P == kP && F == kF) {                                   \
    if (code == Shape<__VA_ARGS__>::kCode) {                            \
      f(Shape<__VA_ARGS__>{});                                          \
      return;                                                           \
    }                                                                   \
  }
  REPRO_PASS_SHAPES(REPRO_CASE)
#undef REPRO_CASE
}

// Whether `code` is a pass shape of instance (points, family).
bool known_shape(int code, int points, int family) {
#define REPRO_IS(kP, kF, ...)                                            \
  if (points == kP && family == kF && code == Shape<__VA_ARGS__>::kCode) \
    return true;
  REPRO_PASS_SHAPES(REPRO_IS)
#undef REPRO_IS
  return false;
}

// Slot of point i in a transform's exchange buffer.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int padded(int n) { return n + n / 16; }

// Slots from one line's buffer to the next in fft_c2c_t and
// fft_c2c_axis1: padded(n), raised to 16 / per_block mod 16 (to an odd
// number from 16 lines a block) so that the strided side's half-warps,
// which take per_block lines of consecutive points, hit 16 different
// float2 banks.
__host__ __device__ constexpr int line_slots(int n, int per_block) {
  return per_block == 1    ? padded(n)
         : per_block >= 16 ? padded(n) | 1
                           : padded(n) +
                                 ((16 / per_block - padded(n)) % 16 + 16) % 16;
}

// Slots of one transform's buffer in the real kernels: the exchange
// buffer, which also holds the n + 1 bins of the Hermitian split or merge
// in natural order (more than padded(n) for n <= 8).
__host__ __device__ constexpr int split_slots(int n) {
  return padded(n) > n + 1 ? padded(n) : n + 1;
}

__device__ __forceinline__ float2 table_twiddle(const float2* __restrict__ tw,
                                                int at, float sign) {
  const float2 w = __ldg(tw + at);
  return make_float2(w.x, -sign * w.y);
}

// One radix-R butterfly of stockham() on registers o, o + S, .. of v,
// in place; wk[k] is branch k's twiddle.
template <int P, int R, int S>
__device__ __forceinline__ void butterfly(float2 (&v)[P], int o,
                                          const float2 (&wk)[R],
                                          const RegPlan& s) {
  const float sign = s.sign;
  if constexpr (R == 2) {
    const float2 x0 = v[o], x1 = v[o + S];
    v[o] = cadd(x0, x1);
    v[o + S] = cmul(csub(x0, x1), wk[1]);
  } else if constexpr (R == 4) {
    const float2 x0 = v[o], x1 = v[o + S], x2 = v[o + 2 * S],
                 x3 = v[o + 3 * S];
    const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2);
    const float2 t2 = cadd(x1, x3), t3 = csub(x1, x3);
    // sign * i * t3: b1/b3 = t1 -+ i*t3 forward, flipped for the inverse.
    const float2 u3 = make_float2(-sign * t3.y, sign * t3.x);
    v[o] = cadd(t0, t2);
    v[o + S] = cmul(cadd(t1, u3), wk[1]);
    v[o + 2 * S] = cmul(csub(t0, t2), wk[2]);
    v[o + 3 * S] = cmul(csub(t1, u3), wk[3]);
  } else {  // R == 8, through the DFT matrix
    float2 x[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) x[p] = v[o + p * S];
    float2 acc = x[0];
#pragma unroll
    for (int p = 1; p < 8; ++p) acc = cadd(acc, x[p]);
    v[o] = acc;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      float ar = x[0].x, ai = x[0].y;
#pragma unroll
      for (int p = 1; p < 8; ++p) {
        const float cr = s.dft_re[p * 8 + k], ci = s.dft_im[p * 8 + k];
        ar = ar + x[p].x * cr - x[p].y * ci;
        ai = ai + x[p].x * ci + x[p].y * cr;
      }
      v[o + k * S] = cmul(make_float2(ar, ai), wk[k]);
    }
  }
}

// Branch k's twiddles of column j (w: the stage's rows of the table).
template <int R>
__device__ __forceinline__ void load_twiddles(float2 (&wk)[R],
                                              const float2* __restrict__ w,
                                              int h, int j, float sign) {
#pragma unroll
  for (int k = 1; k < R; ++k) wk[k] = table_twiddle(w, (k - 1) * h + j, sign);
}

// One stage of radix R at register stride S on the G items of the thread
// (P / G points each; w: the stage's rows of the twiddle table).  The
// butterflies of one item that differ only in the higher digits (the
// branches of the pass's earlier stages) share their twiddle column b*H +
// jj, and so do the items when H <= T (jj = lane mod H for each): each
// twiddle is loaded once for all butterflies that use it.
template <int P, int R, int S, int G>
__device__ __forceinline__ void reg_stage(float2 (&v)[P], const RegPlan& s,
                                          int log_h,
                                          const float2* __restrict__ w,
                                          int lane) {
  constexpr int kA = P / (G * R * S);       // butterflies of an item
  const int h = S << log_h;                 // the stage's butterfly width
  const int hmask = (1 << log_h) - 1;
  float2 wk[R];
  if (G == 1 || log_h <= s.log_t) {
    const int jj = lane & hmask;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      load_twiddles<R>(wk, w, h, (b << log_h) + jj, s.sign);
#pragma unroll
      for (int a = 0; a < G * kA; ++a)
        butterfly<P, R, S>(v, a * R * S + b, wk, s);
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int jj = (lane + (g << s.log_t)) & hmask;
#pragma unroll
      for (int b = 0; b < S; ++b) {
        load_twiddles<R>(wk, w, h, (b << log_h) + jj, s.sign);
#pragma unroll
        for (int a = 0; a < kA; ++a)
          butterfly<P, R, S>(v, (g * kA + a) * R * S + b, wk, s);
      }
    }
  }
}

// The stages of one pass, first to last.
template <int P, typename Sh, int I = 0>
__device__ __forceinline__ void pass_stages(float2 (&v)[P], const RegPlan& s,
                                            const RegPass& ps,
                                            const float2* __restrict__ tw,
                                            int lane) {
  if constexpr (I < Sh::kStages) {
    reg_stage<P, Sh::radix(I), Sh::stride(I), P / Sh::kR>(
        v, s, ps.log_h, tw + ps.tw[I], lane);
    pass_stages<P, Sh, I + 1>(v, s, ps, tw, lane);
  }
}

// Register g*R + q of the thread holds point li*M + q*H + jj of item g,
// (li, jj) = divmod(lane + g*T, H): `at(offset)` is where it is read.
template <int P, typename Sh, typename Read>
__device__ __forceinline__ void gather(float2 (&v)[P], const RegPass& ps,
                                       int lane, int log_t, Read at) {
  constexpr int R = Sh::kR;
#pragma unroll
  for (int g = 0; g < P / R; ++g) {
    const int item = lane + (g << log_t);
    const int base = (((item >> ps.log_h) * R) << ps.log_h) +
                     (item & ((1 << ps.log_h) - 1));
#pragma unroll
    for (int q = 0; q < R; ++q) v[g * R + q] = at(base + (q << ps.log_h));
  }
}

// The result in register g*R + q goes to item + out(q) * n/R.
template <int P, typename Sh, typename Write>
__device__ __forceinline__ void scatter(const float2 (&v)[P], int n,
                                        const RegPass& ps, int lane,
                                        int log_t, Write put) {
  constexpr int R = Sh::kR;
  const int slice = n >> ps.log_r;
#pragma unroll
  for (int g = 0; g < P / R; ++g) {
    const int item = lane + (g << log_t);
#pragma unroll
    for (int q = 0; q < R; ++q) put(item + Sh::out(q) * slice, v[g * R + q]);
  }
}

// Pass p of the plan on the thread's registers.
template <int P, int F>
__device__ __forceinline__ void run_pass(float2 (&v)[P], const RegPlan& s,
                                         int p, const float2* __restrict__ tw,
                                         int lane) {
  const RegPass& ps = s.pass[p];
  with_shape<P, F>(ps.code, [&](auto sh) {
    pass_stages<P, decltype(sh)>(v, s, ps, tw, lane);
  });
}

// The first pass's points of one transform, straight from device memory
// (P independent 8-byte loads a thread, coalesced along jj).
template <int P, int F>
__device__ __forceinline__ void load_global(float2 (&v)[P],
                                            const float2* __restrict__ src,
                                            const RegPlan& s, int lane) {
  with_shape<P, F>(s.pass[0].code, [&](auto sh) {
    gather<P, decltype(sh)>(v, s.pass[0], lane, s.log_t,
                            [&](int at) { return __ldg(src + at); });
  });
}

// The last pass's results, scaled, straight to device memory.
template <int P, int F>
__device__ __forceinline__ void store_global(const float2 (&v)[P],
                                             float2* __restrict__ dst,
                                             const RegPlan& s, int lane) {
  const RegPass& ps = s.pass[s.npasses - 1];
  const float scale = s.scale;
  with_shape<P, F>(ps.code, [&](auto sh) {
    scatter<P, decltype(sh)>(v, s.n, ps, lane, s.log_t, [&](int at, float2 x) {
      __stcs(dst + at, scaled(x, scale));
    });
  });
}

// Pass p's results into the exchange buffer: padded, or in natural order
// (for a reader that indexes the spectrum directly).
template <int P, int F, bool kPad>
__device__ __forceinline__ void store_shared(const float2 (&v)[P],
                                             float2* buf, const RegPlan& s,
                                             int p, int lane) {
  const RegPass& ps = s.pass[p];
  with_shape<P, F>(ps.code, [&](auto sh) {
    scatter<P, decltype(sh)>(v, s.n, ps, lane, s.log_t,
                             [&](int at, float2 x) {
                               buf[kPad ? pad(at) : at] = x;
                             });
  });
}

template <int P, int F>
__device__ __forceinline__ void load_shared(float2 (&v)[P],
                                            const float2* buf,
                                            const RegPlan& s, int p,
                                            int lane) {
  with_shape<P, F>(s.pass[p].code, [&](auto sh) {
    gather<P, decltype(sh)>(v, s.pass[p], lane, s.log_t,
                            [&](int at) { return buf[pad(at)]; });
  });
}

// Every pass but the last on one transform's points, which arrive in v
// from the first pass's loads and leave in v before the last pass.
// Called by every thread of the block (the exchanges synchronise it).
// `staged`: the first pass read its points from buf too (C2R's staged
// bins), so its store waits for every thread's reads as the later ones do.
template <int P, int F>
__device__ __forceinline__ void reg_passes_but_last(
    float2 (&v)[P], float2* buf, const RegPlan& s,
    const float2* __restrict__ tw, int lane, bool staged = false) {
  for (int p = 0; p + 1 < s.npasses; ++p) {
    run_pass<P, F>(v, s, p, tw, lane);
    if (p > 0 || staged) __syncthreads();  // every read of buf is done
    store_shared<P, F, true>(v, buf, s, p, lane);
    __syncthreads();
    load_shared<P, F>(v, buf, s, p + 1, lane);
  }
}

// The last pass's results into the exchange buffer in natural order,
// scaled (1/n for the inverse) and then times ftw[k] (k: the result's
// index; ftw: the transform's row of the four-step twiddle, or null), in
// stockham()'s order.
template <int P, int F>
__device__ __forceinline__ void store_finished(const float2 (&v)[P],
                                               float2* buf, const RegPlan& s,
                                               const float2* __restrict__ ftw,
                                               int lane) {
  const RegPass& ps = s.pass[s.npasses - 1];
  const float scale = s.scale;
  with_shape<P, F>(ps.code, [&](auto sh) {
    scatter<P, decltype(sh)>(v, s.n, ps, lane, s.log_t,
                             [&](int at, float2 x) {
                               x = scaled(x, scale);
                               buf[at] = ftw ? cmul(x, __ldg(ftw + at)) : x;
                             });
  });
}

// The batch entry and the first line (row or column) of the tile of the
// cluster that block `bid` belongs to: clusters of g blocks, `tiles`
// clusters a batch entry, g * per_block lines a tile.
struct LineTile {
  int batch;
  int first;
};

__device__ __forceinline__ LineTile line_tile(int bid, int g, int tiles,
                                              int per_block) {
  const int cid = bid / g;
  const int batch = cid / tiles;
  return {batch, (cid - batch * tiles) * g * per_block};
}

// blockIdx.x, read anew at each call (a read the compiler cannot merge
// with an earlier one).
__device__ __forceinline__ int block_index() {
  int bid;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bid));
  return bid;
}

// A walk of the block's threads over a cluster's tile of `lines` lines
// (rows or columns), g * per_block of them, of some points each: thread
// i's first point is e = k * lines + t, and each step adds the block's
// threads to e.  (k, t) and t's (owner block, line in it), t = owner *
// per_block + line, are carried instead of divided.
struct TileWalk {
  int k, t, owner, line;
  int dk, dt, dq, dr;
  int lines, per_block, g;

  __device__ TileWalk(int k0, int t0, int lines_, int per_block_, int g_)
      : k(k0), t(t0), lines(lines_), per_block(per_block_), g(g_) {
    owner = t / per_block;
    line = t - owner * per_block;
    dk = blockDim.x / lines;
    dt = blockDim.x - dk * lines;
    dq = dt / per_block;
    dr = dt - dq * per_block;
  }

  __device__ __forceinline__ void next() {
    t += dt;
    k += dk;
    owner += dq;
    line += dr;
    if (line >= per_block) {
      line -= per_block;
      ++owner;
    }
    if (t >= lines) {
      t -= lines;
      owner -= g;
      ++k;
    }
  }
};

// The cluster's tile of g * per_block lines of n points, point k of line
// t at src[k * ld + t], into the owners' buffers: line t to block t /
// per_block, slot (t % per_block) * stride + pad(k); lines t >= live are
// masked (zeros).  Block `rank` reads the tile's points [rank * per_block
// * n, ...) in row-major order, P a thread: each row of the tile is one
// contiguous run of g * per_block * 8 bytes.  The loads go out in groups
// of four, each group stored through distributed shared memory as it
// arrives: groups of all P, or of eight, spilled at 16 and 32 points a
// thread.  After the last cluster.sync() every block's buffer holds its
// lines.
template <int P>
__device__ __forceinline__ void cluster_load(float2* smem, int stride,
                                             int per_block, int n,
                                             const float2* __restrict__ src,
                                             long long ld, int live) {
  constexpr int kGroup = P < 4 ? P : 4;  // loads in flight a thread
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int lines = g * per_block;
  const int e0 = static_cast<int>(cluster.block_rank()) * per_block * n +
                 static_cast<int>(threadIdx.x);
  const int k0 = e0 / lines;
  TileWalk w(k0, e0 - k0 * lines, lines, per_block, g);
  cluster.sync();  // every block of the cluster runs: its buffer exists
#pragma unroll
  for (int p = 0; p < P; p += kGroup) {
    float2 got[kGroup];
    float2* to[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      got[i] = w.t < live
                   ? __ldg(src + static_cast<long long>(w.k) * ld + w.t)
                   : make_float2(0.f, 0.f);
      to[i] = cluster.map_shared_rank(smem, w.owner) + w.line * stride +
              pad(w.k);
      w.next();
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) *to[i] = got[i];
  }
  cluster.sync();  // every line is in its owner's buffer
}

// The cluster's results, point k of line t at (t % per_block) * stride +
// k in block t / per_block's buffer, to dst[k * ld + t] for the n points
// of every line t < live.  Block `rank` stores points [rank * share, ...)
// of all g * per_block lines, reading the other blocks' buffers through
// distributed shared memory: consecutive threads take consecutive lines
// of one point, so a point of the tile is one contiguous run.  The first
// cluster.sync() waits for every block's results, the second keeps every
// buffer alive until the others have read it.
__device__ __forceinline__ void cluster_store(float2* smem, int stride,
                                              int per_block, int n,
                                              float2* __restrict__ dst,
                                              long long ld, int live) {
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lines = g * per_block;
  const int share = (n + g - 1) / g;
  const int k1 = min(n, (rank + 1) * share);
  cluster.sync();  // every block's results are in its buffer
  for (TileWalk w(rank * share + static_cast<int>(threadIdx.x) / lines,
                  static_cast<int>(threadIdx.x) % lines, lines, per_block, g);
       w.k < k1; w.next()) {
    if (w.t < live) {
      const float2* z =
          cluster.map_shared_rank(smem, w.owner) + w.line * stride;
      __stcs(dst + static_cast<long long>(w.k) * ld + w.t, z[w.k]);
    }
  }
  cluster.sync();  // the other blocks have read this block's buffer
}

// Checks the host's plan table (fft_kernel.pass_table) and fills `s`:
// every pass is a known shape of at most `points` points, the passes
// cover the transform, and every stage's twiddle rows follow the last
// one's, inside the n - 1 entries of the table.
cudaError_t make_reg_plan(RegPlan* s, int n, int points, const int* table,
                          int npasses, int inverse, const float* dft_re,
                          const float* dft_im) {
  if (n < 2 || (n & (n - 1)) != 0 || n > (1 << kMaxStages) ||
      points < 2 || points > kPassPoints || (points & (points - 1)) != 0 ||
      points > n || npasses < 1 || npasses > kMaxStages)
    return cudaErrorInvalidValue;
  s->n = n;
  s->family = 0;
  s->log_t = ilog2(n / points);
  s->npasses = npasses;
  s->sign = inverse ? 1.0f : -1.0f;
  s->scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;
  std::memcpy(s->dft_re, dft_re, sizeof(s->dft_re));
  std::memcpy(s->dft_im, dft_im, sizeof(s->dft_im));
  int log_m = ilog2(n);
  int tw = 0;
  for (int p = 0; p < npasses; ++p) {
    const int* row = table + p * kPassFields;
    RegPass& ps = s->pass[p];
    ps.log_r = row[0];
    ps.log_h = row[1];
    const int nstages = row[2];
    const int* radix = row + 3;
    if (nstages < 1 || nstages > kPassStages || ps.log_r < 1 ||
        (1 << ps.log_r) > points || ps.log_h < 0 ||
        ps.log_h + ps.log_r != log_m)
      return cudaErrorInvalidValue;
    ps.code = 0;
    int log_s = ps.log_r;
    for (int i = 0; i < kPassStages; ++i) {
      ps.tw[i] = row[3 + kPassStages + i];
      if (i >= nstages) continue;
      const int r = radix[i];
      if (r != 2 && r != 4 && r != 8) return cudaErrorInvalidValue;
      ps.code |= ilog2(r) << (2 * i);
      log_s -= ilog2(r);
      if (ps.tw[i] != tw) return cudaErrorInvalidValue;
      tw += (r - 1) << (log_s + ps.log_h);
    }
    if (log_s != 0) return cudaErrorInvalidValue;
    for (int i = 0; i < nstages; ++i)
      if (radix[i] > s->family) s->family = radix[i];
    log_m = ps.log_h;
  }
  for (int p = 0; p < npasses; ++p)
    if (!known_shape(s->pass[p].code, points, s->family))
      return cudaErrorInvalidValue;
  return (log_m == 0 && tw == n - 1) ? cudaSuccess : cudaErrorInvalidValue;
}

template <int P, int F>
struct PF {
  static constexpr int kP = P;
  static constexpr int kF = F;
};

// Calls f(PF<P, F>{}) for the instance (points, family) of the plan
// (make_reg_plan checked that it is one of REPRO_PASS_INSTANCES).
template <typename Fn>
int with_instance(int points, int family, Fn&& f) {
#define REPRO_INSTANCE(kP, kF) \
  if (points == kP && family == kF) return f(PF<kP, kF>{});
  REPRO_PASS_INSTANCES(REPRO_INSTANCE)
#undef REPRO_INSTANCE
  return cudaErrorInvalidValue;
}

// Raises a pass kernel's dynamic shared-memory limit when a launch of
// `smem` bytes needs more than 48 KB: to the most a block may have, so
// that every launch of the kernel, whatever its size and whenever it was
// planned, stays within the limit (the limit belongs to the function).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem > kDefaultShared)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kMaxShared));
  return cudaSuccess;
}

// Checks a pass kernel's launch (threads, shared memory, blocks) and
// raises its dynamic shared-memory limit (allow_shared).
template <typename Kernel>
cudaError_t prepare_passes(Kernel kernel, long long blocks, int threads,
                           size_t smem) {
  if (threads < 1 || threads > kPassThreads || blocks < 1 ||
      blocks > 0x7fffffffLL || smem > kMaxShared)
    return cudaErrorInvalidValue;
  return allow_shared(kernel, smem);
}

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that one SM holds at once, or -1 if the runtime refuses the query.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, long long smem) {
  int blocks = -1;
  if (smem < 0 || smem > static_cast<long long>(kMaxShared)) return -1;
  if (allow_shared(kernel, static_cast<size_t>(smem)) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, threads, static_cast<size_t>(smem)) != cudaSuccess)
    return -1;
  return blocks;
}

constexpr int kMaxCluster = 8;  // the portable cluster size

// The launch configuration of a clustered pass kernel: `blocks` blocks in
// clusters of `cluster` (attr must outlive cfg).
cudaLaunchConfig_t cluster_config(long long blocks, int threads, size_t smem,
                                  int cluster, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches a clustered pass kernel (cudaLaunchKernelEx) after checking
// its shape and raising its shared-memory limit (prepare_passes).
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, long long blocks, int threads,
                    size_t smem, int cluster, void* stream, Args... args) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaError_t e = prepare_passes(kernel, blocks, threads, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(blocks, threads, smem, cluster, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of `cluster` blocks of a clustered pass kernel that the card
// can run at once (cudaOccupancyMaxActiveClusters), or -1 on error.
template <typename Kernel>
int active_clusters(Kernel kernel, int threads, long long smem,
                    int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || smem < 0 ||
      smem > static_cast<long long>(kMaxShared) ||
      prepare_passes(kernel, cluster, threads, static_cast<size_t>(smem)) !=
          cudaSuccess)
    return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      cluster, threads, static_cast<size_t>(smem), cluster, nullptr, &attr);
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// A launch of fft_c2c or fft_r2c, planned once per shape on the host
// (repro_fft_c2c_plan, repro_fft_r2c_plan: the plan table checked, the
// geometry sized, the instance's shared-memory limit raised) in memory the
// caller keeps (repro_pass_plan_bytes), and launched from then on by
// repro_fft_*_run with no work but the launch.
struct PassLaunchPlan {
  RegPlan s;
  int points;
  int per_block;       // transforms a block runs
  int threads;
  size_t smem;
  const float2* tw;    // the compact twiddle table
  const float2* sw;    // the split table (fft_r2c), or null
};

// Sizes a plan's launch: per_block transforms a block in `slots` slots
// each (`exchange`: the plan needs a buffer at all, fft_c2c of one pass
// does not).
cudaError_t size_launch(PassLaunchPlan* p, int points, int per_block,
                        int slots, bool exchange) {
  if (per_block < 1) return cudaErrorInvalidValue;
  p->points = points;
  p->per_block = per_block;
  p->threads = per_block << p->s.log_t;
  p->smem =
      exchange ? static_cast<size_t>(per_block) * slots * sizeof(float2) : 0;
  return cudaSuccess;
}

// The blocks of a planned launch of `batch` transforms.
cudaError_t planned_blocks(const PassLaunchPlan& p, long long batch,
                           unsigned* blocks) {
  const long long b = (batch + p.per_block - 1) / p.per_block;
  if (batch < 1 || b > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(b);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of the plan that repro_fft_c2c_plan and repro_fft_r2c_plan fill.
int repro_pass_plan_bytes() {
  return static_cast<int>(sizeof(PassLaunchPlan));
}

// The signature of repro_fft_c2c_run and repro_fft_r2c_run, doing
// nothing: the host times its ctypes call against theirs.
int repro_pass_noop(const void*, const void*, void*, long long, void*) {
  return 0;
}

}  // extern "C"
