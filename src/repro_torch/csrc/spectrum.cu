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
// What the design does about it: one pass over a grid that fills the
// card.  The TPU walks a row in one grid step; one block a row leaves most
// SMs idle at a small batch (32 rows: 32 blocks on 132 SMs).  Here each row
// is cut into S segments (spectrum_kernel.segments: enough that the B S
// blocks fill about eight waves of the card, whatever B, where the rows
// are long enough; with two, the last wave's tail cost 7 %), and a block
// streams its segment: 16-byte loads of two interleaved complex64 bins (a
// row of odd N starts only 8-byte aligned, so a segment may begin and end
// with a single bin), p written with streaming stores, and the sums of p
// and p^2 kept in double.  The block's sums go to a (B, S) double
// workspace; the row's last block to finish (it draws the last of the
// row's tickets, an atomicAdd after a __threadfence) sums the S partials
// in a fixed order, writes the row's mean and variance and sets the ticket
// back to 0.  The order of every sum is fixed by the layout alone, not by
// which block finished last, and no floating-point atomic is used: two
// runs give the same bits.  The mean and E[p^2] are the float32 roundings
// of nearly exact means, and the variance is the reference's formula
// E[p^2] - mean^2 in float32 on them, cancellation included.  Each product
// and sum of p is rounded as written (no FMA contraction), as the plain
// version computes it.
//
// Interface: plain C functions on device pointers, launched on the given
// stream; each returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

extern "C" const char* repro_spectrum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Pairs of bins a thread loads before it adds them.
constexpr int kUnroll = 4;

// p of one bin, rounded as the plain version rounds it.
__device__ __forceinline__ float power(float re, float im, float len) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), len);
}

__device__ __forceinline__ void add(double& s1, double& s2, float pk) {
  s1 += pk;
  s2 += __fmul_rn(pk, pk);
}

// The block's sums of (s1, s2), in thread 0: each warp's by shuffles in a
// fixed tree, then the warps' in warp order.
__device__ __forceinline__ void block_sum(double& s1, double& s2) {
  __shared__ double part[2][kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = s1;
    part[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = part[0][0];
    s2 = part[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s1 += part[0][w];
      s2 += part[1][w];
    }
  }
  __syncthreads();  // part is free again
}

// Block i covers segment i % segments, bins [s seg, min(n, (s + 1) seg)),
// of row i / segments.  `partial` holds (s1, s2) a block, (B, S);
// `tickets` one int a row, 0 between launches.
__global__ void __launch_bounds__(kThreads)
    power_spectrum_stats_kernel(const float2* __restrict__ x,
                                float* __restrict__ p,
                                float* __restrict__ mean,
                                float* __restrict__ var,
                                double2* __restrict__ partial,
                                unsigned* __restrict__ tickets, int n,
                                int segments, int seg) {
  const long long row = blockIdx.x / segments;
  const int s = static_cast<int>(blockIdx.x % segments);
  const int tid = threadIdx.x;
  const float len = static_cast<float>(n);
  int a = s * seg;
  const int e = static_cast<int>(min(static_cast<long long>(n),
                                      static_cast<long long>(a) + seg));
  const float2* xr = x + row * n;
  float* pr = p + row * n;
  double s1 = 0.0, s2 = 0.0;
  // A pair starts where x is 16-byte aligned; its p is 8-byte aligned too
  // unless x and p differ in that alignment (x a view at an odd offset).
  const bool x_odd =
      (reinterpret_cast<uintptr_t>(xr + a) & (2 * sizeof(float2) - 1)) != 0;
  const bool p_pairs = ((reinterpret_cast<uintptr_t>(x) >> 3) & 1) ==
                       ((reinterpret_cast<uintptr_t>(p) >> 2) & 1);
  if (x_odd && a < e) {  // the single bin before the first pair
    if (tid == 0) {
      const float2 v = __ldcs(xr + a);
      const float pk = power(v.x, v.y, len);
      __stcs(pr + a, pk);
      add(s1, s2, pk);
    }
    ++a;
  }
  const int pairs = (e - a) / 2;
  const float4* x2 = reinterpret_cast<const float4*>(xr + a);
  auto store = [&](int i, float p0, float p1) {
    float* dst = pr + a + 2 * i;
    if (p_pairs) {
      __stcs(reinterpret_cast<float2*>(dst), make_float2(p0, p1));
    } else {
      __stcs(dst, p0);
      __stcs(dst + 1, p1);
    }
  };
  int i = tid;
  for (; i + (kUnroll - 1) * kThreads < pairs; i += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(x2 + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p0 = power(v[u].x, v[u].y, len);
      const float p1 = power(v[u].z, v[u].w, len);
      store(i + u * kThreads, p0, p1);
      add(s1, s2, p0);
      add(s1, s2, p1);
    }
  }
  for (; i < pairs; i += kThreads) {
    const float4 v = __ldcs(x2 + i);
    const float p0 = power(v.x, v.y, len);
    const float p1 = power(v.z, v.w, len);
    store(i, p0, p1);
    add(s1, s2, p0);
    add(s1, s2, p1);
  }
  if (a + 2 * pairs < e && tid == kThreads - 1) {  // the single last bin
    const float2 v = __ldcs(xr + e - 1);
    const float pk = power(v.x, v.y, len);
    __stcs(pr + e - 1, pk);
    add(s1, s2, pk);
  }
  block_sum(s1, s2);

  __shared__ bool last;
  if (tid == 0) {
    partial[row * segments + s] = make_double2(s1, s2);
    __threadfence();  // the partial is seen before the ticket
    last = atomicAdd(tickets + row, 1u) == static_cast<unsigned>(segments - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // The row's last block: every partial is written.  Thread t sums
  // partials t, t + 256, ... in turn, then the block's fixed tree.
  s1 = s2 = 0.0;
  for (int k = tid; k < segments; k += kThreads) {
    const double2 v = __ldcg(partial + row * segments + k);
    s1 += v.x;
    s2 += v.y;
  }
  block_sum(s1, s2);
  if (tid == 0) {
    const float m = static_cast<float>(s1 / n);
    const float m2 = static_cast<float>(s2 / n);
    mean[row] = m;
    var[row] = __fsub_rn(m2, __fmul_rn(m, m));
    tickets[row] = 0;
  }
}

}  // namespace

extern "C" {

// ``partial`` holds batch x segments double pairs, ``tickets`` batch
// ints that are 0 (the kernel leaves them 0).
int repro_power_spectrum_stats(const void* x, float* p, float* mean,
                               float* var, void* partial, unsigned* tickets,
                               long long batch, int n, int segments, int seg,
                               void* stream) {
  if (batch < 1 || n < 1 || segments < 1 || seg < 1 ||
      static_cast<long long>(segments - 1) * seg >= n ||
      static_cast<long long>(segments) * seg < n ||
      batch * segments > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  power_spectrum_stats_kernel<<<static_cast<unsigned>(batch * segments),
                                kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), p, mean, var,
      static_cast<double2*>(partial), tickets, n, segments, seg);
  return cudaGetLastError();
}

// Blocks of the kernel that one SM holds at once, or -1.
int repro_power_spectrum_stats_blocks_per_sm() {
  int blocks = -1;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, power_spectrum_stats_kernel, kThreads, 0) == cudaSuccess
             ? blocks
             : -1;
}

}  // extern "C"
