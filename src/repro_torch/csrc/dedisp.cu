// Brute-force incoherent dedispersion (many-DM shift-and-sum) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/dedisp/dedisp_kernel.py:
//   repro_dedisperse  <- dedisperse_pallas (def :57; body _dedisp_body
//                        :38): (B, C, N) float32 filterbanks and a (D, C)
//                        integer delay table -> (B, D, N) float32,
//                        out[b, d, t] = sum_c fb[b, c, t + delay[d, c]],
//                        zero past N.
//
// What bounds it: memory.  The function reads each filterbank once and
// writes D series: (C + D) * N * 4 bytes a filterbank over 3.35 TB/s.  It
// adds D * C values a sample, far below the card's float32 rate.
//
// What the design does about it: the TPU kernel unrolls the delay table at
// trace time and keeps the whole (C, N) block in VMEM; a 1024 x 2^17 block
// is 512 MB, which no SM holds.  Here the table is a device int32 array
// that the wrapper caches per delay table and device.  A block is eight
// warps, one DM trial each, over 128 consecutive samples of one
// filterbank; each thread keeps four sums (samples t, t+32, t+64, t+96)
// and walks the channels in order, reading fb[b, c, t + delay[d, c]]:
// coalesced along t, with four independent loads in flight.  The blocks of
// one sample tile are numbered together (DM tiles fastest), so the few MB
// of filterbank they read (C x (128 + the largest delay) samples) stay in
// L2 while every DM trial reads them, and the neighbouring trials of one
// block read overlapping lines through L1.  The filterbank is thus read
// from HBM about once; the D-fold re-reading goes to L2 and L1, and that
// traffic, D * C * N * 4 bytes, is what this simple kernel is bound by in
// practice.  The sum runs over channels in index order (the plain version's
// order; the reference adds channels that share a delay before the shift,
// so it agrees to rounding).
//
// Interface: a plain C function on device pointers, launched on the given
// stream; it returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

extern "C" const char* repro_dedisp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kTrialsPerBlock = 8;   // one warp per DM trial
constexpr int kSamplesPerThread = 4;
constexpr int kTile = 32 * kSamplesPerThread;

// One block per (DM tile of 8, sample tile of 128, filterbank), numbered
// DM tile fastest, then sample tile, then filterbank; block = (32, 8).
__global__ void __launch_bounds__(32 * kTrialsPerBlock)
    dedisperse_kernel(const float* __restrict__ fb,
                      const int* __restrict__ delays, float* __restrict__ out,
                      int nchan, int n, int ndm, int dm_tiles,
                      int sample_tiles) {
  const long long bid = blockIdx.x;
  const int d = static_cast<int>(bid % dm_tiles) * kTrialsPerBlock +
                threadIdx.y;
  const long long rest = bid / dm_tiles;
  const int t0 = static_cast<int>(rest % sample_tiles) * kTile + threadIdx.x;
  const long long b = rest / sample_tiles;
  if (d >= ndm) return;
  const float* row = fb + b * nchan * static_cast<long long>(n);
  const int* table = delays + static_cast<long long>(d) * nchan;
  float acc[kSamplesPerThread];
#pragma unroll
  for (int s = 0; s < kSamplesPerThread; ++s) acc[s] = 0.0f;
  for (int c = 0; c < nchan; ++c) {
    const int shift = __ldg(table + c);
    const float* ch = row + static_cast<long long>(c) * n + shift;
    const int limit = n - shift;  // samples t < limit read inside the row
#pragma unroll
    for (int s = 0; s < kSamplesPerThread; ++s) {
      const int t = t0 + 32 * s;
      if (t < limit) acc[s] += __ldg(ch + t);
    }
  }
  float* dst = out + (b * ndm + d) * static_cast<long long>(n);
#pragma unroll
  for (int s = 0; s < kSamplesPerThread; ++s) {
    const int t = t0 + 32 * s;
    if (t < n) dst[t] = acc[s];
  }
}

}  // namespace

extern "C" int repro_dedisperse(const float* fb, const int* delays,
                                float* out, long long batch, int nchan, int n,
                                int ndm, void* stream) {
  if (batch < 1 || nchan < 1 || n < 1 || ndm < 1)
    return cudaErrorInvalidValue;
  const int dm_tiles = (ndm + kTrialsPerBlock - 1) / kTrialsPerBlock;
  const int sample_tiles = (n + kTile - 1) / kTile;
  const long long blocks = batch * dm_tiles * sample_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dedisperse_kernel<<<static_cast<unsigned>(blocks),
                      dim3(32, kTrialsPerBlock), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      fb, delays, out, nchan, n, ndm, dm_tiles, sample_tiles);
  return cudaGetLastError();
}
