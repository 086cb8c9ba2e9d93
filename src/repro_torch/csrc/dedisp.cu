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
// What bounds it: the adds.  The function reads each filterbank once and
// writes D series, (C + D) * N * 4 bytes a filterbank over 3.35 TB/s, and
// adds D * C values a sample: plain float32 adds, at 132 SMs x 128 lanes
// x 1.98 GHz = 33.5e12 a second (no FMA to pair them).
//
// What the design does about it: the TPU kernel unrolls the delay table at
// trace time and keeps the whole (C, N) block in VMEM; a 1024 x 2^17 block
// is 512 MB, which no SM holds.  The first port gave each warp one DM trial
// and read every term from global memory, each filterbank sample once a
// trial.  Here a block of eight warps takes a tile of T = 128 samples
// [t0, t0 + T) of one filterbank and a group of DB = 64 DM trials.  It
// walks the channels in chunks (32 channels in the wrapper's launches; a
// run-time argument); for each channel of a chunk it stages the
// window fb[c, t0 + lo, t0 + T + hi) in shared memory (4-byte cp.async:
// windows start anywhere; zero past N), where lo and hi are the smallest
// and largest delay of the group's trials in that channel, beside the
// chunk's shifts (delay - lo, 16-byte cp.async) and (lo, hi).  Two stage
// buffers take turns: the next chunk loads while the block adds the
// current one.  Each thread holds kDT = 8 trials x kS = 4 samples (t0 +
// lane + 32 s) in registers; a warp's trials share their shift, so its 32
// reads of a (trial, s) term are 32 consecutive words, free of bank
// conflicts, and each staged sample serves every trial of the group.  A channel whose
// span hi - lo exceeds the staged width (span_cap: arbitrary tables) is
// read from global memory in the same loop, as the first port did.
// HBM and L2 see the filterbank about once a trial group; one shared-memory
// read a term is the new limit (4 bytes an add at 128 bytes a clock an SM).
//
// The channels are summed in index order, as the plain version sums them
// (the reference adds channels that share a delay before the shift, so it
// agrees to rounding); a term past N adds 0.
//
// The wrapper prepares once per delay table the (G, C, DB) shifts (trials
// of the last group past D repeat its last trial), the (G, C) (lo, hi)
// pairs and the staged width.
//
// Interface: a plain C function on device pointers, launched on the given
// stream; it returns the cudaError_t of its launch (0 on success).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

extern "C" const char* repro_dedisp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 4;    // samples a thread: t0 + lane + 32 s
constexpr int kDT = 8;   // DM trials a warp
constexpr int kT = 32 * kS;       // samples a block
constexpr int kDB = kWarps * kDT;  // trials a block (a trial group)
constexpr size_t kDefaultShared = 48 * 1024;
constexpr size_t kMaxShared = 232448;

// Bytes of one stage buffer: the chunk's shifts (chunk x trials ints), its
// (lo, hi) pairs and its windows of `width` floats, rounded up to 16.
__host__ __device__ __forceinline__ int stage_bytes(int chunk, int trials,
                                                    int width) {
  return (chunk * (trials * 4 + 8 + width * 4) + 15) & ~15;
}

// One block per (trial group, sample tile, filterbank), numbered trial
// group fastest, then sample tile, then filterbank; eight warps, warp w
// holding trials w kDT ... of the group.
__global__ void __launch_bounds__(kThreads)
    dedisperse_kernel(const float* __restrict__ fb,
                      const int* __restrict__ shifts,
                      const int2* __restrict__ lohi, float* __restrict__ out,
                      int nchan, int n, int ndm, int chunk, int span_cap,
                      int groups, int sample_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = kT + span_cap;
  const int sbytes = stage_bytes(chunk, kDB, width);
  const long long bid = blockIdx.x;
  const int g = static_cast<int>(bid % groups);
  const long long rest = bid / groups;
  const int t0 = static_cast<int>(rest % sample_tiles) * kT;
  const long long b = rest / sample_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* fbb = fb + b * nchan * static_cast<long long>(n);
  const int* gsh = shifts + static_cast<long long>(g) * nchan * kDB;
  const int2* glh = lohi + static_cast<long long>(g) * nchan;

  // Chunk ck's shifts, (lo, hi) pairs and staged windows into `buf`.
  auto stage = [&](int ck, unsigned char* buf) {
    const int c0 = ck * chunk;
    const int cn = min(chunk, nchan - c0);
    int4* s_sh = reinterpret_cast<int4*>(buf);
    int2* s_lh = reinterpret_cast<int2*>(buf + chunk * kDB * 4);
    float* s_win = reinterpret_cast<float*>(buf + chunk * (kDB * 4 + 8));
    const int4* src_sh = reinterpret_cast<const int4*>(
        gsh + static_cast<long long>(c0) * kDB);
    for (int i = threadIdx.x; i < cn * kDB / 4; i += kThreads)
      __pipeline_memcpy_async(s_sh + i, src_sh + i, sizeof(int4));
    for (int i = threadIdx.x; i < cn; i += kThreads)
      __pipeline_memcpy_async(s_lh + i, glh + c0 + i, sizeof(int2));
    for (int i = warp; i < cn; i += kWarps) {
      const int2 lh = __ldg(glh + c0 + i);
      if (lh.y - lh.x > span_cap) continue;  // read from global memory
      const int len = kT + lh.y - lh.x;
      const float* src = fbb + static_cast<long long>(c0 + i) * n;
      const long long start = static_cast<long long>(t0) + lh.x;
      float* w = s_win + i * width;
      for (int x = lane; x < len; x += 32) {
        if (start + x < n)
          __pipeline_memcpy_async(w + x, src + start + x, sizeof(float));
        else
          w[x] = 0.0f;
      }
    }
    __pipeline_commit();
  };

  float acc[kDT][kS];
#pragma unroll
  for (int q = 0; q < kDT; ++q)
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[q][s] = 0.0f;

  const int nchunks = (nchan + chunk - 1) / chunk;
  stage(0, smem);
  for (int ck = 0; ck < nchunks; ++ck) {
    unsigned char* buf = smem + (ck & 1) * sbytes;
    if (ck + 1 < nchunks) {
      stage(ck + 1, smem + ((ck + 1) & 1) * sbytes);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int c0 = ck * chunk;
    const int cn = min(chunk, nchan - c0);
    const int* s_sh = reinterpret_cast<const int*>(buf);
    const int2* s_lh = reinterpret_cast<const int2*>(buf + chunk * kDB * 4);
    const float* s_win =
        reinterpret_cast<const float*>(buf + chunk * (kDB * 4 + 8));
    for (int i = 0; i < cn; ++i) {
      const int2 lh = s_lh[i];
      const int* sh = s_sh + i * kDB + warp * kDT;
      if (lh.y - lh.x <= span_cap) {
        const float* w = s_win + i * width + lane;
#pragma unroll
        for (int q = 0; q < kDT; q += 4) {
          const int4 o = *reinterpret_cast<const int4*>(sh + q);
          const int off[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < kS; ++s) acc[q + r][s] += w[off[r] + 32 * s];
        }
      } else {
        const float* row = fbb + static_cast<long long>(c0 + i) * n;
#pragma unroll
        for (int q = 0; q < kDT; ++q) {
          const long long base = static_cast<long long>(t0) + lane + lh.x +
                                 sh[q];
#pragma unroll
          for (int s = 0; s < kS; ++s) {
            const long long idx = base + 32 * s;
            acc[q][s] += idx < n ? __ldg(row + idx) : 0.0f;
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }

  const int d0 = g * kDB + warp * kDT;
#pragma unroll
  for (int q = 0; q < kDT; ++q) {
    if (d0 + q >= ndm) break;
    float* dst = out + (b * ndm + d0 + q) * static_cast<long long>(n);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int t = t0 + lane + 32 * s;
      if (t < n) dst[t] = acc[q][s];
    }
  }
}

size_t shared_bytes(int chunk, int span_cap) {
  return 2 * static_cast<size_t>(stage_bytes(chunk, kDB, kT + span_cap));
}

}  // namespace

extern "C" {

// ``shifts`` is the (G, C, 64 trials) int32 table of delay - lo, ``lohi``
// the (G, C, 2) int32 (lo, hi) pairs, G = ceil(ndm / 64); a block covers
// 128 samples and stages ``chunk`` channels a step, each window ``128 +
// span_cap`` values wide.
int repro_dedisperse(const float* fb, const int* shifts, const int* lohi,
                     float* out, long long batch, int nchan, int n, int ndm,
                     int chunk, int span_cap, void* stream) {
  if (batch < 1 || nchan < 1 || n < 1 || ndm < 1)
    return cudaErrorInvalidValue;
  if (chunk < 1 || span_cap < 0 || span_cap > n) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(chunk, span_cap);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  const int groups = (ndm + kDB - 1) / kDB;
  const int sample_tiles = (n + kT - 1) / kT;
  const long long blocks = batch * groups * sample_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > kDefaultShared) {
    if (cudaError_t err = cudaFuncSetAttribute(
            dedisperse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kMaxShared)))
      return err;
  }
  dedisperse_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      fb, shifts, reinterpret_cast<const int2*>(lohi), out, nchan, n, ndm,
      chunk, span_cap, groups, sample_tiles);
  return cudaGetLastError();
}

// Blocks that one SM holds at once for ``chunk`` and ``span_cap``, or -1.
int repro_dedisperse_blocks_per_sm(int chunk, int span_cap) {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dedisperse_kernel, kThreads,
          shared_bytes(chunk, span_cap)))
    return -1;
  return blocks;
}

}  // extern "C"
