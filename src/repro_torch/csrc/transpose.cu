// Tiled last-two-axes transpose for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/fft/fft_kernel.py:
//   repro_transpose  <- transpose_pallas (def :577; body _transpose_body
//                       :306): k (B, R, C) planes -> (B, C, R)
// It is the plan graph's explicit transpose node (repro_torch/fft/plan_nd):
// the hand-off after an axis whose FFT cannot fuse the transposed write (a
// Bluestein or long four-step axis), and the rotation past a length-1 axis
// (real data there, for a length-1 last axis of an r2c spec).
//
// What bounds it: memory.  It reads and writes every element once and
// computes nothing: 2 * B * R * C * elem_bytes over 3.35 TB/s.
//
// What the design does about it: a 32 x 32 tile goes through shared memory,
// so both the read (a warp along C) and the write (a warp along R) touch
// consecutive addresses.  Each tile row is padded to 33 elements, so that
// reading a tile column hits 32 distinct banks for 4-byte elements, and
// distinct bank groups in each 8- or 16-byte access phase.  The kernel is
// templated on the element width — 4 bytes (float32), 8 (complex64, and
// float64) and 16 (complex128) — and moves elements as opaque words, so it
// keeps the input's dtype as the reference does.  Any R and C are taken:
// the edge tiles are masked, never padded (the reference needs
// R % tile_r == 0 and C % tile_c == 0).  Complex data stays interleaved,
// one transpose of one plane, where the TPU kernel transposes re and im as
// two planes.
//
// Interface: a plain C function on device pointers, launched on the given
// stream; it returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

extern "C" const char* repro_fft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // blockDim = (kTile, kRowsPerPass)

// (B, R, C) -> (B, C, R).  Block i handles one 32 x 32 tile of one batch
// entry; blocks are numbered batch-major, then tile row, then tile column.
template <typename T>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
    transpose_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                     int cols, long long tiles_r, long long tiles_c) {
  __shared__ T tile[kTile][kTile + 1];
  const long long bid = blockIdx.x;
  const long long per_batch = tiles_r * tiles_c;
  const long long batch = bid / per_batch;
  const long long rest = bid - batch * per_batch;
  const int r0 = static_cast<int>(rest / tiles_c) * kTile;
  const int c0 = static_cast<int>(rest % tiles_c) * kTile;
  const size_t base = static_cast<size_t>(batch) * rows * cols;
  // Read: warp i reads tile row i along C.
  const int c = c0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRowsPerPass) {
    const int r = r0 + i;
    if (r < rows && c < cols)
      tile[i][threadIdx.x] = x[base + static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
  // Write: warp i writes output row c0 + i along R.
  const int r = r0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRowsPerPass) {
    const int cc = c0 + i;
    if (r < rows && cc < cols)
      y[base + static_cast<size_t>(cc) * rows + r] = tile[threadIdx.x][i];
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long batch, int rows,
                   int cols, cudaStream_t stream) {
  const long long tiles_r = (rows + kTile - 1) / kTile;
  const long long tiles_c = (cols + kTile - 1) / kTile;
  const long long blocks = batch * tiles_r * tiles_c;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  transpose_kernel<T><<<static_cast<unsigned>(blocks),
                        dim3(kTile, kRowsPerPass), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, cols, tiles_r,
      tiles_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_transpose(const void* x, void* y, long long batch, int rows,
                    int cols, int elem_bytes, void* stream) {
  if (rows < 1 || cols < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 4:
      return launch<float>(x, y, batch, rows, cols, s);
    case 8:
      return launch<float2>(x, y, batch, rows, cols, s);
    case 16:
      return launch<float4>(x, y, batch, rows, cols, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
