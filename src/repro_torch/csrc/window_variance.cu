// Kernel D: the stride-1 grid of 24x24 window 1/sigma values.  One thread per
// window origin of a (B, ny, nx) grid reads the padded SATs of the centred
// square and the centred image (ii2, iic: B tables of H1 x W1) and writes
// inv (B, ny, nx).
//
// Replaces: src/repro/kernels/window_variance.py::_inv_sigma_kernel (entry point
// window_inv_sigma_kernel), called through repro.kernels.ops
// .window_inv_sigma_grid(_batch).  No detection engine calls it; the public
// kernel API does.
//
// Arithmetic, kept exactly as the TPU kernel has it (and not as kernel A's
// 1/sigma, which combines corners d - b - c + a):
//   s  = (d - b) - (c - a)           for each of ii2 and iic,
//   var = s2/576 - (s1/576) * (s1/576),
//   inv = 1 / sqrt(max(var, 1))      sqrtf and the division as two IEEE
//                                    operations (rsqrtf is not correctly
//                                    rounded, so it could not equal the
//                                    plain version).
// Corner rows and columns past the table are clamped to its last row and
// column: that is the edge padding of the reference wrapper, which lets ny
// and nx reach past the grid the tables hold.
//
// Bound on the H100: bytes (two table reads and one grid write; about ten
// float operations per window).  Neighbouring threads take neighbouring x, so
// each of a warp's eight corner loads is one coalesced row segment; the
// four corners of a table are read by the warps 24 rows and 24 columns away
// as well, so most of them hit in L1/L2 and the traffic stays near the bytes
// bound.  A tiled version staging rows in shared memory is later work.
//
// The tables may be strided along B (batch_stride elements between images),
// so a stacked (B, 2, H1, W1) pair is read in place.

#include "common.cuh"

namespace {

__device__ inline float window_sum(const float* __restrict__ t, int y0, int y1, int x0,
                                   int x1, int W1) {
  const float a = t[(size_t)y0 * W1 + x0];
  const float b = t[(size_t)y0 * W1 + x1];
  const float c = t[(size_t)y1 * W1 + x0];
  const float d = t[(size_t)y1 * W1 + x1];
  return (d - b) - (c - a);
}

__global__ void inv_sigma(const float* __restrict__ ii2, const float* __restrict__ iic,
                          long long stride2, long long stridec, float* __restrict__ out,
                          int H1, int W1, int ny, int nx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || y >= ny) return;
  const int W = repro_torch::WINDOW;
  const int y0 = min(y, H1 - 1);
  const int y1 = min(y + W, H1 - 1);
  const int x0 = min(x, W1 - 1);
  const int x1 = min(x + W, W1 - 1);
  const float n = repro_torch::AREA;
  const float s2 = window_sum(ii2 + (size_t)b * stride2, y0, y1, x0, x1, W1);
  const float s1 = window_sum(iic + (size_t)b * stridec, y0, y1, x0, x1, W1);
  const float mean = s1 / n;
  const float var = s2 / n - mean * mean;
  out[((size_t)b * ny + y) * nx + x] = 1.0f / sqrtf(var < 1.0f ? 1.0f : var);
}

}  // namespace

extern "C" int window_inv_sigma(const float* ii2, const float* iic, long long stride2,
                                long long stridec, float* out, int B, int H1, int W1,
                                int ny, int nx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y, B);
  inv_sigma<<<grid, block, 0, (cudaStream_t)stream>>>(ii2, iic, stride2, stridec, out,
                                                      H1, W1, ny, nx);
  return (int)cudaGetLastError();
}
