// Kernel S: the SAT phase.  Builds, for a (B, H, W) float32 stack, the three
// padded (B, H+1, W+1) summed-area tables the detector reads: ii of the
// image, ii2 of (img - 128)^2 and iic of (img - 128), each with a zero top
// row and left column.
//
// Replaces: src/repro/kernels/integral_image.py::integral_image_kernel
// (_row_scan_kernel + _col_scan_kernel), and phase 1 of
// src/repro/kernels/fused_head.py::_fused_kernel (the SAT build that grid
// step (0, 0) does on the TPU).
//
// Order.  One pinned order for every SAT the port makes: a column scan, then
// a row scan, each serial, each accumulating in double and rounding every
// entry to float32.  That is what torch.cumsum does on the CPU for float32
// (it accumulates in double), so the plain version in
// repro_torch/kernels/integral_image.py gives these bits on any device, and
// the fused and split heads, which both take their tables from this kernel,
// see the same SAT.
//
// Bound on the H100: bytes.  The work is a few adds per pixel; the least
// traffic is one read of the image and one write of each table.  This
// design moves about twice that (the row pass reads back what the column
// pass wrote) and its row pass is not coalesced: one thread walks one row.
// It is simple and right first; a transposed, tiled scan is later work.

#include "common.cuh"

namespace {

__global__ void sat_columns(const float* __restrict__ img, float* __restrict__ ii,
                            float* __restrict__ ii2, float* __restrict__ iic, int H,
                            int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;  // table column 0..W
  const int b = blockIdx.y;
  const int W1 = W + 1;
  if (x > W) return;
  const size_t out = (size_t)b * (H + 1) * W1;
  ii[out + x] = 0.0f;
  ii2[out + x] = 0.0f;
  iic[out + x] = 0.0f;
  if (x == 0) {
    for (int y = 1; y <= H; ++y) {
      ii[out + (size_t)y * W1] = 0.0f;
      ii2[out + (size_t)y * W1] = 0.0f;
      iic[out + (size_t)y * W1] = 0.0f;
    }
    return;
  }
  const float* src = img + (size_t)b * H * W + (x - 1);
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
  for (int y = 0; y < H; ++y) {
    const float v = src[(size_t)y * W];
    const float c = v - 128.0f;
    const float c2 = c * c;
    a0 += (double)v;
    a1 += (double)c2;
    a2 += (double)c;
    const size_t o = out + (size_t)(y + 1) * W1 + x;
    ii[o] = (float)a0;
    ii2[o] = (float)a1;
    iic[o] = (float)a2;
  }
}

__global__ void sat_rows(float* __restrict__ ii, float* __restrict__ ii2,
                         float* __restrict__ iic, int H, int W) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x + 1;  // table row 1..H
  const int b = blockIdx.y;
  if (y > H) return;
  const size_t row = (size_t)b * (H + 1) * (W + 1) + (size_t)y * (W + 1);
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
  for (int x = 1; x <= W; ++x) {
    a0 += (double)ii[row + x];
    a1 += (double)ii2[row + x];
    a2 += (double)iic[row + x];
    ii[row + x] = (float)a0;
    ii2[row + x] = (float)a1;
    iic[row + x] = (float)a2;
  }
}

}  // namespace

extern "C" int sat_tables(const float* img, float* ii, float* ii2, float* iic, int B,
                          int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  sat_columns<<<dim3((W + 1 + threads - 1) / threads, B), threads, 0, s>>>(img, ii, ii2,
                                                                          iic, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sat_rows<<<dim3((H + threads - 1) / threads, B), threads, 0, s>>>(ii, ii2, iic, H, W);
  return (int)cudaGetLastError();
}
