// Kernel B: one stage's vote sums over a stride-1 window grid, for the split
// dense head.  One thread per window origin of a (B, ny, nx) grid reads the
// padded SAT (B, ny+24, nx+24) and the 1/sigma grid (B, ny, nx) the caller
// gives it, and writes the stage's sums (B, ny, nx).
//
// Replaces: src/repro/kernels/haar_stage.py::_stage_kernel (driver
// haar_stage_sums_kernel).  The per-window body is kernel A's stage sum
// (common.cuh dense_stage_sum): corners (d - b) - (c - a), feat * inv *
// (1/576), all three rectangles, votes in ascending k.
//
// Bound on the H100: by peak rates, operations (about twenty float
// operations per weak classifier per window, against one read of the SAT
// and the 1/sigma grid); in practice the cached corner loads.  The stage's
// weak classifiers (the largest stage of the paper cascade has 211, about
// 15 KB) are staged in shared memory once per block and read as broadcasts;
// a warp's corner loads are coalesced row segments.  On the TPU the
// parameters were scalar-prefetched into SMEM; a block loads its own here.

#include "common.cuh"

namespace {

using repro_torch::WeakClassifier;

__global__ void stage_sums(const float* __restrict__ ii, const float* __restrict__ inv,
                           float* __restrict__ out, int H1, int W1, int ny, int nx,
                           const int* __restrict__ rect_xywh,
                           const float* __restrict__ rect_w,
                           const float* __restrict__ theta,
                           const float* __restrict__ left,
                           const float* __restrict__ right,
                           const int* __restrict__ stage_offsets, int s, int k0, int k1) {
  extern __shared__ unsigned char smem[];
  WeakClassifier* wc = reinterpret_cast<WeakClassifier*>(smem);
  int* bounds = reinterpret_cast<int*>(wc + (k1 - k0));
  repro_torch::stage_params(wc, bounds, rect_xywh, rect_w, theta, left, right,
                            stage_offsets, s, s + 1, k0, k1);

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || y >= ny) return;
  const size_t cell = (size_t)b * ny * nx + (size_t)y * nx + x;
  const float* corner = ii + (size_t)b * H1 * W1 + (size_t)y * W1 + x;
  out[cell] = repro_torch::dense_stage_sum(wc, bounds[0], bounds[1], corner, W1, inv[cell]);
}

}  // namespace

extern "C" int haar_stage_sums(const float* ii, const float* inv, float* out, int B,
                               int H1, int W1, int ny, int nx, const int* rect_xywh,
                               const float* rect_w, const float* theta,
                               const float* left, const float* right,
                               const int* stage_offsets, int s, int k0, int k1,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = repro_torch::stage_smem_bytes(k1 - k0, 1);
  err = repro_torch::reserve_smem(stage_sums, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y, B);
  stage_sums<<<grid, block, smem, (cudaStream_t)stream>>>(
      ii, inv, out, H1, W1, ny, nx, rect_xywh, rect_w, theta, left, right,
      stage_offsets, s, k0, k1);
  return (int)cudaGetLastError();
}
