// Kernel A: the tile pass of the fused dense head.  One thread per window
// origin of a (B, ny, nx) stride-1 grid reads the three SATs that kernel S
// wrote, computes the window's 1/sigma, then every stage of the dense run
// [s0, s1), and writes inv (B, ny, nx) and sums (B, n_run, ny, nx).
//
// Replaces: src/repro/kernels/fused_head.py::_fused_kernel (driver
// fused_head_kernel), all but its SAT build.  On the TPU the grid runs in
// order, so grid step (0, 0) could build the SATs into VMEM for every later
// step.  CUDA blocks run in no order and three 480x640 tables (~3.7 MB) are
// far over a block's 227 KB of shared memory, so the SATs come from kernel S
// in device memory (L2-resident at these sizes) and this launch is the
// tile pass only: the port's fused head is two launches, S then A.
//
// Orderings, kept exactly as the TPU kernel has them:
//   1/sigma: corners d - b - c + a, var = s2/576 - (s1/576)^2,
//            1/sqrt(max(var, 1));
//   sums:    corners (d - b) - (c - a), feat * inv * (1/576), all three
//            rectangles in order, votes in ascending k.
//
// Bound on the H100: by the card's peak rates, operations (about twenty
// float operations per weak classifier per window against one read of each
// SAT).  In practice the corner loads bound it: four scattered-but-cached
// loads per rectangle.  Neighbouring threads take neighbouring x, so each
// corner load of a warp is one coalesced row segment, and the weak
// classifiers of the run (at most a few KB) are staged once per block in
// shared memory, where every thread reads the same entry (a broadcast).
// This replaces the scalar prefetch of the TPU kernel.

#include "common.cuh"

namespace {

using repro_torch::WeakClassifier;

__device__ inline float window_sum(const float* __restrict__ t, int stride) {
  const int W = repro_torch::WINDOW;
  const float a = t[0];
  const float b = t[W];
  const float c = t[(size_t)W * stride];
  const float d = t[(size_t)W * stride + W];
  return d - b - c + a;
}

__global__ void fused_tiles(const float* __restrict__ ii, const float* __restrict__ ii2,
                            const float* __restrict__ iic, float* __restrict__ inv_out,
                            float* __restrict__ sums, int H1, int W1,
                            const int* __restrict__ rect_xywh,
                            const float* __restrict__ rect_w,
                            const float* __restrict__ theta,
                            const float* __restrict__ left,
                            const float* __restrict__ right,
                            const int* __restrict__ stage_offsets, int s0, int s1,
                            int k0, int k1) {
  extern __shared__ unsigned char smem[];
  WeakClassifier* wc = reinterpret_cast<WeakClassifier*>(smem);
  int* bounds = reinterpret_cast<int*>(wc + (k1 - k0));
  repro_torch::stage_params(wc, bounds, rect_xywh, rect_w, theta, left, right,
                            stage_offsets, s0, s1, k0, k1);

  const int ny = H1 - repro_torch::WINDOW;
  const int nx = W1 - repro_torch::WINDOW;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || y >= ny) return;

  const size_t corner = (size_t)b * H1 * W1 + (size_t)y * W1 + x;
  const float n = repro_torch::AREA;
  const float s2 = window_sum(ii2 + corner, W1);
  const float s1w = window_sum(iic + corner, W1);
  const float mean = s1w / n;
  const float var = s2 / n - mean * mean;
  const float inv = 1.0f / sqrtf(var < 1.0f ? 1.0f : var);

  const size_t plane = (size_t)ny * nx;
  const size_t cell = (size_t)y * nx + x;
  inv_out[(size_t)b * plane + cell] = inv;
  const int n_run = s1 - s0;
  float* out = sums + (size_t)b * n_run * plane + cell;
  for (int si = 0; si < n_run; ++si)
    out[si * plane] = repro_torch::dense_stage_sum(wc, bounds[si], bounds[si + 1],
                                                   ii + corner, W1, inv);
}

}  // namespace

extern "C" int fused_head_tiles(const float* ii, const float* ii2, const float* iic,
                                float* inv, float* sums, int B, int H1, int W1,
                                const int* rect_xywh, const float* rect_w,
                                const float* theta, const float* left,
                                const float* right, const int* stage_offsets, int s0,
                                int s1, int k0, int k1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = repro_torch::stage_smem_bytes(k1 - k0, s1 - s0);
  err = repro_torch::reserve_smem(fused_tiles, smem);
  if (err != cudaSuccess) return (int)err;
  const int ny = H1 - repro_torch::WINDOW;
  const int nx = W1 - repro_torch::WINDOW;
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y, B);
  fused_tiles<<<grid, block, smem, (cudaStream_t)stream>>>(
      ii, ii2, iic, inv, sums, H1, W1, rect_xywh, rect_w, theta, left, right,
      stage_offsets, s0, s1, k0, k1);
  return (int)cudaGetLastError();
}
