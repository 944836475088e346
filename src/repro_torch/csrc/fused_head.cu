// Kernel A: the tile pass of the fused dense head.  Over a (B, ny, nx)
// stride-1 window grid it reads the three SATs that kernel S wrote,
// computes each window's 1/sigma, then the vote sums of every stage of the
// dense run [s0, s1), and writes inv (B, ny, nx) and sums (B, n_run, ny,
// nx).
//
// Replaces: src/repro/kernels/fused_head.py::_fused_kernel (driver
// fused_head_kernel), all but its SAT build.  On the TPU the grid runs in
// order, so grid step (0, 0) could build the SATs into VMEM for every later
// step.  CUDA blocks run in no order and three 480x640 tables (~3.7 MB) are
// far over a block's 227 KB of shared memory, so the SATs come from kernel S
// in device memory (L2-resident at these sizes) and this launch is the
// tile pass only: the port's fused head is two launches, S then A.
//
// Launch shape: the plan's head_tile (ty, tx), as the TPU kernel's block
// (haar_stage.head_block_shape maps it): a block of tx x ty/4 threads
// covers ty x tx window origins, each thread 4 windows down one column
// (fewer when ty < 4).  4 rather than ty windows per thread: more share
// each parameter read but lengthen each thread's serial chain, which the
// small pyramid levels, where few blocks run, pay for.
//
// Orderings, kept exactly as the TPU kernel has them:
//   1/sigma: corners d - b - c + a, var = s2/576 - (s1/576)^2,
//            1/sqrt(max(var, 1));
//   sums:    corners (d - b) - (c - a), feat * inv * (1/576), all three
//            rectangles in order, votes in ascending k.
//
// Bound on the H100: by the card's peak rates, operations (about twenty
// float operations per weak classifier per window against one read of each
// SAT).  What held the first version (one window per thread, the SAT read
// from L1, twelve corner loads and the whole weak-classifier record per
// window) was the load pipe: about 35 wavefronts per warp and classifier.
// This design (common.cuh dense_block) feeds the arithmetic instead:
//   - the block's (ty + 24) x (tx + 24) window of the SAT is staged once in
//     shared memory by 4-byte cp.async copies (all in flight while the
//     block computes 1/sigma), column-major with an odd column height, so
//     a warp's corner read is one conflict-free wavefront and a thread's
//     windows are immediate offsets of one address;
//   - the loop runs over weak classifiers outside and the thread's
//     windows inside: one read of the classifier's parameters (four
//     16-byte broadcasts) serves 4 windows;
//   - adjacent rectangles share corners, read once (common.cuh corners, as
//     kernel C): 7 or 8 reads per window and classifier instead of 12;
//   - corner offsets are int32 tile offsets computed once per block;
//   - weak classifiers go through shared memory in chunks of 128, so any
//     run (all 25 stages, 2,913 classifiers, in mode "dense") fits;
//   - a warp whose windows all lie past the grid (the ragged last block)
//     skips the votes.
// The four corners of ii2 and iic per window for 1/sigma are read from
// device memory, once per window.

#include "common.cuh"

namespace {

using repro_torch::kDenseMaxThreads;

__device__ inline float window_sum(const float* __restrict__ t, int stride) {
  const int W = repro_torch::WINDOW;
  const float a = t[0];
  const float b = t[W];
  const float c = t[(size_t)W * stride];
  const float d = t[(size_t)W * stride + W];
  return d - b - c + a;
}

template <int RPT>
__global__ void __launch_bounds__(kDenseMaxThreads, 1)
    fused_tiles(const float* __restrict__ ii, const float* __restrict__ ii2,
                const float* __restrict__ iic, float* __restrict__ inv_out,
                float* __restrict__ sums, int H1, int W1, const int* __restrict__ rect_xywh,
                const float* __restrict__ rect_w, const float* __restrict__ theta,
                const float* __restrict__ left, const float* __restrict__ right,
                const int* __restrict__ stage_offsets, int s0, int s1, int k0, int k1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ny = H1 - repro_torch::WINDOW;
  const int nx = W1 - repro_torch::WINDOW;
  const int x = repro_torch::dense_col();
  const int y0 = repro_torch::dense_row0<RPT>();
  const int b = blockIdx.z;
  const size_t image = (size_t)b * H1 * W1;
  const size_t plane = (size_t)ny * nx;
  const float n = repro_torch::AREA;
  // the SAT tile's copy runs while the windows' 1/sigma is computed
  repro_torch::stage_tile_async(repro_torch::dense_tile(smem, k1 - k0), ii + image, H1, W1,
                                blockDim.y * RPT);

  float inv[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    inv[j] = 0.0f;
    if (x < nx && y0 + j < ny) {
      const size_t corner = image + (size_t)(y0 + j) * W1 + x;
      const float s2 = window_sum(ii2 + corner, W1);
      const float s1w = window_sum(iic + corner, W1);
      const float mean = s1w / n;
      const float var = s2 / n - mean * mean;
      inv[j] = 1.0f / sqrtf(var < 1.0f ? 1.0f : var);
      inv_out[(size_t)b * plane + (size_t)(y0 + j) * nx + x] = inv[j];
    }
  }
  repro_torch::dense_block<RPT>(smem, ny, nx, inv, rect_xywh, rect_w, theta, left, right,
                                stage_offsets, s0, s1 - s0, k0, k1 - k0,
                                sums + (size_t)b * (s1 - s0) * plane, plane);
}

template <int RPT>
cudaError_t launch(const float* ii, const float* ii2, const float* iic, float* inv,
                   float* sums, int B, int H1, int W1, const int* rect_xywh,
                   const float* rect_w, const float* theta, const float* left,
                   const float* right, const int* stage_offsets, int s0, int s1, int k0,
                   int k1, dim3 block, cudaStream_t stream) {
  const int ty = block.y * RPT;
  const size_t smem = repro_torch::dense_smem_bytes(ty, block.x, k1 - k0);
  cudaError_t err = repro_torch::reserve_smem(fused_tiles<RPT>, smem);
  if (err != cudaSuccess) return err;
  const int ny = H1 - repro_torch::WINDOW;
  const int nx = W1 - repro_torch::WINDOW;
  const dim3 grid((nx + block.x - 1) / block.x, (ny + ty - 1) / ty, B);
  fused_tiles<RPT><<<grid, block, smem, stream>>>(ii, ii2, iic, inv, sums, H1, W1, rect_xywh,
                                                  rect_w, theta, left, right, stage_offsets,
                                                  s0, s1, k0, k1);
  return cudaGetLastError();
}

}  // namespace

// A block of bx x by threads, rpt windows per thread (rpt in {1, 2, 4}; bx
// a multiple of 32; bx * by at most kDenseMaxThreads, or the launch fails)
// covers a tile of (by * rpt) x bx window origins.
extern "C" int fused_head_tiles(const float* ii, const float* ii2, const float* iic,
                                float* inv, float* sums, int B, int H1, int W1,
                                const int* rect_xywh, const float* rect_w,
                                const float* theta, const float* left,
                                const float* right, const int* stage_offsets, int s0,
                                int s1, int k0, int k1, int rpt, int bx, int by, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bx < 32 || bx % 32 != 0 || by < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const cudaStream_t st = (cudaStream_t)stream;
#define REPRO_LAUNCH(RPT)                                                                  \
  case RPT:                                                                                \
    return (int)launch<RPT>(ii, ii2, iic, inv, sums, B, H1, W1, rect_xywh, rect_w, theta, \
                            left, right, stage_offsets, s0, s1, k0, k1, block, st)
  switch (rpt) {
    REPRO_LAUNCH(1);
    REPRO_LAUNCH(2);
    REPRO_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}
