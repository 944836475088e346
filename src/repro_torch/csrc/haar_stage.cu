// Kernel B: one stage's vote sums over a stride-1 window grid, for the split
// dense head.  Over a (B, ny, nx) grid it reads the padded SAT (B, H1, W1),
// H1 >= ny + 24 and W1 >= nx + 24, and the 1/sigma grid (B, ny, nx) the
// caller gives it, and writes the stage's sums (B, ny, nx).
//
// Replaces: src/repro/kernels/haar_stage.py::_stage_kernel (driver
// haar_stage_sums_kernel).  The per-window arithmetic is kernel A's:
// corners (d - b) - (c - a), feat * inv * (1/576), all three rectangles,
// votes in ascending k.
//
// Launch shape: the plan's head_tile (ty, tx), as the TPU kernel's block
// and as kernel A's (haar_stage.head_block_shape maps it): a block of tx x
// ty/4 threads covers ty x tx window origins, 4 windows per thread down
// one column.
//
// Bound on the H100: by peak rates, operations (about twenty float
// operations per weak classifier per window, against one read of the SAT
// and the 1/sigma grid).  The block body is kernel A's (common.cuh
// dense_block): the block's SAT window staged once in shared memory by
// cp.async copies (conflict-free corner reads, the thread's windows at
// immediate offsets), weak classifiers outside and the thread's windows
// inside (one parameter read per 4 windows), shared corners read once,
// int32 tile offsets computed once per block, and the stage's weak
// classifiers (211 in the paper cascade's largest stage) in chunks of
// 128.  On the TPU the parameters were scalar-prefetched into SMEM; a
// block loads its own here.

#include "common.cuh"

namespace {

using repro_torch::kDenseMaxThreads;

template <int RPT>
__global__ void __launch_bounds__(kDenseMaxThreads, 1)
    stage_sums(const float* __restrict__ ii, const float* __restrict__ inv_in,
               float* __restrict__ out, int H1, int W1, int ny, int nx,
               const int* __restrict__ rect_xywh, const float* __restrict__ rect_w,
               const float* __restrict__ theta, const float* __restrict__ left,
               const float* __restrict__ right, const int* __restrict__ stage_offsets,
               int s, int k0, int k1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x = repro_torch::dense_col();
  const int y0 = repro_torch::dense_row0<RPT>();
  const int b = blockIdx.z;
  const size_t plane = (size_t)ny * nx;
  repro_torch::stage_tile_async(repro_torch::dense_tile(smem, k1 - k0),
                                ii + (size_t)b * H1 * W1, H1, W1, blockDim.y * RPT);
  float inv[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    inv[j] = (x < nx && y0 + j < ny) ? inv_in[(size_t)b * plane + (size_t)(y0 + j) * nx + x]
                                     : 0.0f;
  repro_torch::dense_block<RPT>(smem, ny, nx, inv, rect_xywh, rect_w, theta, left, right,
                                stage_offsets, s, 1, k0, k1 - k0, out + (size_t)b * plane, 0);
}

template <int RPT>
cudaError_t launch(const float* ii, const float* inv, float* out, int B, int H1, int W1,
                   int ny, int nx, const int* rect_xywh, const float* rect_w,
                   const float* theta, const float* left, const float* right,
                   const int* stage_offsets, int s, int k0, int k1, dim3 block,
                   cudaStream_t stream) {
  const int ty = block.y * RPT;
  const size_t smem = repro_torch::dense_smem_bytes(ty, block.x, k1 - k0);
  cudaError_t err = repro_torch::reserve_smem(stage_sums<RPT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nx + block.x - 1) / block.x, (ny + ty - 1) / ty, B);
  stage_sums<RPT><<<grid, block, smem, stream>>>(ii, inv, out, H1, W1, ny, nx, rect_xywh,
                                                 rect_w, theta, left, right, stage_offsets, s,
                                                 k0, k1);
  return cudaGetLastError();
}

}  // namespace

// A block of bx x by threads, rpt windows per thread (rpt in {1, 2, 4}; bx
// a multiple of 32; bx * by at most kDenseMaxThreads, or the launch fails)
// covers a tile of (by * rpt) x bx window origins.
extern "C" int haar_stage_sums(const float* ii, const float* inv, float* out, int B,
                               int H1, int W1, int ny, int nx, const int* rect_xywh,
                               const float* rect_w, const float* theta,
                               const float* left, const float* right,
                               const int* stage_offsets, int s, int k0, int k1, int rpt,
                               int bx, int by, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bx < 32 || bx % 32 != 0 || by < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const cudaStream_t st = (cudaStream_t)stream;
#define REPRO_LAUNCH(RPT)                                                                   \
  case RPT:                                                                                 \
    return (int)launch<RPT>(ii, inv, out, B, H1, W1, ny, nx, rect_xywh, rect_w, theta, left, \
                            right, stage_offsets, s, k0, k1, block, st)
  switch (rpt) {
    REPRO_LAUNCH(1);
    REPRO_LAUNCH(2);
    REPRO_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}
