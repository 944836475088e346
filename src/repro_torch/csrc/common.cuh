// Shared device code of the port's hand-written Hopper kernels.
//
// Every kernel here is compiled with -fmad=false and without
// --use_fast_math, so each float operation below is one IEEE-rounded
// operation in the order written: that is what makes a kernel equal, bit
// for bit, to its plain PyTorch version in the same Python module.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int WINDOW = 24;                 // detection window side (px)
constexpr float AREA = 576.0f;             // WINDOW * WINDOW
constexpr float INV_AREA = 1.0f / 576.0f;  // float32(1/576), as the TPU kernels use

// One weak classifier as staged in shared memory: up to three weighted
// rectangles (x, y, w, h relative to the window), the stump threshold and
// its two votes.  72 bytes, no padding.
struct WeakClassifier {
  int rect[3][4];
  float w[3];
  float theta;
  float left;
  float right;
};

inline size_t stage_smem_bytes(int n_weak, int n_run) {
  return sizeof(WeakClassifier) * (size_t)n_weak + sizeof(int) * (size_t)(n_run + 1);
}

// Raises a kernel's dynamic shared-memory limit when a stage run needs more
// than the default 48 KB; refuses runs over what one block may hold.
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// Copies weak classifiers [k0, k1) and the run's stage bounds (relative to
// k0) into the block's shared memory.  Every thread of the block must call
// it: it ends with a barrier.
__device__ inline void stage_params(WeakClassifier* wc, int* bounds,
                                    const int* __restrict__ rect_xywh,
                                    const float* __restrict__ rect_w,
                                    const float* __restrict__ theta,
                                    const float* __restrict__ left,
                                    const float* __restrict__ right,
                                    const int* __restrict__ stage_offsets,
                                    int s0, int s1, int k0, int k1) {
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int nt = blockDim.x * blockDim.y;
  for (int i = tid; i < k1 - k0; i += nt) {
    const int k = k0 + i;
    WeakClassifier c;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) c.rect[r][j] = rect_xywh[(k * 3 + r) * 4 + j];
      c.w[r] = rect_w[k * 3 + r];
    }
    c.theta = theta[k];
    c.left = left[k];
    c.right = right[k];
    wc[i] = c;
  }
  for (int i = tid; i <= s1 - s0; i += nt) bounds[i] = stage_offsets[s0 + i] - k0;
  __syncthreads();
}

// Vote sum of weak classifiers [kb, ke) for the window whose top-left SAT
// corner is `sat` (row stride `stride`), with the dense kernels' ordering:
// corners as (d - b) - (c - a), all three rectangles added in order (zero
// weights included), feat * inv * (1/576), votes added in ascending k.
__device__ inline float dense_stage_sum(const WeakClassifier* wc, int kb, int ke,
                                        const float* __restrict__ sat, int stride,
                                        float inv) {
  float acc = 0.0f;
  for (int k = kb; k < ke; ++k) {
    const WeakClassifier& c = wc[k];
    float feat = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* p = sat + (size_t)c.rect[r][1] * stride + c.rect[r][0];
      const size_t dy = (size_t)c.rect[r][3] * stride;
      const int dx = c.rect[r][2];
      const float a = p[0];
      const float b = p[dx];
      const float cc = p[dy];
      const float d = p[dy + dx];
      const float rs = (d - b) - (cc - a);
      feat = feat + c.w[r] * rs;
    }
    const float f_norm = feat * inv * INV_AREA;
    acc = acc + (f_norm < c.theta ? c.left : c.right);
  }
  return acc;
}

}  // namespace repro_torch

// Each kernel source builds into its own shared library, so each carries
// its own copy of this lookup for the Python side's error messages.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
