// Kernel C: vote sums of the stage run [s0, s1) over a packed window list,
// the compacted tail of the batched detector.  One thread per lane; each
// lane carries an image index, the flat SAT base and row stride of its
// pyramid level, its window origin (y, x) and its 1/sigma.  Output is
// (n_run, cap).
//
// Replaces: src/repro/kernels/packed_window.py::_packed_kernel (driver
// packed_stage_sums_kernel), the "pallas" backend of
// src/repro/kernels/packed_tail.py::stage_sums.  The port keeps that
// backend label; it names this hand-written blocked kernel.
//
// Semantics kept from the TPU kernel: corners d - b - c + a, feat * inv /
// 576, all three rectangles, votes in ascending k per stage, and every
// SAT read clamps its flat index into [0, N - 1] as jnp.take(mode="clip")
// does.  The flat offset img * n_sat + base is formed in 64 bits: eight
// 480x640 images already give about 8.1 M SAT entries, and larger batches
// would pass 2^31.
//
// Bound on the H100: by peak rates, operations (about twenty float
// operations per weak classifier per lane); in practice the latency of
// twelve dependent-address gathers per weak classifier, which hit L2
// because the lanes of a warp sit near each other on one level.  Lanes
// that compaction left invalid all point at slot 0 and read the same few
// lines.  The run's weak classifiers are staged once per block in shared
// memory, as in kernels A and B.

#include "common.cuh"

namespace {

using repro_torch::WeakClassifier;

__global__ void packed_sums(const float* __restrict__ sat, long long n_total,
                            long long n_sat, const int* __restrict__ img,
                            const int* __restrict__ base, const int* __restrict__ stride,
                            const int* __restrict__ ys, const int* __restrict__ xs,
                            const float* __restrict__ inv, float* __restrict__ out,
                            int cap, const int* __restrict__ rect_xywh,
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

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= cap) return;
  const long long off = (long long)img[lane] * n_sat + base[lane];
  const long long st = stride[lane];
  const long long y = ys[lane];
  const long long x = xs[lane];
  const float iv = inv[lane];
  const long long last = n_total - 1;
  auto at = [&](long long yy, long long xx) {
    long long i = off + yy * st + xx;
    i = i < 0 ? 0 : (i > last ? last : i);
    return sat[i];
  };

  for (int si = 0; si < s1 - s0; ++si) {
    float acc = 0.0f;
    for (int k = bounds[si]; k < bounds[si + 1]; ++k) {
      const WeakClassifier& c = wc[k];
      float feat = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const long long y0 = y + c.rect[r][1];
        const long long x0 = x + c.rect[r][0];
        const long long y1 = y0 + c.rect[r][3];
        const long long x1 = x0 + c.rect[r][2];
        const float area = at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0);
        feat = feat + c.w[r] * area;
      }
      const float f_norm = feat * iv / repro_torch::AREA;
      acc = acc + (f_norm < c.theta ? c.left : c.right);
    }
    out[(size_t)si * cap + lane] = acc;
  }
}

}  // namespace

extern "C" int packed_stage_sums(const float* sat, long long n_total, long long n_sat,
                                 const int* img, const int* base, const int* stride,
                                 const int* ys, const int* xs, const float* inv,
                                 float* out, int cap, const int* rect_xywh,
                                 const float* rect_w, const float* theta,
                                 const float* left, const float* right,
                                 const int* stage_offsets, int s0, int s1, int k0,
                                 int k1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = repro_torch::stage_smem_bytes(k1 - k0, s1 - s0);
  err = repro_torch::reserve_smem(packed_sums, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  packed_sums<<<(cap + threads - 1) / threads, threads, smem, (cudaStream_t)stream>>>(
      sat, n_total, n_sat, img, base, stride, ys, xs, inv, out, cap, rect_xywh, rect_w,
      theta, left, right, stage_offsets, s0, s1, k0, k1);
  return (int)cudaGetLastError();
}
