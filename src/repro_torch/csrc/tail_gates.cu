// Kernel E: the stage gates and per-image survivor counts of one tail
// segment, the step that follows kernel C's sums in the batched tail.
//
// Inputs: ss (k, cap) float32 stage sums of the segment's k stages (any
// tail backend's), thr (k,) float32 stage thresholds, valid (cap,) bool,
// b_sel (cap,) int64 image index of each lane, n_live (a 0-dim int64 device
// scalar) and counts (k, B) int32.  For each lane l
// below min(*n_live, cap):
//   valid[l] &= ss[0][l] >= thr[0] & ... & ss[k-1][l] >= thr[k-1]
// (float32 comparisons, stage by stage), and counts[j][b_sel[l]] gains one
// for each stage j after which the lane is still valid.  Lanes at or past
// the live count are neither read nor written: a compaction leaves them
// invalid, so they count nothing.  A lane whose image index lies outside
// [0, B) counts nothing either.  The counts are integers, so the result is
// exact and does not depend on the launch or on the order of the adds.
//
// Replaces, in the batched tail: per stage, a compare, an and, a cast, a
// zeroed (B,) tensor and an index_add_ over every capacity lane of the
// segment.  The index_add_ issued one global atomic per capacity lane, and
// every dead lane's (image 0, add 0) went to one address.
//
// Bound on the H100: memory, about 22 bytes a live lane and stage (the sums,
// the image index, the mask in and out): microseconds a segment.  What the
// design does about it:
//   - live count: n_live is read on the device, so the host never syncs,
//     and the live prefix is split into contiguous, warp-aligned shares over
//     a grid of about kBlocksPerSm blocks per SM, so a short prefix (the
//     later segments) still spreads over the card; a block without a share
//     exits at once.
//   - no per-lane global atomic: each warp walks its own contiguous piece 32
//     lanes at a time.  The compactions keep ascending flat order, so the
//     image index does not decrease along the prefix and a warp's 32 lanes
//     are nearly always one image: then lane j of the warp adds the popcount
//     of stage j's ballot to a register (k <= 32 stages a launch).  Where
//     the lanes hold several images (__match_any_sync), the warp first hands
//     its register counts on, then each image's leader adds its lanes'
//     popcount.  Those adds go to a shared-memory bin per (stage, image)
//     for kBins images from the block's first one (from image 0 where B <=
//     kBins, so any order of b_sel stays in shared memory); other images go
//     to global memory directly.  At the end the block adds each non-zero
//     bin to counts: one global add per (block, stage, image present).
//   - coalescing: a warp's loads of the sums, image indices and mask are
//     consecutive; a lane already invalid reads no sum.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStages = 32;   // stages a launch gates (one count register a warp lane)
constexpr int kBins = 64;        // images a block counts in shared memory
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// Adds c survivors of stage j to image b: into the block's bins when b lies
// in [b_base, b_base + kBins), else straight into counts.
__device__ __forceinline__ void add_count(int* bins, int* __restrict__ counts, int n_img,
                                          long long b_base, long long b, int j, int c) {
  if (c == 0 || b < 0 || b >= n_img) return;
  const long long i = b - b_base;
  if (i >= 0 && i < kBins)
    atomicAdd(&bins[j * kBins + i], c);
  else
    atomicAdd(&counts[(size_t)j * n_img + b], c);
}

__global__ void __launch_bounds__(kThreads)
    gate_counts(const float* __restrict__ ss, long long cap, const float* __restrict__ thr,
                int k, unsigned char* __restrict__ valid, const long long* __restrict__ b_sel,
                const long long* __restrict__ n_live, int* __restrict__ counts, int n_img) {
  __shared__ int bins[kMaxStages * kBins];
  const long long n = *n_live;
  const long long live = n < 0 ? 0 : (n < cap ? n : cap);
  const long long per = ((live + gridDim.x - 1) / gridDim.x + 31) / 32 * 32;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = min(lo + per, live);
  if (lo >= hi) return;  // no live lane in this block

  for (int i = threadIdx.x; i < k * kBins; i += blockDim.x) bins[i] = 0;
  long long b_base = 0;
  if (n_img > kBins) {
    const long long b0 = b_sel[lo];
    b_base = b0 < 0 ? 0 : (b0 > n_img - kBins ? n_img - kBins : b0);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const long long wper = ((hi - lo + n_warps - 1) / n_warps + 31) / 32 * 32;
  const long long wlo = lo + (long long)(threadIdx.x / 32) * wper;
  const long long whi = min(wlo + wper, hi);
  if (wlo < whi) {
    long long cur = b_sel[wlo];  // the image the count registers belong to
    int cnt = 0;                 // lane j < k: survivors of stage j in image `cur`
    for (long long c0 = wlo; c0 < whi; c0 += 32) {
      const long long l = c0 + lane;
      const bool in = l < whi;
      const long long b = in ? b_sel[l] : cur;
      const bool v0 = in && valid[l] != 0;
      const bool one = __all_sync(kFull, b == cur);
      unsigned group = 0;
      if (!one) {  // several images: hand the registers on, count by leader
        add_count(bins, counts, n_img, b_base, cur, lane, cnt);
        cnt = 0;
        group = __match_any_sync(kFull, b);
        cur = __shfl_sync(kFull, b, 31);
      }
      const bool leader = in && lane == __ffs(group) - 1;
      bool v = v0;
      for (int j = 0; j < k; ++j) {
        if (v) v = ss[(size_t)j * cap + l] >= thr[j];
        const unsigned bits = __ballot_sync(kFull, v);
        if (one) {
          if (lane == j) cnt += __popc(bits);
        } else if (leader) {
          add_count(bins, counts, n_img, b_base, b, j, __popc(bits & group));
        }
      }
      if (v0 && !v) valid[l] = 0;
    }
    add_count(bins, counts, n_img, b_base, cur, lane, cnt);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k * kBins; i += blockDim.x)
    if (bins[i] != 0) atomicAdd(&counts[(size_t)(i / kBins) * n_img + b_base + i % kBins], bins[i]);
}

}  // namespace

// 1 <= k <= 32 stages; cap > 0 lanes; n_img > 0 images; n_live a device
// pointer.  ss is (k, cap) and counts (k, n_img), both contiguous.
extern "C" int tail_gate_counts(const float* ss, long long cap, const float* thr, int k,
                                unsigned char* valid, const long long* b_sel,
                                const long long* n_live, int* counts, int n_img, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > kMaxStages || cap <= 0 || n_img <= 0) return (int)cudaErrorInvalidValue;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long need = (cap + kThreads - 1) / kThreads;
  const long long most = (long long)kBlocksPerSm * n_sm;
  const long long n_blocks = need < most ? need : most;
  gate_counts<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ss, cap, thr, k, valid, b_sel, n_live, counts, n_img);
  return (int)cudaGetLastError();
}
