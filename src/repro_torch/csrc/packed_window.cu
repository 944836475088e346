// Kernel C: vote sums of the stage run [s0, s1) over a packed window list,
// the compacted tail of the batched detector.  Each lane carries an image
// index, the flat SAT base and row stride of its pyramid level, its window
// origin (y, x) and its 1/sigma.  Output is (n_run, cap).
//
// Replaces: src/repro/kernels/packed_window.py::_packed_kernel (driver
// packed_stage_sums_kernel), the "pallas" backend of
// src/repro/kernels/packed_tail.py::stage_sums.  The port keeps that
// backend label; it names this hand-written blocked kernel.
//
// Semantics kept from the TPU kernel: corners d - b - c + a, feat * inv /
// 576, all three rectangles, votes in ascending k per stage, and every
// SAT read clamps its flat index into [0, N - 1] as jnp.take(mode="clip")
// does.  Stages below s_dense (none on the batched tail, where s_dense <=
// s0) take the dense kernels' arithmetic instead, corners (d - b) - (c - a)
// and feat * inv * (1/576): the stream's incremental tail evaluates a
// window's whole cascade here, and its decisions in the dense prefix must
// be those of the dense head (kernels A and B) that detect runs there.
// The flat offset img * n_sat + base is formed in 64 bits: eight 480x640
// images already give about 8.1 M SAT entries, and larger batches would
// pass 2^31.
//
// Bound on the H100: by peak rates, operations (about twenty float
// operations per weak classifier per live lane).  In practice the gathers:
// twelve SAT reads per weak classifier and lane, where a warp's 32 lanes
// are consecutive survivors spread over a few hundred columns, so each
// gather touches several cache lines.  The SAT (about 32 MB at the flush)
// stays in the 50 MB L2; live lanes run at L1's rate, and lanes that all
// read one entry (the compaction's -1 fill points at slot 0) at the pace
// of their address arithmetic.  What the design does about it:
//   - live count: the compacted list is a prefix of `cap` lanes whose
//     first min(*n_live, cap) are live (n_live is a device scalar, read
//     here, so the host never syncs).  Lanes past it read nothing and get
//     0.  The live lanes are split into contiguous, warp-aligned shares
//     over about 8 blocks per SM, so a short live prefix (the later tail
//     segments) still fills the card; a block without a share writes its
//     part of the zeros and exits at once.
//   - addressing: a thread whose lanes share one row stride and whose
//     windows' footprints off + [0, 24 st + 24] lie inside the table reads
//     through per-lane pointers with 32-bit relative offsets computed once
//     per rectangle, and no clamps; other threads (lanes near the table's
//     end, a level boundary, padding) take the clamped 64-bit path.  Both
//     read the same entries, so the bits are the same.  The SAT is read
//     through the read-only path (__ldg).
//   - shared corners: Haar rectangles of one weak classifier are adjacent,
//     so a rectangle's left (or top) corners are often its neighbour's
//     right (or bottom) ones, and an unused rectangle (w = h = 0) has one
//     corner four times.  The fast path reads each such entry once: 7 or 8
//     gathers per weak classifier instead of 12, the same values (measured
//     faster on the H100, on live lanes and on padding alike).
//   - block shape: lane_block (r, c) of the plan maps to c threads per
//     block, cap / (r c) blocks and r lanes per thread (fewer when a short
//     live prefix is spread), the thread's lanes interleaved at stride c
//     so a warp's lanes stay neighbours in the list.  A thread
//     evaluates its lanes kGroup = 2 at a time: two independent gather
//     chains that share each weak classifier read from shared memory.  More
//     lanes at once measured slower on the H100 (more registers per thread,
//     so fewer warps in flight to hide the gathers' latency).
//   - pipelining: the gathers of the next weak classifier go out before
//     the current one's arithmetic, two classifiers in flight per warp.
//   - L1 over shared memory: the gathers of neighbouring windows hit in
//     L1 (reading the SAT past L1 measured much slower), so the launch
//     asks for a shared-memory carve-out that holds 16 resident warps'
//     blocks and leaves the rest of the SM's 256 KB to L1.
// The run's weak classifiers are staged once per block in shared memory
// (common.cuh stage_params); the corner modes and reads (corner_mode,
// corners) are common.cuh's, which kernels A and B share.

#include "common.cuh"

namespace {

using repro_torch::WeakClassifier;
using repro_torch::corner_mode;
using repro_torch::corners;
using repro_torch::kBelow;
using repro_torch::kOwn;
using repro_torch::kPoint;
using repro_torch::kRight;

// The twelve corner values of one weak classifier for R lanes that share
// the row stride st, each at its window's SAT pointer p[j]: v[j][4 r + i]
// is corner i (a, b, c, d) of rectangle r; rectangles 1 and 2 in corner
// modes M1, M2.  Only loads: the gathers of all R lanes go out together.
template <int R, int M1, int M2>
__device__ __forceinline__ void gather(const float* const (&p)[R], int st,
                                       const WeakClassifier& wk, float (&v)[R][12]) {
  int o[3], dy[3], rw[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    o[r] = wk.rect[r][1] * st + wk.rect[r][0];
    dy[r] = wk.rect[r][3] * st;
    rw[r] = wk.rect[r][2];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float a, b, c, d;
    corners<kOwn>(p[j], o[0], dy[0], rw[0], a, b, c, d);
    v[j][0] = a, v[j][1] = b, v[j][2] = c, v[j][3] = d;
    corners<M1>(p[j], o[1], dy[1], rw[1], a, b, c, d);
    v[j][4] = a, v[j][5] = b, v[j][6] = c, v[j][7] = d;
    corners<M2>(p[j], o[2], dy[2], rw[2], a, b, c, d);
    v[j][8] = a, v[j][9] = b, v[j][10] = c, v[j][11] = d;
  }
}

template <int R>
__device__ __forceinline__ void gather_any(int mode, const float* const (&p)[R], int st,
                                           const WeakClassifier& wk, float (&v)[R][12]) {
  switch (mode) {
    case kRight * 4 + kPoint: gather<R, kRight, kPoint>(p, st, wk, v); break;
    case kBelow * 4 + kPoint: gather<R, kBelow, kPoint>(p, st, wk, v); break;
    case kRight * 4 + kRight: gather<R, kRight, kRight>(p, st, wk, v); break;
    case kBelow * 4 + kBelow: gather<R, kBelow, kBelow>(p, st, wk, v); break;
    default: gather<R, kOwn, kOwn>(p, st, wk, v);
  }
}

// The normalized feature of one lane from its rectangles' corners a, b, c,
// d: feat = 0 + w0 * area0 + w1 * area1 + w2 * area2, with area = d - b - c
// + a and feat * inv / 576 (the tail's order), or, when dense, area = (d -
// b) - (c - a) and feat * inv * (1/576) (the dense kernels' order).
__device__ __forceinline__ float norm_feat(const WeakClassifier& wk, const float* v, float iv,
                                           bool dense) {
  float feat = 0.0f;
  if (dense) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
      feat = feat + wk.w[r] * ((v[4 * r + 3] - v[4 * r + 1]) - (v[4 * r + 2] - v[4 * r]));
    return feat * iv * repro_torch::INV_AREA;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    feat = feat + wk.w[r] * (v[4 * r + 3] - v[4 * r + 1] - v[4 * r + 2] + v[4 * r]);
  return feat * iv / repro_torch::AREA;
}

// Adds weak classifier wk's vote to acc for R lanes from their corner
// values, in the order norm_feat's `dense` picks, as the clamped path and
// the plain version.
template <int R>
__device__ __forceinline__ void add_vote(const WeakClassifier& wk, const float (&v)[R][12],
                                         const float (&iv)[R], bool dense, float (&acc)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float f_norm = norm_feat(wk, v[j], iv[j], dense);
    acc[j] = acc[j] + (f_norm < wk.theta ? wk.left : wk.right);
  }
}

constexpr int kGroup = 2;             // lanes a thread evaluates together
constexpr int kMinWarps = 16;         // resident warps the carve-out must hold
constexpr int kBusyBlocksPerSm = 8;   // blocks per SM a short live prefix spreads over
constexpr size_t kMaxSmem = 233472;   // an SM's largest shared-memory carve-out

// Fast path: R lanes with one row stride, every window's footprint inside
// the table.  p[j] points at lane j's window origin in the SAT.  A lane
// with on[j] false (not this thread's) repeats lane 0's window and is not
// written.  With kDense, the run's first kd weak classifiers take the
// dense order; without it (every batched-tail launch) kd is unused and
// the loop is the tail order's alone.  The loop over the run's weak
// classifiers is software-pipelined: the gathers of classifier k + 1 go
// out before classifier k's arithmetic waits on its own, so a warp has
// two classifiers' gathers in flight.
template <int R, bool kDense>
__device__ __forceinline__ void lane_sums_fast(const float* const (&p)[R], int st,
                                               const float (&iv)[R], const bool (&on)[R],
                                               const WeakClassifier* wc, const int* modes,
                                               const int* bounds, int n_run, int kd,
                                               float* __restrict__ out, int cap,
                                               long long first, int step) {
  float acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.0f;
  int si = 0;
  auto finish_stages = [&](int done) {  // write each stage whose classifiers are done
    for (; si < n_run && bounds[si + 1] <= done; ++si) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const long long l = first + (long long)j * step;
        if (on[j]) out[(size_t)si * cap + l] = acc[j];
        acc[j] = 0.0f;
      }
    }
  };
  finish_stages(0);
  const int n_k = bounds[n_run];
  float cur[R][12], nxt[R][12];
  if (n_k > 0) gather_any<R>(modes[0], p, st, wc[0], cur);
  for (int k = 0; k < n_k; ++k) {
    if (k + 1 < n_k) gather_any<R>(modes[k + 1], p, st, wc[k + 1], nxt);
    add_vote<R>(wc[k], cur, iv, kDense && k < kd, acc);
    finish_stages(k + 1);
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < 12; ++i) cur[j][i] = nxt[j][i];
  }
}

// General path: lanes with on[j] false (not this thread's) read nothing and
// are not written; the rest read every corner at its flat index clamped
// into [0, last], as jnp.take(mode="clip").  With kDense, the run's first
// kd weak classifiers take the dense order.
template <int R, bool kDense>
__device__ __forceinline__ void lane_sums_clamped(
    const float* __restrict__ sat, long long last, const long long (&off)[R],
    const int (&st)[R], const float (&iv)[R], const bool (&on)[R],
    const WeakClassifier* wc, const int* bounds, int n_run, int kd, float* __restrict__ out,
    int cap, long long first, int step) {
  auto at = [&](long long i) { return __ldg(sat + (i < 0 ? 0 : (i > last ? last : i))); };
  for (int si = 0; si < n_run; ++si) {
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0.0f;
    for (int k = bounds[si]; k < bounds[si + 1]; ++k) {
      const WeakClassifier& wk = wc[k];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!on[j]) continue;
        float v[12];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const long long o = off[j] + (long long)wk.rect[r][1] * st[j] + wk.rect[r][0];
          const long long dy = (long long)wk.rect[r][3] * st[j];
          const int rw = wk.rect[r][2];
          v[4 * r] = at(o);
          v[4 * r + 1] = at(o + rw);
          v[4 * r + 2] = at(o + dy);
          v[4 * r + 3] = at(o + dy + rw);
        }
        const float f_norm = norm_feat(wk, v, iv[j], kDense && k < kd);
        acc[j] = acc[j] + (f_norm < wk.theta ? wk.left : wk.right);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (on[j]) out[(size_t)si * cap + first + (long long)j * step] = acc[j];
  }
}

// Lanes [lo, hi) get 0 in every stage row (padding), the block's threads
// striding over them.
__device__ __forceinline__ void zero_range(float* __restrict__ out, int cap, int n_run,
                                           long long lo, long long hi) {
  for (int si = 0; si < n_run; ++si)
    for (long long l = lo + threadIdx.x; l < hi; l += blockDim.x)
      out[(size_t)si * cap + l] = 0.0f;
}

inline size_t smem_bytes(int n_weak, int n_run) {
  return repro_torch::stage_smem_bytes(n_weak, n_run) + sizeof(int) * (size_t)n_weak;
}

// The live lanes [0, live) are split into contiguous, warp-aligned shares
// of at most lanes_per_thread * blockDim.x lanes, one per block and sized so
// that about `spread` blocks have one: a short live prefix still keeps every
// SM busy.  Thread t of a block owns lanes lo + t, lo + t + blockDim.x, ...
// of its share and evaluates kGroup of them at a time.  The padding lanes
// [live, cap) are split evenly over all blocks, which write their zeros.
// kDense: some stage of the run lies below s_dense (the stream's tail);
// the batched tail launches packed_sums<false>.
template <bool kDense>
__global__ void packed_sums(const float* __restrict__ sat, long long n_total,
                            long long n_sat, const int* __restrict__ img,
                            const int* __restrict__ base, const int* __restrict__ stride,
                            const int* __restrict__ ys, const int* __restrict__ xs,
                            const float* __restrict__ inv,
                            const long long* __restrict__ n_live, float* __restrict__ out,
                            int cap, const int* __restrict__ rect_xywh,
                            const float* __restrict__ rect_w,
                            const float* __restrict__ theta,
                            const float* __restrict__ left,
                            const float* __restrict__ right,
                            const int* __restrict__ stage_offsets, int s0, int s1,
                            int k0, int k1, int s_dense, int lanes_per_thread,
                            int spread) {
  const int n_run = s1 - s0;
  long long live = cap;
  if (n_live != nullptr) {
    const long long n = *n_live;
    live = n < 0 ? 0 : (n < cap ? n : cap);
  }
  const int step = blockDim.x;
  const long long b = blockIdx.x;
  const long long pad = (cap - live + gridDim.x - 1) / gridDim.x;
  zero_range(out, cap, n_run, live + b * pad, min((long long)cap, live + (b + 1) * pad));
  const long long per =
      min((long long)lanes_per_thread * step, ((live + spread - 1) / spread + 31) / 32 * 32);
  const long long lo = b * per;
  const long long hi = min(lo + per, live);
  if (lo >= hi) return;  // no live lane in this block

  extern __shared__ unsigned char smem[];
  WeakClassifier* wc = reinterpret_cast<WeakClassifier*>(smem);
  int* bounds = reinterpret_cast<int*>(wc + (k1 - k0));
  int* modes = bounds + (n_run + 1);
  repro_torch::stage_params(wc, bounds, rect_xywh, rect_w, theta, left, right,
                            stage_offsets, s0, s1, k0, k1);
  // corner modes, and whether every rectangle of the run lies inside the
  // 24x24 window (Cascade.validate holds it; checked here so the
  // unclamped path never relies on it)
  bool inside = true;
  for (int i = threadIdx.x; i < k1 - k0; i += step) {
    modes[i] = corner_mode(wc[i].rect[0], wc[i].rect[1]) * 4 +
               corner_mode(wc[i].rect[1], wc[i].rect[2]);
    for (int r = 0; r < 3; ++r) {
      const int* q = wc[i].rect[r];
      inside = inside && q[0] >= 0 && q[1] >= 0 && q[2] >= 0 && q[3] >= 0 &&
               q[0] + q[2] <= repro_torch::WINDOW && q[1] + q[3] <= repro_torch::WINDOW;
    }
  }
  inside = __syncthreads_and(inside);
  // classifiers of the run in stages below s_dense (the dense order)
  const int kd = kDense ? bounds[s_dense >= s1 ? n_run : s_dense - s0] : 0;

  const long long last = n_total - 1;
  for (long long gfirst = lo + threadIdx.x; gfirst < hi; gfirst += (long long)kGroup * step) {
    long long off[kGroup];
    int st[kGroup];
    float iv[kGroup];
    bool on[kGroup];
    bool fast = inside;  // lane 0 is on: gfirst < hi
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const long long l = gfirst + (long long)j * step;
      on[j] = l < hi;
      off[j] = 0;
      st[j] = 0;
      iv[j] = 0.0f;
      if (on[j]) {
        st[j] = stride[l];
        off[j] = (long long)img[l] * n_sat + base[l] + (long long)ys[l] * st[j] + xs[l];
        iv[j] = inv[l];
        const long long span =
            (long long)repro_torch::WINDOW * st[j] + repro_torch::WINDOW;
        fast = fast && st[j] == st[0] && st[j] >= 0 && st[j] <= (1 << 24) &&
               off[j] >= 0 && off[j] + span <= last;
      }
    }
    if (fast) {
      const float* p[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        p[j] = sat + (on[j] ? off[j] : off[0]);
        iv[j] = on[j] ? iv[j] : iv[0];
      }
      lane_sums_fast<kGroup, kDense>(p, st[0], iv, on, wc, modes, bounds, n_run, kd, out,
                                     cap, gfirst, step);
    } else {
      lane_sums_clamped<kGroup, kDense>(sat, last, off, st, iv, on, wc, bounds, n_run, kd,
                                        out, cap, gfirst, step);
    }
  }
}

}  // namespace

// lanes_per_thread >= 1; threads a multiple of 32 in [32, 1024], lowered to
// what the kernel's registers allow.  The wrapper maps the plan's lane_block
// onto both.  n_live may be null (every lane live).  Stages below s_dense
// take the dense kernels' arithmetic (s_dense <= s0: none).
extern "C" int packed_stage_sums(const float* sat, long long n_total, long long n_sat,
                                 const int* img, const int* base, const int* stride,
                                 const int* ys, const int* xs, const float* inv,
                                 const long long* n_live, float* out, int cap,
                                 const int* rect_xywh, const float* rect_w,
                                 const float* theta, const float* left,
                                 const float* right, const int* stage_offsets, int s0,
                                 int s1, int k0, int k1, int s_dense,
                                 int lanes_per_thread, int threads, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || lanes_per_thread < 1 ||
      cap <= 0)
    return (int)cudaErrorInvalidValue;
  // the dense order only where a stage of the run lies below s_dense
  auto* kernel = s_dense > s0 ? packed_sums<true> : packed_sums<false>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  threads = threads < attr.maxThreadsPerBlock ? threads : attr.maxThreadsPerBlock / 32 * 32;
  const size_t smem = smem_bytes(k1 - k0, s1 - s0);
  err = repro_torch::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // The gathers live on L1 hits, so ask for shared memory for only
  // kMinWarps resident warps' blocks (1 KB of each block is the system's)
  // and leave the rest of the SM's 256 KB to L1; CUDA rounds the
  // carve-out up to a size the SM supports.
  const size_t blocks = (kMinWarps * 32 + threads - 1) / threads;
  const size_t pct = (blocks * (smem + 1024) * 100 + kMaxSmem - 1) / kMaxSmem;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)(pct < 100 ? pct : 100));
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)lanes_per_thread * threads;
  const long long n_blocks = (cap + per_block - 1) / per_block;
  const long long spread = n_blocks < kBusyBlocksPerSm * n_sm ? n_blocks
                                                              : kBusyBlocksPerSm * n_sm;
  kernel<<<(unsigned)n_blocks, threads, smem, (cudaStream_t)stream>>>(
      sat, n_total, n_sat, img, base, stride, ys, xs, inv, n_live, out, cap, rect_xywh,
      rect_w, theta, left, right, stage_offsets, s0, s1, k0, k1, s_dense,
      lanes_per_thread, (int)spread);
  return (int)cudaGetLastError();
}
