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

// ----------------------------------------------------- shared corners (A, B, C)
// How a rectangle's corners relate to those of the rectangle before it in
// the same weak classifier (Haar features are adjacent rectangles): a shared
// corner is the same SAT entry, so it is read once and reused.
enum Corners { kOwn = 0, kRight = 1, kBelow = 2, kPoint = 3 };

__device__ inline int corner_mode(const int* prev, const int* r) {
  if (r[2] == 0 && r[3] == 0) return kPoint;  // all four corners one entry
  if (r[1] == prev[1] && r[3] == prev[3] && r[0] == prev[0] + prev[2]) return kRight;
  if (r[0] == prev[0] && r[2] == prev[2] && r[1] == prev[1] + prev[3]) return kBelow;
  return kOwn;
}

// Loads of a corner: through the read-only path from device memory (kernel
// C's gathers), or plainly (the dense kernels' tile in shared memory).
struct GlobalLoad {
  __device__ __forceinline__ float operator()(const float* p) const { return __ldg(p); }
};
struct SharedLoad {
  __device__ __forceinline__ float operator()(const float* p) const { return *p; }
};

// Corners a (y0, x0), b (y0, x1), c (y1, x0), d (y1, x1) of one rectangle
// whose top-left corner is at q + o, with dy the offset of one rectangle
// height down and rw of one rectangle width across.  On entry a..d hold the
// previous rectangle's corners; mode M says which of them coincide with
// this rectangle's, and only the others are read.
template <int M, typename Load = GlobalLoad>
__device__ __forceinline__ void corners(const float* q, int o, int dy, int rw, float& a,
                                        float& b, float& c, float& d) {
  Load ld;
  if (M == kRight) {
    a = b;
    c = d;
    b = ld(q + o + rw);
    d = ld(q + o + dy + rw);
  } else if (M == kBelow) {
    a = c;
    b = d;
    c = ld(q + o + dy);
    d = ld(q + o + dy + rw);
  } else if (M == kPoint) {
    a = ld(q + o);
    b = a;
    c = a;
    d = a;
  } else {
    a = ld(q + o);
    b = ld(q + o + rw);
    c = ld(q + o + dy);
    d = ld(q + o + dy + rw);
  }
}

// ------------------------------------------------------- dense heads (A, B)
// A block of kernels A and B covers a tile of ty x tx window origins of one
// image: blockDim.x = tx threads across (one window column each,
// neighbouring threads on neighbouring x) and blockDim.y = ty / RPT
// threads down, each walking RPT consecutive rows of its column (RPT = 4,
// or ty when ty < 4).  The
// block stages the (ty + 24) x (tx + 24) window of the SAT its windows
// read into shared memory, column-major with an odd column height, so that
// a warp's read of one corner for 32 neighbouring windows is one
// conflict-free wavefront and a thread's RPT windows sit at immediate
// offsets 0..RPT-1 from one address.  The weak classifiers go through
// shared memory in chunks, their corner offsets precomputed once per block
// for that layout; for each weak classifier in ascending k a thread reads
// its parameters once and adds its vote to each of its RPT windows.
constexpr int kDenseChunk = 128;  // weak classifiers staged at a time

// Threads per block the dense kernels are built for (their launch bound):
// CUDA's limit, one block per SM, so at most 64 registers a thread.
constexpr int kDenseMaxThreads = 1024;

// Rows of one tile column: odd, so neighbouring columns fall in other banks.
__host__ __device__ constexpr int dense_tile_rows(int ty) { return (ty + WINDOW) | 1; }

// One weak classifier as the dense kernels stage it: per rectangle the tile
// offset of its top-left corner (column * rows + row) and the offsets of
// one rectangle height down (dy) and one width across (dx), the corner
// modes of rectangles 1 and 2 (mode1 * 4 + mode2), the weights, the stump
// threshold and its votes.  64 bytes, read as four 16-byte broadcasts.
struct alignas(16) DenseWeak {
  int o[3];
  int dy[3];
  int dx[3];
  int mode;
  float w[3];
  float theta;
  float left;
  float right;
};

inline size_t dense_smem_bytes(int ty, int tx, int n_weak) {
  const int chunk = n_weak < kDenseChunk ? n_weak : kDenseChunk;
  return sizeof(DenseWeak) * (size_t)chunk +
         sizeof(float) * (size_t)(tx + WINDOW) * dense_tile_rows(ty);
}

// The block's tile: after the chunk of DenseWeak records at the start of
// the dynamic shared memory.
__device__ __forceinline__ float* dense_tile(unsigned char* smem, int n_k) {
  return reinterpret_cast<float*>(reinterpret_cast<DenseWeak*>(smem) +
                                  (n_k < kDenseChunk ? n_k : kDenseChunk));
}

// Starts the copy of the SAT window of the block's tile, rows y0 .. y0 +
// ty + 23 and columns x0 .. x0 + tx + 23 of a table with H1 rows of W1
// entries, into `tile` (column-major, dense_tile_rows(ty) rows per
// column): 4-byte cp.async copies, coalesced (neighbouring threads read
// neighbouring x of a row) and all in flight at once; dense_block waits
// for them.  Entries past the table are zero-filled and feed only windows
// past the grid, which are not written.  (TMA would need a row pitch that
// is a multiple of 16 bytes; the SAT's is (w + 1) * 4, the flat layout the
// packed tail indexes.)
__device__ __forceinline__ void stage_tile_async(float* tile, const float* __restrict__ sat,
                                                 int H1, int W1, int ty) {
  const int R = dense_tile_rows(ty);
  const int x0 = blockIdx.x * blockDim.x;
  const int y0 = blockIdx.y * ty;
  const int cols = blockDim.x + WINDOW;
  for (int r = threadIdx.y; r < ty + WINDOW; r += blockDim.y) {
    const int y = y0 + r;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const int x = x0 + c;
      const bool in = y < H1 && x < W1;
      const float* src = in ? sat + (size_t)y * W1 + x : sat;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(tile + c * R + r));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                   "r"(in ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Stages weak classifiers [kb, ke) as DenseWeak records for a tile of R
// rows per column.
__device__ __forceinline__ void stage_weak(DenseWeak* wc, int R, const int* __restrict__ rect_xywh,
                                           const float* __restrict__ rect_w,
                                           const float* __restrict__ theta,
                                           const float* __restrict__ left,
                                           const float* __restrict__ right, int kb, int ke) {
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.x + threadIdx.y * blockDim.x; i < ke - kb; i += nt) {
    const int k = kb + i;
    int rc[3][4];
    DenseWeak c;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) rc[r][j] = __ldg(rect_xywh + (k * 3 + r) * 4 + j);
      c.o[r] = rc[r][0] * R + rc[r][1];
      c.dy[r] = rc[r][3];
      c.dx[r] = rc[r][2] * R;
      c.w[r] = __ldg(rect_w + k * 3 + r);
    }
    c.mode = corner_mode(rc[0], rc[1]) * 4 + corner_mode(rc[1], rc[2]);
    c.theta = __ldg(theta + k);
    c.left = __ldg(left + k);
    c.right = __ldg(right + k);
    wc[i] = c;
  }
}

// Adds weak classifier c's vote to the RPT windows of one thread, whose
// first window's tile column starts at `col`, with rectangles 1 and 2 in
// corner modes M1, M2.  Per window the dense kernels' ordering: corners
// (d - b) - (c - a), the three rectangles added in order (zero weights
// included), feat * inv * (1/576), the vote added to the window's sum.
template <int RPT, int M1, int M2>
__device__ __forceinline__ void dense_votes(const DenseWeak& c, const float* col,
                                            const float (&inv)[RPT], float (&acc)[RPT]) {
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const float* q = col + j;
    float a, b, cc, d;
    float feat = 0.0f;
    corners<kOwn, SharedLoad>(q, c.o[0], c.dy[0], c.dx[0], a, b, cc, d);
    feat = feat + c.w[0] * ((d - b) - (cc - a));
    corners<M1, SharedLoad>(q, c.o[1], c.dy[1], c.dx[1], a, b, cc, d);
    feat = feat + c.w[1] * ((d - b) - (cc - a));
    corners<M2, SharedLoad>(q, c.o[2], c.dy[2], c.dx[2], a, b, cc, d);
    feat = feat + c.w[2] * ((d - b) - (cc - a));
    const float f_norm = feat * inv[j] * INV_AREA;
    acc[j] = acc[j] + (f_norm < c.theta ? c.left : c.right);
  }
}

// The mode is the same for every thread (all walk the same k): the switch
// is warp-uniform.  Modes without a case of their own read every corner.
// The record is read as four 16-byte broadcasts.
template <int RPT>
__device__ __forceinline__ void dense_vote(const DenseWeak* wk, const float* col,
                                           const float (&inv)[RPT], float (&acc)[RPT]) {
  DenseWeak c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<int4*>(&c)[i] = reinterpret_cast<const int4*>(wk)[i];
  switch (c.mode) {
    case kRight * 4 + kPoint: dense_votes<RPT, kRight, kPoint>(c, col, inv, acc); break;
    case kBelow * 4 + kPoint: dense_votes<RPT, kBelow, kPoint>(c, col, inv, acc); break;
    case kRight * 4 + kRight: dense_votes<RPT, kRight, kRight>(c, col, inv, acc); break;
    case kBelow * 4 + kBelow: dense_votes<RPT, kBelow, kBelow>(c, col, inv, acc); break;
    default: dense_votes<RPT, kOwn, kOwn>(c, col, inv, acc);
  }
}

// The first of a thread's RPT window rows, and its column.
template <int RPT>
__device__ __forceinline__ int dense_row0() {
  return (blockIdx.y * blockDim.y + threadIdx.y) * RPT;
}
__device__ __forceinline__ int dense_col() { return blockIdx.x * blockDim.x + threadIdx.x; }

// One block of a dense kernel, after stage_tile_async: the vote sums of the
// stage run [s0, s0 + n_run) (weak classifiers [k0, k0 + n_k)) for the
// block's tile of one image, whose (ny, nx) window grid has 1/sigma `inv`
// for the thread's windows.  Stage si's sum of window (y, x) goes to
// out[si * stage_stride + y * nx + x].  Every thread of the block must call
// it: it has barriers.  A warp whose windows all lie past the grid skips
// the votes.
template <int RPT>
__device__ __forceinline__ void dense_block(
    unsigned char* smem, int ny, int nx, const float (&inv)[RPT],
    const int* __restrict__ rect_xywh, const float* __restrict__ rect_w,
    const float* __restrict__ theta, const float* __restrict__ left,
    const float* __restrict__ right, const int* __restrict__ stage_offsets, int s0,
    int n_run, int k0, int n_k, float* __restrict__ out, size_t stage_stride) {
  const int R = dense_tile_rows(blockDim.y * RPT);
  DenseWeak* wc = reinterpret_cast<DenseWeak*>(smem);
  const float* col = dense_tile(smem, n_k) + threadIdx.x * R + threadIdx.y * RPT;
  const int x = dense_col();
  const int y0 = dense_row0<RPT>();
  const bool live = __any_sync(0xffffffffu, x < nx && y0 < ny);

  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.0f;
  // the current stage's end and, loaded ahead, the next one's
  int si = 0;
  int stage_end = __ldg(stage_offsets + s0 + 1) - k0;
  int next_end = n_run > 1 ? __ldg(stage_offsets + s0 + 2) - k0 : n_k;
  // writes every stage whose weak classifiers are all in (empty ones too)
  auto finish_stages = [&](int done) {
    while (si < n_run && stage_end <= done) {
      float* o = out + (size_t)si * stage_stride + x;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (x < nx && y0 + j < ny) o[(size_t)(y0 + j) * nx] = acc[j];
        acc[j] = 0.0f;
      }
      ++si;
      stage_end = next_end;
      if (si + 1 < n_run) next_end = __ldg(stage_offsets + s0 + si + 2) - k0;
    }
  };
  finish_stages(0);
  for (int kc = 0; kc < n_k; kc += kDenseChunk) {
    const int ke = min(kc + kDenseChunk, n_k);
    if (kc > 0) __syncthreads();  // every thread is done with the last chunk
    stage_weak(wc, R, rect_xywh, rect_w, theta, left, right, k0 + kc, k0 + ke);
    if (kc == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int k = kc; k < ke;) {
      const int e = min(stage_end, ke);
      if (live)
        for (; k < e; ++k) dense_vote<RPT>(wc + (k - kc), col, inv, acc);
      k = e;
      finish_stages(k);
    }
  }
  if (n_k == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace repro_torch

// Each kernel source builds into its own shared library, so each carries
// its own copy of this lookup for the Python side's error messages.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
