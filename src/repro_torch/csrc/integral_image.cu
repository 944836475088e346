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
// see the same SAT.  This kernel keeps that order exactly, so it gives the
// plain version's bits on any float32 input, not only integer-valued ones.
//
// Bound on the H100: bytes.  The work is a few adds per pixel; the least
// traffic is one read of the image and one write of each table, and this
// kernel moves just that (plus a small carry buffer that stays in L2).
// Latency is the other limit: each table entry ends a serial chain of
// double adds down its column and then along its row, and each strip
// waits for the carries of the strip to its left.
//
// Design: one launch, one warp per (image, strip of STRIP table columns,
// table): the three tables are three independent scans, which triples the
// warps in flight and cuts each warp's serial work per step to a third.
// The strip walks down its rows in chunks of CHUNK rows:
//   1. column phase: lane x owns image column x of the strip and adds the
//      chunk's rows into its float64 column sum (a warp reads 128
//      contiguous bytes per row); each float32 column entry goes to shared
//      memory;
//   2. row phase: lane r owns row r of the chunk.  It starts from the
//      float64 row carry that the strip to its left published for that row,
//      adds the strip's STRIP entries left to right in float64, and
//      publishes its own carry for the strip to its right: a chained scan
//      across strips, so every row is summed in the serial order;
//   3. store phase: lane x writes column x of the chunk, so each table row
//      segment is one coalesced store.
// Chunks pipeline as a wavefront across strips: the critical path is about
// n_strips + n_chunks steps.  A block takes its (strip, image, table) from
// an atomic ticket, strip-major, so the strip it waits on has always
// started earlier and no block waits on one that is not running.
// The hand-off needs no fence: a carry slot holds a sentinel (a signalling
// NaN bit pattern, which no float64 add or conversion produces) until its
// producer stores the carry with one 64-bit store, and the consumer polls
// the slot itself.  The next chunk's image rows are loaded before the wait.

#include "common.cuh"

namespace {

constexpr int STRIP = 32;  // table columns per block: one warp, one per lane
constexpr int CHUNK = 32;  // rows per hand-off between strips
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, double v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p),
               "l"((unsigned long long)__double_as_longlong(v))
               : "memory");
}

__device__ __forceinline__ double await_carry(const unsigned long long* p,
                                              unsigned long long sentinel) {
  unsigned long long v;
  do {
    v = load_relaxed(p);
  } while (v == sentinel);
  return __longlong_as_double((long long)v);
}

// hand: [0] the ticket counter, then one float64 row carry per (image,
// strip, table, row); the wrapper fills all of it with `sentinel` for each
// launch.
__global__ void __launch_bounds__(STRIP)
    sat_chained(const float* __restrict__ img, float* __restrict__ ii,
                float* __restrict__ ii2, float* __restrict__ iic, int B, int H, int W,
                unsigned long long* __restrict__ hand, unsigned long long sentinel) {
  __shared__ float tile[CHUNK][STRIP + 1];  // +1: conflict-free rows and columns
  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) ticket = (int)(atomicAdd(hand, 1ull) - sentinel);
  ticket = __shfl_sync(FULL, ticket, 0);
  const int n_strips = (W + STRIP - 1) / STRIP;
  const int n_chunks = (H + CHUNK - 1) / CHUNK;
  const int s = ticket / (3 * B);
  const int b = ticket % (3 * B) / 3;
  const int t = ticket % 3;  // 0: ii, 1: ii2, 2: iic
  const int W1 = W + 1;
  const int x = s * STRIP + lane;  // image column of this lane (table column x + 1)
  const bool has_col = x < W;
  const int n_cols = min(STRIP, W - s * STRIP);
  const bool last_strip = s + 1 == n_strips;
  float* const tab = (t == 0 ? ii : (t == 1 ? ii2 : iic)) + (size_t)b * (H + 1) * W1;
  if (has_col) tab[x + 1] = 0.0f;  // top row
  if (s == 0)
    for (int y = lane; y <= H; y += STRIP) tab[(size_t)y * W1] = 0.0f;  // left column

  unsigned long long* const my_carry =
      hand + 1 + (((size_t)b * n_strips + s) * 3 + t) * H;
  const unsigned long long* const left_carry = my_carry - (size_t)H * 3;
  const float* src = img + (size_t)b * H * W + x;
  double col = 0.0;

  float v[CHUNK];
  auto load_chunk = [&](int y0) {
    const int rows = min(CHUNK, H - y0);
#pragma unroll
    for (int r = 0; r < CHUNK; ++r)
      v[r] = (has_col && r < rows) ? __ldg(src + (size_t)(y0 + r) * W) : 0.0f;
  };
  load_chunk(0);

  for (int c = 0; c < n_chunks; ++c) {
    const int y0 = c * CHUNK;
    const int rows = min(CHUNK, H - y0);
    // 1. column phase (lanes past the image's last column keep zeros)
#pragma unroll
    for (int r = 0; r < CHUNK; ++r) {
      if (r < rows) {
        const float cen = v[r] - 128.0f;
        const float q = t == 0 ? v[r] : (t == 1 ? cen * cen : cen);
        col += (double)q;
        tile[r][lane] = (float)col;
      }
    }
    __syncwarp();
    if (c + 1 < n_chunks) load_chunk(y0 + CHUNK);

    // 2. row phase, from the left strip's carry; publishes its own.  The
    // row goes through registers, so the serial chain is the float64 adds
    // alone (no shared-memory round trip per entry).
    if (lane < rows) {
      float row[STRIP];
#pragma unroll
      for (int j = 0; j < STRIP; ++j) row[j] = tile[lane][j];
      double acc = s > 0 ? await_carry(left_carry + y0 + lane, sentinel) : 0.0;
#pragma unroll
      for (int j = 0; j < STRIP; ++j) {
        if (j < n_cols) {
          acc += (double)row[j];
          row[j] = (float)acc;
        }
      }
      if (!last_strip) store_relaxed(my_carry + y0 + lane, acc);
#pragma unroll
      for (int j = 0; j < STRIP; ++j) tile[lane][j] = row[j];
    }
    __syncwarp();

    // 3. store phase
    if (has_col)
      for (int r = 0; r < rows; ++r) tab[(size_t)(y0 + r + 1) * W1 + x + 1] = tile[r][lane];
    __syncwarp();
  }
}

}  // namespace

// `hand` (1 + B * n_strips * 3 * H slots of 64 bits) must hold `sentinel` in
// every slot; `sentinel` must be a bit pattern no float64 add produces.
extern "C" int sat_tables(const float* img, float* ii, float* ii2, float* iic, int B,
                          int H, int W, unsigned long long* hand, long long n_hand,
                          unsigned long long sentinel, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_strips = (W + STRIP - 1) / STRIP;
  if (B <= 0 || H <= 0 || W <= 0 || n_hand < 1 + B * n_strips * 3 * H)
    return (int)cudaErrorInvalidValue;
  sat_chained<<<(unsigned)(3 * B * n_strips), STRIP, 0, (cudaStream_t)stream>>>(
      img, ii, ii2, iic, B, H, W, hand, sentinel);
  return (int)cudaGetLastError();
}
