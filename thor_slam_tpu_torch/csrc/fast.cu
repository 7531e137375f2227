// FAST-9 corner response + 3x3 non-max suppression over a (C, H, W) stack.
//
// Replaces the TPU kernel thor_slam_tpu/ops/fast_pallas.py::_fast_kernel
// (entry point fast_scores_batched). Semantics follow the XLA reference
// thor_slam_tpu/ops/fast.py (fast_score_map + nms3x3) on the WHOLE image,
// not the Pallas kernel's zeroed 4 px border:
//   * circle reads are edge-clamped (jnp.pad(mode="edge"));
//   * raw = max(sum bright excess, sum dark excess) where a contiguous arc
//     of >= 9 of the 16 circle points is brighter / darker than the centre
//     by more than the threshold, else 0; the excess sums accumulate in
//     CIRCLE_OFFSETS order, as the Pallas kernel does;
//   * nms = raw where raw >= every in-image 8-neighbour, else 0 (neighbours
//     outside the image are ignored, as reduce_window with a -inf init).
// The arc test packs the 16 comparisons into a bitmask and tests for a run
// of 9 by log-doubling shift-ANDs (fast_pallas._has_arc16).
//
// What bounds it: issue slots, then the memory phases that nothing overlaps.
// At 4 x 400 x 640 it reads 4.1 MB and writes 8.2 MB (0.0037 ms at
// 3.35 TB/s). The arithmetic is far from the card's 67 TFLOP/s, but not the
// instruction stream: a pixel takes 16 x 4 instructions for its two circle
// masks, ~15 for the arc test, its share of the staging, the list and the
// NMS, and on a noise image a third of the pixels (15 % of a rendered
// frame) have an arc and take ~130 more for the two excess sums. The whole
// image is resident at once (500 blocks, one wave), so the blocks run their
// phases in step: the loads at the start and the stores at the end are
// exposed, and between them the SMs issue about one instruction a cycle
// and scheduler. `chip_smoke.py --fast-phases` times the kernel with a
// phase left out (kSkip below); PERF.md has the numbers. The design:
//   * 128 x 16 output tiles under 256 threads: the 4-pixel halo (circle
//     radius 3 + one ring for the NMS) costs 1.59x staged and 1.14x
//     evaluated pixels per output (the first design's 32 x 16: 1.88x and
//     1.20x). The tile is staged once into shared memory with 16-byte
//     loads (scalar, clamped loads on the image border and where
//     W % 4 != 0), and the raw map never leaves the block between the two
//     stencils;
//   * a thread evaluates a run of 4 pixels of a row, walking the circle in
//     its own order, down the right side and up the left, so a row's loads
//     (16-, 8- and 4-byte, whatever is aligned) serve all 4 pixels:
//     33 shared loads for 4 pixels instead of 68;
//   * a circle point costs 4 instructions, not 7: the difference, the
//     threshold minus its magnitude, and one funnel shift for each of two
//     masks ("over the threshold", "negative") that moves a sign bit in.
//     Both arc tests are then one run-of-8 test on the pairs of neighbours
//     that are both over with equal signs;
//   * the corner test comes first and the excess sums later: the pixels
//     with an arc are pushed on a list in shared memory (one atomicAdd a
//     warp, after a warp scan of the counts), and the sums run over that
//     list afterwards with every lane busy, instead of inside the per-pixel
//     code, where a warp walks them as soon as one of its 128 pixels is a
//     corner. The sums keep CIRCLE_OFFSETS order and round every step, so
//     raw and NMS equal the plain version bit for bit;
//   * the two ring columns beside the tile, which no run of 4 covers, are
//     evaluated pixel by pixel by the threads that the last, partial round
//     of runs leaves idle;
//   * raw and NMS leave as 16-byte stores (scalar on a ragged right edge).
// Both eyes of the rig go in one launch: the caller hands the (C, 2, H, W)
// frame tensor as 2C images.
// Tried on the card and dropped: the compass pretest (an arc of 9 holds
// >= 2 of the points 0, 4, 8, 12; few pixels of a noise image fail it, and
// it was slower on the rendered frames too); one atomicAdd a corner; the
// scores in a function of their own (no fewer registers); 64 x 32, 64 x 16,
// 64 x 30 and 128 x 14 tiles and 64 to 512 threads (64 x 32 needed more
// registers than 4 blocks an SM allow, so a second wave; capping the
// registers spilled); the masks by compare-and-select (7 instructions a
// point); the sign mask kept as a float (twice the mask plus
// saturate(-d * 2^100), to move work off the integer pipe: slower, the
// corner test is bound by instruction issue, ~125 a pixel in the SASS, not
// by a pipe); the list's atomicAdd as inline PTX with branch-free list
// stores (the compiler wraps the atomicAdd of one lane in a warp-wide
// aggregation: ~2 % faster, not kept for the inline PTX). Not tried:
// cp.async staging of a second tile per block, which would overlap the
// exposed loads and stores with the arithmetic.
// Pixels are taken as finite: a NaN compares false in the plain version and
// has an arbitrary sign bit here.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kTileW = 128;  // a multiple of 4
constexpr int kTileH = 16;
constexpr int kThreads = 256;
// Timing experiments only (chip_smoke.py --fast-phases): 1 leaves out the
// scores of the listed corners, 2 the corner test of the runs (and with it
// the scores), 3 the stores to device memory. The results are then wrong.
#ifndef THOR_FAST_SKIP
#define THOR_FAST_SKIP 0
#endif
constexpr int kSkip = THOR_FAST_SKIP;
constexpr int kHalo = 4;
// Shared image tile: pixel (gy, gx) lies at img[gy - y0 + 4][gx - x0 + 4].
constexpr int kImgW = kTileW + 2 * kHalo;
constexpr int kImgH = kTileH + 2 * kHalo;
// Shared raw map, tile plus one ring: pixel (gy, gx) lies at
// raw[gy - y0 + 1][gx - x0 + 4], the image tile's column, so runs of 4 stay
// 16-byte aligned. Columns 3 and kTileW + 4 are the ring.
constexpr int kRawH = kTileH + 2;
constexpr int kRawW = kImgW;
constexpr int kRuns = kTileW / 4;           // runs of 4 pixels in a tile row
constexpr int kRunTasks = kRawH * kRuns;    // the tile and the ring rows above and below
constexpr int kRingTasks = 2 * kRawH;       // the ring columns left and right
constexpr int kVecs = kImgW / 4;            // 16-byte pieces of a staged row

static_assert(kTileW % 4 == 0, "runs of 4 pixels");
static_assert(kRunTasks % 32 == 0 && kThreads % 32 == 0, "whole warps take a round of runs");
static_assert(kRawH * kRawW < 65536, "list entries are 16 bits");

// FAST-16 Bresenham circle, radius 3, clockwise from 12 o'clock (dy, dx):
// thor_slam_tpu/ops/fast.py::CIRCLE_OFFSETS. Indexed by unrolled constants
// only, so every offset folds into its load's address.
#define THOR_CIRCLE_DY {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3}
#define THOR_CIRCLE_DX {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1}

// The circle of one pixel as two 16-bit masks, a point a bit, in circle
// order (either direction, any rotation: an arc stays an arc):
//   over: |p - centre| > threshold;  sign: p - centre < 0.
// Bright points are over & ~sign, dark ones over & sign. A point costs four
// instructions: d = p - c, e = thr - |d|, and one funnel shift for each
// mask that moves the sign bit of e, of d, in at the bottom. For finite
// pixels the sign of e is exactly |d| > thr: a float subtraction never
// rounds a non-zero difference to zero (no flush-to-zero here), and x - x
// is +0.
__device__ __forceinline__ void push_point(float p, float c, float thr, unsigned& over,
                                           unsigned& sign) {
  const float d = __fsub_rn(p, c);
  const float e = __fsub_rn(thr, fabsf(d));
  over = __funnelshift_l(__float_as_uint(e), over, 1);
  sign = __funnelshift_l(__float_as_uint(d), sign, 1);
}

// True when >= 9 contiguous (wrapping) circle points are all bright or all
// dark. A pair of neighbours "holds" when both are over and their signs
// agree; an arc of 9 is a run of 8 holding pairs, found by log-doubling
// shift-ANDs (fast_pallas._has_arc16) on the masks doubled into 32 bits, so
// that a rotation is a plain shift.
__device__ __forceinline__ bool has_arc9(unsigned over, unsigned sign) {
  const unsigned o = over * 0x10001u;  // 16 pushes: 16 bits
  const unsigned g = sign * 0x10001u;
  const unsigned pair = o & (o >> 1) & ~(g ^ (g >> 1));
  const unsigned r2 = pair & (pair >> 1);
  const unsigned r4 = r2 & (r2 >> 2);
  const unsigned r8 = r4 & (r4 >> 4);
  return (r8 & 0xFFFFu) != 0u;
}

// Loads row[LO .. END-1] into v[LO .. END-1] with the widest aligned
// shared loads (row is 16-byte aligned); all indices are compile-time.
template <int LO, int END>
__device__ __forceinline__ void load_span(const float* row, float (&v)[12]) {
  if constexpr (LO < END) {
    if constexpr (LO % 4 == 0 && LO + 4 <= END) {
      const float4 t = *reinterpret_cast<const float4*>(row + LO);
      v[LO] = t.x;
      v[LO + 1] = t.y;
      v[LO + 2] = t.z;
      v[LO + 3] = t.w;
      load_span<LO + 4, END>(row, v);
    } else if constexpr (LO % 2 == 0 && LO + 2 <= END) {
      const float2 t = *reinterpret_cast<const float2*>(row + LO);
      v[LO] = t.x;
      v[LO + 1] = t.y;
      load_span<LO + 2, END>(row, v);
    } else {
      v[LO] = row[LO];
      load_span<LO + 1, END>(row, v);
    }
  }
}

// One circle point, at column offset DX, of the 4 pixels of a run whose
// first pixel lies at w[4].
template <int DX>
__device__ __forceinline__ void push4(const float (&w)[12], const float (&c)[4], float thr,
                                      unsigned (&over)[4], unsigned (&sign)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) push_point(w[4 + p + DX], c[p], thr, over[p], sign[p]);
}

// The corner test of one pixel at img[iy][ix], point by point.
__device__ __forceinline__ bool corner_at(const float (*img)[kImgW], int iy, int ix, float thr) {
  constexpr int dy[16] = THOR_CIRCLE_DY;
  constexpr int dx[16] = THOR_CIRCLE_DX;
  const float centre = img[iy][ix];
  unsigned over = 0u, sign = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) push_point(img[iy + dy[i]][ix + dx[i]], centre, thr, over, sign);
  return has_arc9(over, sign);
}

// The response of a corner at *at (a pixel of the shared image tile): the
// larger of the two excess sums, accumulated in CIRCLE_OFFSETS order.
__device__ __forceinline__ float score_at(const float* at, float thr) {
  constexpr int dy[16] = THOR_CIRCLE_DY;
  constexpr int dx[16] = THOR_CIRCLE_DX;
  const float centre = at[0];
  float excess_b = 0.0f, excess_d = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float d = __fsub_rn(at[dy[i] * kImgW + dx[i]], centre);
    excess_b = __fadd_rn(excess_b, fmaxf(__fsub_rn(d, thr), 0.0f));
    excess_d = __fadd_rn(excess_d, fmaxf(__fsub_rn(-d, thr), 0.0f));
  }
  return fmaxf(excess_b, excess_d);
}

__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ images, float* __restrict__ raw_out,
                float* __restrict__ nms_out, int H, int W, float thr, int vec) {
  __shared__ __align__(16) float img[kImgH][kImgW];
  __shared__ __align__(16) float raw[kRawH][kRawW];
  __shared__ unsigned short corners[kRawH * (kTileW + 2)];
  __shared__ int num_corners;

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* src = images + plane;
  const int tid = threadIdx.x;
  if (tid == 0) num_corners = 0;

  // Stage the tile + halo with edge-clamped coordinates, 4 columns a step.
  for (int t = tid; t < kImgH * kVecs; t += kThreads) {
    const int ly = t / kVecs;
    const int lx = 4 * (t - ly * kVecs);
    int gy = y0 - kHalo + ly;
    gy = gy < 0 ? 0 : (gy > H - 1 ? H - 1 : gy);
    const int gx = x0 - kHalo + lx;
    const float* row = src + (size_t)gy * W;
    float4 v;
    if (vec && gx >= 0 && gx + 3 < W) {
      v = __ldg(reinterpret_cast<const float4*>(row + gx));
    } else {
      const int hi = W - 1;
      v.x = __ldg(row + (gx < 0 ? 0 : (gx > hi ? hi : gx)));
      v.y = __ldg(row + (gx + 1 < 0 ? 0 : (gx + 1 > hi ? hi : gx + 1)));
      v.z = __ldg(row + (gx + 2 < 0 ? 0 : (gx + 2 > hi ? hi : gx + 2)));
      v.w = __ldg(row + (gx + 3 < 0 ? 0 : (gx + 3 > hi ? hi : gx + 3)));
    }
    *reinterpret_cast<float4*>(&img[ly][lx]) = v;
  }
  __syncthreads();

  // Corner test on the tile plus one ring. raw gets 0 inside the image
  // (corners are scored below) and -inf outside, so the NMS ignores those.
  for (int t = tid; t < (kSkip == 2 ? 0 : kRunTasks); t += kThreads) {
    const int ry = t / kRuns;
    const int col = kHalo + 4 * (t - ry * kRuns);  // first column of the run, img and raw alike
    const int iy = ry + kHalo - 1;
    // row(k)[4 + p] is the pixel k rows below pixel p of the run.
    const float* base = &img[iy][col - 4];
#define ROW(k) (base + (k) * kImgW)
    float w[12];
    float c[4];
    unsigned over[4] = {0u, 0u, 0u, 0u};
    unsigned sign[4] = {0u, 0u, 0u, 0u};
    // Points 0..8 lie at column offsets >= 0: down the right side, rows -3..3.
    load_span<4, 11>(ROW(0), w);
#pragma unroll
    for (int p = 0; p < 4; ++p) c[p] = w[4 + p];
    const float r0[4] = {w[7], w[8], w[9], w[10]};  // point 4, kept for its turn
    load_span<4, 9>(ROW(-3), w);
    push4<0>(w, c, thr, over, sign);  // point 0
    push4<1>(w, c, thr, over, sign);  // 1
    load_span<6, 10>(ROW(-2), w);
    push4<2>(w, c, thr, over, sign);  // 2
    load_span<7, 11>(ROW(-1), w);
    push4<3>(w, c, thr, over, sign);  // 3
#pragma unroll
    for (int p = 0; p < 4; ++p) push_point(r0[p], c[p], thr, over[p], sign[p]);  // 4
    load_span<7, 11>(ROW(1), w);
    push4<3>(w, c, thr, over, sign);  // 5
    load_span<6, 10>(ROW(2), w);
    push4<2>(w, c, thr, over, sign);  // 6
    load_span<3, 9>(ROW(3), w);
    push4<1>(w, c, thr, over, sign);  // 7
    push4<0>(w, c, thr, over, sign);  // 8
    // Points 9..15 lie at column offsets < 0: up the left side, rows 3..-3.
    push4<-1>(w, c, thr, over, sign);  // 9
    load_span<2, 6>(ROW(2), w);
    push4<-2>(w, c, thr, over, sign);  // 10
    load_span<1, 5>(ROW(1), w);
    push4<-3>(w, c, thr, over, sign);  // 11
    load_span<1, 4>(ROW(0), w);
    w[4] = c[0];
    push4<-3>(w, c, thr, over, sign);  // 12
    load_span<1, 5>(ROW(-1), w);
    push4<-3>(w, c, thr, over, sign);  // 13
    load_span<2, 6>(ROW(-2), w);
    push4<-2>(w, c, thr, over, sign);  // 14
    load_span<3, 7>(ROW(-3), w);
    push4<-1>(w, c, thr, over, sign);  // 15
#undef ROW
    const int gy = y0 - 1 + ry;
    const int gx = x0 - kHalo + col;
    const bool row_in = gy >= 0 && gy < H;
    float out[4];
    unsigned found = 0u;  // bit p: pixel p of the run is a corner inside the image
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const bool inside = row_in && gx + p < W;
      out[p] = inside ? 0.0f : -CUDART_INF_F;
      if (inside && has_arc9(over[p], sign[p])) found |= 1u << p;
    }
    const int code = ry * kRawW + col;
    // One atomicAdd a warp reserves the list slots of all its corners (a
    // warp scan of the per-thread counts) instead of one a corner.
    const int lane = tid & 31;
    const int mine = __popc(found);
    int upto = mine;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int below = __shfl_up_sync(0xFFFFFFFFu, upto, o);
      if (lane >= o) upto += below;
    }
    int slot = 0;
    if (lane == 31 && upto > 0) slot = atomicAdd(&num_corners, upto);
    slot = __shfl_sync(0xFFFFFFFFu, slot, 31) + upto - mine;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (found >> p & 1u) corners[slot++] = (unsigned short)(code + p);
    }
    *reinterpret_cast<float4*>(&raw[ry][col]) = make_float4(out[0], out[1], out[2], out[3]);
  }
  {
    // The ring columns, by the threads after the last round of runs.
    int t = tid - kRunTasks % kThreads;
    if (t < 0) t += kThreads;
    for (; t < kRingTasks; t += kThreads) {
      const int ry = t >> 1;
      const int col = (t & 1) ? kTileW + kHalo : kHalo - 1;
      const int gy = y0 - 1 + ry;
      const int gx = x0 - kHalo + col;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      raw[ry][col] = inside ? 0.0f : -CUDART_INF_F;
      if (inside && corner_at(img, ry + kHalo - 1, col, thr)) {
        corners[atomicAdd(&num_corners, 1)] = (unsigned short)(ry * kRawW + col);
      }
    }
  }
  __syncthreads();

  // Scores of the listed corners: the excess sums in CIRCLE_OFFSETS order.
  const int n = kSkip == 1 ? 0 : num_corners;
  for (int k = tid; k < n; k += kThreads) {
    const int code = corners[k];
    const int ry = code / kRawW;
    const int col = code - ry * kRawW;
    const int iy = ry + kHalo - 1;
    raw[ry][col] = score_at(&img[iy][col], thr);
  }
  __syncthreads();

  // 3x3 NMS and the stores, a run of 4 outputs a thread.
  for (int t = tid; t < kTileH * kRuns; t += kThreads) {
    const int ty = t / kRuns;
    const int col = kHalo + 4 * (t - ty * kRuns);
    const int gy = y0 + ty;
    const int gx = x0 - kHalo + col;
    if (gy >= H || gx >= W) continue;
    float colmax[6];
    float v[4];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = &raw[ty + dy][col];
      const float4 mid = *reinterpret_cast<const float4*>(row);
      const float e[6] = {row[-1], mid.x, mid.y, mid.z, mid.w, row[4]};
#pragma unroll
      for (int q = 0; q < 6; ++q) colmax[q] = dy == 0 ? e[q] : fmaxf(colmax[q], e[q]);
      if (dy == 1) {
        v[0] = mid.x;
        v[1] = mid.y;
        v[2] = mid.z;
        v[3] = mid.w;
      }
    }
    float s[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float local_max = fmaxf(fmaxf(colmax[p], colmax[p + 1]), colmax[p + 2]);
      s[p] = v[p] >= local_max ? v[p] : 0.0f;
    }
    const size_t o = plane + (size_t)gy * W + gx;
    if (kSkip == 3 && thr > -1e30f) continue;  // always true for a real threshold, which the compiler cannot know
    if (vec && gx + 3 < W) {
      *reinterpret_cast<float4*>(raw_out + o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(nms_out + o) = make_float4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (gx + p < W) {
          raw_out[o + p] = v[p];
          nms_out[o + p] = s[p];
        }
      }
    }
  }
}

}  // namespace

extern "C" int thor_fast_nms(const float* images, float* raw, float* nms, int C, int H, int W,
                             float threshold, void* stream) {
  if (C > 0 && H > 0 && W > 0) {
    // 16-byte loads and stores need every row start aligned.
    const uintptr_t bits = reinterpret_cast<uintptr_t>(images) | reinterpret_cast<uintptr_t>(raw) |
                           reinterpret_cast<uintptr_t>(nms);
    const int vec = (W % 4 == 0 && bits % 16 == 0) ? 1 : 0;
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, C);
    fast_nms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(images, raw, nms, H,
                                                                              W, threshold, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
