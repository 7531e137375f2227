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
// of 9 by log-doubling rotate-ANDs (fast_pallas._has_arc16).
//
// What bounds it: memory traffic (~1 MB in, ~2 MB out at 4 x 640 x 400);
// the arithmetic is ~100 flops a pixel. Each block stages its output tile
// plus a 4-pixel halo (circle radius 3 + one ring for the NMS) in shared
// memory once, computes the raw score for the tile plus one ring into a
// second shared buffer, and runs the NMS from there, so every input pixel
// is read from device memory about once and the raw map never round-trips
// through device memory between the two stencils.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;
constexpr int kImgW = kTileW + 2 * kHalo;
constexpr int kImgH = kTileH + 2 * kHalo;
constexpr int kRawW = kTileW + 2;
constexpr int kRawH = kTileH + 2;

// FAST-16 Bresenham circle, radius 3, clockwise from 12 o'clock (dy, dx):
// thor_slam_tpu/ops/fast.py::CIRCLE_OFFSETS.
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ unsigned rot16(unsigned v, int k) {
  return ((v >> k) | (v << (16 - k))) & 0xFFFFu;
}

// True when the 16-bit circle mask holds a contiguous (wrapping) run >= 9.
__device__ __forceinline__ bool has_arc9(unsigned m) {
  const unsigned r2 = m & rot16(m, 1);
  const unsigned r4 = r2 & rot16(r2, 2);
  const unsigned r8 = r4 & rot16(r4, 4);
  return (r8 & rot16(m, 8)) != 0u;
}

__global__ void fast_nms_kernel(const float* __restrict__ images, float* __restrict__ raw_out,
                                float* __restrict__ nms_out, int H, int W, float thr) {
  __shared__ float img[kImgH][kImgW];
  __shared__ float raw[kRawH][kRawW];

  const int cam = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* src = images + (size_t)cam * H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // Stage the tile + halo with edge-clamped coordinates.
  for (int k = tid; k < kImgH * kImgW; k += nthreads) {
    const int ly = k / kImgW;
    const int lx = k - ly * kImgW;
    int gy = y0 - kHalo + ly;
    int gx = x0 - kHalo + lx;
    gy = gy < 0 ? 0 : (gy > H - 1 ? H - 1 : gy);
    gx = gx < 0 ? 0 : (gx > W - 1 ? W - 1 : gx);
    img[ly][lx] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // Raw score on the tile plus a one-pixel ring; -inf marks pixels outside
  // the image so the NMS ignores them.
  for (int k = tid; k < kRawH * kRawW; k += nthreads) {
    const int ry = k / kRawW;
    const int rx = k - ry * kRawW;
    const int gy = y0 - 1 + ry;
    const int gx = x0 - 1 + rx;
    float score = -CUDART_INF_F;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int iy = ry + kHalo - 1;
      const int ix = rx + kHalo - 1;
      const float centre = img[iy][ix];
      unsigned bright = 0u, dark = 0u;
      float excess_b = 0.0f, excess_d = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float d = img[iy + kCircleDy[i]][ix + kCircleDx[i]] - centre;
        bright |= (d > thr ? 1u : 0u) << i;
        dark |= (d < -thr ? 1u : 0u) << i;
        excess_b = __fadd_rn(excess_b, fmaxf(__fsub_rn(d, thr), 0.0f));
        excess_d = __fadd_rn(excess_d, fmaxf(__fsub_rn(-d, thr), 0.0f));
      }
      score = (has_arc9(bright) || has_arc9(dark)) ? fmaxf(excess_b, excess_d) : 0.0f;
    }
    raw[ry][rx] = score;
  }
  __syncthreads();

  for (int k = tid; k < kTileH * kTileW; k += nthreads) {
    const int ty = k / kTileW;
    const int tx = k - ty * kTileW;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    const float v = raw[ty + 1][tx + 1];
    float local_max = v;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        local_max = fmaxf(local_max, raw[ty + dy][tx + dx]);
      }
    }
    const size_t o = (size_t)cam * H * W + (size_t)gy * W + gx;
    raw_out[o] = v;
    nms_out[o] = v >= local_max ? v : 0.0f;
  }
}

}  // namespace

extern "C" int thor_fast_nms(const float* images, float* raw, float* nms, int C, int H, int W,
                             float threshold, void* stream) {
  if (C > 0 && H > 0 && W > 0) {
    const dim3 block(32, 8);
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, C);
    fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(images, raw, nms, H,
                                                                            W, threshold);
  }
  return static_cast<int>(cudaGetLastError());
}
