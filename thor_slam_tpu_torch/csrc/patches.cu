// Patch gather: (M, S, S) float32 patches from a (C, H, W) float32 stack.
//
// Replaces the TPU kernel thor_slam_tpu/ops/patches_pallas.py::_gather_kernel
// (entry points extract_patches_flat / extract_patches_batched). The TPU
// kernel issued one strided DMA per patch into an 8-row / 128-lane aligned
// VMEM window and rolled the patch into place, because Mosaic needs tiled
// slice offsets. None of that applies here: every thread can address any
// element, so there is no alignment window, no roll, and none of the shape
// gates of patches_pallas.supports (W % 128, H % 8, M % 8) -- any shape is
// taken.
//
// Semantics (bit-identical to the plain version, it is a copy): patch m
// reads images[cam[m], cy - r + i, cx - r + j] with the centre clipped to
// [r, W-r-1] x [r, H-r-1] and the camera clipped to [0, C-1].
//
// What bounds it: bytes and launches. At the tracker's shapes (S = 19,
// M = 2048) a call moves ~3 MB, far below what the card streams in a
// microsecond, so one launch per call and coalesced row reads are what
// matter. One block per patch; its threads stride the S*S outputs in
// row-major order, so neighbouring threads read neighbouring pixels of a
// row and write neighbouring outputs.

#include <cuda_runtime.h>

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ images,
                                      const int* __restrict__ cam,
                                      const int* __restrict__ centers,
                                      float* __restrict__ out, int C, int H, int W,
                                      int S) {
  const int m = blockIdx.x;
  const int r = S / 2;
  int c = cam[m];
  c = c < 0 ? 0 : (c > C - 1 ? C - 1 : c);
  int cx = centers[2 * m];
  int cy = centers[2 * m + 1];
  cx = cx < r ? r : (cx > W - r - 1 ? W - r - 1 : cx);
  cy = cy < r ? r : (cy > H - r - 1 ? H - r - 1 : cy);
  const float* src = images + (size_t)c * H * W + (size_t)(cy - r) * W + (cx - r);
  float* dst = out + (size_t)m * S * S;
  const int n = S * S;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int i = k / S;
    const int j = k - i * S;
    dst[k] = src[(size_t)i * W + j];
  }
}

}  // namespace

extern "C" int thor_patches_gather(const float* images, const int* cam, const int* centers,
                                   float* out, int C, int H, int W, int M, int S,
                                   void* stream) {
  if (M > 0) {
    const int threads = S * S >= 256 ? 256 : 128;
    gather_patches_kernel<<<M, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        images, cam, centers, out, C, H, W, S);
  }
  return static_cast<int>(cudaGetLastError());
}
