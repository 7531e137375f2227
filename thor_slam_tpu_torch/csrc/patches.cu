// Patch gather: (M, S, S) float32 patches from a (C, H, W) float32 stack, or
// from two stacks of equal shape in one launch, (2, M, S, S).
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
// Semantics (bit-identical to the plain version, it is a copy): patch m of
// stack s reads images_s[cam[m], cy - r + i, cx - r + j] with the centre
// (cx, cy) = centers[s, m] clipped to [r, W-r-1] x [r, H-r-1] and the camera
// clipped to [0, C-1]. The clipped centres are written out as well
// (clipped[s, m]) when the caller asks for them: KLT needs them, and the
// kernel has them in a register anyway.
//
// What bounds it: latency, then bytes. A call moves a few MB (5.9 MB a
// stack at S = 19, M = 2048), which the card streams in under 2 us and
// mostly finds in L2, so the time is the launch, one round of dependent
// loads (indices, then pixels) and the block scheduler's rate. The design:
//   * both frames of a KLT level (or both eyes' BRIEF patches) go in one
//     launch, blockIdx.y picks the stack, so the fixed cost is paid once;
//   * a group of threads per patch (a warp at S = 19, four warps at S = 37,
//     so a thread moves ~12 floats) and 256-thread blocks: 8 (or 2) patches
//     a block instead of one, a quarter of the blocks to schedule;
//   * S is a template parameter for 19 and 37: the row/column split of the
//     flat index is a multiply-shift by a constant, the loop is unrolled,
//     and every load of a thread is issued before its first store, so a
//     thread has all its ~12 reads in flight at once. Other odd sizes take
//     a generic instantiation that walks (row, column) counters, with no
//     division in the loop;
//   * a group's threads run over the flat (i, j) index, so a warp writes
//     128 contiguous bytes per store and reads two or three row segments
//     per load; indices are loaded once per thread group as a broadcast.
// Tried on the card and dropped: staging a block's patches in shared memory
// and writing them out as 16-byte stores (the block's output is one aligned
// contiguous run when it holds a multiple of 4 patches): no faster at
// S = 19 and a little faster at S = 37, for a barrier and a second copy
// loop; a half-warp a patch, and 64 threads a patch, at S = 19 (64 and 256
// at S = 37): both slower than a warp (128 at S = 37). The reads stay
// 4-byte: a 19-float row starts at any address. PERF.md has the times of
// the kept design.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct GatherArgs {
  const float* images0;
  const float* images1;
  long long cam_stride0;  // elements between cameras of stack 0 (rows are W apart)
  long long cam_stride1;
  const int* cam;      // (M,)
  const int* centers;  // (stacks, M, 2)
  float* out;          // (stacks, M, S, S)
  int* clipped;        // (stacks, M, 2) or nullptr
  int C, H, W, M, S;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// S > 0: compile-time patch side. S == 0: any odd side, from args.S.
// GROUP threads copy one patch; a block holds kThreads / GROUP patches.
template <int S, int GROUP>
__global__ void __launch_bounds__(kThreads) gather_patches_kernel(const GatherArgs a) {
  const int stack = blockIdx.y;
  const int lane = threadIdx.x % GROUP;
  const int m = blockIdx.x * (kThreads / GROUP) + threadIdx.x / GROUP;
  if (m >= a.M) return;
  const int size = S > 0 ? S : a.S;
  const int r = size / 2;
  const size_t p = (size_t)stack * a.M + m;
  const int c = clampi(a.cam[m], 0, a.C - 1);
  const int cx = clampi(a.centers[2 * p], r, a.W - r - 1);
  const int cy = clampi(a.centers[2 * p + 1], r, a.H - r - 1);
  if (lane == 0 && a.clipped != nullptr) {
    a.clipped[2 * p] = cx;
    a.clipped[2 * p + 1] = cy;
  }
  const float* src = (stack == 0 ? a.images0 + (size_t)c * a.cam_stride0
                                 : a.images1 + (size_t)c * a.cam_stride1) +
                     (size_t)(cy - r) * a.W + (cx - r);
  float* dst = a.out + p * size * size;
  const int skip = a.W - size;  // flat patch index k lies at src[k + (k / S) * skip]
  if constexpr (S > 0) {
    constexpr int kPerThread = (S * S + GROUP - 1) / GROUP;
    float v[kPerThread];
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int k = lane + t * GROUP;
      if (k < S * S) v[t] = __ldg(src + k + (k / S) * skip);
    }
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int k = lane + t * GROUP;
      if (k < S * S) dst[k] = v[t];
    }
  } else {
    int i = lane / size;  // once a thread; the loop below only counts
    int j = lane - i * size;
    const int n = size * size;
    for (int k = lane; k < n; k += GROUP) {
      dst[k] = __ldg(src + (size_t)i * a.W + j);
      j += GROUP;
      while (j >= size) {
        j -= size;
        ++i;
      }
    }
  }
}

template <int S, int GROUP>
void launch(const GatherArgs& a, int stacks, cudaStream_t stream) {
  constexpr int kPatches = kThreads / GROUP;
  const dim3 grid((a.M + kPatches - 1) / kPatches, stacks);
  gather_patches_kernel<S, GROUP><<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace

// images1 is read only when stacks == 2; clipped may be null.
extern "C" int thor_patches_gather(const float* images0, const float* images1,
                                   long long cam_stride0, long long cam_stride1, const int* cam,
                                   const int* centers, float* out, int* clipped, int stacks, int C,
                                   int H, int W, int M, int S, void* stream) {
  if (M > 0 && stacks > 0) {
    const GatherArgs a{images0, images1, cam_stride0, cam_stride1, cam, centers,
                       out,     clipped, C,           H,           W,   M,       S};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (S == 19) {
      launch<19, 32>(a, stacks, s);
    } else if (S == 37) {
      launch<37, 128>(a, stacks, s);
    } else {
      launch<0, 32>(a, stacks, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
