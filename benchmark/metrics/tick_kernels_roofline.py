"""tick_kernels_roofline (%): the tracker's hand-written kernels, the patch
gather (``csrc/patches.cu``) and FAST-9 with its non-maximum suppression
(``csrc/fast.cu``), against the chip's memory bandwidth: the sum of each
launch's least time (its bytes over the peak, each input byte read once and
each output byte written once) over the sum of their profiled device times.

Bytes of one launch, from its arguments:

* gather of n stacks (1 or 2) at M patch centres of side S: the patch
  pixels read and the patches written (2 n M S^2 float32), the camera index
  (M int32), the centres (n M 2 int32) and, for a pair, the clipped centres
  written (n M 2 int32);
* FAST on C images of H x W: the images read, the raw and suppressed maps
  written (3 C H W float32).
"""

from benchmark.core.peaks import hbm_bytes_per_s

KERNELS = ("gather_patches_kernel", "fast_nms_kernel")


def gather_bytes(stacks, cam, centers, size, want_clipped):
    n, m = len(stacks), int(cam.shape[0])
    return 2 * n * m * size * size * 4 + m * 4 + n * m * 2 * 4 * (2 if want_clipped else 1)


def fast_bytes(images, threshold):
    return 3 * images.numel() * 4


LAUNCHERS = {
    "thor_slam_tpu_torch.ops.patches_cuda._launch": gather_bytes,
    "thor_slam_tpu_torch.ops.fast_cuda.fast_scores_cuda": fast_bytes,
}


def read(run):
    s, nbytes = run.summary, run.launch_bytes.get("tick_kernels_roofline")
    if s is None or not nbytes or s.seconds(*KERNELS) <= 0:
        return None
    return 100.0 * sum(nbytes) / hbm_bytes_per_s(run.device_name) / s.seconds(*KERNELS)
