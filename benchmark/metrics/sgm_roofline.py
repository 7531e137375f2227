"""sgm_roofline (%): the RGB-D product's hand-written SGM kernels
(``csrc/sgm.cu``: the path-aggregation scan and the winner / left-right
pass) against the chip's memory bandwidth: the sum of each call's least
time (its bytes over the peak) over the sum of their profiled device times.

Bytes of one call, from its arguments, for a (D, H, W) volume:

* the 4-path aggregation (three scan launches): the cost volume read and
  the aggregated volume written, 2 D H W float32;
* winner / left-right: the aggregated volume read and six H x W planes
  written (D H W + 6 H W, 4 bytes each).
"""

from benchmark.core.peaks import hbm_bytes_per_s

KERNELS = ("sgm_scan_kernel", "winner_lr_kernel")


def aggregate_bytes(cost_dhw, p1, p2, num_paths=4):
    return 2 * cost_dhw.numel() * 4


def winner_bytes(agg, num_disparities):
    d, h, w = agg.shape
    return (d * h * w + 6 * h * w) * 4


LAUNCHERS = {
    "thor_slam_tpu_torch.ops.sgm_cuda.sgm_aggregate_4dir_cuda": aggregate_bytes,
    "thor_slam_tpu_torch.ops.sgm_cuda.winner_lr_cuda": winner_bytes,
}


def read(run):
    s, nbytes = run.summary, run.launch_bytes.get("sgm_roofline")
    if s is None or not nbytes or s.seconds(*KERNELS) <= 0:
        return None
    return 100.0 * sum(nbytes) / hbm_bytes_per_s(run.device_name) / s.seconds(*KERNELS)
