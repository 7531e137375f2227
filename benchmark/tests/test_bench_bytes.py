"""The roofline readers' byte counts against PERF.md's at the 640x400 shapes."""

import pytest
import torch

from benchmark.core import spec


def test_kernel_bytes_at_the_main_path_shapes():
    tick = spec.reader("tick_kernels_roofline")
    sgm = spec.reader("sgm_roofline")
    m, s = 2048, 19
    stacks = (torch.empty(4, 400, 640), torch.empty(4, 400, 640))
    cam, centers = torch.empty(m, dtype=torch.int32), torch.empty(2 * m, 2, dtype=torch.int32)
    assert tick.gather_bytes(stacks, cam, centers, s, want_clipped=True) / 1e6 == pytest.approx(11.90, abs=0.005)
    assert tick.fast_bytes(torch.empty(8, 400, 640), 0.05) / 1e6 == pytest.approx(24.6, abs=0.05)
    vol = torch.empty(64, 400, 640)
    assert sgm.aggregate_bytes(vol, 6.0, 96.0) / 1e6 == pytest.approx(131.1, abs=0.05)
    assert sgm.winner_bytes(vol, 64) / 1e6 == pytest.approx(71.7, abs=0.05)
    # A single stack: pixels and patches, the camera index and the centres.
    single = tick.gather_bytes(stacks[:1], cam, centers[:m], s, want_clipped=False)
    assert single == 2 * m * s * s * 4 + m * 3 * 4


def test_roofline_reads_nothing_without_a_trace():
    run = type("R", (), {"summary": None, "launch_bytes": {}, "device_name": "NVIDIA H100 80GB HBM3"})()
    assert spec.reader("tick_kernels_roofline").read(run) is None
    assert spec.reader("sgm_roofline").read(run) is None


def test_roofline_share_from_bytes_and_kernel_time():
    from benchmark.core.trace import TraceSummary

    s = TraceSummary(1.0, 0.5, 10, 1, ops=[("gather_patches_kernel(GatherArgs)", 0.0, 2e-5),
                                            ("fast_nms_kernel", 1e-4, 1.2e-4)])
    run = type("R", (), {"summary": s, "launch_bytes": {"tick_kernels_roofline": [3.35e7, 3.35e7]},
                         "device_name": "NVIDIA H100 80GB HBM3"})()
    assert spec.reader("tick_kernels_roofline").read(run) == pytest.approx(100 * 2e-5 / 4e-5)
