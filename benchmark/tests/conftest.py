"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

``small_cell`` shrinks a cell's configuration and mix to a size the CPU
runs in seconds, keeping its layers, and feeds it in a closed loop (the
CPU's ticks are slow enough for the camera clock to skip most frames);
``cuda_device`` skips a test marked ``cuda`` where no card is visible,
deciding when the test runs.
"""

import copy

import pytest


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def shrink(cfg: dict, mix: dict) -> tuple[dict, dict]:
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["rig"].update(width=160, height=100)
    if cfg["rig"].get("color_resolution"):
        cfg["rig"]["color_resolution"] = [320, 200]
    cfg["engine"]["params"]["max_keypoints"] = 64
    if cfg.get("rgbd"):
        cfg["rgbd"]["num_disparities"] = 16
    if cfg.get("mapping"):
        cfg["mapping"]["dims"] = [48, 48, 32]
    mix.pop("warmup_s", None)
    mix.update(generator="closed_loop", cycle_frames=14, warmup_ticks=4, trace_ticks=4)
    if mix.get("depth_sample"):
        mix["depth_sample"] = 2
    return cfg, mix


#: Limits at the CPU size, where 160x100 images and 64 slots track to a
#: median step error of 0.24-0.43 mrad and 1.3-2.1 mm (2.1-7.0 mm between
#: the poses a depth-6 pipeline hands over), and the reference in bfloat16
#: reads 0.89 mrad or more (my CPU runs over eight seeds a cell, 3 s
#: windows; the cells' own limits are set from runs at their sizes,
#: PERF.md). The depth and the map are exact at any size.
SMALL_LIMITS = {"rpe_med_mrad": 0.6, "rpe_med_mm": 3.0, "steps_off_pct": 5.0, "pose_err_mrad": 2.0,
                "depth_bad_px_pct": 1.0, "tsdf_bad_vox_pct": 1.0}


@pytest.fixture
def small_cell():
    """``small_cell(name)`` -> (cell, config, mix, limits, bench) at a CPU size."""
    from benchmark.core import spec

    def make(name):
        bench = spec.load_benchmark()
        cell = spec.cell(name, bench)
        cfg, mix = shrink(spec.config(cell["config"], bench), spec.traffic(cell["traffic"]))
        return cell, cfg, mix, {k: SMALL_LIMITS[k] for k in spec.limits(name)}, bench

    return make
