"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives a whole run of a cell at a
CPU size, with one fault planted in the program where it happens: a step
that hands back its state unchanged, an answer altered where it is
produced, half of a batch (the image rows of the depth product) left out,
a correction gone wrong on keyframe ticks alone (which moves no median).
The exchange between chips has no cell here: every cell takes one chip.
"""

import numpy as np
import pytest
import torch

from benchmark.run import run_cell

CADENCE = "oak4-640x400-deployed.cadence30-map"
REPLAY = "oak4-1280x720-flagship.replay-vo"


def _run(small_cell, name, seconds=3.0, log=lambda m: None, **mix_update):
    cell, cfg, mix, limits, bench = small_cell(name)
    mix.update(mix_update)
    return run_cell(cell, cfg, mix, limits, bench, 3000000019, seconds, False, torch.device("cpu"), log=log)


def _failing(result):
    return sorted(n for n, c in result["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("name", [CADENCE, REPLAY])
def test_sound_run_is_correct(small_cell, name):
    result = _run(small_cell, name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", [CADENCE, REPLAY])
def test_step_that_returns_its_state_unchanged(small_cell, monkeypatch, name):
    from thor_slam_tpu_torch.engine import tracker

    real, calls = tracker.track_step, []

    def frozen(params, setup, state, images, **kw):
        if len(calls) < 6:
            calls.append(real(params, setup, state, images, **kw))
        return state if len(calls) == 6 else calls[-1][0], calls[-1][1]

    monkeypatch.setattr(tracker, "track_step", frozen)
    result = _run(small_cell, name)
    assert not result["correct"] and "rpe_med_mrad" in _failing(result)


@pytest.mark.parametrize("name", [CADENCE, REPLAY])
def test_pose_altered_where_it_is_produced(small_cell, monkeypatch, name):
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamPose

    real = TorchSlamEngine._finalize_values

    def altered(self, rec):
        pose = real(self, rec)
        k = int(round(rec["ts"] * 30))
        if pose is not None and k >= 20:  # from the 20th tick on, each pose turned and moved by its own amount
            a = 0.02 * (k % 5 - 2)
            turn = np.eye(4)
            turn[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            turn[0, 3] = a
            pose = SlamPose.from_4x4_matrix(pose.to_4x4_matrix() @ turn, timestamp=pose.timestamp,
                                            tracking_state=pose.tracking_state, confidence=pose.confidence)
        return pose

    monkeypatch.setattr(TorchSlamEngine, "_finalize_values", altered)
    result = _run(small_cell, name, seconds=4.0)
    assert not result["correct"] and "rpe_med_mrad" in _failing(result)


def test_ba_correction_perturbed_on_keyframes(small_cell, monkeypatch):
    """BA runs on keyframe ticks only; each of its corrections, accepted or
    not, is turned by 5 mrad and moved by 5 mm on the way into the tracker.
    The landmarks are left where BA put them, so the next ticks' solves pull
    the pose back: a minority of steps is off, and no median moves."""
    from thor_slam_tpu_torch.engine.backends import track_ba

    real, calls = track_ba.TrackBA.run, []
    a = 0.005
    extra = np.eye(4)
    extra[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    extra[0, 3] = 0.005

    def perturbed(self, world_t_body, covariance, state, diagnostics):
        state, new_world, t_corr = real(self, world_t_body, covariance, state, diagnostics)
        calls.append(1)
        state = state._replace(world_t_body=torch.as_tensor(extra, dtype=torch.float32) @ state.world_t_body)
        return state, extra @ new_world, extra @ (np.eye(4) if t_corr is None else t_corr)

    monkeypatch.setattr(track_ba.TrackBA, "run", perturbed)
    logs = []
    # A longer sweep than the other faults' turns the rig far enough for keyframes.
    result = _run(small_cell, CADENCE, seconds=8.0, log=logs.append, cycle_frames=60)
    window = next(m for m in logs if m.startswith("window"))
    assert calls and " 0 keyframes" not in window, window
    assert not result["correct"] and _failing(result) == ["steps_off_pct"], result["checks"]


def test_depth_altered_where_it_is_produced(small_cell, monkeypatch):
    from thor_slam_tpu_torch.ops import stereo

    real = stereo.depth_to_millimeters_u16

    def altered(depth_m):
        return real(depth_m + 0.004 * (torch.arange(depth_m.shape[-1]) % 7 == 0))

    monkeypatch.setattr(stereo, "depth_to_millimeters_u16", altered)
    result = _run(small_cell, CADENCE)
    assert not result["correct"] and "depth_bad_px_pct" in _failing(result)


def test_half_of_the_rows_left_out(small_cell, monkeypatch):
    from thor_slam_tpu_torch.ops import stereo

    real = stereo.sgm_disparity

    def half(left, right, **kw):
        disp, valid = real(left, right, **kw)
        keep = torch.arange(disp.shape[0])[:, None] % 2 == 0
        return torch.where(keep, disp, 0.0), valid & keep

    monkeypatch.setattr(stereo, "sgm_disparity", half)
    result = _run(small_cell, CADENCE)
    assert not result["correct"] and "depth_bad_px_pct" in _failing(result)


def test_map_altered_where_it_is_produced(small_cell, monkeypatch):
    from thor_slam_tpu_torch.mapping import tsdf

    real, n = tsdf._integrate_one, [0]

    def altered(spec, grid, *args):
        real(spec, grid, *args)
        n[0] += 1
        if n[0] == 3:
            grid.tsdf[::3] += 0.004

    monkeypatch.setattr(tsdf, "_integrate_one", altered)
    result = _run(small_cell, CADENCE)
    assert not result["correct"] and _failing(result) == ["tsdf_bad_vox_pct"]
