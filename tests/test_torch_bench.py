"""The port's benchmark (``thor_slam_tpu_torch/bench.py``) against the
reference's root ``bench.py``, on the CPU.

* ``_palindrome`` and ``_payload_stats`` give the reference's values, and
  the sync factory the reference's frame sets: frames, timestamps, names
  and IMU batches equal (exactly: both are host code on the same arrays).
* The printed result dict has the reference's keys, read from the literal
  in its ``main`` by the AST (``import bench`` loads no JAX, but the dict is
  built inside ``main``).
* ``_bench_e2e(mode="stream")`` at 1 camera, 160x96, warm-up 2, 3 frames
  a trial, in both packages on the same uint8 frames: the payload mix of
  the timed window is equal, the final pose within 1 cm (the engine
  tests' bar).
* ``_bench_mapping`` at the deployed grid with small frame counts (through
  ``--mapping-only``) gives finite figures and a mesh; ``main`` at a tiny size prints one JSON line
  and exits 0 (the test shrinks the SGM and mapping phases' counts by
  monkeypatching: the bench has no switch for them); ``main`` without a
  CUDA device and without ``--device`` exits non-zero, printing nothing.
* The 720p flagship rig's calibration and setup equal the reference's.
  ``-m slow``: both engines on 12 ticks of that rig's sequence, each ATE
  printed and under 5 cm.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
from thor_slam_tpu.utils import flagship as jflagship
from thor_slam_tpu_torch import bench as tbench
from thor_slam_tpu_torch.utils import flagship as tflagship

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
#: The tiny size of the CPU runs: (cameras, width, height).
TINY = (1, 160, 96)
TINY_ENV = dict(BENCH_CAMS="1", BENCH_WIDTH="160", BENCH_HEIGHT="96", BENCH_WARMUP="2", BENCH_FRAMES="3",
                BENCH_SEQ="4", BENCH_SKIP_640="1", BENCH_SKIP_DEFAULT="1")
#: Small counts of the mapping phase (the grid stays the deployed one).
SMALL_MAPPING = dict(reps=2, stream_frames=2, scan_frames=2)


def _host_seq(num_cams, width, height, seq_len):
    """The flagship rig's uint8 host frames, rendered on the host (equal to
    the reference's render byte for byte), the reference's conversion."""
    sources = tflagship.flagship_rig(num_cams=num_cams, width=width, height=height, max_keypoints=256)[3]
    return np.clip(tflagship.render_sequence(sources, seq_len) * 255.0, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("n", [2, 3, 4, 12])
def test_palindrome_equals_reference(n):
    assert [tbench._palindrome(i, n) for i in range(5 * n)] == [jbench._palindrome(i, n) for i in range(5 * n)]


@pytest.mark.parametrize("ticks", [0, 7])
def test_payload_stats_equal_reference(ticks):
    before = dict(full=3, light=1, light_half=0, bytes=1000)
    after = dict(full=3 + ticks, light=1 + 2 * ticks, light_half=ticks, bytes=1000 + 4096 * ticks)
    assert tbench._payload_stats(after, before) == jbench._payload_stats(after, before)


def _frame_set_fields(sync):
    out = [sync.timestamp, sync.max_time_delta, sync.sensor_timestamp, sorted(sync.frame_sets)]
    for name, fset in sorted(sync.frame_sets.items()):
        out += [fset.timestamp, fset.source_name]
        out += [(f.timestamp, f.sequence_num, f.camera_name, f.image.tobytes()) for f in fset.frames]
    sd = sync.sensor_data
    out.append(None if sd is None else {k: np.asarray(v).tolist() for k, v in sd.items()})
    return out


@pytest.mark.parametrize("with_imu", [False, True])
def test_sync_factory_equals_reference(with_imu):
    seq_len = 4
    host_seq = np.random.default_rng(0).integers(0, 255, (seq_len, 2, 2, 6, 8), dtype=np.uint8)
    t_cal = tflagship.flagship_rig(num_cams=2, width=64, height=48, max_keypoints=16)[2]
    j_cal = jflagship.flagship_rig(num_cams=2, width=64, height=48, max_keypoints=16)[2]
    assert list(t_cal.source_names) == list(j_cal.source_names)
    t_make = tbench._make_sync_factory(t_cal, host_seq, seq_len, 30.0, with_imu)
    j_make = jbench._make_sync_factory(j_cal, host_seq, seq_len, 30.0, with_imu)
    for i in range(9):  # past the palindrome's turn
        assert _frame_set_fields(t_make(i)) == _frame_set_fields(j_make(i))


def _reference_result_keys() -> list[str]:
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    literal = next(
        n.value for n in ast.walk(main)
        if isinstance(n, ast.Assign) and [t.id for t in n.targets if isinstance(t, ast.Name)] == ["result"]
    )
    return [k.value for k in literal.keys]


@pytest.fixture(scope="module")
def tiny_main():
    """One CPU run of ``main`` at the tiny size: (exit code, stdout, stderr)."""
    patch = pytest.MonkeyPatch()
    try:
        for k, v in TINY_ENV.items():
            patch.setenv(k, v)
        patch.setattr(tbench, "_bench_sgm", functools.partial(tbench._bench_sgm, width=64, height=48, reps=2))
        patch.setattr(tbench, "_bench_mapping", functools.partial(tbench._bench_mapping, **SMALL_MAPPING))
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tbench.main(["--device", "cpu"])
    finally:
        patch.undo()
    return rc, out.getvalue(), err.getvalue()


def test_main_prints_one_json_line_and_exits_0(tiny_main):
    rc, out, err = tiny_main
    assert rc == 0, err
    lines = out.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["phases_skipped"] == []
    assert result["device"] == "cpu"
    # Every row of an enabled phase is filled (the 640x400 and default rows
    # are switched off at this size).
    for key in ("value", "vs_baseline", "device_tick_fps", "num_inliers_scan_last", "num_inliers_last", "e2e_fps",
                "e2e_vs_baseline", "e2e_deferred_fps", "transfer_bound_fps", "sgm_640x400_64_ms",
                "tsdf_integrate_640x400_ms", "tsdf_scan_ms_per_frame", "mesh_extract_ms", "esdf_slice_ms"):
        assert result[key] is not None, key
    assert set(result["phase_s"]) == {"device_scan", "device_tick", "sgm", "mapping", "render_720", "e2e_deferred",
                                      "e2e_stream"}
    assert "kernel launches" in err.splitlines()[-1]


def test_result_keys_equal_reference(tiny_main):
    keys = list(json.loads(tiny_main[1])) if tiny_main[1] else []
    assert keys == _reference_result_keys()


def test_main_without_cuda_and_without_device_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def test_bench_mapping_at_small_counts(monkeypatch, capsys):
    """``--mapping-only`` runs the mapping phase alone: one JSON line of
    finite, positive figures and a mesh with vertices."""
    monkeypatch.setattr(tbench, "_bench_mapping", functools.partial(tbench._bench_mapping, **SMALL_MAPPING))
    assert tbench.main(["--mapping-only", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    vals = json.loads(lines[0])
    assert all(math.isfinite(vals[k]) and vals[k] > 0 for k in ("integrate_ms", "scan_ms", "mesh_ms", "esdf_ms"))
    assert vals["vertices"] > 0


def test_e2e_stream_row_matches_reference(monkeypatch):
    """Both packages' ``_bench_e2e`` on the same frames: the same payload
    mix (full, light and half-res ticks and their bytes), final poses
    within 1 cm."""
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    num_cams, width, height = TINY
    seq_len, warmup, frames = 4, 2, 3
    host_seq = _host_seq(num_cams, width, height, seq_len)
    flushed = {}
    for name, cls in (("port", TorchSlamEngine), ("reference", TpuSlamEngine)):
        def flush(self, _orig=cls.flush, _name=name):
            pose = _orig(self)
            flushed[_name] = pose
            return pose

        monkeypatch.setattr(cls, "flush", flush)
    t_cal = tflagship.flagship_rig(num_cams=num_cams, width=width, height=height, max_keypoints=256)[2]
    j_cal = jflagship.flagship_rig(num_cams=num_cams, width=width, height=height, max_keypoints=256)[2]
    t_fps, _t_diag, t_bound, t_payload = tbench._bench_e2e(
        t_cal, host_seq, seq_len, warmup, frames, "stream", torch.device("cpu")
    )
    j_fps, _j_diag, _j_bound, j_payload = jbench._bench_e2e(j_cal, host_seq, seq_len, warmup, frames, "stream")
    assert t_fps > 0 and j_fps > 0 and t_bound[0] > 0
    assert t_payload == j_payload
    assert t_payload["ticks"] == 2 * frames
    t_pos, j_pos = flushed["port"].position, flushed["reference"].position
    assert np.linalg.norm(np.asarray(t_pos) - np.asarray(j_pos)) < 0.01


def test_720p_flagship_calibration_and_setup_equal_reference():
    t_params, t_setup, t_cal, *_ = tflagship.flagship_rig(4, 1280, 720, 256)
    j_params, j_setup, j_cal, *_ = jflagship.flagship_rig(4, 1280, 720, 256)
    assert (t_params.num_cams, t_params.height, t_params.width, t_params.max_keypoints) == (
        j_params.num_cams, j_params.height, j_params.width, j_params.max_keypoints
    ) == (4, 720, 1280, 256)
    for field in t_setup._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t_setup, field)), np.asarray(getattr(j_setup, field)),
                                      err_msg=field)
    assert list(t_cal.source_names) == list(j_cal.source_names)
    for name in t_cal.source_names:
        t_int, j_int = t_cal.intrinsics[name], j_cal.intrinsics[name]
        assert [(i.width, i.height) for i in t_int] == [(i.width, i.height) for i in j_int] == [(1280, 720)] * 2
        for a, b in zip(t_int, j_int):
            np.testing.assert_array_equal(a.matrix, b.matrix)
            np.testing.assert_array_equal(a.coeffs, b.coeffs)
        for a, b in zip(t_cal.extrinsics[name], j_cal.extrinsics[name]):
            np.testing.assert_array_equal(a.to_4x4_matrix(), b.to_4x4_matrix())
        np.testing.assert_array_equal(t_cal.rig_extrinsics[name].to_4x4_matrix(),
                                      j_cal.rig_extrinsics[name].to_4x4_matrix())


@pytest.mark.slow
def test_720p_flagship_both_engines_track_12_ticks(capsys):
    """Both engines, synchronous and VO only (the bench's 256 slots), on 12
    ticks of the 4x1280x720 flagship's frames: ATE printed, each < 5 cm."""
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.slam.interface import SlamConfig as JSlamConfig
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse

    ticks = 12
    host_seq = _host_seq(4, 1280, 720, ticks)
    traj = tflagship.flagship_rig(4, 1280, 720, 256)[5]
    args = dict(params=dict(max_keypoints=256), use_imu=False, enable_ba=False, adaptive_half_res=False)
    ates = {}
    for name, flagship, make, config in (
        ("port", tflagship, lambda: TorchSlamEngine(device="cpu", **args), SlamConfig),
        ("reference", jflagship, lambda: TpuSlamEngine(**args), JSlamConfig),
    ):
        cal = flagship.flagship_rig(4, 1280, 720, 256)[2]
        bench = tbench if name == "port" else jbench
        make_sync = bench._make_sync_factory(cal, host_seq, ticks, 30.0, False)
        engine = make()
        engine.initialize(cal, config(num_cameras=8, enable_loop_closure=False))
        est, gt = [], []
        gt0 = traj.pose(0.0)
        for i in range(ticks):
            sync = make_sync(i)
            pose = engine.process_frames(sync)
            if pose is not None:
                est.append(pose.position.copy())
                gt.append((np.linalg.inv(gt0) @ traj.pose(sync.timestamp))[:3, 3])
        engine.shutdown()
        ates[name] = ate_rmse(np.asarray(est), np.asarray(gt))
    with capsys.disabled():
        print(f"\n720p flagship, 12 ticks: ATE port {ates['port'] * 100:.3f} cm, "
              f"reference {ates['reference'] * 100:.3f} cm")
    assert ates["port"] < 0.05 and ates["reference"] < 0.05
