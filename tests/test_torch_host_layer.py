"""The port's own host layer against the JAX package's framework-free modules.

``thor_slam_tpu_torch`` keeps copies of ``geometry``, ``camera.types``,
``camera.rig``, ``camera.sources.synthetic``, ``slam.interface``,
``utils.evaluation``, ``engine.backends.light``, ``engine.pipeline_exec``,
``pipeline.bus``, ``utils.config``, ``utils.profiling``, ``camera.utils``,
``camera.sources.dataset``, ``camera.sources.luxonis`` and
``slam.adapters`` (``tests/test_torch_sources.py`` and
``test_torch_adapters.py`` run those on the same inputs; here their code is
held to the original's, line for line), so that it imports nothing of the
JAX package. These tests hold each copy to the
module it copies on the same seeded inputs (all exact: the copies run the
same numpy code; the light module's and the bus's code is the original's,
line for line; the pipeline executor asks a record's event, not its device
array, whether it is ready; the config reads the deployed YAML alike), and
guard that no module of the port, nor ``chip_smoke.py``, loads JAX, the
JAX package, pyyaml, cv2, depthai or rclpy.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from thor_slam_tpu import geometry as jgeom
from thor_slam_tpu.camera.rig import CameraRig as JaxCameraRig
from thor_slam_tpu.camera.sources import synthetic as jsyn
from thor_slam_tpu.engine import pipeline_exec as jpipe
from thor_slam_tpu.engine.backends import light as jlight
from thor_slam_tpu.pipeline import bus as jbus
from thor_slam_tpu.slam import interface as jiface
from thor_slam_tpu.utils import config as jconfig
from thor_slam_tpu.utils import evaluation as jeval
from thor_slam_tpu.utils import profiling as jprof
from thor_slam_tpu_torch import geometry as tgeom
from thor_slam_tpu_torch.camera.rig import CameraRig as PortCameraRig
from thor_slam_tpu_torch.camera.sources import synthetic as tsyn
from thor_slam_tpu_torch.engine import pipeline_exec as tpipe
from thor_slam_tpu_torch.engine.backends import light as tlight
from thor_slam_tpu_torch.pipeline import bus as tbus
from thor_slam_tpu_torch.slam import interface as tiface
from thor_slam_tpu_torch.utils import config as tconfig
from thor_slam_tpu_torch.utils import evaluation as teval
from thor_slam_tpu_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parents[1]


def _quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _rot(rng):
    return jgeom.quat_to_matrix(_quat(rng))


# function name -> maker of its seeded arguments
GEOMETRY_CASES = {
    "quat_identity": lambda rng: (),
    "quat_normalize": lambda rng: (rng.normal(size=4),),
    "quat_multiply": lambda rng: (_quat(rng), _quat(rng)),
    "quat_conjugate": lambda rng: (_quat(rng),),
    "quat_to_matrix": lambda rng: (rng.normal(size=4),),
    "matrix_to_quat": lambda rng: (_rot(rng),),
    "quat_rotate": lambda rng: (_quat(rng), rng.normal(size=(7, 3))),
    "axis_angle_to_quat": lambda rng: (rng.normal(size=3), float(rng.uniform(-np.pi, np.pi))),
    "euler_xyz_extrinsic_to_matrix": lambda rng: tuple(float(a) for a in rng.uniform(-np.pi, np.pi, 3)),
    "se3_matrix": lambda rng: (_rot(rng), rng.normal(size=3)),
    "se3_inverse": lambda rng: (jgeom.se3_matrix(_rot(rng), rng.normal(size=3)),),
    "se3_from_pose": lambda rng: (rng.normal(size=3), _quat(rng)),
    "pose_from_se3": lambda rng: (jgeom.se3_matrix(_rot(rng), rng.normal(size=3)),),
    "rotate_cov6": lambda rng: (_rot(rng), np.cov(rng.normal(size=(6, 20)))),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_geometry_matches_reference(name):
    rng = np.random.default_rng(sorted(GEOMETRY_CASES).index(name))
    for _ in range(5):
        args = GEOMETRY_CASES[name](rng)
        want = getattr(jgeom, name)(*args)
        got = getattr(tgeom, name)(*args)
        for g, w in zip(np.atleast_1d(got) if not isinstance(got, tuple) else got,
                        np.atleast_1d(want) if not isinstance(want, tuple) else want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["FLU_FROM_RDF", "RDF_FROM_FLU", "RDF_FROM_DRB"])
def test_frame_constants_match_reference(name):
    np.testing.assert_array_equal(getattr(tgeom, name), getattr(jgeom, name))


def _spec(pkg, **kw):
    base = dict(num_sources=2, stereo=True, width=64, height=48, fps=30.0, baseline_m=0.1,
                color_camera=True, color_resolution=(48, 32))
    base.update(kw)
    return pkg.SyntheticRigSpec(**base)


@pytest.mark.parametrize("clock_offsets", [None, (0.0, 0.004)])
def test_synthetic_rig_renders_identically(clock_offsets):
    """Same spec and seed: byte-identical frames, IMU packets, trajectory
    poses and IMU samples in both packages."""
    rigs = [
        pkg.make_synthetic_rig(_spec(pkg), world=pkg.SyntheticWorld(half_extents=(3.0, 3.0, 2.0)),
                               trajectory=pkg.OrbitTrajectory(radius=1.2, angular_rate=0.4),
                               clock_offsets=clock_offsets)
        for pkg in (jsyn, tsyn)
    ]
    (j_src, j_ext, _, j_traj), (t_src, t_ext, _, t_traj) = rigs
    assert sorted(j_ext) == sorted(t_ext)
    for name in j_ext:
        np.testing.assert_array_equal(j_ext[name].to_4x4_matrix(), t_ext[name].to_4x4_matrix())
    for t in np.linspace(0.0, 2.0, 7):
        np.testing.assert_array_equal(j_traj.pose(t), t_traj.pose(t))
        for a, b in zip(j_traj.imu_sample(t), t_traj.imu_sample(t)):
            np.testing.assert_array_equal(a, b)
    for js, ts in zip(j_src, t_src):
        assert js.name == ts.name
        js.start()
        ts.start()
        for _ in range(3):
            jf, tf = js.get_latest_frames(), ts.get_latest_frames()
            assert len(jf) == len(tf)
            for a, b in zip(jf, tf):
                assert a.image.tobytes() == b.image.tobytes() and a.timestamp == b.timestamp
            jd, jt = js.get_timestamped_sensor_data()
            td, tt = ts.get_timestamped_sensor_data()
            assert jt == tt
            if jd is not None:
                for key in ("accelerometer", "gyroscope", "timestamps"):
                    np.testing.assert_array_equal(jd[key], td[key])
        ji, ti = js.get_intrinsics(), ts.get_intrinsics()
        for a, b in zip(ji, ti):
            np.testing.assert_array_equal(a.matrix, b.matrix)
        jc, tc = js.try_get_latest_rgb_frame(), ts.try_get_latest_rgb_frame()
        assert jc.image.tobytes() == tc.image.tobytes()
        np.testing.assert_array_equal(js.render_color_depth(jc.sequence_num), ts.render_color_depth(tc.sequence_num))


def test_frames_rendered_ahead_are_delivered_unchanged():
    """The port's source delivers frames handed to ``prerender`` (as a pool of
    processes renders them) and renders the others when due: the sequence is
    the reference's either way, and a frame rendered ahead is not rendered again."""
    (j_src, *_), (t_src, *_) = (pkg.make_synthetic_rig(_spec(pkg, num_sources=1)) for pkg in (jsyn, tsyn))
    js, ts = j_src[0], t_src[0]
    ts.prerender({(n, ci): ts.render_frame(n, ci) for n in (0, 2) for ci in (0, 1)})
    rendered = []
    render_frame = ts.render_frame
    ts.render_frame = lambda n, ci: rendered.append((n, ci)) or render_frame(n, ci)
    js.start()
    ts.start()
    for _ in range(4):
        for a, b in zip(js.get_latest_frames(), ts.get_latest_frames()):
            assert a.image.tobytes() == b.image.tobytes() and a.timestamp == b.timestamp
    assert rendered == [(1, 0), (1, 1), (3, 0), (3, 1)]


@pytest.mark.parametrize("clock_offsets", [(0.0, 0.004, -0.003), (0.0, 0.011, 0.02)])
def test_camera_rig_synchronizes_identically(clock_offsets):
    """Both packages' CameraRig pick the same reference timestamps, frames,
    time deltas and IMU batches from the same sources."""
    out = []
    for pkg, rig_cls in ((jsyn, JaxCameraRig), (tsyn, PortCameraRig)):
        sources, rig_ext, _, _ = pkg.make_synthetic_rig(
            _spec(pkg, num_sources=3, color_camera=False, color_resolution=None), clock_offsets=clock_offsets
        )
        seq = []
        with rig_cls(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as rig:
            for _ in range(6):
                sync = rig.get_synchronized_frames()
                seq.append(sync)
            names = rig.get_source_names()
        out.append((seq, names))
    (j_seq, j_names), (t_seq, t_names) = out
    assert j_names == t_names
    for a, b in zip(j_seq, t_seq):
        assert a.timestamp == b.timestamp and a.max_time_delta == b.max_time_delta
        assert a.sensor_timestamp == b.sensor_timestamp
        assert a.get_all_timestamps() == b.get_all_timestamps()
        for fa, fb in zip(a.get_all_frames(), b.get_all_frames()):
            assert fa.image.tobytes() == fb.image.tobytes()
        if a.sensor_data is not None:
            np.testing.assert_array_equal(a.sensor_data["gyroscope"], b.sensor_data["gyroscope"])


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_rmse_matches_reference(align, with_scale):
    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(size=(50, 3)), 0)
    est = gt @ jgeom.quat_to_matrix(_quat(rng)).T * 1.1 + rng.normal(scale=0.05, size=gt.shape)
    assert teval.ate_rmse(est, gt, align=align, with_scale=with_scale) == jeval.ate_rmse(
        est, gt, align=align, with_scale=with_scale
    )


def test_trajectory_metrics_match_reference():
    rng = np.random.default_rng(4)
    poses = np.stack([jgeom.se3_matrix(_rot(rng), rng.normal(size=3)) for _ in range(20)])
    noisy = poses.copy()
    noisy[:, :3, 3] += rng.normal(scale=0.01, size=(20, 3))
    assert teval.rpe_translation(noisy, poses) == jeval.rpe_translation(noisy, poses)
    assert teval.rotation_rmse_deg(noisy, poses) == jeval.rotation_rmse_deg(noisy, poses)


def test_slam_interface_types_match_reference():
    """The port's enum has the reference's members; a pose round-trips
    through both packages' SlamPose identically."""
    assert [s.name for s in tiface.TrackingState] == [s.name for s in jiface.TrackingState]
    assert tiface.TrackingState is not jiface.TrackingState
    rng = np.random.default_rng(5)
    m = jgeom.se3_matrix(_rot(rng), rng.normal(size=3))
    a = jiface.SlamPose.from_4x4_matrix(m, timestamp=1.5)
    b = tiface.SlamPose.from_4x4_matrix(m, timestamp=1.5)
    np.testing.assert_array_equal(a.to_4x4_matrix(), b.to_4x4_matrix())
    np.testing.assert_array_equal(a.position, b.position)
    assert tiface.SlamConfig().__dict__.keys() == jiface.SlamConfig().__dict__.keys()


@pytest.mark.parametrize("name", ["downsample2_host", "LightController"])
def test_light_module_is_the_reference_code(name):
    """The port's light module carries the original's code unchanged
    (tests/test_torch_light.py runs both on the same series)."""
    import inspect

    assert inspect.getsource(getattr(tlight, name)) == inspect.getsource(getattr(jlight, name))


class _Scripted:
    """Readiness read from a shared script: ``is_ready()`` as the
    reference asks a device array, ``query()`` as the port asks an event."""

    def __init__(self, ready: set, i: int) -> None:
        self._ready, self._i = ready, i

    def is_ready(self) -> bool:
        return self._i in self._ready

    query = is_ready


# (depth, defer_sync, steps): "s" submits the next record, "f" finalizes the
# ready batch (when at depth), "r<k>" marks record k ready, "d" drains.
EXECUTOR_SCRIPTS = [
    (1, False, "s f s r2 r3 s s f s d"),
    (3, False, "s s s r1 f s r3 r4 f s s r5 r6 r7 f f d"),
    (2, False, "r0 r1 r2 r3 s s f s f s f s d"),
    (4, True, "s s s s s r0 f s d"),
    (3, False, "s s s r2 f r1 f s s f d"),
]


@pytest.mark.parametrize("depth,defer,script", EXECUTOR_SCRIPTS)
def test_pipeline_executor_matches_reference(depth, defer, script):
    """The same fetch batches, finalize order and returned poses as the
    reference's executor over one script of submits, readiness changes,
    finalizes and a drain."""
    logs = []
    for mod in (jpipe, tpipe):
        ready: set = set()
        log: list = []
        ex = mod.PipelineExecutor(
            depth, defer,
            fetch=lambda recs, log=log: log.append(("fetch", [r["i"] for r in recs])),
            finalize=lambda rec, log=log: log.append(("fin", rec["i"])) or f"pose{rec['i']}",
        )
        n = 0
        for step in script.split():
            if step == "s":
                token = _Scripted(ready, n)
                ex.submit({"i": n, "packed": token, "event": token})
                n += 1
            elif step == "f":
                if ex.at_depth:
                    log.append(("pose", ex.finalize_ready()))
            elif step == "d":
                log.append(("drain", ex.drain(), len(ex)))
            else:
                ready.add(int(step[1:]))
        logs.append(log)
    assert logs[0] == logs[1]
    assert any(e[0] == "fetch" and len(e[1]) > 1 for e in logs[1])  # some fetch batched


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    """A fresh interpreter imports every module of the port and
    ``chip_smoke`` (the two-view bootstrap's, the mapper's, the runners',
    the sources', the ROS adapters', the multi-device ``parallel/``
    package's, the measurement scripts', the device renderer's, the
    demos' in ``examples/``, the benchmark's and ``set_ip``'s among them);
    neither JAX, any
    ``thor_slam_tpu`` module, pyyaml, cv2, depthai nor rclpy loads."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import thor_slam_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "roots = ('jax', 'jaxlib', 'thor_slam_tpu', 'yaml', 'cv2', 'depthai', 'rclpy')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
        "for name in ('engine.epipolar', 'pipeline.mapper', 'mapping.mesh', 'scripts.run_pipeline', 'camera.utils',\n"
        "             'camera.sources.dataset', 'camera.sources.luxonis', 'slam.adapters.external_ros',\n"
        "             'slam.adapters.ros_bridge', 'slam.adapters.null_engine', 'scripts.run_euroc',\n"
        "             'scripts.make_euroc_synthetic', 'scripts.find_cameras', 'scripts.publish_odom_tf',\n"
        "             'parallel', 'parallel.mesh', 'parallel.dryrun', 'scripts.profile_stages',\n"
        "             'scripts.ablate_step', 'utils.flagship', 'utils.profiling', 'camera.sources.synthetic_torch',\n"
        "             'examples', 'examples.pull_extrinsics', 'examples.rgbd_stream', 'examples.test_camera_driver',\n"
        "             'examples.test_camera_rig', 'examples.test_imu', 'examples.test_stream_resolutions',\n"
        "             'bench', 'scripts.set_ip'):\n"
        "    assert 'thor_slam_tpu_torch.' + name in mods, mods\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 70


#: module -> names whose code the port's copy carries unchanged (but the
#: package's name in the imports).
COPIED_CODE = {
    "camera.utils": ["parse_urdf_transform", "load_rig_extrinsics_from_urdf", "prompt_for_resolution",
                     "get_luxonis_device"],
    "camera.sources.dataset": ["_load_image", "EurocCameraSource", "RecordedCameraSource", "record_frames"],
    "camera.sources.luxonis": ["LuxonisResolution", "select_rgb_sensor_resolution", "validate_camera_config",
                               "LuxonisCameraConfig", "scale_intrinsics_to_output", "extrinsics_cm_to_m"],
    "slam.adapters.null_engine": ["NullSlamEngine"],
    "slam.adapters.external_ros": ["extract_cameras", "split_stamp", "image_wire", "distortion_wire",
                                   "projection_matrix", "camera_tf_list", "latest_imu_sample", "ExternalRosEngine"],
    "slam.adapters.ros_bridge": ["pack_xyz_cloud", "pack_xyzrgb_cloud"],
    "scripts.set_ip": ["main"],
}
#: Originals that live outside the JAX package (the root ``scripts/``).
REFERENCE_MODULE = {"scripts.set_ip": "scripts.set_ip"}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in COPIED_CODE.items() for n in names])
def test_copied_code_is_the_reference_code(module, name):
    import importlib
    import inspect

    reference = REFERENCE_MODULE.get(module, f"thor_slam_tpu.{module}")
    want = inspect.getsource(getattr(importlib.import_module(reference), name))
    got = inspect.getsource(getattr(importlib.import_module(f"thor_slam_tpu_torch.{module}"), name))
    assert got == want.replace("thor_slam_tpu.", "thor_slam_tpu_torch.")


@pytest.mark.parametrize("name", ["Topic", "Subscription", "MessageBus"])
def test_bus_is_the_reference_code(name):
    import inspect

    assert inspect.getsource(getattr(tbus, name)) == inspect.getsource(getattr(jbus, name))


def test_bus_delivers_as_the_reference():
    """One script of publishes, subscriptions and reads on both buses: the
    same sequence numbers, messages, drops and topic names."""
    logs = []
    for mod in (jbus, tbus):
        bus, log, seen = mod.MessageBus(), [], []
        keep = bus.topic("/rgbd", queue_size=3)
        latest = bus.topic("/imu", queue_size=5, keep_latest_only=True)
        a, b, cb = keep.subscribe(), latest.subscribe(), keep.subscribe(seen.append)
        for i in range(6):
            log.append((keep.publish(i), latest.publish(10 * i)))
        log += [a.try_get(), a.get(timeout=0.01), len(a), a.latest(), a.try_get(), a.dropped]
        log += [b.latest(), b.dropped, b.get(timeout=0.01), bus.names(), list(seen)]
        keep.unsubscribe(cb)
        keep.publish(99)
        log += [a.try_get(), len(seen), bus.topic("/rgbd", queue_size=1) is keep]
        logs.append(log)
    assert logs[0] == logs[1]


def _fields(obj):
    """A config dataclass tree as plain values."""
    import dataclasses

    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [_fields(x) for x in obj]
    return obj


def test_config_reads_the_deployed_yaml_alike():
    """``from_dict`` on the deployed YAML's values (read here with pyyaml)
    and ``load_config`` on the file give the reference's config, field for
    field, and the same derived values."""
    import yaml

    path = REPO / "config" / "slam_config.yaml"
    data = yaml.safe_load(path.read_text())
    want, got = jconfig.RunConfig.from_dict(data), tconfig.RunConfig.from_dict(data)
    assert _fields(got) == _fields(want)
    assert got.num_cameras == want.num_cameras and got.rgbd_camera_ips() == want.rgbd_camera_ips()
    assert _fields(tconfig.load_config(path)) == _fields(jconfig.load_config(path))
    assert _fields(tconfig.RunConfig()) == _fields(jconfig.RunConfig())


@pytest.mark.parametrize("text", [
    "cameras: [{stereo: true}]",
    "cameras: [{ip: '999.1.1.1'}]",
    "mapping: {dims: [8, 8]}",
    "fps: [",
    "- 1\n- 2",
    "backend: {max_keypoints: many}",
])
def test_config_errors_match_reference(tmp_path, text):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    errors = []
    for mod in (jconfig, tconfig):
        with pytest.raises(mod.ConfigError) as e:
            mod.load_config(path)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_profiling_matches_reference():
    """Rate, EMA timers, status line and snapshot equal on one script of
    ticks and stage times; the port's copy has ``torch_trace`` in place of
    ``jax_trace``."""
    out = []
    for mod in (jprof, tprof):
        stats = mod.PipelineStats()
        for t in (0.0, 0.03, 0.07, 0.1, 0.135):
            stats.fps.tick(t)
        for name, times in (("track", (30.0, 12.5, 40.0)), ("sync", (1.0, 2.0))):
            timer = stats.stage(name)
            for ms in times:  # the EMA update of StageTimer.time(), fed fixed times
                timer.ema_ms = ms if timer.count == 0 else (1 - timer.alpha) * timer.ema_ms + timer.alpha * ms
                timer.count += 1
        stats.max_time_delta_ms, stats.num_inliers, stats.tracking_state = 4.25, 812, "TRACKING"
        with stats.stage("map").time():
            pass
        stats.stage("map").ema_ms = 0.0
        out.append((stats.fps.rate_hz, stats.status_line(17), stats.snapshot(17)))
    assert out[0] == out[1]
    assert hasattr(tprof, "torch_trace") and not hasattr(tprof, "jax_trace")
