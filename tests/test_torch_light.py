"""Light ticks, half-resolution staging and the adaptive controller of the
port, against the JAX package.

* ``downsample2_host`` and ``LightController`` are copies: the same outputs
  on the same inputs (uint8 byte for byte, float to 1e-7), the same
  schedule and degrade/restore decisions over scripted series.
* The light step (``track_step(allow_refresh=False)``) is bit-equal to a
  full step that chose not to refresh, and never refreshes; the half-res
  upsample is the reference's ``jax.image.resize`` to 1e-6, and one
  half-res light tick agrees with the reference's
  ``make_track_step(light=True, half_res=True)`` to 5 mm / 5 mrad from one
  state with the same draws.
* Engines: with light ticks on, the port ships the same light ticks, the
  same keyframes and the same upload bytes as the reference (ATE within 1
  cm; RANSAC draws differ), and its poses equal its own light-off run to
  1e-6. Half-res light ticks and the adaptive controller keep the
  reference's bars (tests/test_engine_light.py).

Every engine pins ``adaptive_half_res=False`` unless it tests the
controller, and then it sets ``pace_override``: a CPU tick's wall time can
fall inside the controller's real-time band and degrade one run and not
the next.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_slam_tpu.camera.rig import CameraRig
from thor_slam_tpu.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu.engine import setup as jsetup
from thor_slam_tpu.engine import tracker as jtrk
from thor_slam_tpu.engine.backends import light as jlight
from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
from thor_slam_tpu.slam.interface import SlamConfig
from thor_slam_tpu.utils.evaluation import ate_rmse
from thor_slam_tpu_torch.engine import convert, staging
from thor_slam_tpu_torch.engine import setup as tsetup
from thor_slam_tpu_torch.engine import tracker as ttrk
from thor_slam_tpu_torch.engine.backends import light as tlight
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.ops.image import upsample2

torch.set_num_threads(2)

N = 128
PARAMS = dict(max_keypoints=N, keyframe_min_inliers=40)
SPEC = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
WORLD = SyntheticWorld(half_extents=(4.0, 4.0, 2.0))
TRAJ = OrbitTrajectory(radius=1.5, angular_rate=0.5)
TICKS = 30


@pytest.fixture(scope="module")
def rig():
    sources, rig_ext, _, _ = make_synthetic_rig(SPEC, world=WORLD, trajectory=TRAJ)
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as r:
        cal = r.calibration
        frames = [r.get_synchronized_frames() for _ in range(TICKS)]
    order = sorted(cal.source_names)
    stacks = [np.stack([[f.image for f in fs.frame_sets[name].frames[:2]] for name in order]) for fs in frames]
    return dict(cal=cal, frames=frames, order=order, stacks=stacks)


# ------------------------------------------------------------ the copies


@pytest.mark.parametrize("shape", [(120, 160), (7, 9), (1, 3), (33, 64)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_downsample2_host_matches_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8) if dtype == np.uint8 else rng.random(shape, np.float32)
    got, want = tlight.downsample2_host(img), jlight.downsample2_host(img)
    assert got.dtype == want.dtype and got.shape == (shape[0] // 2, shape[1] // 2)
    if dtype == np.uint8:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _pose(rng):
    pose = np.eye(4)
    pose[:3, 3] = rng.normal(scale=0.05, size=3)
    return pose


def _drive_controller(ctl, params, scenario):
    """Feed one scripted series; returns the per-step decisions."""
    ctl.resolve(1, False, 120, 160, 30.0)
    ctl.adapt_down_ticks = 30
    rng = np.random.default_rng(11)
    out = []
    wall, ts = 100.0, 0.0
    for k in range(160):
        if scenario == "schedule":
            # Inputs around each gate of the scheduler.
            kf = _pose(rng)
            fin = kf.copy()
            fin[:3, 3] += rng.normal(scale=0.06, size=3)
            light = ctl.schedule(
                frame_count=k % 9, want_reloc=k % 13 == 5, tracking=k % 11 != 3,
                num_inliers=int(rng.integers(30, 90)), params=params,
                fin_pose=None if k % 17 == 4 else fin, last_kf_odom=kf,
            )
            ctl.note_dispatch(light)
            out.append((light, ctl.ticks_since_full))
            continue
        # Cadence: frame timestamps 33.3 ms apart, the wall either paced
        # 1:1 or a fast replay; busy time over the budget, then far under.
        ts += 1.0 / 30.0
        wall += 1.0 / 30.0 if scenario != "replay" else 0.005
        busy = 0.040 if k < 60 else (0.003 if scenario == "restore" else 0.005)
        ctl.note_payload(10_000 if ctl.half_active else 40_000, 80_000)
        ctl.on_tick(busy, ts, wall)
        out.append((ctl.half_active, round(ctl._busy_ema, 12)))
    return out


@pytest.mark.parametrize("scenario", ["schedule", "replay", "paced", "restore"])
def test_light_controller_matches_reference(scenario):
    """The same schedule decisions and half-res sequence: a fast replay
    never degrades; a paced overload degrades; with a 1/8 byte ratio a
    3 ms tick restores full-res (its full-res estimate fits), a 5 ms one
    does not (paced)."""
    got = _drive_controller(
        tlight.LightController(True, False, True, 4), ttrk.TrackerParams(num_cams=2, height=120, width=160), scenario
    )
    want = _drive_controller(
        jlight.LightController(True, False, True, 4), jtrk.TrackerParams(num_cams=2, height=120, width=160), scenario
    )
    assert got == want
    if scenario == "schedule":
        assert 10 < sum(light for light, _ in got) < len(got) - 10
    else:
        halves = [h for h, _ in got]
        assert any(halves) == (scenario != "replay")
        assert halves[-1] == (scenario == "paced")


# ------------------------------------------------------------ light step


def _params_t(rig, **kw):
    h, w = rig["stacks"][0].shape[-2:]
    return ttrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=N, **kw)


def _setup_t(rig):
    setup_np, _, _, _ = tsetup.build_camera_setup(rig["cal"])
    return convert.setup_to_torch(setup_np, "cpu")


def _uniforms(seed, params):
    return torch.from_numpy(np.random.default_rng(seed).random((params.ransac_hypotheses, 2 * N), np.float32))


def test_light_step_matches_a_full_step_that_does_not_refresh(rig):
    params, setup = _params_t(rig), _setup_t(rig)
    state, out0 = ttrk.track_step(params, setup, ttrk.init_state(params, "cpu"), torch.from_numpy(rig["stacks"][0]),
                                  uniforms=_uniforms(0, params))
    assert out0.refreshed_host  # tick 0 mints the bank
    images = torch.from_numpy(rig["stacks"][1])
    full_state, full_out = ttrk.track_step(params, setup, state, images, uniforms=_uniforms(1, params))
    assert not full_out.refreshed_host, "pick a tick that does not refresh"
    light_state, light_out = ttrk.track_step(
        params, setup, state, images[:, :1].clone(), uniforms=_uniforms(1, params), allow_refresh=False
    )
    assert not light_out.refreshed_host
    assert torch.equal(ttrk.pack_output(full_out), ttrk.pack_output(light_out))
    assert torch.equal(ttrk.pack_ba_obs(full_out, full_state.lm_pos_w), ttrk.pack_ba_obs(light_out, light_state.lm_pos_w))
    for f in ttrk.TrackerState._fields:
        assert torch.equal(getattr(full_state, f), getattr(light_state, f)), f


def test_light_step_never_refreshes(rig):
    """Even the restart path does not trip on a light tick: an empty bank at
    frame 0 with ``restart_after_untracked=1`` mints nothing, and the
    streak keeps counting."""
    params = _params_t(rig, restart_after_untracked=1)
    setup = _setup_t(rig)
    state = ttrk.init_state(params, "cpu")
    for k in range(3):
        state, out = ttrk.track_step(
            params, setup, state, torch.from_numpy(rig["stacks"][k][:, :1].copy()),
            uniforms=_uniforms(k, params), allow_refresh=False,
        )
        assert not bool(out.refreshed) and not out.refreshed_host
        assert int(state.lm_valid.sum()) == 0
    assert int(state.untracked_streak) == 3 and int(state.lm_id_counter) == 0


# ------------------------------------------------------------ half res


def test_upsample_matches_jax_image_resize():
    x = np.random.default_rng(3).random((2, 1, 200, 320), np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 1, 400, 640), method="linear"))
    got = upsample2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_half_res_light_tick_matches_reference(rig):
    """Three full ticks in the reference, its state carried into the port,
    then one half-res light tick in both with the reference's draws."""
    setup_j, _, h, w = jsetup.build_camera_setup(rig["cal"])
    params_j = jtrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=N)
    step_j = jtrk.make_track_step(params_j, setup_j)
    state_j = jtrk.init_state(params_j)
    for k in range(3):
        state_j, _ = step_j(state_j, jnp.asarray(rig["stacks"][k]))
    state_t = convert.state_to_torch({f: np.asarray(v) for f, v in state_j._asdict().items()}, "cpu")
    half = np.stack([[jlight.downsample2_host(im) for im in cam[:1]] for cam in rig["stacks"][3]])
    assert half.shape == (2, 1, h // 2, w // 2)
    _, subkey = jax.random.split(state_j.key)
    uniforms = np.asarray(jax.random.uniform(subkey, (params_j.ransac_hypotheses, 2 * N)))
    light_j = jtrk.make_track_step(params_j, setup_j, light=True, half_res=True)
    _, out_j = light_j(state_j, jnp.asarray(half))
    _, out_t = ttrk.track_step(
        _params_t(rig), _setup_t(rig), state_t, torch.from_numpy(half.copy()),
        uniforms=torch.from_numpy(uniforms.copy()), allow_refresh=False, half_res=True,
    )
    pj, pt = np.asarray(out_j.world_t_body), out_t.world_t_body.numpy()
    assert np.linalg.norm(pj[:3, 3] - pt[:3, 3]) <= 5e-3
    rel = pj[:3, :3].T @ pt[:3, :3]
    assert np.arccos(np.clip(0.5 * (np.trace(rel) - 1.0), -1.0, 1.0)) <= 5e-3
    assert not bool(out_j.refreshed) and not out_t.refreshed_host
    assert abs(int(out_j.num_inliers) - int(out_t.num_inliers)) <= max(3, 0.05 * int(out_j.num_inliers))
    assert int(out_t.num_inliers) >= 50


def test_half_res_staging_shapes(rig):
    """Staged light images are (H/2, W/2) and left-only; full ticks stay
    (C, 2, H, W); the reference's staging has the same bytes."""
    fs = rig["frames"][2]
    zero = np.zeros((120, 160), np.uint8)
    stats = {"full": 0, "light": 0, "light_half": 0, "bytes": 0}
    full = staging.stage_images(fs, rig["order"], zero, stats=stats)
    lite = staging.stage_images(fs, rig["order"], zero, light=True, half=True, stats=stats)
    assert full.shape == (2, 2, 120, 160) and lite.shape == (2, 1, 60, 80) and lite.dtype == np.uint8
    assert stats == {"full": 1, "light": 0, "light_half": 1, "bytes": full.nbytes + lite.nbytes}
    for c, name in enumerate(rig["order"]):
        img = fs.frame_sets[name].frames[0].image
        np.testing.assert_array_equal(lite[c, 0], jlight.downsample2_host(img))


# ------------------------------------------------------------ engines


def _run(engine, frames, cal, config=None, traj=TRAJ):
    engine.initialize(cal, config or SlamConfig(num_cameras=4, enable_loop_closure=False))
    gt0 = traj.pose(frames[0].timestamp)
    est, gt, lights, on_light = [], [], [], 0
    for fs in frames:
        pose = engine.process_frames(fs)
        d = engine.last_diagnostics
        lights.append(bool(d.get("light_tick", False)))
        on_light += bool(d["refreshed"] and d.get("light_tick"))
        if pose is not None:
            est.append(pose.position.copy())
            gt.append((np.linalg.inv(gt0) @ traj.pose(fs.timestamp))[:3, 3])
    est, gt = np.asarray(est), np.asarray(gt)
    return dict(
        est=est, ate=ate_rmse(est, gt), lights=lights, refreshed_on_light=on_light,
        kf=len(engine._keyframe_poses), stats=dict(engine.upload_stats),
    )


@pytest.fixture(scope="module")
def light_runs(rig):
    frames, cal = rig["frames"], rig["cal"]
    vo = dict(enable_ba=False, use_imu=False, adaptive_half_res=False)
    ref = TpuSlamEngine(params=PARAMS, light_ticks=True, **vo)
    out = dict(ref=_run(ref, frames, cal))
    ref.shutdown()
    for key, light in (("port", True), ("port_off", False)):
        out[key] = _run(TorchSlamEngine(params=PARAMS, device="cpu", light_ticks=light, **vo), frames, cal)
    return out


def test_light_ticks_like_the_reference(light_runs):
    ref, port = light_runs["ref"], light_runs["port"]
    assert sum(port["lights"]) > 10 and not port["lights"][0]  # the first tick is full
    assert port["lights"] == ref["lights"]
    assert port["kf"] == ref["kf"] and port["refreshed_on_light"] == ref["refreshed_on_light"] == 0
    assert port["stats"] == ref["stats"]
    assert port["stats"]["light"] == sum(port["lights"]) and port["stats"]["light_half"] == 0
    assert port["ate"] < 0.05 and abs(port["ate"] - ref["ate"]) <= 0.01


def test_light_ticks_keep_the_trajectory(light_runs):
    """The scheduler predicted every keyframe: the same keyframes and the
    same trajectory as with light ticks off (the bar of the reference's
    tests/test_engine_light.py)."""
    on, off = light_runs["port"], light_runs["port_off"]
    assert sum(off["lights"]) == 0 and off["stats"]["light"] == 0
    assert on["kf"] == off["kf"]
    np.testing.assert_allclose(on["est"], off["est"], rtol=0, atol=1e-6)


def test_light_half_res_tracks_close_to_full_res():
    """Half-res light ticks on the rig and at the settings of the
    reference's own bar (tests/test_engine_light.py: 2 cameras at 160x100,
    40 ticks, the defaults otherwise): keyframes within 2 of the full-res
    light run, ATE within 1.5x."""
    runs = {}
    for half in (False, True):
        sources, rig_ext, _, traj = make_synthetic_rig(SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=100))
        with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as r:
            frames = [r.get_synchronized_frames() for _ in range(40)]
            engine = TorchSlamEngine(
                params=dict(max_keypoints=N), device="cpu", light_ticks=True, light_half_res=half, adaptive_half_res=False
            )
            runs[half] = _run(engine, frames, r.calibration, SlamConfig(num_cameras=4), traj=traj)
    full, half = runs[False], runs[True]
    assert sum(half["lights"]) > 10 and half["stats"]["light_half"] == sum(half["lights"])
    assert half["stats"]["light"] == 0 and half["refreshed_on_light"] == 0
    assert abs(half["kf"] - full["kf"]) <= 2
    assert half["ate"] < max(1.5 * full["ate"], full["ate"] + 2e-3), (half["ate"], full["ate"])


def test_adaptive_degrades_under_overload_then_recovers(rig):
    """Overload (a camera rate the tick cannot keep) flips light ticks to
    half-res after the up-streak; a huge budget restores full-res after the
    down-streak; tracking survives both switches at pipeline depth 2."""
    engine = TorchSlamEngine(
        params=PARAMS, device="cpu", light_ticks=True, adaptive_half_res=True, pipelined=True, pipeline_depth=2,
    )
    engine.initialize(rig["cal"], SlamConfig(num_cameras=4, enable_loop_closure=False, expected_fps=1e6))
    ctl = engine._light_ctl
    assert ctl.adaptive and not engine.light_half_active
    ctl.adapt_up_ticks, ctl.adapt_down_ticks, ctl.pace_override = 3, 4, True
    half_light_ticks, pose = 0, None
    for fs in rig["frames"][:20]:
        pose = engine.process_frames(fs) or pose
        half_light_ticks += bool(engine.last_diagnostics.get("light_half"))
    assert engine.light_half_active, "controller never degraded"
    assert half_light_ticks > 0 and engine.upload_stats["light_half"] > 0
    assert pose is not None and np.all(np.isfinite(pose.position))
    ctl.budget_s = 1e6
    for fs in rig["frames"][20:]:
        pose = engine.process_frames(fs) or pose
    assert not engine.light_half_active, "controller never recovered"
    tail = engine.flush()
    assert tail is not None and np.all(np.isfinite(tail.position))
    assert engine.get_tracking_state().name == "TRACKING"
    engine.shutdown()


def test_forced_half_res_disables_adaptivity(rig):
    engine = TorchSlamEngine(params=PARAMS, device="cpu", light_ticks=True, light_half_res=True, adaptive_half_res=True)
    engine.initialize(rig["cal"], SlamConfig(num_cameras=4, enable_loop_closure=False))
    assert engine._light_ctl.adaptive is False and engine.light_half_active is True
    engine.shutdown()
