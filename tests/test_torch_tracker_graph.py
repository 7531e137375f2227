"""The tick in parts (``tracker.track_step``) and replayed from CUDA graphs
(``tracker.track_step_graphed``).

A 2-camera stereo rig at 320x240 with 128 slots a camera runs one plan of
ticks that holds every kind the engine makes: keyframe ticks (the first,
and one after a reset), full ticks, light ticks at full and half
resolution, ticks with an IMU pose prediction, a stale camera, and states
replaced between two ticks as bundle adjustment and a reset replace them.

On the CPU (tier 1):

* ``track_step``, its parts in order (front, solve, back, the readback
  and the keyframe branch), gives bit for bit what the sharded step's
  composition gives (``run_hot_frontend``, ``ransac_pnp``,
  ``_finish_step``);
* ``track_step_graphed`` on CPU tensors is ``track_step`` itself: the same
  results, nothing captured, ``graph="eager"`` on ``tracker.front`` and
  ``tracker.back``.

The card's case (graphed = eager bit for bit, one capture a key) is in
``tests/test_torch_cuda.py`` and uses :func:`run_plan`. This file imports no
JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from thor_slam_tpu_torch.camera.rig import CameraRig
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu_torch.engine import convert, pnp
from thor_slam_tpu_torch.engine import setup as tsetup
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.engine.backends.light import downsample2_host
from thor_slam_tpu_torch.ops import lie
from thor_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

N = 128

#: The ticks, in order: light/half (a light tick, at half resolution),
#: pred (an IMU-style prediction), stale (that camera's source is stale),
#: replace (the state is replaced before the tick: "ba" moves it as a BA
#: correction does, "reset" is a fresh state, whose first tick keyframes).
PLAN = (
    dict(),
    dict(),
    dict(light=True),
    dict(light=True, half=True),
    dict(light=True),
    dict(pred=True),
    dict(pred=True, stale=1),
    dict(stale=1),
    dict(replace="ba"),
    dict(light=True, half=True),
    dict(replace="reset"),
    dict(),
)


def rig_frames(width: int = 320, height: int = 240):
    """(params, setup as numpy, frames): len(PLAN) (C, 2, H, W) uint8 ticks."""
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=width, height=height, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
        trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.5),
    )
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        setup_np, order, h, w = tsetup.build_camera_setup(rig.calibration)
        frames = [
            np.stack([[f.image for f in fs.frame_sets[name].frames[:2]] for name in order])
            for fs in (rig.get_synchronized_frames() for _ in PLAN)
        ]
    params = trk.TrackerParams(num_cams=len(order), height=h, width=w, max_keypoints=N)
    return params, setup_np, frames


def _ba_shift(state: trk.TrackerState) -> trk.TrackerState:
    """The state as a BA correction leaves it: pose and landmarks moved."""
    t_corr = lie.se3_exp(torch.tensor([0.004, -0.002, 0.003, 0.001, -0.002, 0.0015], device=state.world_t_body.device))
    return state._replace(
        world_t_body=t_corr @ state.world_t_body,
        lm_pos_w=state.lm_pos_w @ t_corr[:3, :3].T + t_corr[:3, 3],
    )


def run_plan(step, params, setup_np, frames, device, host_inputs: bool = False) -> list:
    """``step`` (called as ``track_step``) over :data:`PLAN`: each tick's
    (state, output). With ``host_inputs`` the live cameras and the
    prediction are pinned host tensors, as the engine hands them to the
    graphed step on a card; else tensors on ``device``."""
    device = torch.device(device)
    setup = convert.setup_to_torch(setup_np, device)
    state = trk.init_state(params, device)
    gen = torch.Generator(device=device).manual_seed(5)
    delta = lie.se3_exp(torch.tensor([0.002, 0.001, -0.003, 0.0005, 0.001, -0.0008], dtype=torch.float64))

    def host(t):
        return t.pin_memory() if host_inputs and device.type == "cuda" else t.to(device)

    rows = []
    for k, tick in enumerate(PLAN):
        if tick.get("replace") == "ba":
            state = _ba_shift(state)
        elif tick.get("replace") == "reset":
            state = trk.init_state(params, device)
        img = frames[k]
        light, half = tick.get("light", False), tick.get("half", False)
        if light:
            img = img[:, :1]
        if half:
            img = np.stack([[downsample2_host(im) for im in cam] for cam in img])
        kw = dict(allow_refresh=not light, half_res=half)
        if tick.get("pred"):
            kw["pose_prediction"] = host(state.world_t_body.double().cpu() @ delta)
        if "stale" in tick:
            active = torch.ones(params.num_cams, dtype=torch.bool)
            active[tick["stale"]] = False
            kw["cam_active"] = host(active)
        images = torch.from_numpy(np.ascontiguousarray(img)).to(device)
        state, out = step(params, setup, state, images, generator=gen, **kw)
        rows.append((state, out))
    return rows


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (the packed ids are NaNs as floats)."""
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(t.dtype, t.dtype))


def assert_rows_equal(got: list, want: list) -> None:
    """Every tick's state, output and packed records, bit for bit."""
    assert len(got) == len(want)
    for k, ((s_a, o_a), (s_b, o_b)) in enumerate(zip(got, want)):
        for kind, a, b in (("state", s_a, s_b), ("output", o_a, o_b)):
            for name, x, y in zip(type(a)._fields, a, b):
                if isinstance(x, torch.Tensor):
                    assert x.dtype == y.dtype and x.shape == y.shape, (k, kind, name)
                    assert torch.equal(_bits(x), _bits(y)), (k, kind, name)
                else:
                    assert x == y, (k, kind, name)
        for pack in (lambda s, o: trk.pack_output(o), lambda s, o: trk.pack_ba_obs(o, s.lm_pos_w),
                     lambda s, o: trk.pack_kf_sig(s)):
            assert torch.equal(_bits(pack(s_a, o_a)), _bits(pack(s_b, o_b))), k


def plan_kinds(rows: list) -> list[str]:
    """Each tick's kind: keyframe, full or light."""
    return [
        "light" if PLAN[k].get("light") else "keyframe" if out.refreshed_host else "full"
        for k, (_, out) in enumerate(rows)
    ]


@pytest.fixture(scope="module")
def rig():
    return rig_frames()


def _unsplit_step(params, setup, state, images, uniforms=None, generator=None, cam_active=None,
                  pose_prediction=None, allow_refresh=True, half_res=False):
    """The tick composed as the sharded step composes its shards: the
    normalization and prediction inline, ``run_hot_frontend``, the eager
    ``ransac_pnp`` and ``_finish_step``."""
    p = params
    if images.dtype == torch.uint8:
        images = images.float() * (1.0 / 255.0)
    if half_res:
        images = trk.upsample2(images)
    if p.median_prefilter:
        images = trk.median3x3(images)
    if pose_prediction is None:
        delta = state.world_t_body @ lie.se3_inverse(state.prev_world_t_body)
        klt_prediction = torch.where(state.untracked_streak > 0, state.world_t_body, delta @ state.world_t_body)
        init = lie.se3_inverse(state.world_t_body)
    else:
        klt_prediction = pose_prediction.to(state.world_t_body)
        init = lie.se3_inverse(klt_prediction)
    hot = trk.run_hot_frontend(p, setup, state, images, lie.se3_inverse(klt_prediction))
    if cam_active is not None:
        hot = hot._replace(corr_valid=hot.corr_valid & cam_active[:, None],
                           tracks_valid=hot.tracks_valid & cam_active[:, None])
    c, n = p.num_cams, p.max_keypoints
    pnp_valid = hot.corr_valid & ~state.lm_pending if p.mono_bootstrap else hot.corr_valid
    result = pnp.ransac_pnp(
        state.lm_pos_w.reshape(c * n, 3), hot.obs_norm.reshape(c * n, 2), pnp_valid.reshape(c * n),
        setup.cam_r_body.repeat_interleave(n, 0), setup.cam_t_body.repeat_interleave(n, 0), init,
        num_hypotheses=p.ransac_hypotheses, sample_size=p.ransac_sample_size,
        inlier_threshold=p.inlier_threshold_px / torch.amax(setup.k_left[:, 0]), uniforms=uniforms,
        generator=generator, obs_weight=state.lm_weight.reshape(c * n) if p.has_mono else None,
    )
    return trk._finish_step(
        p, setup, state, hot, images, body_t_world=result.body_t_world, num_inliers=result.num_inliers,
        inliers_cn=result.inliers.reshape(c, n), rms_error=result.rms_error, init_body_t_world=init,
        covariance=result.covariance, cam_active=cam_active, allow_refresh=allow_refresh,
    )


@pytest.mark.parametrize("switches", [dict(), dict(median_prefilter=True, oriented_descriptors=True)],
                         ids=["default", "prefilter"])
def test_split_tick_equals_the_unsplit_composition(rig, switches):
    params, setup_np, frames = rig
    params = dataclasses.replace(params, **switches)
    split = run_plan(trk.track_step, params, setup_np, frames, "cpu")
    whole = run_plan(_unsplit_step, params, setup_np, frames, "cpu")
    assert_rows_equal(split, whole)
    kinds = plan_kinds(split)
    assert kinds[0] == kinds[10] == "keyframe" and "full" in kinds
    assert int(split[1][1].num_inliers) >= 50  # actually tracking


def test_graphed_step_on_cpu_is_track_step(rig):
    params, setup_np, frames = rig
    graphed = trk.GraphedTrackStep()
    want = run_plan(trk.track_step, params, setup_np, frames, "cpu")
    profiling.tracing(False)
    profiling.clear()
    profiling.tracing(True)
    try:
        got = run_plan(graphed, params, setup_np, frames, "cpu")
        spans = profiling.spans()
    finally:
        profiling.tracing(False)
        profiling.clear()
    assert_rows_equal(got, want)
    assert graphed.captures == 0
    for name in ("tracker.front", "tracker.back"):
        assert [s.attrs for s in spans if s.name == name] == [{"graph": "eager"}] * len(PLAN), name


def test_segment_spans_nest_in_order(rig):
    """Per tick: ``tracker.front``, ``tracker.pnp``, ``tracker.back``, then
    the readback on a full tick and ``tracker.keyframe`` on a keyframe tick,
    each a top-level span of the tick, in that order."""
    params, setup_np, frames = rig
    profiling.tracing(False)
    profiling.clear()
    profiling.tracing(True)
    try:
        rows = run_plan(trk.track_step, params, setup_np, frames, "cpu")
        spans = profiling.spans()
    finally:
        profiling.tracing(False)
        profiling.clear()
    assert all(s.parent is None for s in spans)
    order = [s.name for s in sorted(spans, key=lambda s: s.t0)]
    want = []
    for kind in plan_kinds(rows):
        want += ["tracker.front", "tracker.pnp", "tracker.back"]
        want += [] if kind == "light" else ["tracker.refresh_readback"]
        want += ["tracker.keyframe"] if kind == "keyframe" else []
    assert order == want
