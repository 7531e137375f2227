"""The engine's window solve as a captured CUDA graph (``ba.bundle_adjust_graphed``)
and ``TrackBA`` around it.

On the CPU: the packed result round-trips, the graphed entry is the eager
``bundle_adjust`` on CPU tensors (``graph="eager"`` on the span, no
capture), and ``TrackBA.warm`` solves the bound window as ``run`` does. On
the card (``cuda`` marker): graph and eager agree bit for bit at D's window
(K 10, 2C 8, L 384) and E's (2C 2), on accepted solves, on solves the 0.9x
rms rule refuses and on solves the diverged-solve ``where`` returns
unchanged; a key is captured once over 20 solves, pinned inputs copy in
without a synchronizing call, and ``TrackBA.run`` over an engine's recorded
ticks makes the eager path's decisions, corrections and landmark writes.

This file imports no JAX: run the card's cases from the repo root with
``python -m pytest tests/test_torch_ba_graph.py --noconftest -m cuda``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from thor_slam_tpu_torch.engine import ba
from thor_slam_tpu_torch.engine.backends import TrackBA
from thor_slam_tpu_torch.ops import lie
from thor_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

#: Cameras of the benchmark's BA windows: D's 4 stereo pairs, E's one.
CAMS = {"D": 4, "E": 1}
K, L_CAP = 10, 384
SOLVE = dict(huber_delta=0.004)  # TrackBA's solve; the other numbers at their defaults


def _window(c: int, seed: int, init_sigma=(0.01, 0.005), outliers=0.1) -> ba.BAProblem:
    """A seeded window of ``c`` stereo cameras (2C imagers, yawed evenly
    around the body, right eyes 7.5 cm along x): K poses drifted from the
    truth by ``init_sigma`` (translation, rotation), L landmarks 2-6 m out,
    observations with 1e-3 noise and an ``outliers`` share of gross ones."""
    rng = np.random.default_rng(seed)
    yaws = torch.tensor([[0.0, 2 * math.pi * i / c, 0.0] for i in range(c)])
    r_left = lie.so3_exp(yaws).numpy()
    t_left = np.zeros((c, 3), np.float32)
    cam_rot = np.concatenate([r_left, r_left])
    cam_trans = np.concatenate([t_left, t_left - np.float32([0.075, 0.0, 0.0])])
    cam_of = rng.integers(0, c, L_CAP)
    rays = np.stack([rng.uniform(-0.5, 0.5, L_CAP), rng.uniform(-0.4, 0.4, L_CAP), np.ones(L_CAP)], -1)
    p_cam = rays * rng.uniform(2.0, 6.0, L_CAP)[:, None]
    lms = np.einsum("lji,lj->li", cam_rot[cam_of], p_cam - cam_trans[cam_of])
    true = np.stack([lie.se3_exp(torch.tensor([0.04 * i, 0.01 * i, 0.0, 0.0, 0.015 * i, 0.0])).double().numpy()
                     for i in range(K)])
    p_b = np.einsum("kij,lj->kli", true[:, :3, :3], lms) + true[:, None, :3, 3]
    p_c = np.einsum("cij,klj->kcli", cam_rot, p_b) + cam_trans[None, :, None, :]
    uv = p_c[..., :2] / p_c[..., 2:3]
    mask = ((p_c[..., 2] > 0.3) & (np.abs(uv) < 0.6).all(-1) & (rng.random(uv.shape[:-1]) > 0.3)).astype(np.float32)
    obs = uv + rng.normal(0, 1e-3, uv.shape)
    gross = rng.random(mask.shape) < outliers
    obs[gross] = rng.uniform(-0.5, 0.5, (int(gross.sum()), 2))
    init = true.copy()
    for i in range(1, K):
        xi = torch.from_numpy(rng.normal(0, [init_sigma[0]] * 3 + [init_sigma[1]] * 3).astype(np.float32))
        init[i] = lie.se3_exp(xi).double().numpy() @ init[i]
    pose_mask = np.ones(K, np.float32)
    pose_mask[-1] = float(seed % 2)  # every other window a partial one
    fields = dict(body_t_world=init, landmarks_w=lms + rng.normal(0, 0.02, lms.shape), obs=obs, obs_mask=mask,
                  cam_rot=cam_rot, cam_trans=cam_trans, pose_mask=pose_mask,
                  lm_mask=(rng.random(L_CAP) > 0.1).astype(np.float32))
    return ba.BAProblem(**{f: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for f, v in fields.items()})


def _outcome(problem: ba.BAProblem, result: ba.BAResult) -> str:
    """``diverged`` (the ``where`` handed the input back), ``accepted``
    (TrackBA's 0.9x rms rule takes it) or ``refused`` (the rule does not)."""
    if torch.equal(result.body_t_world, problem.body_t_world) and torch.equal(result.final_rms, result.initial_rms):
        return "diverged"
    return "accepted" if float(result.final_rms) < 0.9 * float(result.initial_rms) else "refused"


def _windows(c: int, device) -> list[ba.BAProblem]:
    """Windows for every outcome: drifted starts (accepted), starts at the
    truth (refused: noise only), and starts at the eager least-squares
    optimum of a window with 30 % gross outliers, which the Huber solve
    can only raise (diverged, on some seeds)."""
    out = [_window(c, s, init_sigma=(0.3, 0.3)) for s in range(2)]
    out += [_window(c, 10 + s, init_sigma=(0.0, 0.0)) for s in range(2)]
    for s in range(6):
        p = ba.BAProblem(*(t.to(device) for t in _window(c, 20 + s, outliers=0.3)))
        ls = ba.bundle_adjust(p, iters=60, huber_delta=1e3)
        out.append(p._replace(body_t_world=ls.body_t_world, landmarks_w=ls.landmarks_w))
    return [ba.BAProblem(*(t.to(device) for t in p)) for p in out]


def _assert_same(a: ba.BAResult, b: ba.BAResult) -> None:
    for name, x, y in zip(ba.BAResult._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


# ---------------------------------------------------------------- CPU


def test_pack_round_trips():
    p = _window(1, 0)
    r = ba.bundle_adjust(p, iters=1)
    packed = ba.pack(r)
    assert packed.shape == (16 * K + 3 * L_CAP + 2,)
    _assert_same(ba.unpack(packed, K, L_CAP), r)


def test_graphed_entry_on_cpu_is_the_eager_call():
    p = _window(4, 1, init_sigma=(0.3, 0.3))
    graphed = ba.GraphedBundleAdjust()
    profiling.clear()
    profiling.tracing(True)
    try:
        with profiling.span("backend.ba") as sp:
            got = graphed(p, **SOLVE)
    finally:
        profiling.tracing(False)
        profiling.clear()
    _assert_same(ba.unpack(got, K, L_CAP), ba.bundle_adjust(p, **SOLVE))
    assert sp.attrs == {"graph": "eager"}
    assert graphed.captures == 0


def _bound(device, num_cams: int) -> TrackBA:
    """A TrackBA bound to ``num_cams`` stereo cameras yawed evenly."""
    from types import SimpleNamespace

    yaws = torch.tensor([[0.0, 2 * math.pi * i / num_cams, 0.0] for i in range(num_cams)])
    rot = lie.so3_exp(yaws).to(device)
    t = torch.zeros((num_cams, 3), device=device)
    setup = SimpleNamespace(cam_r_body=rot, cam_r_body_right=rot, cam_t_body=t,
                            cam_t_body_right=t - torch.tensor([0.075, 0.0, 0.0], device=device),
                            stereo_mask=torch.ones(num_cams, dtype=torch.bool))
    out = TrackBA()
    out.bind(setup, num_cams)
    return out


def test_warm_solves_the_bound_window_as_run_does(monkeypatch):
    """``warm`` hands the solve ``run``'s key (its ``huber_delta`` and the
    defaults) and an empty window of the bound shape (2C, L)."""
    seen = []
    real = ba.bundle_adjust_graphed

    def spy(problem, **kw):
        seen.append(([tuple(t.shape) for t in problem], kw))
        return real(problem, **kw)

    monkeypatch.setattr(ba, "bundle_adjust_graphed", spy)
    _bound("cpu", 3).warm()
    (shapes, kw), = seen
    assert kw == SOLVE
    assert shapes == [(K, 4, 4), (L_CAP, 3), (K, 6, L_CAP, 2), (K, 6, L_CAP), (6, 3, 3), (6, 3), (K,), (L_CAP,)]


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from thor_slam_tpu_torch.utils.platform import pin_precision

    pin_precision()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CAMS))
def test_graph_replays_the_eager_solve(cuda_device, cell):
    """Every window, the capture and the replays after it: the eager
    solve's result bit for bit, whichever way the solve came out."""
    graphed = ba.GraphedBundleAdjust()
    outcomes = []
    for p in _windows(CAMS[cell], cuda_device):
        want = ba.bundle_adjust(p, **SOLVE)
        got = ba.unpack(graphed(p, **SOLVE), K, L_CAP)
        _assert_same(got, want)
        outcomes.append(_outcome(p, want))
    assert {"accepted", "refused", "diverged"} <= set(outcomes), outcomes
    assert graphed.captures == 1


@pytest.mark.cuda
def test_one_capture_for_twenty_solves_from_pinned_inputs(cuda_device):
    """20 windows through pinned host buffers: one capture, then replays,
    each a new window's result (no stale static buffer is read), and a
    replay makes no synchronizing call."""
    graphed = ba.GraphedBundleAdjust()
    pinned = ba.BAProblem(*(torch.empty(t.shape, pin_memory=True) for t in _window(4, 0)))
    profiling.clear()
    profiling.tracing(True)
    modes, last = [], None
    try:
        for s in range(20):
            p = _window(4, 100 + s, init_sigma=(0.1, 0.05))
            for dst, src in zip(pinned, p):
                dst.copy_(src)
            problem = pinned._replace(cam_rot=p.cam_rot.to(cuda_device), cam_trans=p.cam_trans.to(cuda_device))
            if s == 10:
                torch.cuda.set_sync_debug_mode("error")
            try:
                with profiling.span("backend.ba") as sp:
                    got = graphed(problem, **SOLVE)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            modes.append(sp.attrs["graph"])
            want = ba.pack(ba.bundle_adjust(ba.BAProblem(*(t.to(cuda_device) for t in p)), **SOLVE))
            assert torch.equal(got, want)
            assert last is None or not torch.equal(got, last)
            last = got
    finally:
        profiling.tracing(False)
        profiling.clear()
    assert modes == ["capture"] + ["replay"] * 19
    assert graphed.captures == 1


def _recorded(device, num_cams: int, ticks: int = 48):
    """An engine's BA calls on the card over ``ticks`` ticks of a
    ``num_cams``-stereo-camera orbit: pushes, clears and runs (each with a
    snapshot of the state it wrote into); and the engine's setup."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticRigSpec,
        SyntheticWorld,
        make_synthetic_rig,
    )
    from thor_slam_tpu_torch.engine import convert
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig

    spec = SyntheticRigSpec(num_sources=num_cams, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
                                                trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.8))
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        cal = rig.calibration
        frames = [rig.get_synchronized_frames() for _ in range(ticks)]
    engine = TorchSlamEngine(params=dict(max_keypoints=128, keyframe_min_inliers=40), use_imu=False,
                             light_ticks=False, device=device)
    engine.initialize(cal, SlamConfig(num_cameras=2 * num_cams, enable_loop_closure=False))
    events, obj = [], engine._ba
    push, clear, run = obj.push_tick, obj.clear, obj.run

    def rec_push(ba_obs, world_t_body, ts, refreshed):
        events.append(("push", np.array(ba_obs), world_t_body.copy(), ts, refreshed))
        return push(ba_obs, world_t_body, ts, refreshed)

    def rec_clear():
        events.append(("clear",))
        return clear()

    def rec_run(world_t_body, covariance, state, diag):
        events.append(("run", world_t_body.copy(), covariance.copy(), convert.state_to_numpy(state)))
        return run(world_t_body, covariance, state, diag)

    obj.push_tick, obj.clear, obj.run = rec_push, rec_clear, rec_run
    for fs in frames:
        engine.process_frames(fs)
    engine.shutdown()
    return events, engine._setup


def _replay(events, setup, num_cams: int, device) -> list:
    """The events through a fresh TrackBA: every run's outcome."""
    from thor_slam_tpu_torch.engine import convert

    port = TrackBA()
    port.bind(setup, num_cams)
    out = []
    for ev in events:
        if ev[0] == "push":
            port.push_tick(torch.from_numpy(ev[1]), *ev[2:])
        elif ev[0] == "clear":
            port.clear()
        else:
            diag = {}
            state, pose, corr = port.run(ev[1], ev[2], convert.state_to_torch(ev[3], device), diag)
            out.append(dict(diag=diag, pose=pose, corr=corr, last_solve=dict(port.last_solve),
                            upd_ids=port._np["upd_ids"].copy() if corr is not None else None,
                            state={f: getattr(state, f).cpu() for f in state._fields}))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CAMS))
def test_track_ba_run_is_the_eager_path(cuda_device, cell, monkeypatch):
    """An engine's recorded ticks replayed through TrackBA twice: the
    graphed solve, then the eager ``bundle_adjust`` on the same windows
    moved to the card. The same decisions and rms, the same ``t_corr``,
    ``upd_ids`` and state (poses and landmark writes), bit for bit; and
    the solves read new windows (their rms differ)."""
    num_cams = CAMS[cell]
    events, setup = _recorded(cuda_device, num_cams)
    graphed = _replay(events, setup, num_cams, cuda_device)

    def eager(problem, **kw):
        return ba.pack(ba.bundle_adjust(ba.BAProblem(*(t.to(cuda_device) for t in problem)), **kw))

    monkeypatch.setattr(ba, "bundle_adjust_graphed", eager)
    want = _replay(events, setup, num_cams, cuda_device)
    assert len(graphed) == len(want)
    for g, w in zip(graphed, want):
        assert g["diag"] == w["diag"] and g["last_solve"] == w["last_solve"]
        assert (g["corr"] is None) == (w["corr"] is None)
        if w["corr"] is not None:
            np.testing.assert_array_equal(g["corr"], w["corr"])
            np.testing.assert_array_equal(g["pose"], w["pose"])
            np.testing.assert_array_equal(g["upd_ids"], w["upd_ids"])
        for f, t in w["state"].items():
            assert torch.equal(g["state"][f], t), f
    rms = [g["last_solve"]["rms"] for g in graphed if g["last_solve"]["solved"]]
    assert len(set(rms)) >= 2, rms
    assert any(g["corr"] is not None for g in graphed), [g["diag"] for g in graphed]


@pytest.mark.cuda
def test_engine_captures_at_initialize_and_replays_in_ticks(cuda_device):
    """An engine on the card: the window's solve is captured (or found
    captured) while ``initialize`` runs, and every solved ``backend.ba``
    span of its ticks says ``replay``."""
    profiling.clear()
    profiling.tracing(True)
    try:
        events, _ = _recorded(cuda_device, 2, ticks=40)
        spans = [s for s in profiling.spans() if s.name == "backend.ba"]
    finally:
        profiling.tracing(False)
        profiling.clear()
    solved = [s for s in spans if s.attrs["solved"]]
    assert solved and all(s.attrs["graph"] == "replay" for s in solved)
    assert all("graph" not in s.attrs for s in spans if not s.attrs["solved"])
