"""The tracker's RANSAC PnP as a captured CUDA graph (``pnp.ransac_pnp_graphed``).

On the CPU: the hypothesis is picked by a device-side gather with the
result of the indexed form, and the graphed entry is the eager function
on CPU tensors. On the card (``cuda`` marker): graph and eager agree bit
for bit at the benchmark's shapes, a held result is never overwritten, a
replay makes no synchronizing call, a key is captured once, and an engine
on the flagship's configuration delivers the same poses either way.

This file imports no JAX: run the card's cases from the repo root with
``python -m pytest tests/test_torch_pnp_graph.py --noconftest -m cuda``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from thor_slam_tpu_torch.engine import pnp
from thor_slam_tpu_torch.ops import lie
from thor_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

#: The tracker's RANSAC (``TrackerParams``): 16 hypotheses of 6 rows.
H, S = 16, 6
#: C * N rows of the solve: D (4 x 512 slots) and F (4 x 256).
ROWS = {"D": 2048, "F": 1024}


def _case(n: int, seed: int, device="cpu", weighted=False) -> tuple[tuple, dict]:
    """A 4-camera rig's (points, obs, valid, rot, trans, init) and the
    keyword arguments as ``track_step`` passes them: noisy observations,
    20 % outliers, 10 % invalid rows, a tensor inlier threshold."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    cam = torch.arange(n) % 4
    yaws = torch.tensor([[0.0, 0.5 * math.pi * c, 0.0] for c in range(4)])
    rot = lie.so3_exp(yaws)[cam]
    trans = torch.tensor([0.05, 0.0, 0.02]).expand(n, 3)
    body_t_world = lie.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.05]))
    p_c = torch.cat([u(n, 2, lo=-2, hi=2), u(n, 1, lo=2, hi=6)], -1)
    p_b = torch.einsum("nji,nj->ni", rot, p_c - trans)
    w_t_b = torch.linalg.inv(body_t_world)
    points = p_b @ w_t_b[:3, :3].T + w_t_b[:3, 3]
    obs = p_c[:, :2] / p_c[:, 2:] + 1e-3 * torch.randn((n, 2), generator=g)
    out = u(n) < 0.2
    obs = torch.where(out[:, None], obs + u(n, 2, lo=-0.2, hi=0.2), obs)
    valid = u(n) < 0.9
    init = lie.se3_exp(torch.tensor([0.12, -0.03, 0.17, 0.0, -0.02, 0.06]))
    args = tuple(t.contiguous().to(device) for t in (points, obs, valid, rot, trans, init))
    kw = dict(num_hypotheses=H, sample_size=S, inlier_threshold=torch.tensor(0.012, device=device))
    if weighted:
        kw["obs_weight"] = (0.25 + u(n)).to(device)
    return args, kw


def _draws(kind: str, n: int, seed: int, device="cpu") -> dict:
    """The hypothesis draws: injected ``uniforms``, or a seeded generator."""
    if kind == "uniforms":
        return {"uniforms": torch.rand((H, n), generator=torch.Generator().manual_seed(seed)).to(device)}
    return {"generator": torch.Generator(device=device).manual_seed(seed)}


def _assert_same(a: pnp.PnPResult, b: pnp.PnPResult) -> None:
    for name, x, y in zip(pnp.PnPResult._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("draws", ["uniforms", "generator"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", sorted(ROWS.values()))
def test_gather_selection_matches_the_indexed_form(monkeypatch, n, weighted, draws):
    """``_pick``'s gather gives what ``x[best]`` gave, output for output."""
    args, kw = _case(n, seed=n + weighted, weighted=weighted)
    got = pnp.ransac_pnp(*args, **kw, **_draws(draws, n, 5))
    monkeypatch.setattr(pnp, "_pick", lambda x, i: x[i])
    want = pnp.ransac_pnp(*args, **kw, **_draws(draws, n, 5))
    _assert_same(got, want)
    assert 0 < int(got.num_inliers) <= n


def test_pick_is_the_indexed_row():
    x = torch.arange(24.0).reshape(6, 2, 2)
    for i in range(6):
        assert torch.equal(pnp._pick(x, torch.tensor(i)), x[i])
    masks = torch.rand(5, 7) < 0.5
    assert torch.equal(pnp._pick(masks, torch.tensor(3)), masks[3])


@pytest.mark.parametrize("draws", ["uniforms", "generator"])
@pytest.mark.parametrize("weighted", [False, True])
def test_graphed_entry_on_cpu_is_the_eager_call(draws, weighted):
    """CPU tensors take ``ransac_pnp`` itself: the same result, the same
    generator state after it, no capture, and ``graph="eager"`` on the span."""
    n = ROWS["F"]
    args, kw = _case(n, seed=7, weighted=weighted)
    graphed = pnp.GraphedRansacPnP()
    d_eager, d_graphed = _draws(draws, n, 11), _draws(draws, n, 11)
    want = pnp.ransac_pnp(*args, **kw, **d_eager)
    profiling.clear()
    profiling.tracing(True)
    try:
        with profiling.span("tracker.pnp") as sp:
            got = graphed(*args, **kw, **d_graphed)
    finally:
        profiling.tracing(False)
        profiling.clear()
    _assert_same(got, want)
    assert sp.attrs == {"graph": "eager"}
    assert graphed.captures == 0
    if draws == "generator":
        assert torch.equal(d_eager["generator"].get_state(), d_graphed["generator"].get_state())


def test_graphed_entry_tags_nothing_with_the_tracer_off():
    args, kw = _case(ROWS["F"], seed=8)
    with profiling.span("tracker.pnp") as sp:
        pnp.GraphedRansacPnP()(*args, **kw, generator=torch.Generator().manual_seed(1))
    assert sp is None  # the null span: nothing recorded, nothing to tag


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["uniforms", "generator"])
@pytest.mark.parametrize("cell", ["D", "F"])
def test_graph_replays_the_eager_result(cuda_device, cell, draws):
    """Three calls with other inputs (the capture, then replays): each the
    eager call's result bit for bit, the generators left in one state."""
    n = ROWS[cell]
    graphed = pnp.GraphedRansacPnP()
    d_eager, d_graphed = _draws(draws, n, 3, cuda_device), _draws(draws, n, 3, cuda_device)
    for call in range(3):
        args, kw = _case(n, seed=100 * call + n, device=cuda_device)
        if draws == "uniforms":
            d_eager = d_graphed = _draws(draws, n, call, cuda_device)
        want = pnp.ransac_pnp(*args, **kw, **d_eager)
        got = graphed(*args, **kw, **d_graphed)
        _assert_same(got, want)
    assert graphed.captures == 1
    if draws == "generator":
        assert torch.equal(d_eager["generator"].get_state(), d_graphed["generator"].get_state())


@pytest.mark.cuda
def test_a_held_result_survives_the_next_replay(cuda_device):
    n = ROWS["F"]
    graphed = pnp.GraphedRansacPnP()
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    args, kw = _case(n, seed=1, device=cuda_device)
    held = graphed(*args, **kw, generator=gen)
    kept = pnp.PnPResult(*(t.clone() for t in held))
    other, kw2 = _case(n, seed=2, device=cuda_device)
    nxt = graphed(*other, **kw2, generator=gen)
    torch.cuda.synchronize()
    _assert_same(held, kept)
    assert not torch.equal(nxt.body_t_world, held.body_t_world)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_no_synchronizing_call(cuda_device, weighted):
    """Under sync-debug ``error`` neither the eager solve (the readbacks of
    ``x[best]`` are gone) nor a replay raises."""
    n = ROWS["D"]
    graphed = pnp.GraphedRansacPnP()
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    args, kw = _case(n, seed=3, device=cuda_device, weighted=weighted)
    graphed(*args, **kw, generator=gen)  # the capture synchronizes the device once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed(*args, **kw, generator=gen)
        pnp.ransac_pnp(*args, **kw, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_one_capture_for_a_hundred_calls(cuda_device):
    n = ROWS["F"]
    graphed = pnp.GraphedRansacPnP()
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    args, kw = _case(n, seed=4, device=cuda_device)
    profiling.clear()
    profiling.tracing(True)
    modes = []
    try:
        for _ in range(100):
            with profiling.span("tracker.pnp") as sp:
                graphed(*args, **kw, generator=gen)
            modes.append(sp.attrs["graph"])
    finally:
        profiling.tracing(False)
        profiling.clear()
    assert graphed.captures == 1
    assert modes == ["capture"] + ["replay"] * 99
    graphed(*args, **{**kw, "num_hypotheses": 8}, generator=gen)  # another key, another graph
    assert graphed.captures == 2


@pytest.mark.cuda
def test_engine_poses_equal_the_eager_solve(cuda_device, monkeypatch):
    """60 ticks of ``TorchSlamEngine`` on the flagship cell's configuration
    and frames: every finalized tick's output (pose, inliers, covariance,
    ...) and every delivered pose the same with the graphed solve as with
    ``track_step`` patched back to the eager ``ransac_pnp``. The device is
    synchronized before each call, so that a depth-6 call hands over the
    same ticks in both runs however fast either runs."""
    from benchmark.core import spec, traffic
    from thor_slam_tpu_torch.engine import tracker
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig

    bench = spec.load_benchmark()
    cell = spec.cell("oak4-1280x720-flagship.replay-vo", bench)
    cfg, mix = spec.config(cell["config"], bench), spec.traffic(cell["traffic"])
    seed = 3_000_000_777
    rig = spec.rig_builder(cfg["rig"]["builder"]).build(cfg, mix, seed, cuda_device)

    def run():
        engine = TorchSlamEngine(**cfg["engine"], device=cuda_device, seed=seed)
        engine.initialize(rig.calibration, SlamConfig(num_cameras=rig.num_cameras, **cfg["slam"]))
        ticks, finalize = [], engine._finalize_values

        def logged(rec):  # a depth-6 call finalizes several ticks and returns one pose
            ticks.append((rec["ts"], tracker.unpack_output(rec["packed"])))
            return finalize(rec)

        engine._finalize_values = logged
        frames = traffic.FrameSetFactory(rig, mix["fps"], mix.get("imu_hz", 0))
        out = []
        for k in range(60):
            torch.cuda.synchronize(cuda_device)
            out.append(engine.process_frames(frames(k)))
        out.append(engine.flush())
        engine.shutdown()
        return ticks, [(p.timestamp, p.to_4x4_matrix()) for p in out if p is not None]

    graphed = run()
    monkeypatch.setattr(pnp, "ransac_pnp_graphed", pnp.ransac_pnp)
    eager = run()
    assert len(graphed[0]) == len(eager[0]) == 60
    for (ta, a), (tb, b) in zip(graphed[0], eager[0]):
        assert ta == tb and a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert len(graphed[1]) == len(eager[1]) >= 5
    for (ta, a), (tb, b) in zip(graphed[1], eager[1]):
        assert ta == tb
        np.testing.assert_array_equal(a, b)
