"""Guards of the port's device dispatch, and its kernels on the card.

This file imports no JAX, so the ``cuda``-marked tests also run on a
machine with a card and no JAX (run from the repo root with
``python -m pytest tests/test_torch_cuda.py --noconftest``: the suite's
conftest imports JAX). Without a card they skip; the guards run anywhere.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda, sgm_cuda
from thor_slam_tpu_torch.utils import cuda_lib

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------- guards


def test_package_imports_no_jax():
    """Every module of the port imports without loading JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import thor_slam_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_chip_smoke_imports_no_jax_and_needs_a_card():
    """``chip_smoke.py`` loads no JAX and fails, printing no result, without a card."""
    code = (
        "import sys, runpy, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code not in (0, None), e.code\n"
        "else:\n"
        "    raise AssertionError('chip_smoke exited 0 without a card')\n"
        "assert 'jax' not in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert '"ok"' not in proc.stdout


def _missing_library():
    raise RuntimeError("kernel library unavailable")


@pytest.mark.parametrize("wrapper", ["patches", "patches_pair", "fast", "sgm_scan", "sgm_4dir", "sgm_winner_lr"])
def test_device_tensor_never_falls_back(monkeypatch, wrapper):
    """A non-CPU tensor gets the kernel or an exception, never the plain
    version: with the loader failing, the wrapper raises and the plain
    counter stays at zero (meta tensors stand in for CUDA ones here)."""
    monkeypatch.setattr(cuda_lib, "load", _missing_library)
    patches_cuda.reset_counts()
    fast_cuda.reset_counts()
    sgm_cuda.reset_counts()
    imgs = torch.empty((2, 32, 48), device="meta")
    with pytest.raises(RuntimeError, match="unavailable"):
        if wrapper == "patches":
            cam = torch.empty(8, dtype=torch.int32, device="meta")
            centers = torch.empty((8, 2), dtype=torch.int32, device="meta")
            patches_cuda.extract_patches_flat(imgs, cam, centers, 9)
        elif wrapper == "patches_pair":
            cam = torch.empty(8, dtype=torch.int32, device="meta")
            centers = torch.empty((2, 8, 2), dtype=torch.int32, device="meta")
            patches_cuda.extract_patches_pair(imgs, imgs, cam, centers, 9)
        elif wrapper == "fast":
            fast_cuda.fast_scores_batched(imgs, 0.05)
        elif wrapper == "sgm_scan":
            sgm_cuda.sgm_aggregate_dir(torch.empty((48, 16, 32), device="meta"), 6.0, 96.0, False)
        elif wrapper == "sgm_4dir":
            sgm_cuda.sgm_aggregate_4dir(torch.empty((16, 32, 48), device="meta"), 6.0, 96.0)
        else:
            sgm_cuda.winner_lr(torch.empty((16, 32, 48), device="meta"), 16)
    assert patches_cuda.counts["plain"] == 0 and fast_cuda.counts["plain"] == 0
    assert all(c["plain"] == 0 for c in sgm_cuda.counts.values())


def test_kernel_entry_rejects_cpu_tensors(monkeypatch):
    """Called directly, the CUDA entry points refuse host tensors."""
    monkeypatch.setattr(cuda_lib, "load", lambda: None)
    with pytest.raises(ValueError):
        fast_cuda.fast_scores_cuda(torch.rand(1, 16, 16), 0.05)
    with pytest.raises(ValueError):
        patches_cuda.extract_patches_flat_cuda(
            torch.rand(1, 16, 16), torch.zeros(2, dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32), 5
        )
    with pytest.raises(ValueError):
        patches_cuda.extract_patches_pair_cuda(
            torch.rand(1, 16, 16), torch.rand(1, 16, 16), torch.zeros(2, dtype=torch.int32),
            torch.zeros((2, 2, 2), dtype=torch.int32), 5,
        )
    with pytest.raises(ValueError):
        sgm_cuda.sgm_aggregate_dir_cuda(torch.rand(8, 16, 4), 6.0, 96.0, False)
    with pytest.raises(ValueError):
        sgm_cuda.sgm_aggregate_4dir_cuda(torch.rand(16, 8, 12), 6.0, 96.0)
    with pytest.raises(ValueError):
        sgm_cuda.winner_lr_cuda(torch.rand(16, 8, 12), 16)


def test_library_path_tracks_sources():
    """The build cache key covers every CUDA source, under an ignored dir."""
    path = cuda_lib.library_path()
    assert path.name == cuda_lib.LIB_NAME
    assert path.parent.parent == cuda_lib.BUILD_DIR
    assert {p.name for p in cuda_lib._sources()} == {"fast.cu", "patches.cu", "sgm.cu"}
    assert "thor_slam_tpu_torch/_build/" in (REPO / ".gitignore").read_text()


# ----------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from thor_slam_tpu_torch.utils.platform import pin_precision

    pin_precision()
    return torch.device("cuda", 0)


# (shape, S, M): the main path's three, then M = 1, M a multiple of no
# block's patch count, a patch as tall as the image, generic sizes.
PATCH_CASES = [
    ((4, 400, 640), 19, 2048), ((4, 200, 320), 19, 2048), ((4, 400, 640), 37, 2048), ((3, 41, 37), 9, 2048),
    ((3, 41, 37), 9, 1), ((3, 41, 37), 19, 13), ((2, 37, 53), 37, 7), ((1, 64, 48), 5, 1001), ((2, 9, 300), 3, 77),
]


def _patch_inputs(shape, m, device, seed=5):
    """Two stacks, a camera-major cam and (2, M, 2) centres up to 30 px
    outside every border."""
    gen = torch.Generator().manual_seed(seed)
    c, h, w = shape
    stacks = [torch.rand(shape, generator=gen).to(device) for _ in range(2)]
    cam = torch.arange(c, dtype=torch.int32).repeat_interleave(m // c + 1)[:m].to(device)
    centers = torch.stack(
        [torch.randint(-30, w + 30, (2, m), generator=gen), torch.randint(-30, h + 30, (2, m), generator=gen)], -1
    ).int().to(device)
    return stacks, cam, centers


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size,m", PATCH_CASES)
def test_patch_kernel_matches_plain(cuda_device, shape, size, m):
    """A copy: exact. The single-stack entry on each stack, the pair entry
    against two plain calls, its clipped centres against the tensor clamps,
    and the pair entry on the two eyes of a (C, 2, H, W) tensor."""
    stacks, cam, centers = _patch_inputs(shape, m, cuda_device)
    want = torch.stack(
        [patches_cuda.extract_patches_flat_plain(s, cam, k, size) for s, k in zip(stacks, centers)]
    )
    for k in range(2):
        assert torch.equal(patches_cuda.extract_patches_flat_cuda(stacks[k], cam, centers[k], size), want[k])
    patches_cuda.reset_counts()
    got, clipped = patches_cuda.extract_patches_pair_cuda(*stacks, cam, centers, size)
    assert patches_cuda.counts == {"kernel": 1, "plain": 0}
    _, clamps = patches_cuda.extract_patches_pair_plain(*stacks, cam, centers, size)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert clipped.dtype == torch.int32 and torch.equal(clipped, clamps)
    both = torch.stack(stacks, 1)
    got, _ = patches_cuda.extract_patches_pair_cuda(both[:, 0], both[:, 1], cam, centers, size)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_patch_wrapper_refusals(cuda_device):
    """What the kernel does not take raises before any launch."""
    stacks, cam, centers = _patch_inputs((2, 40, 56), 6, cuda_device)
    a, b = stacks
    pair = patches_cuda.extract_patches_pair_cuda
    patches_cuda.reset_counts()
    with pytest.raises(ValueError, match="one shape"):
        pair(a, b[:, :-1].contiguous(), cam, centers, 9)
    with pytest.raises(ValueError, match="dense"):
        pair(a, b.transpose(1, 2).contiguous().transpose(1, 2), cam, centers, 9)
    with pytest.raises(ValueError, match="dense"):
        patches_cuda.extract_patches_flat_cuda(a[:, :, ::2], cam, centers[0], 9)
    with pytest.raises(ValueError, match="float32"):
        pair(a.double(), b.double(), cam, centers, 9)
    with pytest.raises(ValueError, match="int32"):
        pair(a, b, cam, centers.long(), 9)
    with pytest.raises(ValueError, match=r"\(2, M, 2\)"):
        pair(a, b, cam, centers[0], 9)
    with pytest.raises(ValueError, match="mismatch"):
        pair(a, b, cam[:-1], centers, 9)
    with pytest.raises(ValueError, match="odd"):
        pair(a, b, cam, centers, 8)
    with pytest.raises(ValueError):
        fast_cuda.fast_scores_cuda(a.transpose(1, 2), 0.05)
    with pytest.raises(ValueError):
        fast_cuda.fast_scores_cuda(a.double(), 0.05)
    assert patches_cuda.counts == {"kernel": 0, "plain": 0}


# The main path's 4 and 8 images, 720p, then W % 4 != 0, H and W below one
# 128 x 16 tile, H = 1, a single pixel's neighbourhood, a tile edge in the
# last column and row, and rows that start off a 16-byte boundary.
FAST_SHAPES = [
    (4, 400, 640), (8, 400, 640), (4, 720, 1280), (1, 37, 53), (2, 1, 9), (1, 3, 3), (3, 33, 66), (1, 17, 129),
    (1, 16, 128), (2, 400, 642), (1, 130, 260),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FAST_SHAPES)
def test_fast_kernel_matches_plain(cuda_device, shape):
    """Within 1e-6 (the sums keep the plain version's order, so 0.0 so far)."""
    imgs = torch.rand(shape, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    raw_k, nms_k = fast_cuda.fast_scores_cuda(imgs, 0.05)
    raw_p, nms_p = fast_cuda.fast_scores_plain(imgs, 0.05)
    torch.cuda.synchronize()
    assert float((raw_k - raw_p).abs().max()) <= 1e-6
    assert float((nms_k - nms_p).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_fast_kernel_on_an_unaligned_view(cuda_device):
    """Images that start off a 16-byte boundary take the scalar loads and stores."""
    base = torch.rand(2 * 40 * 64 + 1, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    imgs = base[1:].reshape(2, 40, 64)
    assert imgs.is_contiguous() and imgs.data_ptr() % 16 != 0
    raw_k, nms_k = fast_cuda.fast_scores_cuda(imgs, 0.05)
    raw_p, nms_p = fast_cuda.fast_scores_plain(imgs, 0.05)
    torch.cuda.synchronize()
    assert float((raw_k - raw_p).abs().max()) <= 1e-6
    assert float((nms_k - nms_p).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_engine_tracks_on_the_card_through_the_kernels(cuda_device):
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticRigSpec,
        SyntheticWorld,
        make_synthetic_rig,
    )
    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, traj = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
        trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.5),
    )
    engine = TorchSlamEngine(params=dict(max_keypoints=128, keyframe_min_inliers=40), device=cuda_device)
    patches_cuda.reset_counts()
    fast_cuda.reset_counts()
    est, gt = [], []
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        engine.initialize(rig.calibration, SlamConfig(enable_loop_closure=False))
        gt0 = None
        for _ in range(20):
            fs = rig.get_synchronized_frames()
            pose = engine.process_frames(fs)
            g = traj.pose(fs.timestamp)
            gt0 = g if gt0 is None else gt0
            est.append(pose.position)
            gt.append((np.linalg.inv(gt0) @ g)[:3, 3])
    assert engine.get_tracking_state() == TrackingState.TRACKING
    assert ate_rmse(np.asarray(est), np.asarray(gt)) < 0.05
    # One FAST launch a keyframe (both eyes); one gather launch per KLT level
    # (2) and tick for both frames, and one a keyframe for BRIEF.
    keyframes = fast_cuda.counts["kernel"]
    assert keyframes >= 1 and fast_cuda.counts["plain"] == 0
    assert patches_cuda.counts == {"kernel": 2 * 20 + keyframes, "plain": 0}


def _scan_inputs(shape, seed, with_add, layout):
    """Integral costs in [0, 32] (and a pair volume in [0, 128]) as a
    step-major (S, D, X) tensor on the card: contiguous, or the (S, D, X)
    view of an (X, S, D) tensor, disparities at unit stride, since the
    kernel takes any strides (``.float()`` and ``.cuda()`` keep a permuted
    tensor's strides)."""
    gen = torch.Generator().manual_seed(seed)
    s, d, x = shape

    def volume(high):
        if layout == "contiguous":
            return torch.randint(0, high, (s, d, x), generator=gen).float().cuda()
        return torch.randint(0, high, (x, s, d), generator=gen).permute(1, 2, 0).float().cuda()

    return volume(33), volume(129) if with_add else None


# (D, H, W) at the listed disparity counts, with H and W multiples of no
# tile (the scan's 4-16 steps and 4-8 lines, the winner's 128 columns),
# H = 1, and W < D; then the flagship geometry.
SGM_SHAPES = [(48, 37, 203), (64, 1, 50), (64, 45, 37), (96, 23, 61), (256, 9, 100), (256, 3, 300), (64, 400, 640)]
PENALTIES = [(6.0, 96.0), (6.5, 97.25)]


def _sgm_volume(dhw, seed, integral):
    gen = torch.Generator().manual_seed(seed)
    if integral:
        return torch.randint(0, 33, dhw, generator=gen).float().cuda()
    return (torch.rand(dhw, generator=gen) * 24).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "permuted"])
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(200, 16, 200), (64, 40, 33), (640, 64, 400), (400, 64, 640), (50, 256, 9)])
def test_scan_kernel_matches_plain(cuda_device, shape, reverse, with_add, layout):
    """Bit-exact: integral costs keep every value an exact float32 integer."""
    cost, add = _scan_inputs(shape, 7, with_add, layout)
    got = sgm_cuda.sgm_aggregate_dir_cuda(cost, 6.0, 96.0, reverse, add)
    want = sgm_cuda.sgm_aggregate_dir_plain(cost, 6.0, 96.0, reverse, add)
    torch.cuda.synchronize()
    assert got.stride() == cost.stride()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("num_paths", [4, 2])
@pytest.mark.parametrize("penalties", PENALTIES)
@pytest.mark.parametrize("dhw", [(16, 40, 64)] + SGM_SHAPES)
def test_4dir_kernel_matches_plain(cuda_device, dhw, penalties, num_paths):
    """Bit-exact for integral and non-integral penalties, in three launches
    (four paths) or two (the horizontal pair)."""
    p1, p2 = penalties
    cost = _sgm_volume(dhw, 8, p1 == int(p1))
    sgm_cuda.reset_counts()
    got = sgm_cuda.sgm_aggregate_4dir_cuda(cost, p1, p2, num_paths)
    assert sgm_cuda.counts["sgm_scan"]["kernel"] == (3 if num_paths == 4 else 2)
    want = sgm_cuda.sgm_aggregate_4dir_plain(cost, p1, p2, num_paths)
    torch.cuda.synchronize()
    assert got.shape == dhw and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_scan_kernel_non_integral_penalties(cuda_device):
    """f32 non-integral inputs: the same float32 operations in the same
    order as the plain version, so equal bit for bit as well."""
    cost = (torch.rand((300, 48, 70), generator=torch.Generator().manual_seed(9)) * 24).cuda()
    got = sgm_cuda.sgm_aggregate_dir_cuda(cost, 6.5, 97.25, True)
    want = sgm_cuda.sgm_aggregate_dir_plain(cost, 6.5, 97.25, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("integral", [True, False])
@pytest.mark.parametrize(
    "dhw", [(16, 32, 256), (64, 37, 200), (96, 24, 1280), (3, 5, 7)] + SGM_SHAPES + [(64, 400, 600), (96, 720, 1280)]
)
def test_winner_kernel_matches_plain(cuda_device, dhw, integral):
    """All six outputs exact, on a tie-heavy integer volume (values in
    [0, 400)) and on a non-integral one."""
    gen = torch.Generator().manual_seed(10)
    if integral:
        agg = torch.randint(0, 400, dhw, generator=gen).float().cuda()
    else:
        agg = (torch.rand(dhw, generator=gen) * 400).cuda()
    got = sgm_cuda.winner_lr_cuda(agg, dhw[0])
    want = sgm_cuda.winner_lr_plain(agg, dhw[0])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("penalties", PENALTIES)
@pytest.mark.parametrize("dhw", SGM_SHAPES)
def test_scan_kernel_every_direction_on_the_dhw_volume(cuda_device, dhw, penalties):
    """Each direction and ``add_to`` case of the single-scan entry on the
    step-major views of a (D, H, W) volume, bit-exact against the plain
    scan, for integral and non-integral penalties."""
    p1, p2 = penalties
    cost = _sgm_volume(dhw, 11, p1 == int(p1))
    add = _sgm_volume(dhw, 12, True) * 4
    for view in (lambda v: v.permute(2, 0, 1), lambda v: v.permute(1, 0, 2)):
        for reverse in (False, True):
            for add_to in (None, view(add)):
                got = sgm_cuda.sgm_aggregate_dir_cuda(view(cost), p1, p2, reverse, add_to)
                want = sgm_cuda.sgm_aggregate_dir_plain(view(cost), p1, p2, reverse, add_to)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (dhw, reverse, add_to is not None)


@pytest.mark.cuda
def test_rgbd_product_on_the_card_through_the_kernels(cuda_device):
    """The RGB-D product on the card runs the kernels, never the plain
    versions, and agrees with the same product run on the CPU."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticCameraSource,
        SyntheticRigSpec,
        SyntheticWorld,
    )
    from thor_slam_tpu_torch.pipeline import RGBDProcessor

    spec = SyntheticRigSpec(
        num_sources=1, stereo=True, width=160, height=120, baseline_m=0.3,
        color_camera=True, color_resolution=(96, 64),
    )
    src = SyntheticCameraSource(
        "cam0", SyntheticWorld(half_extents=(2.5, 2.5, 1.5)), OrbitTrajectory(radius=1.0), np.eye(4), spec
    )
    with CameraRig([src]) as rig:
        sync = rig.get_synchronized_frames()
        color = src.try_get_latest_rgb_frame()
    kw = dict(color_intrinsics=src.get_rgb_intrinsics(), left_t_color=src.get_rgb_extrinsics().to_4x4_matrix())
    args = (src.name, src.get_intrinsics(), src.get_extrinsics())
    on_cpu = RGBDProcessor(*args, num_disparities=16, device="cpu", **kw).process(sync, color_frame=color)
    sgm_cuda.reset_counts()
    on_card = RGBDProcessor(*args, num_disparities=16, device=cuda_device, **kw).process(sync, color_frame=color)
    assert sgm_cuda.counts["sgm_scan"] == {"kernel": 3, "plain": 0}
    assert sgm_cuda.counts["sgm_winner_lr"] == {"kernel": 1, "plain": 0}
    np.testing.assert_array_equal(on_card.rgb, on_cpu.rgb)
    # Same formulas; the card's division by a scalar multiplies by its
    # reciprocal, so a depth can move by one millimetre.
    assert (on_card.depth_mm == on_cpu.depth_mm).mean() >= 0.99
    assert (on_card.depth_mm > 0).mean() > 0.2


@pytest.mark.cuda
def test_every_launch_sets_the_tensors_device(cuda_device, monkeypatch):
    """Each wrapper launches under ``torch.cuda.device(tensor.device)``,
    also from a thread whose current device was set to another card (the
    last one visible; on a one-card machine the same card, so the recorded
    guard is what shows the repair there). Results exact against the plain
    versions (FAST within 1e-6, as its own test)."""
    import threading

    entered = []

    class Recording(torch.cuda.device):  # a class still: torch checks isinstance against it
        def __init__(self, device):
            entered.append(torch.device(device))
            super().__init__(device)

    monkeypatch.setattr(torch.cuda, "device", Recording)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(2)
    stacks, cam, centers = _patch_inputs((2, 64, 80), 64, dev)
    images = torch.rand((2, 64, 80), generator=gen).to(dev)
    cost = _sgm_volume((16, 24, 40), 3, True)
    calls = {
        "patches": lambda: patches_cuda.extract_patches_flat_cuda(stacks[0], cam, centers[0].contiguous(), 9),
        "fast": lambda: fast_cuda.fast_scores_cuda(images, 0.05),
        "sgm_4dir": lambda: sgm_cuda.sgm_aggregate_4dir_cuda(cost, 6.0, 96.0),
        "sgm_winner_lr": lambda: sgm_cuda.winner_lr_cuda(cost, 16),
    }
    plains = {
        "patches": lambda: patches_cuda.extract_patches_flat_plain(stacks[0], cam, centers[0].contiguous(), 9),
        "fast": lambda: fast_cuda.fast_scores_plain(images, 0.05),
        "sgm_4dir": lambda: sgm_cuda.sgm_aggregate_4dir_plain(cost, 6.0, 96.0),
        "sgm_winner_lr": lambda: sgm_cuda.winner_lr_plain(cost, 16),
    }
    got, errors = {}, []

    def launch_all():
        try:
            torch.cuda.set_device(torch.cuda.device_count() - 1)
            for name, fn in calls.items():
                before = len(entered)
                got[name] = fn()
                torch.cuda.synchronize(dev)
                assert entered[before:] and all(d == dev for d in entered[before:]), (name, entered[before:])
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    thread = threading.Thread(target=launch_all)
    thread.start()
    thread.join()
    if errors:
        raise errors[0]
    for name, fn in plains.items():
        want = fn()
        for g, w in zip(got[name] if isinstance(got[name], tuple) else (got[name],),
                        want if isinstance(want, tuple) else (want,)):
            assert float((g.float() - w.float()).abs().max()) <= (1e-6 if name == "fast" else 0.0), name


# ------------------------------------------------ pipelined ticks on the card


def _stage_into(item, alloc):
    """An uploader stage function: copy ``item`` into the slot's buffer."""
    out = alloc(item.shape, item.dtype)
    out[...] = item
    return out


@pytest.mark.cuda
def test_uploader_ring_delivers_every_tick_at_depth_four(cuda_device):
    """8 distinct (C, 2, H, W) uint8 ticks through a ring of 5 pinned slots
    with 4 ticks in flight, the copy stream held back so that a slot is
    wanted again while its copy is still queued: each tick arrives on the
    device equal to its host array (a buffer overwritten before its copy
    would hand the device another tick's frame)."""
    from thor_slam_tpu_torch.pipeline.transfer import DoubleBufferedUploader

    rng = np.random.default_rng(9)
    ticks = [rng.integers(0, 256, (4, 2, 400, 640), dtype=np.uint8) for _ in range(8)]
    up = DoubleBufferedUploader(_stage_into, cuda_device, slots=5)
    try:
        with torch.cuda.stream(up._copy_stream):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the copy stream's time
        got = []
        for k, tick in enumerate(ticks):
            up.submit(tick)
            got.append(up.get())
            if k >= 4:  # a consumer 4 ticks behind reads the oldest
                assert torch.equal(got[k - 4].cpu(), torch.from_numpy(ticks[k - 4]))
        torch.cuda.synchronize()
        for tick, dev in zip(ticks, got):
            assert dev.device.type == "cuda" and torch.equal(dev.cpu(), torch.from_numpy(tick))
    finally:
        up.close()


@pytest.mark.cuda
def test_record_is_ready_only_after_its_pinned_copy_holds_the_tick(cuda_device):
    """The engine's record event: queried while the device is still busy
    it reports not ready; once it reports ready, the pinned copies hold the
    tick's values."""
    from thor_slam_tpu_torch.engine.pipeline_exec import record_ready
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    engine = TorchSlamEngine(device=cuda_device)
    engine._device = cuda_device
    x = torch.arange(57, dtype=torch.float32, device=cuda_device)
    torch.cuda._sleep(200_000_000)  # the stream is busy for ~0.1 s
    packed = x * 2.0
    ba_obs = torch.full((2, 8, 10), 3.0, device=cuda_device)
    rec = {"packed": packed, "ba_obs": ba_obs, "kf_sig": None, "event": None}
    engine._start_fetch(rec)
    assert rec["packed"].is_pinned() and rec["ba_obs"].is_pinned()
    assert not record_ready(rec)
    while not record_ready(rec):
        pass
    assert torch.equal(rec["packed"], (x * 2.0).cpu()) and bool((rec["ba_obs"] == 3.0).all())
    engine._fetch_records([rec])
    assert rec["event"] is None and isinstance(rec["packed"], np.ndarray)
    np.testing.assert_array_equal(rec["packed"], np.arange(57, dtype=np.float32) * 2.0)


# ------------------------------------------------ the tick's CUDA graphs


@pytest.mark.cuda
def test_graphed_tick_equals_the_eager_tick(cuda_device):
    """``track_step_graphed`` against the eager ``track_step`` over the plan
    of ``test_torch_tracker_graph.py`` (keyframe, full, light and half-res
    light ticks, an IMU prediction, a stale camera, a state moved as BA
    moves it and a reset), the graphed side fed its live cameras and
    predictions from pinned host memory as the engine feeds it: every
    tick's state, outputs and packed records bit for bit, compared after
    the last tick, so a result overwritten by a later replay shows. One
    capture a key (full, light, half-res light, with a prediction), and
    ``graph="replay"`` on ``tracker.front`` and ``tracker.back`` from a
    key's second call on."""
    from test_torch_tracker_graph import PLAN, assert_rows_equal, plan_kinds, rig_frames, run_plan

    from thor_slam_tpu_torch.engine import tracker as trk
    from thor_slam_tpu_torch.utils import profiling

    params, setup_np, frames = rig_frames()
    want = run_plan(trk.track_step, params, setup_np, frames, cuda_device)
    graphed = trk.GraphedTrackStep()
    profiling.tracing(False)
    profiling.clear()
    profiling.tracing(True)
    try:
        got = run_plan(graphed, params, setup_np, frames, cuda_device, host_inputs=True)
        torch.cuda.synchronize()
        spans = profiling.spans()
    finally:
        profiling.tracing(False)
        profiling.clear()
    assert_rows_equal(got, want)
    kinds = plan_kinds(want)
    assert kinds[0] == kinds[10] == "keyframe" and "full" in kinds and plan_kinds(got) == kinds
    keys = [(t.get("light", False), t.get("half", False), t.get("pred", False)) for t in PLAN]
    assert graphed.captures == len(set(keys)) == 4
    first = [keys.index(key) == k for k, key in enumerate(keys)]
    for name in ("tracker.front", "tracker.back"):
        modes = [s.attrs["graph"] for s in spans if s.name == name]
        assert modes == ["capture" if f else "replay" for f in first], name


@pytest.mark.cuda
def test_graphed_light_tick_makes_no_synchronizing_call(cuda_device):
    """A light tick's replay under sync-debug ``error``: its copies in, the
    front's graphs and gathers, the solve, the back and the clones never
    wait for the device."""
    from test_torch_tracker_graph import rig_frames

    from thor_slam_tpu_torch.engine import convert
    from thor_slam_tpu_torch.engine import tracker as trk

    params, setup_np, frames = rig_frames()
    setup = convert.setup_to_torch(setup_np, cuda_device)
    graphed = trk.GraphedTrackStep()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    state, _ = graphed(params, setup, trk.init_state(params, cuda_device),
                       torch.from_numpy(frames[0]).to(cuda_device), generator=gen)
    light = [torch.from_numpy(np.ascontiguousarray(f[:, :1])).to(cuda_device) for f in frames[1:3]]
    state, _ = graphed(params, setup, state, light[0], generator=gen, allow_refresh=False)  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = graphed(params, setup, state, light[1], generator=gen, allow_refresh=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(out.num_inliers) >= 50 and graphed.captures == 2


@pytest.mark.cuda
def test_engine_captures_every_tick_variant_at_initialize(cuda_device):
    """On a card ``initialize`` captures the graphed tick of every variant a
    tick can take (full, light and half-res light, each with and without
    the IMU's prediction: six) by dry ticks that launch no hand-written
    kernel; then no tick of the stream captures, every ``tracker.front`` and
    ``tracker.back`` says ``replay``."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticRigSpec,
        SyntheticWorld,
        make_synthetic_rig,
    )
    from thor_slam_tpu_torch.engine import tracker as trk
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils import profiling

    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
        trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.5),
    )
    engine = TorchSlamEngine(params=dict(max_keypoints=96, keyframe_min_inliers=40), device=cuda_device,
                             adaptive_half_res=True)
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as rig:
        frames = [rig.get_synchronized_frames() for _ in range(16)]
        before = trk.track_step_graphed.captures
        patches_cuda.reset_counts()
        fast_cuda.reset_counts()
        engine.initialize(rig.calibration, SlamConfig(enable_loop_closure=False, expected_fps=30.0))
    torch.cuda.synchronize()
    assert engine._light_ctl.adaptive
    assert trk.track_step_graphed.captures - before == 6
    assert patches_cuda.counts["kernel"] == fast_cuda.counts["kernel"] == 0
    profiling.tracing(False)
    profiling.clear()
    profiling.tracing(True)
    try:
        for fs in frames:
            engine.process_frames(fs)
        torch.cuda.synchronize()
        spans = profiling.spans()
    finally:
        profiling.tracing(False)
        profiling.clear()
    modes = [s.attrs["graph"] for s in spans if s.name in ("tracker.front", "tracker.back")]
    assert len(modes) == 2 * len(frames) and set(modes) == {"replay"}
    assert trk.track_step_graphed.captures - before == 6
    assert any(s.attrs.get("light") for s in spans if s.name == "engine.process_frames")
