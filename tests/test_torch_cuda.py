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

from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda
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


@pytest.mark.parametrize("wrapper", ["patches", "fast"])
def test_device_tensor_never_falls_back(monkeypatch, wrapper):
    """A non-CPU tensor gets the kernel or an exception, never the plain
    version: with the loader failing, the wrapper raises and the plain
    counter stays at zero (meta tensors stand in for CUDA ones here)."""
    monkeypatch.setattr(cuda_lib, "load", _missing_library)
    patches_cuda.reset_counts()
    fast_cuda.reset_counts()
    imgs = torch.empty((2, 32, 48), device="meta")
    with pytest.raises(RuntimeError, match="unavailable"):
        if wrapper == "patches":
            cam = torch.empty(8, dtype=torch.int32, device="meta")
            centers = torch.empty((8, 2), dtype=torch.int32, device="meta")
            patches_cuda.extract_patches_flat(imgs, cam, centers, 9)
        else:
            fast_cuda.fast_scores_batched(imgs, 0.05)
    assert patches_cuda.counts["plain"] == 0 and fast_cuda.counts["plain"] == 0


def test_kernel_entry_rejects_cpu_tensors(monkeypatch):
    """Called directly, the CUDA entry points refuse host tensors."""
    monkeypatch.setattr(cuda_lib, "load", lambda: None)
    with pytest.raises(ValueError):
        fast_cuda.fast_scores_cuda(torch.rand(1, 16, 16), 0.05)
    with pytest.raises(ValueError):
        patches_cuda.extract_patches_flat_cuda(
            torch.rand(1, 16, 16), torch.zeros(2, dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32), 5
        )


def test_library_path_tracks_sources():
    """The build cache key covers every CUDA source, under an ignored dir."""
    path = cuda_lib.library_path()
    assert path.name == cuda_lib.LIB_NAME
    assert path.parent.parent == cuda_lib.BUILD_DIR
    assert {p.name for p in cuda_lib._sources()} == {"fast.cu", "patches.cu"}
    assert "thor_slam_tpu_torch/_build/" in (REPO / ".gitignore").read_text()


# ----------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from thor_slam_tpu_torch.utils.platform import pin_precision

    pin_precision()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size", [((4, 400, 640), 19), ((4, 200, 320), 19), ((4, 400, 640), 37), ((3, 41, 37), 9)])
def test_patch_kernel_matches_plain(cuda_device, shape, size):
    gen = torch.Generator().manual_seed(5)
    c, h, w = shape
    m = 2048
    imgs = torch.rand(shape, generator=gen).to(cuda_device)
    cam = torch.arange(c, dtype=torch.int32).repeat_interleave(m // c + 1)[:m].to(cuda_device)
    centers = torch.stack(
        [torch.randint(-30, w + 30, (m,), generator=gen), torch.randint(-30, h + 30, (m,), generator=gen)], -1
    ).int().to(cuda_device)
    got = patches_cuda.extract_patches_flat_cuda(imgs, cam, centers, size)
    want = patches_cuda.extract_patches_flat_plain(imgs, cam, centers, size)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 400, 640), (4, 720, 1280), (1, 37, 53)])
def test_fast_kernel_matches_plain(cuda_device, shape):
    imgs = torch.rand(shape, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    raw_k, nms_k = fast_cuda.fast_scores_cuda(imgs, 0.05)
    raw_p, nms_p = fast_cuda.fast_scores_plain(imgs, 0.05)
    torch.cuda.synchronize()
    assert float((raw_k - raw_p).abs().max()) <= 1e-6
    assert float((nms_k - nms_p).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_engine_tracks_on_the_card_through_the_kernels(cuda_device):
    from thor_slam_tpu.camera.rig import CameraRig
    from thor_slam_tpu.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticRigSpec,
        SyntheticWorld,
        make_synthetic_rig,
    )
    from thor_slam_tpu.slam.interface import SlamConfig, TrackingState
    from thor_slam_tpu.utils.evaluation import ate_rmse
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
    assert patches_cuda.counts["kernel"] >= 80 and patches_cuda.counts["plain"] == 0
    assert fast_cuda.counts["kernel"] >= 2 and fast_cuda.counts["plain"] == 0
