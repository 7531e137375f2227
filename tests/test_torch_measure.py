"""The port's measurement tools against the JAX package's, on the CPU.

* ``utils/flagship.render_sequence``: the host render equals the
  reference's byte for byte (the port's and the reference's flagship rig at
  128x96, 2 cameras, 3 frames); the torch render agrees with the numpy
  render and with the reference's ``xp=jnp`` render on >= 99.9 % of the
  uint8 pixels (``clip(x * 255, 0, 255).astype(uint8)``, the reference's
  ``profile_stages`` conversion). Measured when written: 99.996 % against
  numpy, 99.999 % against JAX; the rest are texture-cell boundaries, where
  float32 and numpy's float64 floor into neighbouring cells.
* ``utils/profiling.torch_trace``: writes a trace and reports 0 device ms
  and 0 kernel launches on the CPU; the kernel counts read, subtract and
  reset by name.
* ``scripts/profile_stages``: every row the reference prints, by name (the
  label before its bracket: the port's labels name what runs), at
  ``160x100 1`` with ``--e2e --default`` and 3 ticks; ``profile_e2e`` with
  the EuRoC runner's engine splits its ticks by type.
* ``scripts/ablate_step``: each stub returns the real function's shapes,
  dtypes and device on the inputs the tracker gives the real one; every
  patched attribute is the original after a run, also when a variant
  raises; all seven rows print, each variant with the median of its
  paired differences from FULL, at 128x96 with 2 timed steps.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_slam_tpu.utils import flagship as jflagship
from thor_slam_tpu_torch.engine import convert
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.scripts import ablate_step, profile_stages
from thor_slam_tpu_torch.utils import flagship as tflagship
from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda
from thor_slam_tpu_torch.utils import profiling
from thor_slam_tpu_torch.utils.profiling import torch_trace

torch.set_num_threads(2)

FRAMES = 3
MIN_U8_EQUAL = 0.999


def _u8(x) -> np.ndarray:
    return np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.uint8)


def _sources(package):
    mod = tflagship if package == "port" else jflagship
    return mod.flagship_rig(num_cams=2, width=128, height=96)[3]


@pytest.fixture(scope="module")
def host_render():
    return tflagship.render_sequence(_sources("port"), FRAMES)


@pytest.mark.parametrize("rig", ["port", "reference"])
def test_host_render_equals_reference_byte_for_byte(rig, host_render):
    sources = _sources(rig)
    got = tflagship.render_sequence(sources, FRAMES)
    want = np.asarray(jflagship.render_sequence(sources, FRAMES))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (FRAMES, 2, 2, 96, 128)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == host_render.tobytes()  # both rigs render the same frames


@pytest.mark.parametrize("against", ["numpy", "jax"])
def test_torch_render_matches_host_and_jax(against, host_render):
    got = tflagship.render_sequence(_sources("port"), FRAMES, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == host_render.shape
    want = host_render if against == "numpy" else np.asarray(jflagship.render_sequence(_sources("reference"),
                                                                                       FRAMES, xp=jnp))
    equal = (_u8(got.numpy()) == _u8(want)).mean()
    assert equal >= MIN_U8_EQUAL, f"uint8-equal on {equal:.6f} of pixels"
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_torch_render_batch_equals_single_poses():
    src = _sources("port")[0]
    poses = np.stack([src.world_t_optical(src.frame_time(0), ci) for ci in range(2)])
    from thor_slam_tpu_torch.camera.sources import synthetic_torch

    intrinsics = src.get_intrinsics()[0]
    batch = synthetic_torch.render(src._world, intrinsics, poses, "cpu")
    for k in range(2):
        one = synthetic_torch.render(src._world, intrinsics, poses[k : k + 1], "cpu")
        torch.testing.assert_close(one[0], batch[k], rtol=0, atol=0)


def test_torch_trace_writes_a_trace_and_no_device_time_on_the_cpu(tmp_path):
    with torch_trace(str(tmp_path)) as window:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert window.device_ms == 0.0 and window.launches == 0
    assert os.path.dirname(window.path) == str(tmp_path) and os.path.getsize(window.path) > 0
    with open(window.path) as f:
        assert "traceEvents" in json.load(f)


def test_kernel_counts_read_subtract_and_reset_by_name():
    profiling.reset_kernel_counts()
    assert profiling.kernel_counts() == {k: {"kernel": 0, "plain": 0} for k in profiling.KERNELS}
    before = profiling.kernel_counts(("patch_gather", "fast9_nms"))
    images = torch.rand(2, 40, 48)
    cam = torch.zeros(3, dtype=torch.int32)
    patches_cuda.extract_patches_flat(images, cam, torch.full((3, 2), 20, dtype=torch.int32), 9)
    fast_cuda.fast_scores_plain(images, 0.05)
    assert profiling.counts_since(before) == {"patch_gather": {"kernel": 0, "plain": 1},
                                              "fast9_nms": {"kernel": 0, "plain": 1}}
    profiling.reset_kernel_counts(("fast9_nms",))
    assert profiling.kernel_counts(("patch_gather", "fast9_nms")) == {
        "patch_gather": {"kernel": 0, "plain": 1}, "fast9_nms": {"kernel": 0, "plain": 0}}
    profiling.reset_kernel_counts()
    assert profiling.kernel_counts()["patch_gather"] == {"kernel": 0, "plain": 0}


# ------------------------------------------------------------ profile_stages

#: The reference's rows (``scripts/profile_stages.py``), each by the part
#: of its label that names the stage.
STAGE_ROWS = ("gaussian blur", "FAST detect", "BRIEF describe", "coord rectify", "match", "disparity refine",
              "KLT track", "RANSAC PnP", "SUM of stages", "FULL track_step")
#: Rows that reach a hand-written kernel: what one call launches (KLT: one
#: pair gather a level, 2 levels).
HAND_KERNELS = {"FAST detect": "fast9_nms 1", "BRIEF describe": "patch_gather 1", "KLT track": "patch_gather 2"}
E2E_ROWS = ("e2e attribution", *profile_stages.E2E_STAGES, "TOTAL", "default-featured e2e", "max rate",
            "33 ms cadence")


@pytest.fixture(scope="module")
def profile_out():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_stages.main(["160x100", "1", "--e2e", "--default", "--cadence-ms=33.3", "--device", "cpu",
                                  "--ticks", "3", "--reps", "2"])
    assert rc == 0
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("row", STAGE_ROWS + E2E_ROWS)
def test_profile_stages_prints_every_reference_row(row, profile_out):
    lines = [ln.strip() for ln in profile_out]
    hits = [ln for ln in lines if ln.startswith(row + " ") or ln.startswith(row + ":") or ln.startswith(row + "(")]
    assert len(hits) == 1, f"{row!r} in {lines}"
    if row in STAGE_ROWS:
        # host ms, then the device's ms and launches: 0 on the CPU
        assert "device    0.000 ms      0.0 launches" in hits[0], hits[0]
    if row in HAND_KERNELS:  # the plain versions of the hand-written kernels, a call
        assert hits[0].endswith(f"a call: {HAND_KERNELS[row]} (plain versions)"), hits[0]


def test_profile_stages_header_names_the_device(profile_out):
    assert profile_out[0] == "profile 1 cams @ 160x100, N=512  device=cpu"


def test_profile_e2e_with_the_euroc_engine_splits_ticks_by_type():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = profile_stages.profile_e2e(160, 100, 1, ticks=4, device="cpu", engine="euroc")
    text = buf.getvalue()
    assert "euroc engine, 4 synchronized ticks" in text and "of which step" in text, text
    assert sum(v["n"] for v in out["by_kind"].values()) == 4 and set(out["by_kind"]) <= {"keyframe", "light", "full"}
    assert 0.0 < out["step"] <= out["dispatch+compute"]
    assert out["TOTAL"] == pytest.approx(sum(out[k] for k in profile_stages.E2E_STAGES))
    for kind, row in out["by_kind"].items():
        assert re.search(rf"^  {kind} ticks +n= +{row['n']} median ms: stage ", text, re.M), text


# --------------------------------------------------------------- ablate_step

def _recorded_calls():
    """Each stubbed function's first call in one keyframe tick of a small
    rig: (args, kwargs, result)."""
    params, setup, _, sources, _, _ = tflagship.flagship_rig(num_cams=2, width=128, height=96, max_keypoints=64)
    setup = convert.setup_to_torch(setup, "cpu")
    images = torch.from_numpy(np.asarray(tflagship.render_sequence(sources, 1))[0])
    calls = {}
    saved = [(m, a, getattr(m, a)) for _, m, a, _ in ablate_step.VARIANTS[1:]]

    def recorder(key, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.setdefault(key, (args, kwargs, out))
            return out
        return wrapper

    for module, attr, fn in saved:
        setattr(module, attr, recorder(attr, fn))
    try:
        trk.track_step(params, setup, trk.init_state(params, "cpu"), images, generator=torch.Generator().manual_seed(0))
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    return calls


@pytest.fixture(scope="module")
def recorded():
    return _recorded_calls()


@pytest.mark.parametrize("label", [v[0] for v in ablate_step.VARIANTS[1:]])
def test_ablation_stub_matches_the_real_function(label, recorded):
    _, module, attr, stub = next(v for v in ablate_step.VARIANTS if v[0] == label)
    args, kwargs, real = recorded[attr]
    fake = stub(*args, **kwargs)
    real_t = real if isinstance(real, tuple) else (real,)
    fake_t = fake if isinstance(fake, tuple) else (fake,)
    assert type(fake) is type(real)
    for r, f in zip(real_t, fake_t, strict=True):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)


def test_ablation_restores_every_attribute_when_a_variant_raises(monkeypatch):
    originals = [(m, a, getattr(m, a)) for _, m, a, _ in ablate_step.VARIANTS[1:]]

    def broken(*args, **kwargs):
        raise RuntimeError("stub failed")

    variants = list(ablate_step.VARIANTS)
    label, module, attr, _ = variants[4]
    variants[4] = (label, module, attr, broken)
    monkeypatch.setattr(ablate_step, "VARIANTS", tuple(variants))
    with pytest.raises(RuntimeError, match="stub failed"):
        ablate_step.run(128, 96, "cpu", reps=1, warmup=1, frames=3, num_cams=1, max_keypoints=64)
    for module, attr, fn in originals:
        assert getattr(module, attr) is fn, attr


@pytest.fixture(scope="module")
def ablate_out():
    originals = [(m, a, getattr(m, a)) for _, m, a, _ in ablate_step.VARIANTS[1:]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ablate_step.main(["128x96", "--reps", "2", "--device", "cpu"])
    assert rc == 0
    restored = all(getattr(m, a) is fn for m, a, fn in originals)
    return buf.getvalue().splitlines(), restored


@pytest.mark.parametrize("label", [v[0] for v in ablate_step.VARIANTS])
def test_ablate_step_prints_every_row(label, ablate_out):
    lines, restored = ablate_out
    rows = [ln for ln in lines if ln.startswith(label + " ")]
    assert len(rows) == 1, lines
    assert " ms a step (median" in rows[0], rows[0]
    if label == "FULL":
        assert re.search(r"keyframe ticks \d+ of 2$", rows[0]), rows[0]
    else:  # the median of the paired differences, and FULL's keyframes beside the variant's
        assert "; FULL - this " in rows[0] and "(median of 2 pairs; " in rows[0], rows[0]
        assert re.search(r"; (n/a|[+-]\d+\.\d\d) over \d+ non-keyframe pairs; (n/a|[+-]\d+\.\d\d) over \d+ "
                         r"keyframe pairs\)", rows[0]), rows[0]
        assert re.search(r"keyframe ticks \d+ of 2 \(FULL \d+\)$", rows[0]), rows[0]
    assert restored, "a stub outlived main"
