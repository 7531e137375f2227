"""The port's two kernels: plain versions against the JAX reference.

On the CPU the kernel wrappers dispatch to their plain PyTorch versions,
which are held here against the reference's XLA formulation and its
Pallas kernels in interpret mode. The CUDA kernels themselves are held
against the plain versions in ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_slam_tpu.ops import fast as jfast
from thor_slam_tpu.ops import fast_pallas, patches_pallas
from thor_slam_tpu.ops import klt as jklt
from thor_slam_tpu.ops.image import extract_patches_mxu
from thor_slam_tpu_torch.ops import fast as tfast
from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda
from thor_slam_tpu_torch.ops import klt as tklt

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rendered(c=2, w=128, h=96, eye=0):
    """Rendered (C, H, W) float32 views of the synthetic room, in [0, 1]."""
    from thor_slam_tpu.camera.sources.synthetic import SyntheticRigSpec, make_synthetic_rig

    spec = SyntheticRigSpec(num_sources=c, stereo=True, width=w, height=h)
    sources, _, _, _ = make_synthetic_rig(spec)
    return np.stack([s.render_frame(3, eye) for s in sources]).astype(np.float32) / 255.0


# -------------------------------------------------------- patch gather


class TestPatchGatherPlain:
    @pytest.mark.parametrize("size", [9, 19, 37])
    def test_matches_mxu_reference(self, size):
        rng = np.random.default_rng(21)
        c, h, w, n = 3, 64, 100, 32
        imgs = rng.uniform(size=(c, h, w)).astype(np.float32)
        centers = rng.integers(-25, [w + 25, h + 25], size=(c, n, 2)).astype(np.int32)
        want = np.asarray(
            jax.vmap(lambda im, ct: extract_patches_mxu(im, ct, size))(jnp.asarray(imgs), jnp.asarray(centers))
        )
        got = patches_cuda.extract_patches_batched(_t(imgs), _t(centers), size=size)
        np.testing.assert_array_equal(got.numpy(), want)  # a copy: exact

    @pytest.mark.parametrize("size", [9, 19])
    def test_matches_pallas_interpret(self, size):
        rng = np.random.default_rng(22)
        c, h, w, m = 2, 48, 256, 16  # a geometry the Pallas kernel supports
        assert patches_pallas.supports(h, w, m, size)
        imgs = rng.uniform(size=(c, h, w)).astype(np.float32)
        cam = np.repeat(np.arange(c, dtype=np.int32), m // c)
        centers = rng.integers(-5, [w + 5, h + 5], size=(m, 2)).astype(np.int32)
        want = np.asarray(
            patches_pallas.extract_patches_flat(
                jnp.asarray(imgs), jnp.asarray(cam), jnp.asarray(centers), size=size, interpret=True
            )
        )
        got = patches_cuda.extract_patches_flat(_t(imgs), _t(cam), _t(centers), size)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_cpu_tensor_takes_plain_version(self):
        patches_cuda.reset_counts()
        imgs = torch.rand(2, 30, 40)
        centers = torch.randint(0, 30, (2, 5, 2), dtype=torch.int32)
        patches_cuda.extract_patches_batched(imgs, centers, size=7)
        assert patches_cuda.counts == {"kernel": 0, "plain": 1}


def _pair_inputs(seed, c, h, w, m, spill):
    """Two (C, H, W) stacks, a camera-major cam and (2, M, 2) centres that
    spill past every border."""
    rng = np.random.default_rng(seed)
    stacks = rng.uniform(size=(2, c, h, w)).astype(np.float32)
    cam = np.repeat(np.arange(c, dtype=np.int32), m // c)
    centers = rng.integers(-spill, [w + spill, h + spill], size=(2, m, 2)).astype(np.int32)
    return stacks, cam, centers


class TestPatchGatherPair:
    """The pair entry (two stacks, one launch on the card) on the CPU: its
    plain version against the reference, for both stacks. A copy: exact."""

    @pytest.mark.parametrize("size", [9, 19])
    def test_matches_pallas_interpret(self, size):
        c, h, w, m = 2, 48, 256, 16  # a geometry the Pallas kernel supports
        assert patches_pallas.supports(h, w, m, size)
        stacks, cam, centers = _pair_inputs(31, c, h, w, m, 5)
        got, _ = patches_cuda.extract_patches_pair(_t(stacks[0]), _t(stacks[1]), _t(cam), _t(centers), size)
        assert got.shape == (2, m, size, size)
        for k in range(2):
            want = patches_pallas.extract_patches_flat(
                jnp.asarray(stacks[k]), jnp.asarray(cam), jnp.asarray(centers[k]), size=size, interpret=True
            )
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))

    @pytest.mark.parametrize("size", [9, 19, 37])
    def test_matches_mxu_reference(self, size):
        c, h, w, n = 3, 64, 100, 32  # a geometry it does not support
        stacks, cam, centers = _pair_inputs(32, c, h, w, c * n, 25)
        got, _ = patches_cuda.extract_patches_pair(_t(stacks[0]), _t(stacks[1]), _t(cam), _t(centers), size)
        for k in range(2):
            want = jax.vmap(lambda im, ct: extract_patches_mxu(im, ct, size))(
                jnp.asarray(stacks[k]), jnp.asarray(centers[k].reshape(c, n, 2))
            )
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want).reshape(c * n, size, size))

    @pytest.mark.parametrize("wr,spill", [(9, 30), (4, 3)])
    def test_windows_and_clipped_centres_match_reference_klt(self, wr, spill):
        """The port's ``klt._extract_windows`` (one pair gather, which clips
        the centres) against the reference's (tensor clamps, then its
        gather), frame by frame: windows and clipped centres, exact."""
        c, h, w, n = 2, 40, 56, 24
        stacks, cam, centers = _pair_inputs(33, c, h, w, c * n, spill)
        win, ctr = tklt._extract_windows(_t(stacks[0]), _t(stacks[1]), _t(cam), _t(centers), wr)
        assert ctr.dtype == torch.int32 and ctr.shape == (2, c * n, 2)
        for k in range(2):
            win_j, ctr_j = jklt._extract_windows(
                jnp.asarray(stacks[k]), jnp.asarray(cam), jnp.asarray(centers[k]), wr
            )
            np.testing.assert_array_equal(ctr[k].numpy(), np.asarray(ctr_j))
            np.testing.assert_array_equal(win[k].numpy(), np.asarray(win_j))

    def test_strided_eye_views_and_plain_count(self):
        """One eye of a (C, 2, H, W) tensor is taken as it lies; a CPU call
        counts one plain call and no kernel launch."""
        stacks, cam, centers = _pair_inputs(34, 2, 30, 44, 10, 8)
        both = _t(stacks).transpose(0, 1).contiguous()  # (C, 2, H, W)
        patches_cuda.reset_counts()
        got, clipped = patches_cuda.extract_patches_pair(both[:, 0], both[:, 1], _t(cam), _t(centers), 7)
        assert patches_cuda.counts == {"kernel": 0, "plain": 1}
        for k in range(2):
            want = patches_cuda.extract_patches_flat(_t(stacks[k]), _t(cam), _t(centers[k]), 7)
            np.testing.assert_array_equal(got[k].numpy(), want.numpy())
        assert int(clipped[..., 0].min()) >= 3 and int(clipped[..., 0].max()) <= 44 - 4
        assert int(clipped[..., 1].min()) >= 3 and int(clipped[..., 1].max()) <= 30 - 4


# ------------------------------------------------------------- FAST-9


def _xla_fast(imgs, thr):
    raw = np.stack([np.asarray(jfast.fast_score_map(jnp.asarray(im), thr)) for im in imgs])
    nms = np.stack([np.asarray(jfast.nms3x3(jnp.asarray(r))) for r in raw])
    return raw, nms


class TestFastPlain:
    @pytest.mark.parametrize("source", ["uniform", "rendered"])
    def test_matches_xla_whole_image(self, source):
        imgs = (
            np.random.default_rng(23).uniform(size=(2, 48, 70)).astype(np.float32)
            if source == "uniform"
            else _rendered()
        )
        raw_x, nms_x = _xla_fast(imgs, 0.05)
        raw_t, nms_t = fast_cuda.fast_scores_batched(_t(imgs), 0.05)
        # Sequential vs XLA-tree sums of <= 16 excess terms: f32 ulps.
        np.testing.assert_allclose(raw_t.numpy(), raw_x, atol=1e-6, rtol=0)
        np.testing.assert_allclose(nms_t.numpy(), nms_x, atol=1e-6, rtol=0)

    @pytest.mark.parametrize("shape", [(2, 48, 128), (1, 320, 128)])
    def test_matches_pallas_interior(self, shape):
        imgs = np.random.default_rng(24).uniform(size=shape).astype(np.float32)
        raw_p, nms_p = fast_pallas.fast_scores_batched(jnp.asarray(imgs), 0.05, interpret=True)
        raw_t, nms_t = fast_cuda.fast_scores_batched(_t(imgs), 0.05)
        b = fast_pallas.BORDER  # the Pallas kernel zeroes this frame by contract
        inner = (slice(None), slice(b, -b), slice(b, -b))
        np.testing.assert_allclose(raw_t.numpy()[inner], np.asarray(raw_p)[inner], atol=1e-6, rtol=0)
        np.testing.assert_allclose(nms_t.numpy()[inner], np.asarray(nms_p)[inner], atol=1e-6, rtol=0)

    def test_cpu_tensor_takes_plain_version(self):
        fast_cuda.reset_counts()
        fast_cuda.fast_scores_batched(torch.rand(1, 20, 20), 0.05)
        assert fast_cuda.counts == {"kernel": 0, "plain": 1}


class TestDetection:
    @pytest.mark.parametrize("max_keypoints,border", [(64, 8), (200, 20), (400, 4)])
    def test_same_keypoint_sets(self, max_keypoints, border):
        imgs = _rendered(c=2, w=160, h=120)
        kw = dict(threshold=0.05, max_keypoints=max_keypoints, cell_size=32, per_cell=8, border_margin=border)
        want = jfast.detect_keypoints_batched(jnp.asarray(imgs), **kw)
        got = tfast.detect_keypoints_batched(_t(imgs), **kw)
        for c in range(imgs.shape[0]):
            vj = np.asarray(want.valid[c])
            vt = got.valid[c].numpy()
            assert vt.sum() == vj.sum() > 0
            # As sets of (x, y, score): order by integer position.
            xy_j = np.asarray(want.xy[c])[vj]
            xy_t = got.xy[c].numpy()[vt]
            oj = np.lexsort(np.round(xy_j).T)
            ot = np.lexsort(np.round(xy_t).T)
            np.testing.assert_allclose(xy_t[ot], xy_j[oj], atol=1e-5, rtol=0)
            np.testing.assert_allclose(
                got.score[c].numpy()[vt][ot], np.asarray(want.score[c])[vj][oj], atol=1e-6, rtol=0
            )

    @pytest.mark.parametrize("max_keypoints,border", [(64, 8), (200, 20)])
    def test_stereo_stack_matches_two_reference_calls(self, max_keypoints, border):
        """One detection on the (2C, H, W) view of a (C, 2, H, W) frame
        tensor, as the keyframe front end runs it, against the reference's
        two detections on the left and the right images: the same valid
        sets, xy within 1e-5 px and scores within 1e-6 (sequential vs
        XLA-tree sums of <= 16 excess terms)."""
        eyes = [_rendered(c=2, w=160, h=120, eye=e) for e in (0, 1)]
        frame = np.stack(eyes, 1)  # (C, 2, H, W)
        c = frame.shape[0]
        kw = dict(threshold=0.05, max_keypoints=max_keypoints, cell_size=32, per_cell=8, border_margin=border)
        got = tfast.detect_keypoints_batched(_t(frame).reshape(2 * c, 120, 160), **kw)
        for eye in (0, 1):
            want = jfast.detect_keypoints_batched(jnp.asarray(eyes[eye]), **kw)
            for cam in range(c):
                k = 2 * cam + eye
                vj = np.asarray(want.valid[cam])
                vt = got.valid[k].numpy()
                assert vt.sum() == vj.sum() > 0
                xy_j = np.asarray(want.xy[cam])[vj]
                xy_t = got.xy[k].numpy()[vt]
                oj = np.lexsort(np.round(xy_j).T)
                ot = np.lexsort(np.round(xy_t).T)
                np.testing.assert_allclose(xy_t[ot], xy_j[oj], atol=1e-5, rtol=0)
                np.testing.assert_allclose(
                    got.score[k].numpy()[vt][ot], np.asarray(want.score[cam])[vj][oj], atol=1e-6, rtol=0
                )
