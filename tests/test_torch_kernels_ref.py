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
from thor_slam_tpu.ops.image import extract_patches_mxu
from thor_slam_tpu_torch.ops import fast as tfast
from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rendered(c=2, w=128, h=96):
    """Rendered (C, H, W) float32 views of the synthetic room, in [0, 1]."""
    from thor_slam_tpu.camera.sources.synthetic import SyntheticRigSpec, make_synthetic_rig

    spec = SyntheticRigSpec(num_sources=c, stereo=True, width=w, height=h)
    sources, _, _, _ = make_synthetic_rig(spec)
    return np.stack([s.render_frame(3, 0) for s in sources]).astype(np.float32) / 255.0


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
