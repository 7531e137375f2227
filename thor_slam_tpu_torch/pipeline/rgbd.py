"""The RGB-D product stream: dense SGM depth aligned with an RGB image.

Port of :mod:`thor_slam_tpu.pipeline.rgbd`, the nvblox feed: per camera an
aligned (rgb, depth) pair at a resolution independent of the SLAM stream,
depth encoded 16UC1 millimetres. Per frame, on the processor's device:
full-frame rectification, census + cost volume, 4-direction SGM
aggregation and the winner/LR pass (the two CUDA kernels of
:mod:`thor_slam_tpu_torch.ops.sgm_cuda`), the subpixel tail, depth,
alignment to the color camera (or resize) and the u16 encode.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from thor_slam_tpu_torch.camera.types import Intrinsics, SynchronizedFrameSet
from thor_slam_tpu_torch.ops import stereo
from thor_slam_tpu_torch.ops.image import remap_bilinear, resize_bilinear
from thor_slam_tpu_torch.ops.rectify import StereoRectification, rectification_from_extrinsics
from thor_slam_tpu_torch.utils.platform import select_device


@dataclass
class RGBDFrame:
    """One aligned RGB-D product frame.

    Attributes:
        rgb: (H, W) or (H, W, 3) uint8 image at the product resolution.
        depth_mm: (H, W) uint16 depth in millimetres (0 = invalid).
        intrinsics: Intrinsics of the aligned pair at the product resolution.
        timestamp: Source frame timestamp.
        camera_name: Source name.

    ``rgb``/``depth_mm`` are host numpy arrays when produced with
    ``fetch=True`` and device tensors with ``fetch=False`` (the feed a
    consumer on the same device takes where it lies); :meth:`fetched`
    gives the host copy.
    """

    rgb: np.ndarray | torch.Tensor
    depth_mm: np.ndarray | torch.Tensor
    intrinsics: Intrinsics
    timestamp: float
    camera_name: str

    @property
    def device_resident(self) -> bool:
        """Whether the image payloads are still device tensors."""
        return isinstance(self.depth_mm, torch.Tensor)

    def fetched(self) -> "RGBDFrame":
        """Host copy of this frame (one ``.cpu()`` per payload; self if already host)."""
        if not self.device_resident:
            return self
        return RGBDFrame(
            rgb=self.rgb.cpu().numpy(),
            depth_mm=self.depth_mm.cpu().numpy(),
            intrinsics=self.intrinsics,
            timestamp=self.timestamp,
            camera_name=self.camera_name,
        )


def make_depth_to_color_aligner(
    sr: StereoRectification,
    color_matrix: np.ndarray,
    rect_t_color: np.ndarray,
    out_wh: tuple[int, int],
    device: torch.device,
    iters: int = 2,
    z_init: float = 2.0,
    min_depth_m: float = 0.05,
):
    """``depth_rect -> depth_color``: depth along the COLOR camera's rays.

    Inverse warp by a short fixed-point iteration, as the reference: for
    every color pixel, guess its depth, project the point into the
    rectified-left depth map, read the depth there and lift it back into
    the color frame. The 3x3 products are float32 matmuls: keep TF32 off
    (:func:`thor_slam_tpu_torch.utils.platform.pin_precision`).

    Returns:
        ``(H_rect, W_rect) float32 depth -> (H_out, W_out) float32 depth``
        (0 = invalid) in the color frame.
    """
    out_w, out_h = out_wh
    kc = np.asarray(color_matrix, np.float64)
    fx_c, fy_c, cx_c, cy_c = kc[0, 0], kc[1, 1], kc[0, 2], kc[1, 2]
    kr = np.asarray(sr.new_matrix, np.float64)
    fx_r, fy_r, cx_r, cy_r = (float(v) for v in (kr[0, 0], kr[1, 1], kr[0, 2], kr[1, 2]))
    r = torch.from_numpy(np.asarray(rect_t_color[:3, :3], np.float32)).to(device)
    t = torch.from_numpy(np.asarray(rect_t_color[:3, 3], np.float32)).to(device)
    h_r, w_r = sr.height, sr.width

    uu, vv = np.meshgrid(np.arange(out_w, dtype=np.float32), np.arange(out_h, dtype=np.float32))
    ray = np.stack([(uu - cx_c) / fx_c, (vv - cy_c) / fy_c, np.ones_like(uu)], axis=-1).astype(np.float32)
    ray = torch.from_numpy(ray).to(device)  # (H, W, 3) color-frame rays

    def align(depth_rect: torch.Tensor) -> torch.Tensor:
        z = torch.full((out_h, out_w), z_init, dtype=torch.float32, device=device)
        d = u = v = torch.zeros((out_h, out_w), dtype=torch.float32, device=device)
        for _ in range(iters):
            p_c = ray * z[..., None]
            p_r = p_c @ r.T + t
            zr = torch.clamp(p_r[..., 2], min=1e-6)
            u = fx_r * p_r[..., 0] / zr + cx_r
            v = fy_r * p_r[..., 1] / zr + cy_r
            d = remap_bilinear(depth_rect, u, v)
            # Lift the sampled rect-frame depth back into the color frame.
            xr = (u - cx_r) / fx_r * d
            yr = (v - cy_r) / fy_r * d
            z = ((torch.stack([xr, yr, d], -1) - t) @ r)[..., 2]
        in_bounds = (u >= 0) & (u <= w_r - 1) & (v >= 0) & (v <= h_r - 1)
        valid = in_bounds & (d > min_depth_m) & (z > min_depth_m)
        return torch.where(valid, z, 0.0)

    return align


class RGBDProcessor:
    """Produces RGB-D frames for one stereo camera source.

    Grayscale mode: rgb = the rectified left image, depth in the rectified
    left frame. Color mode (``color_intrinsics`` and ``left_t_color``
    given): rgb = the color image, depth reprojected into the color camera
    at the product resolution.
    """

    def __init__(
        self,
        camera_name: str,
        intrinsics: list[Intrinsics],
        extrinsics: list,
        output_resolution: tuple[int, int] | None = None,
        num_disparities: int = 64,
        color_intrinsics: Intrinsics | None = None,
        left_t_color: np.ndarray | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        """Build the rectification maps and the aligner on ``device``.

        Args:
            camera_name: Source name.
            intrinsics: [left, right] raw intrinsics.
            extrinsics: [left, right] source-frame extrinsics.
            output_resolution: (width, height) of the product; defaults to
                the stereo resolution (grayscale) or the color resolution.
            num_disparities: SGM search range.
            color_intrinsics: Color imager intrinsics (enables color mode).
            left_t_color: (4, 4) pose of the color imager in the raw left
                camera frame.
            device: Compute device; ``None`` is the current CUDA device
                (and raises without one), ``"cpu"`` runs the plain versions.
        """
        self.camera_name = camera_name
        self.device = select_device(device)
        sr = rectification_from_extrinsics(
            intrinsics[0], intrinsics[1], extrinsics[0], extrinsics[1], compute_maps=True
        )
        self.rectification = sr
        self._color = color_intrinsics is not None and left_t_color is not None
        self._left_t_color = left_t_color
        default_out = (color_intrinsics.width, color_intrinsics.height) if self._color else (sr.width, sr.height)
        self._out_w, self._out_h = output_resolution or default_out
        self._num_disp = num_disparities
        self.maps = tuple(
            torch.from_numpy(m).to(self.device) for m in (*sr.map_left, *sr.map_right)
        )
        self.align = None
        if self._color:
            # Color K at the output resolution; depth lives in the
            # rectified-left frame, so compose the rectifying rotation in.
            kc = np.asarray(color_intrinsics.matrix, np.float64).copy()
            kc[0, :] *= self._out_w / color_intrinsics.width
            kc[1, :] *= self._out_h / color_intrinsics.height
            rect4 = np.eye(4)
            rect4[:3, :3] = sr.rect_rotation_left
            rect_t_color = rect4 @ np.asarray(left_t_color, np.float64)
            self.align = make_depth_to_color_aligner(sr, kc, rect_t_color, (self._out_w, self._out_h), self.device)
            self._out_intrinsics = Intrinsics(
                width=self._out_w, height=self._out_h, matrix=kc, coeffs=np.zeros(5)
            )
        else:
            k = sr.new_matrix.copy()
            k[0, :] *= self._out_w / sr.width
            k[1, :] *= self._out_h / sr.height
            self._out_intrinsics = Intrinsics(
                width=self._out_w, height=self._out_h, matrix=k, coeffs=np.zeros(5)
            )

    @property
    def output_intrinsics(self) -> Intrinsics:
        return self._out_intrinsics

    @property
    def product_t_in_left(self) -> np.ndarray:
        """(4, 4) pose of the product frame in the raw left-camera frame:
        the color camera (color mode) or the rectified left camera."""
        if self._color:
            return np.asarray(self._left_t_color, np.float64)
        m = np.eye(4)
        m[:3, :3] = np.asarray(self.rectification.rect_rotation_left, np.float64).T
        return m

    @property
    def color_mode(self) -> bool:
        """Whether this processor produces color-aligned RGB-D."""
        return self._color

    def upload(self, image: np.ndarray) -> torch.Tensor:
        """A uint8 frame on the device, normalized there to float32 [0, 1]."""
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device).float() / 255.0

    def _rect_depth(self, left_raw: torch.Tensor, right_raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Rectified left image and its depth (m) from a raw float32 pair."""
        m = self.maps
        left = remap_bilinear(left_raw, m[0], m[1])
        right = remap_bilinear(right_raw, m[2], m[3])
        disp, valid = stereo.sgm_disparity(left, right, num_disparities=self._num_disp)
        return left, stereo.disparity_to_depth(disp, valid, self.rectification.fx, self.rectification.baseline_m)

    def _compute(self, left_raw, right_raw):
        left, depth = self._rect_depth(left_raw, right_raw)
        out_h, out_w = self._out_h, self._out_w
        if (out_h, out_w) != tuple(left.shape):
            depth = resize_bilinear(depth, out_h, out_w)
            left = resize_bilinear(left, out_h, out_w)
        rgb = torch.clamp(torch.round(left * 255.0), 0, 255).to(torch.uint8)
        return rgb, stereo.depth_to_millimeters_u16(depth)

    def _compute_color(self, left_raw, right_raw, color_img: torch.Tensor):
        _, depth = self._rect_depth(left_raw, right_raw)
        depth_mm = stereo.depth_to_millimeters_u16(self.align(depth))
        out_h, out_w = self._out_h, self._out_w
        if tuple(color_img.shape[:2]) != (out_h, out_w):
            chans = resize_bilinear(color_img.permute(2, 0, 1).float(), out_h, out_w)
            color_img = torch.clamp(torch.round(chans.permute(1, 2, 0)), 0, 255).to(torch.uint8)
        return color_img, depth_mm

    def process(
        self,
        frame_set: SynchronizedFrameSet,
        color_frame=None,
        fetch: bool = True,
    ) -> RGBDFrame | None:
        """Produce the RGB-D frame for this camera from a synchronized tick.

        Args:
            frame_set: The rig tick ([left, right] frames for this source).
            color_frame: The color :class:`CameraFrame` to align depth to
                (color mode).
            fetch: Return host numpy payloads (default); ``fetch=False``
                returns the device tensors without copying them back.
        """
        frames = frame_set.get_frames_for_source(self.camera_name)
        if frames is None or len(frames) < 2:
            return None
        left = self.upload(frames[0].image)
        right = self.upload(frames[1].image)
        if self._color and color_frame is not None:
            color = torch.from_numpy(np.ascontiguousarray(color_frame.image)).to(self.device)
            rgb, depth_mm = self._compute_color(left, right, color)
            ts = color_frame.timestamp
        else:
            rgb, depth_mm = self._compute(left, right)
            ts = frames[0].timestamp
        frame = RGBDFrame(
            rgb=rgb, depth_mm=depth_mm, intrinsics=self._out_intrinsics, timestamp=ts, camera_name=self.camera_name
        )
        return frame.fetched() if fetch else frame
