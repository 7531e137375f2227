"""Plain reference of the RGB-D product: SGM depth aligned to the color camera.

The semantics of the program's ``pipeline/rgbd.RGBDProcessor.process`` in
color mode, frozen here as plain PyTorch so that a later change to the
program is held to what the product computed when the benchmark was set
up: Bouguet rectification maps from the calibration, bilinear remap, a 5x5
census, the Hamming cost volume (cost 32 where x < d), 4-path semi-global
aggregation (the exact recurrence, P1 = 6, P2 = 96), winner and left-right
data, the subpixel / uniqueness / left-right tail, depth = f b / d, the
two-step fixed-point warp of depth onto the color camera's rays, and the
16UC1 millimetre encoding.

It works a batch of frames at once and imports nothing of the program. It
computes in ``dtype`` wherever the program computes in float32: float32
for the reference, a lower precision for the control.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e9  # never wins: above any reachable running cost
CENSUS_MAX_COST = 32.0


# ------------------------------------------------------------ rectification


def _rodrigues(rotvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rotvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rotvec / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * kx + (1.0 - np.cos(theta)) * (kx @ kx)


def _log_so3(r: np.ndarray) -> np.ndarray:
    cos = np.clip(0.5 * (np.trace(r) - 1.0), -1.0, 1.0)
    theta = float(np.arccos(cos))
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    if theta < 1e-12:
        return 0.5 * w
    return theta / (2.0 * np.sin(theta)) * w


def rectify_geometry(k_left: np.ndarray, k_right: np.ndarray, left_t_right: np.ndarray, width: int, height: int):
    """Bouguet rectification of a pinhole pair without distortion.

    Returns (rect_rotation_left, rect_rotation_right, new K, baseline m):
    the relative rotation split evenly between the two cameras, then both
    turned so that the new x axis runs along the baseline (left to right),
    with a shared focal length (the mean of the four) centred on the image.
    """
    r_lr = np.asarray(left_t_right[:3, :3], np.float64)
    t_lr = np.asarray(left_t_right[:3, 3], np.float64)
    half_l = _rodrigues(-0.5 * _log_so3(r_lr))
    half_r = half_l @ r_lr
    t_new = half_l @ t_lr
    e1 = t_new / np.linalg.norm(t_new)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n2 < 1e-9 else e2 / n2
    r_align = np.stack([e1, e2, np.cross(e1, e2)])
    f = 0.25 * (k_left[0, 0] + k_left[1, 1] + k_right[0, 0] + k_right[1, 1])
    k_new = np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]])
    return r_align @ half_l, r_align @ half_r, k_new, float(np.linalg.norm(t_new))


def rectify_map(k: np.ndarray, rect_rotation: np.ndarray, k_new: np.ndarray, width: int, height: int):
    """(map_x, map_y) float32 (H, W): rectified pixel -> raw pixel."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    rays = np.stack([u, v, np.ones_like(u)], axis=-1) @ np.linalg.inv(k_new).T @ rect_rotation
    z = rays[..., 2]
    safe_z = np.where(np.abs(z) < 1e-9, 1e-9, z)
    map_x = k[0, 0] * (rays[..., 0] / safe_z) + k[0, 2]
    map_y = k[1, 1] * (rays[..., 1] / safe_z) + k[1, 2]
    behind = z <= 1e-9
    return np.where(behind, -1e6, map_x).astype(np.float32), np.where(behind, -1e6, map_y).astype(np.float32)


def remap_bilinear(images: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) images at (Ho, Wo) coordinates; 0 outside
    [0, W-1] x [0, H-1] (OpenCV's INTER_LINEAR with a constant border)."""
    h, w = images.shape[-2:]
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i, y0i = x0.long(), y0.long()
    valid = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    x0c, x1c = torch.clamp(x0i, 0, w - 1), torch.clamp(x0i + 1, 0, w - 1)
    y0c, y1c = torch.clamp(y0i, 0, h - 1), torch.clamp(y0i + 1, 0, h - 1)
    flat = images.reshape(*images.shape[:-2], h * w)

    def take(yy, xx):
        return flat[..., (yy * w + xx).reshape(-1)].reshape(*images.shape[:-2], *map_x.shape)

    top = take(y0c, x0c) * (1.0 - fx) + take(y0c, x1c) * fx
    bot = take(y1c, x0c) * (1.0 - fx) + take(y1c, x1c) * fx
    return torch.where(valid, top * (1.0 - fy) + bot * fy, 0.0)


# ------------------------------------------------------------ SGM


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    v = v & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def census(images: torch.Tensor, window: int = 5) -> torch.Tensor:
    """(..., H, W) -> int64 codes: bit b = (b-th neighbour < centre), the
    neighbours in row-major order without the centre, edges replicated."""
    r = window // 2
    h, w = images.shape[-2:]
    rows = torch.clamp(torch.arange(-r, h + r, device=images.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-r, w + r, device=images.device), 0, w - 1)
    padded = images[..., rows, :][..., cols]
    code = torch.zeros(images.shape, dtype=torch.int64, device=images.device)
    bit = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            code = code | ((padded[..., r + dy : r + dy + h, r + dx : r + dx + w] < images).long() << bit)
            bit += 1
    return code


def cost_volume(codes_l: torch.Tensor, codes_r: torch.Tensor, num_disp: int, dtype) -> torch.Tensor:
    """(B, H, W) codes -> (B, D, H, W): cost[d, y, x] = ham(L[y, x], R[y, x - d])."""
    w = codes_l.shape[-1]
    dev = codes_l.device
    src = torch.arange(w, device=dev)[None, :] - torch.arange(num_disp, device=dev)[:, None]  # (D, W)
    shifted = codes_r[:, :, torch.clamp(src, min=0)]  # (B, H, D, W)
    cost = _popcount32(codes_l[:, :, None, :] ^ shifted).to(dtype)
    cost = torch.where(src[None, None] >= 0, cost, torch.tensor(CENSUS_MAX_COST, dtype=dtype, device=dev))
    return cost.permute(0, 2, 1, 3).contiguous()


def _scan(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """The path recurrence along dim 2 of (N, D, S, X):
    L[s] = c[s] + min(L[s-1][d], L[s-1][d+-1] + P1, min L[s-1] + P2) - min L[s-1]."""
    n, d, s, x = cost.shape
    big = torch.full((n, 1, x), BIG, dtype=cost.dtype, device=cost.device)
    prev = torch.zeros((n, d, x), dtype=cost.dtype, device=cost.device)
    out = torch.empty_like(cost)
    for i in range(s):
        prev_min = torch.amin(prev, 1, keepdim=True)
        up = torch.cat([prev[:, 1:], big], 1)
        down = torch.cat([big, prev[:, :-1]], 1)
        best = torch.minimum(torch.minimum(prev, torch.minimum(up, down) + p1), prev_min + p2)
        prev = cost[:, :, i] + (best - prev_min)
        out[:, :, i] = prev
    return out


def _pair(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Forward + reverse paths along dim 2, scanned in one loop."""
    b = cost.shape[0]
    both = _scan(torch.cat([cost, cost.flip(2)]), p1, p2)
    return both[b:].flip(2) + both[:b]


def aggregate(cost: torch.Tensor, p1: float = 6.0, p2: float = 96.0) -> torch.Tensor:
    """(B, D, H, W) -> the sum of the four path costs (left, right, down, up)."""
    pair_h = _pair(cost.transpose(2, 3), p1, p2).transpose(2, 3)
    return pair_h + _pair(cost, p1, p2)


def winners(agg: torch.Tensor):
    """(B, D, H, W) -> d_best, c0, c-, c+, second best outside d +- 1, and the
    right view's winner at x - d_best (first index on ties everywhere)."""
    b, d, h, w = agg.shape
    dev = agg.device
    d_best = torch.argmin(agg, 1)

    def at(dsel):
        return torch.gather(agg, 1, torch.clamp(dsel, 0, d - 1)[:, None])[:, 0]

    c0, cm, cp = at(d_best), at(d_best - 1), at(d_best + 1)
    d_idx = torch.arange(d, device=dev)[None, :, None, None]
    second = torch.amin(torch.where(torch.abs(d_idx - d_best[:, None]) <= 1, BIG, agg), 1)
    xs = torch.arange(w, device=dev)
    col = xs[None, :] + torch.arange(d, device=dev)[:, None]  # (D, W)
    shifted = torch.gather(agg, 3, torch.clamp(col, max=w - 1)[None, :, None, :].expand(b, d, h, w))
    d_best_r = torch.argmin(torch.where((col < w)[None, :, None, :], shifted, BIG), 1)
    xr = xs[None, None, :] - d_best
    d_r_at = torch.where(xr >= 0, torch.gather(d_best_r, 2, torch.clamp(xr, min=0)), 0)
    return d_best, c0, cm, cp, second, d_r_at


def disparity(d_best, c0, cm, cp, second, d_r_at, num_disp: int, lr_threshold=1.25, uniqueness=0.95):
    """Subpixel parabola, uniqueness, left-right and range checks -> (disp, valid)."""
    denom = cm - 2.0 * c0 + cp
    offset = torch.where(torch.abs(denom) > 1e-6, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-6), 0.0)
    offset = torch.clamp(offset, -0.5, 0.5)
    interior = (d_best > 0) & (d_best < num_disp - 1)
    disp = d_best.to(c0.dtype) + torch.where(interior, offset, 0.0)
    xs = torch.arange(d_best.shape[-1], device=d_best.device)
    valid = (c0 <= uniqueness * second) & (torch.abs(d_best - d_r_at) <= lr_threshold) & (xs >= d_best) & (d_best > 0)
    return torch.where(valid, disp, 0.0), valid


# ------------------------------------------------------------ the product


class RgbdReference:
    """Color-aligned u16 depth of raw stereo pairs, ``depth_mm(left, right)``.

    Args:
        k_left, k_right: Raw 3x3 camera matrices of the pair (no distortion).
        left_t_right: (4, 4) pose of the right imager in the left's frame.
        size: (width, height) of the stereo images.
        k_color: 3x3 camera matrix of the color imager at ``color_size``.
        color_size: (width, height) of the color imager = of the product.
        left_t_color: (4, 4) pose of the color imager in the left's frame.
        num_disp: SGM search range.
        device, dtype: Where and in what precision it computes.
    """

    def __init__(self, k_left, k_right, left_t_right, size, k_color, color_size, left_t_color,
                 num_disp=64, device="cpu", dtype=torch.float32):
        w, h = size
        rect_l, rect_r, k_new, baseline = rectify_geometry(k_left, k_right, left_t_right, w, h)
        self.device, self.dtype, self.num_disp = torch.device(device), dtype, num_disp
        self.fb = float(k_new[0, 0]) * baseline
        self.maps = [
            torch.from_numpy(m).to(self.device, dtype)
            for m in (*rectify_map(k_left, rect_l, k_new, w, h), *rectify_map(k_right, rect_r, k_new, w, h))
        ]
        rect4 = np.eye(4)
        rect4[:3, :3] = rect_l
        rect_t_color = rect4 @ np.asarray(left_t_color, np.float64)
        self.k_rect, self.rect_size = k_new, (w, h)
        self.r = torch.from_numpy(np.asarray(rect_t_color[:3, :3], np.float32)).to(self.device, dtype)
        self.t = torch.from_numpy(np.asarray(rect_t_color[:3, 3], np.float32)).to(self.device, dtype)
        cw, ch = color_size
        kc = np.asarray(k_color, np.float64)
        uu, vv = np.meshgrid(np.arange(cw, dtype=np.float32), np.arange(ch, dtype=np.float32))
        ray = np.stack([(uu - kc[0, 2]) / kc[0, 0], (vv - kc[1, 2]) / kc[1, 1], np.ones_like(uu)], -1)
        self.ray = torch.from_numpy(ray.astype(np.float32)).to(self.device, dtype)

    def _align(self, depth_rect: torch.Tensor, iters=2, z_init=2.0, min_depth=0.05) -> torch.Tensor:
        """(H, W) rectified-left depth (m) -> depth along the color camera's rays."""
        fx, fy, cx, cy = (float(self.k_rect[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
        w_r, h_r = self.rect_size
        z = torch.full(self.ray.shape[:2], z_init, dtype=self.dtype, device=self.device)
        d = u = v = torch.zeros_like(z)
        for _ in range(iters):
            p_r = (self.ray * z[..., None]) @ self.r.T + self.t
            zr = torch.clamp(p_r[..., 2], min=1e-6)
            u = fx * p_r[..., 0] / zr + cx
            v = fy * p_r[..., 1] / zr + cy
            d = remap_bilinear(depth_rect, u, v)
            xr = (u - cx) / fx * d
            yr = (v - cy) / fy * d
            z = ((torch.stack([xr, yr, d], -1) - self.t) @ self.r)[..., 2]
        valid = (u >= 0) & (u <= w_r - 1) & (v >= 0) & (v <= h_r - 1) & (d > min_depth) & (z > min_depth)
        return torch.where(valid, z, 0.0)

    def depth_mm(self, left_u8, right_u8) -> torch.Tensor:
        """(B, H, W) uint8 raw left and right images -> (B, Hc, Wc) uint16 mm."""
        imgs = [torch.as_tensor(np.ascontiguousarray(x)).to(self.device).to(self.dtype) / 255.0 for x in (left_u8, right_u8)]
        left = remap_bilinear(imgs[0], self.maps[0], self.maps[1])
        right = remap_bilinear(imgs[1], self.maps[2], self.maps[3])
        codes = census(torch.stack([left, right], 1))
        agg = aggregate(cost_volume(codes[:, 0], codes[:, 1], self.num_disp, self.dtype))
        disp, valid = disparity(*winners(agg), self.num_disp)
        del agg
        z = torch.full_like(disp, self.fb) / torch.clamp(disp, min=1e-6)
        depth = torch.stack([self._align(x) for x in torch.where(valid, z, 0.0)])
        return torch.clamp(torch.round(depth.float() * 1000.0), 0.0, 65535.0).to(torch.uint16)
