"""SGM path aggregation and winner/LR: the CUDA kernels ``csrc/sgm.cu`` and
their plain versions.

Replaces ``thor_slam_tpu/ops/sgm_pallas.py``: ``_scan_kernel`` /
``_scan_add_kernel`` (:func:`sgm_aggregate_dir`, :func:`sgm_aggregate_4dir`)
and ``_winner_kernel`` (:func:`winner_lr`). The RGB-D product runs all four
path directions and one winner pass per frame.

Both versions run the EXACT recurrence in float32. With integral costs
and penalties every value is an integer <= 256, so they equal the TPU
kernel's bfloat16 results bit for bit once both are cast to float32; with
non-integral penalties they are still the exact recurrence (the reference
falls back to its approximate blocked-halo scan there).

Dispatch is by the tensor's device: a CPU tensor gets the plain PyTorch
version; any other tensor gets the kernel or an exception, never the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from thor_slam_tpu_torch.utils import cuda_lib

# Never wins: above any reachable running cost. The reference's XLA tail
# uses the same value for the second-best and right-view sentinels.
BIG = 1e9
MAX_DISPARITIES = 256  # 8 registers per lane in the scan kernel

#: Kernel launches and plain-version calls since the last :func:`reset_counts`.
counts = {"sgm_scan": {"kernel": 0, "plain": 0}, "sgm_winner_lr": {"kernel": 0, "plain": 0}}


def reset_counts() -> None:
    for c in counts.values():
        c["kernel"] = 0
        c["plain"] = 0


# ------------------------------------------------------------------ scan


def sgm_aggregate_dir_plain(
    cost_sdx: torch.Tensor, p1: float, p2: float, reverse: bool, add_to: torch.Tensor | None = None
) -> torch.Tensor:
    """The plain PyTorch path scan the kernel is held against: a Python loop
    over the S steps of vectorised (D, X) ops, in the kernel's order."""
    counts["sgm_scan"]["plain"] += 1
    s, d, x = cost_sdx.shape
    out = torch.empty_like(cost_sdx)
    big = torch.full((1, x), BIG, dtype=cost_sdx.dtype, device=cost_sdx.device)
    # A uniform carry makes the first step exact: L[0] == c[0].
    prev = torch.zeros((d, x), dtype=cost_sdx.dtype, device=cost_sdx.device)
    for i in range(s):
        si = s - 1 - i if reverse else i
        prev_min = torch.amin(prev, 0, keepdim=True)
        up = torch.cat([prev[1:], big], 0)
        down = torch.cat([big, prev[:-1]], 0)
        best = torch.minimum(torch.minimum(prev, torch.minimum(up, down) + p1), prev_min + p2)
        prev = cost_sdx[si] + (best - prev_min)
        out[si] = prev if add_to is None else prev + add_to[si]
    return out


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t`` is a permutation of a contiguous tensor."""
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    return t.permute(order).is_contiguous()


def _job(cost_sdx, out, reverse, add=None, add2=None) -> list[int]:
    """One scan of ``thor_sgm_scan``: pointers, shape and element strides of
    (S, D, X) views that share one layout."""
    s, _, x = cost_sdx.shape
    ss, sd, sx = cost_sdx.stride()
    ptr = lambda v: 0 if v is None else v.data_ptr()  # noqa: E731
    return [cost_sdx.data_ptr(), ptr(add), ptr(add2), out.data_ptr(), s, x, ss, sx, sd, int(reverse)]


def _launch_scan(jobs: list[list[int]], d: int, p1: float, p2: float, device: torch.device) -> None:
    """One launch of the scan kernel running every job of ``jobs`` (at most 2)."""
    lib = cuda_lib.load()
    desc = (ctypes.c_longlong * (10 * len(jobs)))(*[v for job in jobs for v in job])
    # The library launches on the host thread's current device: make it the
    # tensors' one, whose stream the launch takes.
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cuda_lib.check(lib.thor_sgm_scan(len(jobs), desc, d, float(p1), float(p2), stream), "thor_sgm_scan")
    counts["sgm_scan"]["kernel"] += 1


def sgm_aggregate_dir_cuda(
    cost_sdx: torch.Tensor, p1: float, p2: float, reverse: bool, add_to: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch ``thor_sgm_scan`` on the current stream, one job.

    ``cost_sdx`` may be any permuted view of a contiguous float32 volume;
    the output (and ``add_to``) share its strides.
    """
    cuda_lib.load()
    if not cost_sdx.is_cuda:
        raise ValueError(f"SGM scan kernel needs CUDA tensors, got {cost_sdx.device}")
    if cost_sdx.dtype != torch.float32 or cost_sdx.dim() != 3:
        raise ValueError(f"SGM scan takes a (S, D, X) float32 volume, got {cost_sdx.dtype} {tuple(cost_sdx.shape)}")
    d = cost_sdx.shape[1]
    if d > MAX_DISPARITIES:
        raise ValueError(f"SGM scan takes D <= {MAX_DISPARITIES}, got {d}")
    if not _dense(cost_sdx):
        raise ValueError(f"SGM scan needs a dense volume, got strides {cost_sdx.stride()}")
    out = torch.empty_like(cost_sdx)
    if out.stride() != cost_sdx.stride():
        raise ValueError("SGM scan output does not share the cost volume's strides")
    if add_to is not None and (
        add_to.shape != cost_sdx.shape
        or add_to.dtype != torch.float32
        or add_to.stride() != cost_sdx.stride()
        or add_to.device != cost_sdx.device
    ):
        raise ValueError("add_to must be a float32 volume of the cost's shape, strides and device")
    if out.numel():
        _launch_scan([_job(cost_sdx, out, reverse, add_to)], d, p1, p2, cost_sdx.device)
    return out


def sgm_aggregate_dir(
    cost_sdx: torch.Tensor, p1: float, p2: float, reverse: bool, add_to: torch.Tensor | None = None
) -> torch.Tensor:
    """Exact SGM path aggregation along axis 0 of a (S, D, X) float32 volume.

    Args:
        cost_sdx: (S, D, X) matching costs, step-major (any strides on the
            card as long as the volume is dense).
        p1: Small-jump penalty (|dd| = 1).
        p2: Large-jump penalty.
        reverse: Aggregate along decreasing step index.
        add_to: Optional same-layout volume summed into the output (the
            opposite direction's result).

    Returns:
        (S, D, X) float32 path costs L_r (+ ``add_to``), in ``cost_sdx``'s layout.
    """
    if cost_sdx.device.type == "cpu":
        return sgm_aggregate_dir_plain(cost_sdx, p1, p2, reverse, add_to)
    return sgm_aggregate_dir_cuda(cost_sdx, p1, p2, reverse, add_to)


# Step-major views of a (D, H, W) volume: the horizontal paths step along x
# (lines are rows), the vertical ones along y (lines are columns).
def _horizontal(v: torch.Tensor) -> torch.Tensor:
    return v.permute(2, 0, 1)  # (W, D, H)


def _vertical(v: torch.Tensor) -> torch.Tensor:
    return v.permute(1, 0, 2)  # (H, D, W)


def sgm_aggregate_4dir_plain(cost_dhw: torch.Tensor, p1: float, p2: float, num_paths: int = 4) -> torch.Tensor:
    """:func:`sgm_aggregate_4dir` through the plain scan: each pair sums in
    its reverse scan, then the two pairs in float32."""
    cost = cost_dhw.float()
    scan = sgm_aggregate_dir_plain
    h = _horizontal(cost)
    pair_h = scan(h, p1, p2, True, scan(h, p1, p2, False)).permute(1, 2, 0)
    if num_paths < 4:
        return pair_h.contiguous()
    v = _vertical(cost)
    pair_v = scan(v, p1, p2, True, scan(v, p1, p2, False)).permute(1, 0, 2)
    return pair_h + pair_v


def sgm_aggregate_4dir_cuda(cost_dhw: torch.Tensor, p1: float, p2: float, num_paths: int = 4) -> torch.Tensor:
    """:func:`sgm_aggregate_4dir` in three launches of the scan kernel, on
    the (D, H, W) volume as it lies (``num_paths`` 2: two launches).

    1. forward horizontal and forward vertical, into two scratch volumes;
    2. reverse horizontal + its forward result -> ``agg`` (the pair sum);
    3. reverse vertical + its forward result + ``agg`` -> ``agg`` in place:
       (L_rev_v + L_fwd_v) + pair_h, bit-equal to the reference's
       pair_h + pair_v since float32 addition commutes.
    """
    cuda_lib.load()
    if not cost_dhw.is_cuda:
        raise ValueError(f"SGM scan kernel needs CUDA tensors, got {cost_dhw.device}")
    cost = cost_dhw.float()
    if cost.dim() != 3 or not cost.is_contiguous():
        raise ValueError(f"4-direction SGM takes a contiguous (D, H, W) volume, got strides {cost.stride()}")
    d = cost.shape[0]
    if d > MAX_DISPARITIES:
        raise ValueError(f"SGM scan takes D <= {MAX_DISPARITIES}, got {d}")
    agg = torch.empty_like(cost)
    if not cost.numel():
        return agg
    h, v = _horizontal, _vertical
    fwd_h = torch.empty_like(cost)
    if num_paths < 4:
        _launch_scan([_job(h(cost), h(fwd_h), False)], d, p1, p2, cost.device)
        _launch_scan([_job(h(cost), h(agg), True, h(fwd_h))], d, p1, p2, cost.device)
        return agg
    fwd_v = torch.empty_like(cost)
    _launch_scan([_job(h(cost), h(fwd_h), False), _job(v(cost), v(fwd_v), False)], d, p1, p2, cost.device)
    _launch_scan([_job(h(cost), h(agg), True, h(fwd_h))], d, p1, p2, cost.device)
    _launch_scan([_job(v(cost), v(agg), True, v(fwd_v), v(agg))], d, p1, p2, cost.device)
    return agg


def sgm_aggregate_4dir(cost_dhw: torch.Tensor, p1: float, p2: float, num_paths: int = 4) -> torch.Tensor:
    """All-direction aggregation of a (D, H, W) volume -> (D, H, W) float32.

    Each direction pair sums inside its reverse scan; the horizontal and
    vertical pair volumes are summed in float32 (``num_paths`` 2 keeps only
    the horizontal pair).
    """
    if cost_dhw.device.type == "cpu":
        return sgm_aggregate_4dir_plain(cost_dhw, p1, p2, num_paths)
    return sgm_aggregate_4dir_cuda(cost_dhw, p1, p2, num_paths)


# ------------------------------------------------------------ winner / LR


def winner_lr_plain(agg: torch.Tensor, num_disparities: int) -> tuple[torch.Tensor, ...]:
    """The plain PyTorch winner/LR pass the kernel is held against (the
    reference's XLA tail, ``stereo.sgm_disparity``, by gathers)."""
    counts["sgm_winner_lr"]["plain"] += 1
    d, h, w = agg.shape
    dev = agg.device
    d_best = torch.argmin(agg, 0)  # first index on ties

    def at(dsel):
        return torch.gather(agg, 0, torch.clamp(dsel, 0, d - 1)[None])[0]

    c0, cm, cp = at(d_best), at(d_best - 1), at(d_best + 1)
    d_idx = torch.arange(d, device=dev)[:, None, None]
    second = torch.amin(torch.where(torch.abs(d_idx - d_best[None]) <= 1, BIG, agg), 0)

    # Right view: agg_r[dd, y, xr] = agg[dd, y, xr + dd]; columns past the
    # image never win.
    xs = torch.arange(w, device=dev)
    col = xs[None, :] + torch.arange(d, device=dev)[:, None]  # (D, W)
    shifted = torch.gather(agg, 2, torch.clamp(col, max=w - 1)[:, None, :].expand(d, h, w))
    d_best_r = torch.argmin(torch.where((col < w)[:, None, :], shifted, BIG), 0)
    xr = xs[None, :] - d_best
    d_r_at = torch.where(xr >= 0, torch.gather(d_best_r, 1, torch.clamp(xr, min=0)), 0)
    return d_best.int(), c0, cm, cp, second, d_r_at.int()


def winner_lr_cuda(agg: torch.Tensor, num_disparities: int) -> tuple[torch.Tensor, ...]:
    """Launch ``thor_sgm_winner_lr`` on the current stream."""
    lib = cuda_lib.load()
    if not agg.is_cuda:
        raise ValueError(f"winner/LR kernel needs CUDA tensors, got {agg.device}")
    if agg.dtype != torch.float32 or agg.dim() != 3 or not agg.is_contiguous():
        raise ValueError(f"winner/LR takes a contiguous (D, H, W) float32 volume, got {agg.dtype} {tuple(agg.shape)}")
    d, h, w = agg.shape
    if d != num_disparities:
        raise ValueError(f"volume has {d} disparities, expected {num_disparities}")
    ints = [torch.empty((h, w), dtype=torch.int32, device=agg.device) for _ in range(2)]
    floats = [torch.empty((h, w), dtype=torch.float32, device=agg.device) for _ in range(4)]
    d_best, d_r_at = ints
    c0, cm, cp, second = floats
    with torch.cuda.device(agg.device):  # as _launch_scan
        status = lib.thor_sgm_winner_lr(
            agg.data_ptr(), d, h, w, d_best.data_ptr(), c0.data_ptr(), cm.data_ptr(), cp.data_ptr(),
            second.data_ptr(), d_r_at.data_ptr(), torch.cuda.current_stream(agg.device).cuda_stream,
        )
    cuda_lib.check(status, "thor_sgm_winner_lr")
    counts["sgm_winner_lr"]["kernel"] += 1
    return d_best, c0, cm, cp, second, d_r_at


def winner_lr(agg: torch.Tensor, num_disparities: int) -> tuple[torch.Tensor, ...]:
    """Disparity winners and left-right check data from a (D, H, W) volume.

    Returns (d_best int32, c0, c_minus, c_plus, second float32, d_r_at
    int32), all (H, W): the argmin disparity (first on ties), the costs at
    clip(d-1), d, clip(d+1), the best cost outside d +- 1 (``BIG`` where
    none), and the right view's winner at each left match x - d (0 where
    x - d < 0).
    """
    if agg.device.type == "cpu":
        return winner_lr_plain(agg, num_disparities)
    return winner_lr_cuda(agg, num_disparities)
