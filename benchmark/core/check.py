"""The correctness check: what the window produced against the plain reference.

Run once the window has closed, the peak memory read and the engine freed.
The numbers it compares, each against its limit in
``benchmark/limits/<cell>.json``:

* ``pose_err_mm``, ``pose_err_mrad``: over every pose the window
  delivered, the largest translation and rotation error against the rig's
  ground truth (``rig.gt_poses``), both taken in the odometry frame, whose
  origin is the body at the stream's first tick; ``pose_err_med_*``: their
  medians;
* ``rpe_mm``, ``rpe_mrad``: the same errors of the motion between each
  two poses delivered one after the other (free of the drift that the
  absolute error gathers over a window); ``rpe_med_*``: their medians;
* ``steps_off_pct``: the share of those steps whose rotation is off by more
  than ``STEP_OFF_MRAD``: a fault that hits a minority of ticks (keyframes,
  say) moves no median, but it moves this;
* ``depth_bad_px_pct``: over a sample of the window's RGB-D frames drawn
  from the seed, the share of pixels whose u16 depth differs from the
  reference's (:mod:`benchmark.reference.stereo`) by more than 1 mm;
* ``tsdf_bad_vox_pct``: of the voxels observed in either grid, the share
  where the program's map and the reference's (:mod:`benchmark.reference.
  tsdf`, fed the reference's depth of the same frames at the poses the
  program's map was given) differ: TSDF by more than 1 mm, weight at all,
  or colour by more than 0.5.

The control (``dtype`` below float32) puts the reference, computed in that
precision, in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import orbit as orbit_ref
from benchmark.reference.tsdf import TsdfReference

DEPTH_TOL_MM = 1
TSDF_TOL_M = 1e-3
COLOR_TOL = 0.5
STEP_OFF_MRAD = 2.0
MISSING = 1e30  # the reading of a number with nothing to compare: fails any limit


def reference_outputs(run, system, dtype=torch.float32, batch: int = 8) -> dict:
    """The reference's answers to everything the window is judged on,
    computed in ``dtype`` (float64 for the poses when ``dtype`` is float32)."""
    cfg, rig = run.config, system.rig
    ks = [k for k, _, _ in run.poses]
    out = {"poses": rig.gt_poses(ks, torch.float64 if dtype == torch.float32 else dtype)}
    wanted = sorted({p for p, _ in run.kept_depth} | {i["p"] for i in run.integrations})
    if not wanted:
        return out
    ref = rig.rgbd_reference(cfg["rgbd"], run.device, dtype)
    depth = {}
    for lo in range(0, len(wanted), batch):
        ps = wanted[lo : lo + batch]
        frames = rig.frames[ps, cfg["rgbd"]["source"]]
        for p, d in zip(ps, ref.depth_mm(frames[:, 0], frames[:, 1])):
            depth[p] = d
    out["depth"] = depth
    if run.integrations:
        grid = TsdfReference(cfg["mapping"], device=run.device, dtype=dtype)
        for i in run.integrations:
            grid.integrate(depth[i["p"]], rig.colors[i["p"]], i["world_t_product"], i["k_color"])
        out["grid"] = (grid.tsdf, grid.weight, grid.rgb)
    return out


def program_outputs(run, system) -> dict:
    out = {"poses": torch.from_numpy(np.stack([m for _, _, m in run.poses]) if run.poses else np.zeros((0, 4, 4)))}
    if run.kept_depth:
        out["depth"] = run.kept_depth
    if system.mapper is not None and system.mapper.grid is not None:
        g = system.mapper.grid
        out["grid"] = (g.tsdf, g.weight, g.color)
    return out


def control_outputs(run, system, dtype) -> dict:
    """The control: the reference computed in ``dtype``, standing where the
    program's outputs stand (the same poses, sampled frames and map frames)."""
    ctrl = reference_outputs(run, system, dtype)
    out = {"poses": ctrl["poses"]}
    if run.kept_depth:
        out["depth"] = [(p, ctrl["depth"][p]) for p, _ in run.kept_depth]
    if "grid" in ctrl:
        out["grid"] = ctrl["grid"]
    return out


def _steps(poses: np.ndarray) -> np.ndarray:
    """inv(P_i) @ P_{i+1} of (N, 4, 4) poses."""
    return np.linalg.inv(poses[:-1]) @ poses[1:]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the check can make, each a float (larger is worse)."""
    est, gt = prog["poses"].to(torch.float64).numpy(), ref["poses"].to(torch.float64).numpy()
    trans, rot = orbit_ref.pose_errors(est, torch.from_numpy(gt))
    rtrans, rrot = orbit_ref.pose_errors(_steps(est), torch.from_numpy(_steps(gt))) if len(est) > 1 else ([], [])
    nums = {}
    for name, errs in (("pose_err_mm", trans), ("pose_err_mrad", rot), ("rpe_mm", rtrans), ("rpe_mrad", rrot)):
        stem, unit = name.rsplit("_", 1)
        nums[name] = float(np.max(errs) * 1e3) if len(errs) else MISSING
        nums[f"{stem}_med_{unit}"] = float(np.median(errs) * 1e3) if len(errs) else MISSING
    nums["steps_off_pct"] = float(100.0 * np.mean(np.asarray(rrot) * 1e3 > STEP_OFF_MRAD)) if len(rrot) else MISSING
    if "depth" in ref:
        depth = prog.get("depth") or []
        items = depth.items() if isinstance(depth, dict) else depth
        bad = total = 0
        for p, d in items:
            diff = (d.to(torch.int32) - ref["depth"][p].to(d.device).to(torch.int32)).abs()
            bad += int((diff > DEPTH_TOL_MM).sum())
            total += diff.numel()
        nums["depth_bad_px_pct"] = 100.0 * bad / total if total else MISSING
    if "grid" in ref:
        if "grid" not in prog:
            nums["tsdf_bad_vox_pct"] = MISSING
        else:
            (pt, pw, pc), (rt, rw, rc) = prog["grid"], ref["grid"]
            rt, rw, rc = (x.to(pt.device).float() for x in (rt, rw, rc))
            pt, pw, pc = pt.float(), pw.float(), pc.float()
            seen = (pw > 0) | (rw > 0)
            bad = seen & (((pt - rt).abs() > TSDF_TOL_M) | (pw != rw) | ((pc - rc).abs() > COLOR_TOL).any(-1))
            n_seen = int(seen.sum())
            nums["tsdf_bad_vox_pct"] = 100.0 * int(bad.sum()) / n_seen if n_seen else MISSING
    return nums


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number the cell's limits
    name is present and within its limit. The numbers the limits leave out
    are read, not compared."""
    checks = {name: {"value": nums.get(name, MISSING), "limit": lim} for name, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
