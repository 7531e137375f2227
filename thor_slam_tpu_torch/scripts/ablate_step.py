"""Ablation timing of ``track_step``: stub stages out, measure the delta.

Port of the JAX package's ``scripts/ablate_step.py``.

Usage: python -m thor_slam_tpu_torch.scripts.ablate_step [WIDTHxHEIGHT] [--reps 30] [--device cpu]

Replaces one stage at a time by a stub of the same shapes, dtypes and
device (patching the module attribute the port's tracker calls) and times
the whole step: FULL minus a variant is that stage's cost in its context.
The reference's sequence: a palindrome over a 12-frame sequence of
the 4-camera flagship rig, rendered on the device
(``render_sequence(device=)``), with the state threaded through the steps;
4 warm-up steps, then 30 timed, each ended by a readback of ``world_t_body``.
The host-bound step drifts by tens of ms within a run and between runs,
so each variant is paired with a FULL run of its own: the two are stepped
in turn (step i of one, then of the other, the first of the two
alternating), and the row gives the median of the paired differences,
FULL's step minus the variant's, each step ended by the readback: over
all pairs, over the pairs in which neither step was a keyframe, and over
those in which both were (the keyframe stages run on keyframe ticks only,
which the median of all pairs does not see).
The keyframe branch is a host ``if`` in the port, so each row also prints
how many keyframe ticks fell inside the timed window: a stub that changes
that count changes what its delta means. Runs on the card unless
``--device`` says otherwise. Not part of the test suite.
"""

from __future__ import annotations

import argparse
import statistics
import time
from contextlib import contextmanager

import torch

from thor_slam_tpu_torch.engine import pnp
from thor_slam_tpu_torch.ops import brief, fast, klt, match
from thor_slam_tpu_torch.ops import stereo as stereo_ops


def _palindrome(i: int, n: int) -> int:
    j = i % (2 * n - 2)
    return j if j < n else 2 * n - 2 - j


def fake_klt(prev_pyr, cur_pyr, pts_prev, pts_init, valid, **kw):
    """Every point stays at its prediction."""
    return klt.TrackResult(xy=pts_init, residual=torch.zeros(pts_prev.shape[:2], device=pts_prev.device), valid=valid)


def fake_pnp(points_w, obs, valid, cam_rot, cam_trans, init_body_t_world, **kw):
    """The initial pose, every valid correspondence an inlier."""
    dev = points_w.device
    return pnp.PnPResult(
        body_t_world=init_body_t_world, inliers=valid, num_inliers=valid.sum(),
        rms_error=torch.zeros((), device=dev), covariance=torch.eye(6, device=dev),
    )


def fake_refine(left, right, xy_left, disparity, valid, **kw):
    """The coarse disparities unrefined."""
    return disparity


def fake_detect(images, threshold=0.0, max_keypoints=512, **kw):
    """A fixed grid of keypoints on each of the (2C, H, W) images."""
    c, h, w = images.shape
    n, dev = max_keypoints, images.device
    xs = (torch.arange(n, device=dev) * 37 % (w - 60) + 30).float()
    ys = (torch.arange(n, device=dev) * 23 % (h - 60) + 30).float()
    xy = torch.stack([xs, ys], -1).expand(c, n, 2).contiguous()
    return fast.Keypoints(xy=xy, score=torch.ones((c, n), device=dev), valid=torch.ones((c, n), dtype=torch.bool,
                                                                                          device=dev))


def fake_match(desc_a, valid_a, desc_b, valid_b, **kw):
    """Slot i of A matched to slot i of B."""
    n = desc_a.shape[-2]
    idx = torch.arange(n, device=desc_a.device).expand(valid_a.shape).contiguous()
    return match.Matches(idx=idx, distance=torch.zeros(valid_a.shape, device=desc_a.device), valid=valid_a & valid_b)


def fake_describe_pair(images_a, images_b, xy, valid, oriented=False):
    """All-zero descriptors of both eyes, (2, C, N, 8) int32."""
    return brief.Descriptors(bits=torch.zeros((*xy.shape[:3], brief.NUM_WORDS), dtype=torch.int32, device=xy.device),
                             valid=valid)


#: (row label, module, attribute the tracker calls, stub); FULL first.
VARIANTS = (
    ("FULL", None, None, None),
    ("no KLT", klt, "track_points_rig", fake_klt),
    ("no RANSAC PnP", pnp, "ransac_pnp_graphed", fake_pnp),
    ("no disparity refine", stereo_ops, "refine_disparity_photometric", fake_refine),
    ("no FAST detect", fast, "detect_keypoints_batched", fake_detect),
    ("no matching", match, "match_descriptors", fake_match),
    ("no BRIEF", brief, "compute_descriptors_pair", fake_describe_pair),
)


@contextmanager
def patched(module, attr, stub):
    """``module.attr = stub`` inside the block; the original after it, also
    when the block raises."""
    if module is None:
        yield
        return
    orig = getattr(module, attr)
    setattr(module, attr, stub)
    try:
        yield
    finally:
        setattr(module, attr, orig)


class _Run:
    """One side of a pairing: its own tracker state and generator, the ms
    and keyframe flag of each step, its kernel launches."""

    def __init__(self, params, device, stub=(None, None, None)):
        from thor_slam_tpu_torch.engine import tracker as trk
        from thor_slam_tpu_torch.utils.profiling import kernel_counts

        self.state = trk.init_state(params, device)
        self.gen = torch.Generator(device=device).manual_seed(0)
        self.stub, self.ms, self.keyframes = stub, [], []
        self.counts = {k: dict.fromkeys(c, 0) for k, c in kernel_counts().items()}

    def step(self, params, setup, images) -> None:
        from thor_slam_tpu_torch.engine import tracker as trk
        from thor_slam_tpu_torch.utils.profiling import counts_since, kernel_counts

        before = kernel_counts()
        with patched(*self.stub):
            t0 = time.perf_counter()
            self.state, out = trk.track_step(params, setup, self.state, images, generator=self.gen)
            out.world_t_body.cpu()  # the reference's device_get: the readback ends the step
            self.ms.append((time.perf_counter() - t0) * 1000.0)
        self.keyframes.append(bool(out.refreshed_host))
        for k, c in counts_since(before).items():
            for r, n in c.items():
                self.counts[k][r] += n


def time_pair(params, setup, seq, device, stub, reps: int = 30, warmup: int = 4) -> tuple[_Run, _Run]:
    """FULL and the variant ``stub`` = (module, attr, stub) stepped in turn
    over the same palindrome, each threading its own state: step i of one,
    then step i of the other, the first of the two alternating. Returns
    the two runs (FULL's first)."""
    n = seq.shape[0]
    full, variant = _Run(params, device), _Run(params, device, stub)
    for i in range(warmup + reps):
        images = seq[_palindrome(i, n)]
        for run in (full, variant) if i % 2 == 0 else (variant, full):
            run.step(params, setup, images)
    return full, variant


def _add_counts(total: dict, counts: dict) -> None:
    for k, c in counts.items():
        for r, n in c.items():
            total.setdefault(k, dict.fromkeys(c, 0))[r] += n


def run(w: int, h: int, device, reps: int = 30, warmup: int = 4, frames: int = 12, num_cams: int = 4,
        max_keypoints: int = 512) -> list[dict]:
    """Every variant's row, FULL's first: label, the median ms a timed step,
    the ms FULL saves (the median of the paired differences, FULL's step i
    minus the variant's; FULL's own row 0), that median over the pairs in
    which neither step was a keyframe and over those in which both were
    (None where there is none), the number of each, the keyframe ticks among the
    timed steps (FULL's: of its first pairing) and among all steps, the
    steps, and the port's hand-written kernels launched over them (FULL's:
    over all of its pairings)."""
    from thor_slam_tpu_torch.engine import convert
    from thor_slam_tpu_torch.utils.flagship import flagship_rig, render_sequence

    device = torch.device(device)
    params, setup_np, _, sources, _, _ = flagship_rig(num_cams=num_cams, width=w, height=h,
                                                      max_keypoints=max_keypoints)
    setup = convert.setup_to_torch(setup_np, device)
    seq = render_sequence(sources, frames, device=device)  # (T, C, 2, H, W) float32
    print(f"ablate {num_cams} cams @ {w}x{h}, N={max_keypoints}, {reps} paired steps after {warmup}  device={device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""), flush=True)
    fulls, rows = [], []
    for label, module, attr, stub in VARIANTS[1:]:
        full, var = time_pair(params, setup, seq, device, (module, attr, stub), reps=reps, warmup=warmup)
        fulls.append(full)
        pairs = list(zip(full.ms[warmup:], var.ms[warmup:], full.keyframes[warmup:], var.keyframes[warmup:]))
        by_kind = {kind: [f - v for f, v, kf, kv in pairs if kf == kv == (kind == "keyframe")]
                   for kind in ("hot", "keyframe")}
        rows.append(dict(name=label, ms=statistics.median(var.ms[warmup:]),
                         saved_ms=statistics.median(f - v for f, v, _, _ in pairs),
                         **{f"saved_{k}_ms": statistics.median(d) if d else None for k, d in by_kind.items()},
                         **{f"{k}_pairs": len(d) for k, d in by_kind.items()},
                         keyframes=sum(var.keyframes[warmup:]), full_keyframes=sum(full.keyframes[warmup:]),
                         all_keyframes=sum(var.keyframes), steps=len(var.ms), counts=var.counts))
    counts: dict = {}
    for full in fulls:
        _add_counts(counts, full.counts)
    rows.insert(0, dict(name=VARIANTS[0][0], ms=statistics.median(t for f in fulls for t in f.ms[warmup:]),
                        saved_ms=0.0, keyframes=sum(fulls[0].keyframes[warmup:]),
                        full_keyframes=sum(fulls[0].keyframes[warmup:]),
                        all_keyframes=sum(sum(f.keyframes) for f in fulls), steps=sum(len(f.ms) for f in fulls),
                        counts=counts))
    for row in rows:
        if row["name"] == VARIANTS[0][0]:
            print(f"{row['name']:24s} {row['ms']:8.2f} ms a step (median of its {len(fulls)} pairings)"
                  f"{'':34s}keyframe ticks {row['keyframes']} of {reps}", flush=True)
        else:
            split = "; ".join(
                f"{'n/a' if row[f'saved_{k}_ms'] is None else format(row[f'saved_{k}_ms'], '+.2f')} over "
                f"{row[f'{k}_pairs']} {name} pairs" for k, name in (("hot", "non-keyframe"), ("keyframe", "keyframe")))
            print(f"{row['name']:24s} {row['ms']:8.2f} ms a step (median); FULL - this {row['saved_ms']:+8.2f} ms "
                  f"(median of {reps} pairs; {split})  keyframe ticks {row['keyframes']} of {reps} "
                  f"(FULL {row['full_keyframes']})", flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("res", nargs="?", default="640x400", help="WIDTHxHEIGHT")
    parser.add_argument("--reps", type=int, default=30, help="timed steps a variant")
    parser.add_argument("--device", default=None, help="compute device (default: the current CUDA device)")
    args = parser.parse_args(argv)

    from thor_slam_tpu_torch.utils.platform import pin_precision, select_device

    w, h = (int(v) for v in args.res.split("x"))
    device = select_device(args.device)
    pin_precision()
    run(w, h, device, reps=args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
