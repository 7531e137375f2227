"""Stage-by-stage timing of the tracker pipeline on the card.

Port of the JAX package's ``scripts/profile_stages.py``, with its flags.

Usage: python -m thor_slam_tpu_torch.scripts.profile_stages [WIDTHxHEIGHT] [num_cams]
           [--e2e] [--e2e-engine euroc] [--default] [--cadence-ms=N] [--device cpu]

Times each stage of ``track_step`` alone, called as ``engine/tracker.py``
calls it (one batched call over the cameras where the reference maps over
them): 10 calls after a warm-up, synchronized at both ends, on the host's
clock. Beside each row, the device-busy ms and the kernel launches of one
call, read by :func:`~thor_slam_tpu_torch.utils.profiling.torch_trace`
over separate calls: the gap between the host's ms and the device's is
launch overhead. With ``--e2e`` it also splits the end-to-end synchronous
``process_frames`` tick into named host stages (stage / upload /
dispatch+compute / fetch / host state machine), each followed by a
synchronize of the device, with the tracker step's host time and a split
by tick type (keyframe, light, full); ``--e2e-engine euroc`` builds that
engine as the EuRoC runner does (BA, light ticks, loop closure). ``--default`` runs the shipped configuration
(BA + IMU + loop closure, pipelined at depth 6) and reports the fetch wait
a tick at max rate and at a frame cadence (``--cadence-ms``, default the
reference's 30 fps), with the reference's drop-newest camera clock.
Runs on the card unless ``--device`` says otherwise. Not part of the test
suite.
"""

from __future__ import annotations

import argparse
import statistics
import tempfile
import time

import numpy as np
import torch

#: The e2e buckets, in tick order.
E2E_STAGES = ("stage", "upload", "dispatch+compute", "fetch", "host-state")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernels_note(counts: dict, calls: int) -> str:
    ran = {k: (c["kernel"] + c["plain"]) / calls for k, c in counts.items() if c["kernel"] + c["plain"]}
    if not ran:
        return ""
    plain = any(c["plain"] for c in counts.values())
    return "  a call: " + ", ".join(f"{k} {v:g}" for k, v in ran.items()) + (" (plain versions)" if plain else "")


def bench_fn(name, fn, *args, device, reps=10, trace_calls=10):
    """Print and return one stage row: host ms a call (``reps`` calls after
    a warm-up, synchronized at both ends), then device-busy ms and kernel
    launches a call under the profiler over ``trace_calls`` calls, and the
    port's hand-written kernels each call launched (``counts`` holds them
    over all ``calls``)."""
    from thor_slam_tpu_torch.utils.profiling import counts_since, kernel_counts, torch_trace

    before = kernel_counts()
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync(device)
    ms = (time.perf_counter() - t0) / reps * 1000.0
    with tempfile.TemporaryDirectory() as tmp:
        with torch_trace(tmp, cuda=device.type == "cuda") as window:
            for _ in range(trace_calls):
                fn(*args)
    calls = 1 + reps + trace_calls
    row = dict(name=name, ms=ms, device_ms=window.device_ms / trace_calls, launches=window.launches / trace_calls,
               calls=calls, counts=counts_since(before))
    print(f"{name:28s} {ms:8.2f} ms  device {row['device_ms']:8.3f} ms  {row['launches']:7.1f} launches"
          + _kernels_note(row["counts"], calls), flush=True)
    return row


def stage_table(w: int, h: int, c: int, device, reps: int = 10) -> list[dict]:
    """The eight stages, their sum and the full ``track_step``, as rows
    (512 keypoints a camera, as the reference profiles them)."""
    from thor_slam_tpu_torch.engine import convert, pnp
    from thor_slam_tpu_torch.engine import tracker as trk
    from thor_slam_tpu_torch.ops import brief, calib, fast, klt, match
    from thor_slam_tpu_torch.ops import stereo as stereo_ops
    from thor_slam_tpu_torch.ops.image import downsample2, gaussian_blur
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    device = torch.device(device)
    n = 512
    params, setup_np, *_ = flagship_rig(num_cams=c, width=w, height=h, max_keypoints=n)
    setup = convert.setup_to_torch(setup_np, device)
    p = params

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (c, 2, h, w)).astype(np.float32)).to(device)
    img1 = images[:, 0].contiguous()
    print(f"profile {c} cams @ {w}x{h}, N={n}  device={device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""), flush=True)

    def row(name, fn, *args):
        return bench_fn(name, fn, *args, device=device, reps=reps)

    def detect(stack):
        return fast.detect_keypoints_batched(
            stack, threshold=p.fast_threshold, max_keypoints=n, cell_size=p.cell_size, per_cell=p.per_cell,
            border_margin=p.border_margin,
        )

    pair = images.reshape(2 * c, h, w)  # image 2c + eye, as the tracker detects
    rows = [
        row("gaussian blur (2C)", lambda a: gaussian_blur(a, 2.0, radius=4), images),
        row("FAST detect (2C)", detect, pair),
    ]
    kp = detect(pair)
    xy, valid = kp.xy.reshape(c, 2, n, 2), kp.valid.reshape(c, 2, n)
    rows.append(row("BRIEF describe (2C)", lambda a, q, v: brief.compute_descriptors_batched(a, q, v), pair, kp.xy,
                    kp.valid))
    desc = brief.compute_descriptors_batched(pair, kp.xy, kp.valid).bits.reshape(c, 2, n, brief.NUM_WORDS)

    def rectify(q):
        return (
            calib.raw_pixels_to_rect(q[:, 0], setup.k_left, setup.dist_left, setup.rect_left, setup.k_rect),
            calib.raw_pixels_to_rect(q[:, 1], setup.k_right, setup.dist_right, setup.rect_right, setup.k_rect),
        )

    rows.append(row("coord rectify (2C)", rectify, xy))
    rect_l, rect_r = rectify(xy)
    dy = torch.abs(rect_l[:, :, None, 1] - rect_r[:, None, :, 1])
    dx = rect_l[:, :, None, 0] - rect_r[:, None, :, 0]
    gate = (dy <= p.stereo_max_dy + 1.0) & (dx > 0) & (dx <= p.max_disparity_px)
    rows.append(row(
        "match (stereo, gated)",
        lambda d, v: match.match_descriptors(
            d[:, 0], v[:, 0], d[:, 1], v[:, 1], max_distance=p.match_max_distance, ratio=p.match_ratio, allowed=gate,
        ),
        desc, valid,
    ))
    rows.append(row(
        "disparity refine",
        lambda l, r, q: stereo_ops.refine_disparity_photometric(
            l, r, q, torch.full((c, n), 5.0, device=device), torch.ones((c, n), dtype=torch.bool, device=device)
        ),
        img1, images[:, 1].contiguous(), xy[:, 0].contiguous(),
    ))
    pyr1 = downsample2(img1)
    pyr2 = downsample2(pyr1)
    pts = xy[:, 0].contiguous()
    rows.append(row(
        f"KLT track (rig, {p.klt_levels} levels)",
        lambda p0, p1, p2, q: klt.track_points_rig(
            (p0, p1, p2), (p0, p1, p2), q, q, torch.ones((c, n), dtype=torch.bool, device=device),
            num_levels=p.klt_levels, radius=p.klt_radius, iters=p.klt_iters, max_residual=p.klt_max_residual,
        ),
        img1, pyr1, pyr2, pts,
    ))
    pts3 = torch.from_numpy(rng.uniform(-3, 3, (c * n, 3)).astype(np.float32)).to(device)
    obs = torch.from_numpy(rng.uniform(-0.4, 0.4, (c * n, 2)).astype(np.float32)).to(device)
    rot = torch.eye(3, device=device).expand(c * n, 3, 3).contiguous()
    trans = torch.zeros((c * n, 3), device=device)
    ones = torch.ones(c * n, dtype=torch.bool, device=device)
    eye4 = torch.eye(4, device=device)
    gen = torch.Generator(device=device).manual_seed(0)  # the reference's PRNGKey(0)
    rows.append(row(
        f"RANSAC PnP ({p.ransac_hypotheses} hyp)",
        lambda a, b: pnp.ransac_pnp_graphed(
            a, b, ones, rot, trans, eye4, num_hypotheses=p.ransac_hypotheses, sample_size=p.ransac_sample_size,
            generator=gen,
        ),
        pts3, obs,
    ))
    total = dict(name="SUM of stages", ms=sum(r["ms"] for r in rows), device_ms=sum(r["device_ms"] for r in rows),
                 launches=sum(r["launches"] for r in rows))
    print(f"{total['name']:28s} {total['ms']:8.2f} ms  device {total['device_ms']:8.3f} ms  "
          f"{total['launches']:7.1f} launches", flush=True)
    rows.append(total)

    state = [trk.init_state(params, device)]
    step_gen = torch.Generator(device=device).manual_seed(0)
    keyframes = [0]

    def full_step(imgs):
        state[0], out = trk.track_step(params, setup, state[0], imgs, generator=step_gen)
        keyframes[0] += out.refreshed_host
        return out

    full = row("FULL track_step", full_step, images)
    full["keyframes"] = keyframes[0]
    print(f"{'':28s} ({1000.0 / full['ms']:.1f} fps; {keyframes[0]} of {full['calls']} calls keyframes)", flush=True)
    rows.append(full)
    return rows


def flagship_syncs(w: int, h: int, c: int, frames: int, device, imu: bool = False):
    """(calibration, make_sync): the flagship rig's first ``frames`` frame
    sets rendered on ``device`` and replayed as a palindrome, at 30 fps."""
    from thor_slam_tpu_torch.camera.types import CameraFrame, FrameSet, SynchronizedFrameSet
    from thor_slam_tpu_torch.utils.flagship import flagship_rig, render_sequence

    _, _, calibration, sources, _, _ = flagship_rig(num_cams=c, width=w, height=h, max_keypoints=256)
    seq = render_sequence(sources, frames, device=device)
    seq = torch.clamp(seq * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
    names = list(calibration.source_names)

    def make_sync(i):
        ts = i / 30.0
        j = i % (2 * len(seq) - 2)
        j = j if j < len(seq) else 2 * len(seq) - 2 - j
        fsets = {
            name: FrameSet(
                timestamp=ts,
                frames=[CameraFrame(seq[j, ci, k], ts, i, f"{name}_{k}") for k in range(2)],
                source_name=name,
            )
            for ci, name in enumerate(names)
        }
        if not imu:
            return SynchronizedFrameSet(timestamp=ts, frame_sets=fsets, max_time_delta=0.0)
        n = 13
        t_imu = ts - 1 / 30.0 + np.arange(1, n + 1) * (1 / 30.0 / n)
        sd = {
            "accelerometer": np.tile([0.0, 0.0, 9.81], (n, 1)),
            "gyroscope": np.tile([0.0, 0.4, 0.0], (n, 1)),
            "timestamps": t_imu,
        }
        return SynchronizedFrameSet(
            timestamp=ts, frame_sets=fsets, max_time_delta=0.0, sensor_data=sd, sensor_timestamp=ts,
        )

    return calibration, make_sync


def profile_e2e(w: int, h: int, c: int, ticks: int = 30, device=None, engine: str = "reference") -> dict:
    """Split the synchronous ``process_frames`` tick into host stages.

    Each stage ends in a synchronize of the device, so the sum exceeds the
    pipelined tick: the point is attribution. Inside ``dispatch+compute``,
    ``step`` is the host's time in the tracker step (``_track``, not
    synchronized at its end). ``engine`` builds the engine with the
    reference profiler's arguments (``"reference"``: 256 keypoints, no IMU,
    BA or loop closure) or with the EuRoC runner's (``"euroc"``: the
    engine's defaults with BA, light ticks and loop closure; the flagship's
    frames carry no IMU samples). Returns ms a tick by stage (the mean over
    all ticks) and, by tick type (keyframe, light, full), the number of
    ticks and the median ms by stage.
    """
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.platform import select_device

    device = select_device(device)
    calibration, make_sync = flagship_syncs(w, h, c, 6, device)
    if engine == "reference":
        eng = TorchSlamEngine(params=dict(max_keypoints=256), use_imu=False, enable_ba=False, device=device)
        config = SlamConfig(num_cameras=2 * c, enable_loop_closure=False)
    elif engine == "euroc":  # run_euroc.build_engine with the runner's default flags
        eng = TorchSlamEngine(device=device)
        config = SlamConfig(num_cameras=2 * c, enable_loop_closure=True)
    else:
        raise ValueError(f"engine must be 'reference' or 'euroc', not {engine!r}")
    eng.initialize(calibration, config)
    warmup = 3
    for i in range(warmup):
        eng.process_frames(make_sync(i))

    track, step = eng._track, {}

    def timed_track(*args, **kwargs):
        t = time.perf_counter()
        out = track(*args, **kwargs)
        step.update(ms=(time.perf_counter() - t) * 1000.0, keyframe=bool(out[1].refreshed_host))
        return out

    eng._track = timed_track
    rows, kinds = [], []
    for i in range(warmup, warmup + ticks):
        sync = make_sync(i)
        t0 = time.perf_counter()
        light = eng._schedule_light()
        half = light and eng.light_half_active
        flat = eng._stage(sync, light, half)
        t1 = time.perf_counter()
        images = torch.from_numpy(flat).to(device)
        _sync(device)
        t2 = time.perf_counter()
        rec = eng._dispatch_tick(images, sync, light, half)
        _sync(device)
        t3 = time.perf_counter()
        eng._fetch_records([rec])
        t4 = time.perf_counter()
        eng._finalize_values(rec)
        t5 = time.perf_counter()
        if eng._light_ctl.adaptive:  # as process_frames reports the tick
            eng._light_ctl.on_tick(t5 - t0, sync.timestamp, t5)
        rows.append(dict(zip(E2E_STAGES, (1e3 * d for d in (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4))),
                         step=step["ms"]))
        kinds.append("keyframe" if step["keyframe"] else "light" if light else "full")
    eng.shutdown()
    cols = (*E2E_STAGES, "step")
    mean = {k: sum(r[k] for r in rows) / ticks for k in cols}
    total = sum(mean[k] for k in E2E_STAGES)
    print(f"\ne2e attribution ({c} cams @ {w}x{h}, {engine} engine, {ticks} synchronized ticks, "
          f"{kinds.count('light')} light):", flush=True)
    for k in E2E_STAGES:
        print(f"  {k:20s} {mean[k]:8.2f} ms  ({100.0 * mean[k] / total:4.1f}%)", flush=True)
        if k == "dispatch+compute":
            print(f"    {'of which step':18s} {mean['step']:8.2f} ms  (host, in _track)", flush=True)
    print(f"  {'TOTAL':20s} {total:8.2f} ms  ({1000.0 / total:.1f} fps synchronized)", flush=True)
    by_kind = {}
    for kind in ("keyframe", "light", "full"):
        sel = [r for r, k in zip(rows, kinds) if k == kind]
        if sel:
            by_kind[kind] = dict(n=len(sel), **{k: statistics.median(r[k] for r in sel) for k in cols},
                                 TOTAL=statistics.median(sum(r[k] for k in E2E_STAGES) for r in sel))
            print(f"  {kind + ' ticks':20s} n={len(sel):3d} median ms: "
                  + " ".join(f"{k} {v:.2f}" for k, v in by_kind[kind].items() if k != "n"), flush=True)
    return dict(mean, TOTAL=total, light_ticks=kinds.count("light"), ticks=ticks, by_kind=by_kind)


def profile_default(w: int, h: int, c: int, cadence_ms: float, ticks: int = 40, device=None) -> dict:
    """The shipped configuration's pipelined tick at max rate and at a cadence.

    BA + IMU + loop closure, pipeline depth 6, driven back to back and on a
    camera clock of ``cadence_ms`` whose newest frame the loop always takes
    (a consumer that lags drops the frames it missed, as the rig's sync
    does). The fetch wait is the time inside ``_fetch_records``.
    """
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.platform import select_device

    device = select_device(device)
    calibration, make_sync = flagship_syncs(w, h, c, 8, device, imu=True)
    engine = TorchSlamEngine(params=dict(max_keypoints=256), pipelined=True, pipeline_depth=6, device=device)
    engine.initialize(calibration, SlamConfig(num_cameras=2 * c, enable_loop_closure=True))
    warmup = 8
    for i in range(warmup):
        engine.process_frames(make_sync(i))
    engine.flush()

    fetch_t: list[float] = []
    orig = engine._fetch_records

    def timed(records):
        t0 = time.perf_counter()
        orig(records)
        fetch_t.append(time.perf_counter() - t0)

    engine._fetch_records = timed
    base = warmup
    results = {}
    print(f"\ndefault-featured e2e ({c} cams @ {w}x{h}, BA+IMU+loop, depth 6):", flush=True)
    for label, sleep_s in (("max rate", 0.0), (f"{cadence_ms:.0f} ms cadence", cadence_ms / 1e3)):
        fetch_t.clear()
        slept = 0.0
        processed = 0
        t0 = time.perf_counter()
        if not sleep_s:
            for i in range(base, base + ticks):
                engine.process_frames(make_sync(i))
                processed += 1
        else:
            next_k = 0
            while next_k < ticks:
                now = time.perf_counter()
                newest = int((now - t0) / sleep_s)
                if newest < next_k:
                    d = t0 + next_k * sleep_s - now
                    time.sleep(d)
                    slept += d
                    newest = next_k
                k = min(newest, ticks - 1)
                engine.process_frames(make_sync(base + k))
                processed += 1
                next_k = k + 1
        engine.flush()
        wall = time.perf_counter() - t0
        busy = wall - slept
        avg_fetch = sum(fetch_t) / max(1, len(fetch_t)) * 1000.0
        results[label] = dict(fps=processed / wall, frames=processed, ms_per_tick=busy / max(1, processed) * 1000.0,
                              fetch_ms=avg_fetch, fetch_events=len(fetch_t))
        print(
            f"  {label:16s} {processed / wall:6.1f} fps delivered"
            f" ({processed}/{ticks} frames) | engine"
            f" {busy / max(1, processed) * 1000.0:6.1f} ms/tick"
            f" | fetch wait {avg_fetch:6.1f} ms over {len(fetch_t)} events",
            flush=True,
        )
        base += ticks
    engine.shutdown()
    return results


def run(argv=None) -> dict:
    """Parse ``argv`` as :func:`main` does and run it; the rows and splits."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("res", nargs="?", default="640x400", help="WIDTHxHEIGHT")
    parser.add_argument("num_cams", nargs="?", type=int, default=4)
    parser.add_argument("--e2e", action="store_true", help="split the synchronous tick into host stages")
    parser.add_argument("--default", action="store_true", help="the shipped configuration at max rate and cadence")
    parser.add_argument("--cadence-ms", type=float, default=33.3)
    parser.add_argument("--e2e-engine", choices=("reference", "euroc"), default="reference",
                        help="--e2e's engine: the reference profiler's arguments, or the EuRoC runner's")
    parser.add_argument("--device", default=None, help="compute device (default: the current CUDA device)")
    parser.add_argument("--reps", type=int, default=10, help="timed calls a stage row")
    parser.add_argument("--ticks", type=int, default=None, help="ticks of --e2e (30) and of each --default regime (40)")
    args = parser.parse_args(argv)

    from thor_slam_tpu_torch.utils.platform import pin_precision, select_device

    w, h = (int(v) for v in args.res.split("x"))
    device = select_device(args.device)
    pin_precision()
    ticks = {"ticks": args.ticks} if args.ticks else {}
    out = {"stages": stage_table(w, h, args.num_cams, device, reps=args.reps)}
    if args.e2e:
        out["e2e"] = profile_e2e(w, h, args.num_cams, device=device, engine=args.e2e_engine, **ticks)
    if args.default:
        out["default"] = profile_default(w, h, args.num_cams, args.cadence_ms, device=device, **ticks)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
