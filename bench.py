"""Benchmark: RGB-D tracking throughput on one GPU + deployment-shape
full-pipeline throughput + global BA throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", ...}.  It needs a GPU: with none it exits non-zero and prints
no result.

Baseline (BASELINE.md [U]): the reference tracks a VGA frame with 1000
features in ~25-30 ms on an i7 (4 threads) — we take 30 ms/frame
(33.3 fps) as the comparison point.  vs_baseline > 1 means faster than
the reference.

Parity semantics: the reference's number is TRACKING-THREAD time per
frame (ORB extraction + matching + two pose optimizations); its local
mapping/loop closing run on background threads and are excluded.  The
primary metric therefore measures the same per-frame tracking path
(frame build + track step, including host<->device transfer of the
camera frame), on a map built by the RGB-D initializer.  The round-4
additions (verdict items 4+5):

  * ``full_pipeline_fps`` — a second window with mapping + loop
    closing ON at the DEFAULT arena (512 KF / 65,536 points), i.e.
    deployment shape, amortizing keyframe-rate mapping into the
    per-frame wall time exactly like a long real run would.
  * ``ba_iters_per_s`` / ``ba_est_tflops`` — global BA throughput on
    the 48-KF/8,192-pt/8-obs problem of io/synthetic.py
    (``synthetic_ba_problem``) and at the 512-KF/65,536-pt shape.

Compilation is covered by the persistent cache
(utils/runtime.py::configure_compile_cache).
"""

import json
import subprocess
import sys
import time

import numpy as np

_T0 = time.time()


def _lap(msg):
    print(f"[bench {time.time() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def tracking_window(frames, cfg, System):
    """Median-of-3-window tracking-path ms/frame (reference parity)."""
    slam = System(cfg, use_mapping=False)
    for i in range(6):                       # compiles + map init
        g, d = frames[i]
        slam.track_rgbd(g, d, i / 30.0)
        _lap(f"warmup frame {i}")
    slam.flush()

    # one continuous measured run with split timestamps: flushing at
    # every window boundary drained the async pipeline and charged the
    # refill to the window (short 12-frame windows overstated
    # steady-state cost by 5-15 ms/frame); the queue now only drains
    # once at the end, and the three split times expose the variance
    # without resetting the overlap
    _lap("measuring tracking path")
    n = len(frames) - 6
    per_window = n // 3
    marks = [time.perf_counter()]
    for w in range(3):
        for i in range(6 + w * per_window, 6 + (w + 1) * per_window):
            g, d = frames[i]
            slam.track_rgbd(g, d, i / 30.0)
        marks.append(time.perf_counter())
    slam.flush()                             # drain the device queue
    t_end = time.perf_counter()
    window_ms = [(marks[w + 1] - marks[w]) / per_window * 1e3
                 for w in range(3)]
    total_ms = (t_end - marks[0]) / (3 * per_window) * 1e3
    for w, ms in enumerate(window_ms):
        _lap(f"window {w}: {ms:.2f} ms/frame")
    _lap(f"steady state incl. final drain: {total_ms:.2f} ms/frame")
    return total_ms, window_ms, slam


def mapping_timing(slam):
    """ms per fused keyframe-mapping dispatch (triangulate + fuse +
    local BA + culling — what deployment runs per keyframe)."""
    import jax as _jax
    _lap("mapping-step timing")
    m, k = slam.map, max(slam.last_kf_slot, 0)
    out = slam.keyframe_mapping(m, k, slam.kf_seq)     # compile
    _jax.block_until_ready(out)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = slam.keyframe_mapping(m, k, slam.kf_seq)
        _jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def full_pipeline_window(frames, cam, System, SlamConfig, OrbConfig,
                         TrackingConfig, MapConfig):
    """Deployment-shape window: DEFAULT 512-KF/65,536-pt arena,
    mapping + loop closing ON.  The warmup must reach PAST the
    vocabulary-training keyframe count (4 live KFs -> ~frame 32 at
    kf_max_interval=8) and the first loop-detect compile, or those
    one-time costs land inside the measuring window and misreport
    steady state by an order of magnitude.

    Returns (ms_per_frame, kf_count, stage_ms): per-stage medians are
    collected with profiling ON during the tail of warmup (profiling
    serializes the overlapped pipeline, so the measuring window runs
    with it OFF — the r4 endurance conflated the two)."""
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=1024, n_levels=8),
        tracking=TrackingConfig(th_depth=8.0, kf_max_interval=8),
        map=MapConfig())                     # the defaults: 512 / 65536
    slam = System(cfg, use_mapping=True, use_loop_closing=True)
    n = len(frames)
    measure = max(n // 3, 12)
    warm = n - measure
    stage_hist = {}
    for i in range(warm):
        g, d = frames[i]
        # stage profiling over the last third of warmup only
        slam.profile_stages = i >= (2 * warm) // 3
        slam.track_rgbd(g, d, i / 30.0)
        if slam.stage_ms:
            for k, v in slam.stage_ms.items():
                stage_hist.setdefault(k, []).append(v)
            slam.stage_ms = {}
        if i % 16 == 0:
            _lap(f"full-pipeline warmup {i} (kf={slam.kf_seq})")
    slam.profile_stages = False
    slam.flush()
    _lap(f"measuring full pipeline ({slam.kf_seq} KFs after warmup)")
    t0 = time.perf_counter()
    for i in range(warm, n):
        g, d = frames[i]
        slam.track_rgbd(g, d, i / 30.0)
    slam.flush()
    ms = (time.perf_counter() - t0) / measure * 1e3
    # drop each stage's first sample: it carries the one-time compile /
    # vocabulary-setup cost, not steady state
    stage_ms = {k: round(float(np.median(v[1:] if len(v) > 1 else v)), 1)
                for k, v in stage_hist.items()}
    _lap(f"full pipeline: {ms:.2f} ms/frame ({slam.kf_seq} KFs) "
         f"stages={stage_ms}")
    return ms, slam.kf_seq, stage_ms


def stereo_kitti_shape(System, SlamConfig, OrbConfig, TrackingConfig,
                       MapConfig, CameraParams):
    """Config #3's shape (SURVEY.md §6 KITTI rows): 1226x370 stereo,
    2000 features, forward motion with tangent heading on a closed
    circuit, DEFAULT arena, mapping + loop closing ON.  The right eye
    is rendered from the left pose translated by the baseline.
    Returns (fps, ate_m, n_kf, loops)."""
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, loop_trajectory, render_rgbd)
    from active_orb_slam2_tpu.io.trajectory import camera_centers

    w, h = 1226, 370
    f = 707.0                                # ~KITTI intrinsics
    base = 0.12                              # room-scaled baseline (m)
    cam = CameraParams(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
                       bf=f * base, width=w, height=h)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=2000, n_levels=8),
        tracking=TrackingConfig(th_depth=35.0 * base,  # ThDepth=35 [U]
                                kf_max_interval=8),
        map=MapConfig())
    world = default_world(n_boxes=0)
    # 150 frames around the circuit = 2.4 deg/frame peak yaw — the
    # KITTI-like turn rate (60 frames = 6 deg/frame pushed ~74 px of
    # rotation flow at fx=707, beyond any projection search radius)
    n = 150
    traj = loop_trajectory(n, radius=2.5)
    _lap(f"stereo KITTI-shape: rendering {n} stereo pairs at {w}x{h}")
    pairs = []
    gt = []
    for Twc in traj:
        gl, _ = render_rgbd(world, cam, Twc, supersample=1)
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array(
            [base, 0.0, 0.0], np.float32)
        gr, _ = render_rgbd(world, cam, Twc_r, supersample=1)
        pairs.append((np.clip(gl, 0, 255).astype(np.uint8),
                      np.clip(gr, 0, 255).astype(np.uint8)))
        gt.append(Twc[:3, 3].copy())
    slam = System(cfg, use_mapping=True, use_loop_closing=True)
    warm = n - 30
    for i in range(warm):
        l, r = pairs[i]
        slam.track_stereo(l, r, i / 10.0)
        if i % 24 == 0:
            _lap(f"stereo warmup {i} (kf={slam.kf_seq})")
    slam.flush()
    t0 = time.perf_counter()
    for i in range(warm, n):
        l, r = pairs[i]
        slam.track_stereo(l, r, i / 10.0)
    slam.flush()
    fps = (n - warm) / (time.perf_counter() - t0)
    _, poses = slam.frame_trajectory()
    est = np.asarray(camera_centers(poses))
    gt_np = np.stack(gt)
    mu_e, mu_g = est.mean(0), gt_np.mean(0)
    ec, gc = est - mu_e, gt_np - mu_g
    U, D, Vt = np.linalg.svd(gc.T @ ec / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    t = mu_g - R @ mu_e                      # stereo: scale fixed at 1
    ate = float(np.sqrt((((est @ R.T + t) - gt_np) ** 2).sum(1).mean()))
    _lap(f"stereo KITTI-shape: {fps:.2f} fps ate={ate:.3f} "
         f"kf={slam.kf_seq} loops={slam.n_loops_closed}")
    return fps, ate, slam.kf_seq, slam.n_loops_closed


def ba_flops_per_iter(K=48, Pn=8192, O=8):
    """Analytic FLOP count of one global-BA LM iteration (dominant
    terms)."""
    E = Pn * O
    lin = E * 400                 # residual+jacobian blocks
    blocks = E * (6*3*3*2 + 6*6*3*2 + 3*3*3*2)   # A, Hcc, Hpp einsums
    schur = Pn * O * O * 6*3*6*2 + Pn * O * 6*3*2
    solve = (K*6) ** 3 * 2 // 3
    return 2 * (lin + blocks + schur) + solve    # x2: chi2 re-eval pass


def ba_roofline():
    """Global-BA iters/s on this GPU.

    Two problem sizes: the 48-KF/8k-pt LOCAL-BA shape (small ops —
    latency-bound, the deployment per-KF case) and a KITTI-00-scale
    512-KF/65k-pt GLOBAL-BA shape.  Returns
    (small_iters_per_s, small_flops, big_iters_per_s, big_flops)."""
    import jax
    from active_orb_slam2_tpu.io.synthetic import (
        synthetic_ba_problem as build_problem)
    from active_orb_slam2_tpu.geometry.projection import CameraParams
    from active_orb_slam2_tpu.parallel.dist_ba import global_ba

    cam = CameraParams(fx=400., fy=400., cx=320., cy=320., bf=40.,
                       width=640, height=640)

    def measure(K, Pn, O, iters, reps, dense):
        prob = build_problem(K=K, Pn=Pn, O=O)
        f = jax.jit(lambda *a: global_ba(cam, *a, iters=iters,
                                         dense=dense))
        out = f(*prob)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*prob)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        its = iters / dt
        return its, ba_flops_per_iter(K=K, Pn=Pn, O=O) * its

    # dense Schur (one dense factorization per LM iteration) and the
    # matrix-free PCG of the sharded path, both timed
    s_its, s_fl = measure(48, 8192, 8, iters=10, reps=5, dense=False)
    _lap(f"BA small (pcg): {s_its:.1f} iters/s")
    b_its, b_fl = measure(512, 65536, 8, iters=10, reps=3, dense=True)
    _lap(f"BA big (dense): {b_its:.1f} iters/s")
    p_its, _ = measure(512, 65536, 8, iters=10, reps=2, dense=False)
    _lap(f"BA big (pcg): {p_its:.1f} iters/s")
    return s_its, s_fl, b_its, b_fl, p_its


def device_record():
    """The device every number of this run comes from; exits without a
    GPU (no CPU fallback)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX sees {devs[0].platform}",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs),
            "card": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 else None}


def main():
    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    device = device_record()

    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import CameraParams
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, make_sequence, orbit_trajectory)
    from active_orb_slam2_tpu.models.system import System

    cam = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                       width=640, height=480)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=1024, n_levels=8),
        tracking=TrackingConfig(th_depth=8.0),
        map=MapConfig(max_keyframes=64, max_points=16384,
                      local_ba_keyframes=8, local_ba_points=2048))

    n_frames = 72          # 42 for the tracking windows; all 72 for the
    _lap("rendering frames")   # full-pipeline window (vocab trains ~f32)
    frames = [(np.clip(g, 0, 255).astype(np.uint8),
               np.clip(d * 1e3, 0, 65535).astype(np.uint16))
              for g, d, _ in make_sequence(
                  n_frames, cam, world=default_world(),
                  trajectory=orbit_trajectory(n_frames, step_deg=0.8))]
    _lap("frames ready")

    # tracking-path only (the reference's per-frame thread): mapping is
    # amortized at KF rate on a background cadence
    ms_per_frame, window_ms, slam = tracking_window(
        frames[:42], cfg, System)
    fps = 1e3 / ms_per_frame
    baseline_ms = 30.0

    # mapping-side budget (the reference amortizes local BA at keyframe
    # rate on a background thread with a 100-400 ms/KF budget)
    mapping_ms = mapping_timing(slam)
    del slam

    record = {
        "metric": "rgbd_tracking_throughput_vga_1024feat",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(baseline_ms / ms_per_frame, 3),
        "device": device,
        # all three window times, so that comparisons between runs
        # carry their variance
        "tracking_window_ms": [round(x, 2) for x in window_ms],
        "mapping_ms_per_kf": round(mapping_ms, 2),
        "mapping_budget_ok": bool(mapping_ms < 400.0),
    }

    # deployment-shape window (verdict item 5): default arena,
    # mapping + loop closing on
    try:
        fp_ms, fp_kfs, fp_stages = full_pipeline_window(
            frames, cam, System, SlamConfig, OrbConfig,
            TrackingConfig, MapConfig)
        record["full_pipeline_fps"] = round(1e3 / fp_ms, 2)
        record["full_pipeline_kfs"] = int(fp_kfs)
        record["full_pipeline_stage_ms"] = fp_stages
    except Exception as e:  # never lose the primary metric
        _lap(f"full-pipeline window FAILED: {e!r}")
        record["full_pipeline_fps"] = None

    # config #3's shape: KITTI-sized stereo with forward motion and a
    # closing loop (r4 verdict item 6 — previously unmeasured anywhere)
    try:
        st_fps, st_ate, st_kf, st_loops = stereo_kitti_shape(
            System, SlamConfig, OrbConfig, TrackingConfig, MapConfig,
            CameraParams)
        record["stereo_kitti_shape_fps"] = round(st_fps, 2)
        record["stereo_kitti_shape_ate_m"] = round(st_ate, 4)
        record["stereo_kitti_shape_kfs"] = int(st_kf)
        record["stereo_kitti_shape_loops"] = int(st_loops)
    except Exception as e:
        _lap(f"stereo KITTI-shape FAILED: {e!r}")
        record["stereo_kitti_shape_fps"] = None

    # BA roofline (verdict item 4 / north star)
    try:
        s_its, s_fl, b_its, b_fl, p_its = ba_roofline()
        record["ba_iters_per_s"] = round(s_its, 2)
        record["ba_est_tflops"] = round(s_fl / 1e12, 3)
        record["ba_global_iters_per_s_512kf_65kpt"] = round(p_its, 2)
        record["ba_global_iters_per_s_dense"] = round(b_its, 2)
        record["ba_global_est_tflops"] = round(b_fl / 1e12, 3)
    except Exception as e:
        _lap(f"BA roofline FAILED: {e!r}")
        record["ba_iters_per_s"] = None

    print(json.dumps(record))


if __name__ == "__main__":
    main()
