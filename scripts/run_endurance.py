"""KITTI-00-shaped endurance run (round-3 verdict item 1): thousands of
frames through the FULL pipeline (mapping + loop closing ON) at the
DEFAULT arenas (512 KF / 65,536 points), with per-stage timing and
peak live counts recorded to a JSON artifact.

  python scripts/run_endurance.py --frames 4000 [--out build/endurance.json]

Runs on JAX's default device and records its platform and kind.

Shape rationale: upstream KITTI 00 is 4,541 stereo frames with large
loop closures and ~1,300 keyframes before culling (SURVEY.md §5.7,
config.py MapConfig docstring).  No real dataset is mountable in this
environment (zero egress — scripts/fetch_datasets.py), so the run
drives a closed circuit in the synthetic box world, traversed R times:
each traversal revisits mapped territory and must trigger loop
closures; keyframe culling + slot recycling must keep the live set
bounded and tracking healthy for the whole run.  Rendering cost is
amortized by caching the circuit's unique frames (the pipeline still
does full per-frame work every lap).

Round-5 additions (r4 verdict items 1 and 8):
  * --timeline FILE.jsonl — after EVERY keyframe event and closure,
    record the keyframe-trajectory ATE so far (numpy Umeyama on the
    host mirror, <= 512 poses), so the FIRST corrupting event is
    identifiable instead of one opaque 4,000-frame blob.
  * Bisection flags: --no-loop, --gba-iters N (0 = pose-graph-only
    corrections), --no-cull, --no-fuse, --no-local-ba — rerun the tour
    with stages disabled to isolate which one corrupts the map.
  * Profiling is SAMPLED (--profile-every, default every 8th keyframe
    event) instead of serializing every mapping dispatch with
    block_until_ready: fps_sustained now measures the overlapped
    pipeline, and stage percentiles come from the sampled events.
  * vocab_retrain_ms recorded (the mid-run retrain spike).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pct(xs, q):
    import numpy as np
    a = np.asarray(xs)
    return round(float(np.percentile(a, q)), 3) if a.size else None


def np_umeyama_ate(est, gt):
    """Plain-numpy similarity-aligned RMSE (per-event calls would
    recompile a jitted Umeyama for every point count)."""
    import numpy as np
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_e = (ec ** 2).sum() / len(est)
    s = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
    t = mu_g - s * R @ mu_e
    resid = (s * est @ R.T + t) - gt
    return float(np.sqrt((resid ** 2).sum(1).mean()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4000)
    ap.add_argument("--unique", type=int, default=1000,
                    help="unique poses on the circuit (render cache)")
    ap.add_argument("--out", default="build/endurance.json")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--trajectory", choices=("circle", "tour"),
                    default="tour",
                    help="circle: maximal redundancy (stresses culling/"
                    "recycling); tour: room-covering Lissajous "
                    "(stresses arena growth toward the 512-KF cap)")
    ap.add_argument("--timeline", default=None,
                    help="JSONL path for per-event KF-ATE records")
    ap.add_argument("--profile-every", type=int, default=8,
                    help="profile stage timings on every Nth keyframe "
                    "event (0 = never); other events run overlapped")
    # bisection switches (r4 verdict item 1)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--gba-iters", type=int, default=None,
                    help="override closure GBA LM iterations "
                    "(0 = pose-graph-only corrections)")
    ap.add_argument("--no-cull", action="store_true")
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--no-local-ba", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    import jax
    dev = jax.devices()[0]

    import numpy as np
    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import CameraParams
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, loop_trajectory, render_rgbd, tour_trajectory)
    from active_orb_slam2_tpu.io.trajectory import camera_centers
    from active_orb_slam2_tpu.models.system import (
        LOST, OK, System, host_fetch)

    w, h = args.width, args.height
    f = 260.0 * w / 320.0
    cam = CameraParams(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
                       bf=f * 0.08, width=w, height=h)
    # DEFAULT arena (MapConfig()): 512 KF / 65,536 points — the
    # deployment shape the verdict asks to prove (config #3/#4)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=1024, n_levels=8),
        tracking=TrackingConfig(th_depth=8.0, kf_max_interval=8),
        map=MapConfig())
    assert cfg.map.max_keyframes == 512 and cfg.map.max_points == 65536

    t0 = time.time()
    # the tour sweeps most of the room: no interior boxes, or the
    # camera clips into geometry (same reason the full-pipeline test
    # uses the walled world for its radius-2.5 loop)
    world = default_world(n_boxes=0 if args.trajectory == "tour" else 8,
                          seed=args.seed)
    traj = (loop_trajectory(args.unique, radius=1.2)
            if args.trajectory == "circle"
            else tour_trajectory(args.unique))
    print(f"[{time.time()-t0:6.1f}s] rendering {args.unique} unique "
          f"poses at {w}x{h}", file=sys.stderr, flush=True)
    cache = []
    for i, Twc in enumerate(traj):
        g, d = render_rgbd(world, cam, Twc)
        cache.append((np.clip(g, 0, 255).astype(np.uint8),
                      np.clip(d * 1e3, 0, 65535).astype(np.uint16),
                      Twc[:3, 3].copy()))
        if i % 200 == 199:
            print(f"[{time.time()-t0:6.1f}s]   {i+1}/{args.unique}",
                  file=sys.stderr, flush=True)
    print(f"[{time.time()-t0:6.1f}s] frames ready", file=sys.stderr,
          flush=True)

    slam = System(cfg, use_mapping=True,
                  use_loop_closing=not args.no_loop)
    if args.gba_iters is not None and slam.loop_closer is not None:
        slam.loop_closer.gba_iters = args.gba_iters
    if args.no_cull or args.no_fuse or args.no_local_ba:
        from active_orb_slam2_tpu.models.local_mapping import (
            build_keyframe_mapping)
        slam.keyframe_mapping = build_keyframe_mapping(
            cfg, triangulate=True, fuse=not args.no_fuse,
            local_ba=not args.no_local_ba, cull=not args.no_cull)

    stage_hist = {"mapping": [], "loop_detect": [], "loop_verify": [],
                  "loop_correct": []}
    timeline_f = open(args.timeline, "w") if args.timeline else None

    def kf_ate_now():
        """Similarity-aligned keyframe-trajectory ATE from the host
        mirrors (no flush: kf_pose reads the latest dispatched map)."""
        if len(slam.kf_records) < 4:
            return None
        poses = host_fetch(slam.map.kf_pose)
        slots = np.array([s for _, s in slam.kf_records])
        est = camera_centers(poses[slots])
        g = np.stack([cache[int(round(t * 30)) % args.unique][2]
                      for t, _ in slam.kf_records])
        return np_umeyama_ate(est, g)

    gt = []
    lost_frames = 0
    peak_live_kf = 0
    peak_live_pt = 0
    n = args.frames
    prev_kf_seq, prev_loops = 0, 0
    t_run = time.perf_counter()
    for i in range(n):
        g, d, c = cache[i % args.unique]
        # sampled profiling: serialize only every Nth keyframe event
        slam.profile_stages = (args.profile_every > 0
                               and slam.kf_seq % args.profile_every == 0)
        slam.track_rgbd(g, d, i / 30.0)
        gt.append(c)
        if slam.stage_ms:
            for k, v in slam.stage_ms.items():
                if k in stage_hist:
                    stage_hist[k].append(v)
            slam.stage_ms = {}
        if timeline_f is not None and (
                slam.kf_seq != prev_kf_seq
                or slam.n_loops_closed != prev_loops):
            ate = kf_ate_now()
            row = {"frame": i, "kf_seq": slam.kf_seq,
                   "live_kf": slam.n_live_kf,
                   "loops": slam.n_loops_closed,
                   "event": ("loop" if slam.n_loops_closed != prev_loops
                             else "kf"),
                   "kf_ate": None if ate is None else round(ate, 4)}
            if (slam.n_loops_closed != prev_loops
                    and slam.loop_closer is not None
                    and slam.loop_closer.last_closure is not None):
                # check the verified Sim3 against ground truth: s_cm
                # maps loop-KF camera coords -> current-KF camera
                # coords, so GT is Tcw_cur . Twc_loop
                lcd = slam.loop_closer.last_closure
                row.update(cur_fid=lcd["cur_fid"],
                           loop_fid=lcd["loop_fid"])
                try:
                    def _qmat(q):
                        w, x, y, z = q
                        return np.array([
                            [1 - 2 * (y * y + z * z),
                             2 * (x * y - w * z), 2 * (x * z + w * y)],
                            [2 * (x * y + w * z),
                             1 - 2 * (x * x + z * z),
                             2 * (y * z - w * x)],
                            [2 * (x * z - w * y), 2 * (y * z + w * x),
                             1 - 2 * (x * x + y * y)]])
                    Twc_c = np.asarray(
                        traj[lcd["cur_fid"] % args.unique], np.float64)
                    Twc_l = np.asarray(
                        traj[lcd["loop_fid"] % args.unique], np.float64)
                    T_rel_gt = np.linalg.inv(Twc_c) @ Twc_l  # cur<-loop
                    s = lcd["s_cm"].astype(np.float64)
                    R_est = _qmat(s[:4] / np.linalg.norm(s[:4]))
                    t_est = s[4:7]
                    row["sim3_t_err"] = round(float(np.linalg.norm(
                        t_est - T_rel_gt[:3, 3])), 4)
                    cosang = (np.trace(R_est.T @ T_rel_gt[:3, :3]) - 1) / 2
                    row["sim3_rot_err_deg"] = round(float(np.degrees(
                        np.arccos(np.clip(cosang, -1, 1)))), 3)
                    row["sim3_scale"] = round(float(s[7]), 5)
                except Exception as ex:   # diagnostics must not kill runs
                    row["sim3_err"] = repr(ex)
            timeline_f.write(json.dumps(row) + "\n")
            timeline_f.flush()
            prev_kf_seq = slam.kf_seq
            prev_loops = slam.n_loops_closed
        if i % 250 == 249:
            slam.flush()
            live_kf = slam.n_live_kf
            live_pt = int(np.asarray(slam.map.pt_valid.sum()))
            peak_live_kf = max(peak_live_kf, live_kf)
            peak_live_pt = max(peak_live_pt, live_pt)
            lost_frames += int(slam._state != OK)
            lc_dbg = slam.loop_closer
            print(f"[{time.time()-t0:6.1f}s] [{i+1}/{n}] "
                  f"kf_seq={slam.kf_seq} live_kf={live_kf} "
                  f"pts={live_pt} loops={slam.n_loops_closed} "
                  f"cand={getattr(lc_dbg, 'n_candidates', 0)} "
                  f"vfail={getattr(lc_dbg, 'n_verify_fail', 0)} "
                  f"rej={getattr(lc_dbg, 'n_rejected', 0)} "
                  f"state={slam._state}", file=sys.stderr, flush=True)
    slam.flush()
    wall = time.perf_counter() - t_run
    if timeline_f is not None:
        timeline_f.close()
    peak_live_kf = max(peak_live_kf, slam.n_live_kf)
    peak_live_pt = max(peak_live_pt,
                       int(np.asarray(slam.map.pt_valid.sum())))

    _, poses = slam.frame_trajectory()
    est = camera_centers(poses)
    gt_np = np.stack(gt)
    ate = np_umeyama_ate(est, gt_np)
    # residuals under the final alignment, for percentile reporting
    aligned_err = None
    try:
        import numpy.linalg as _la
        mu_e, mu_g = est.mean(0), gt_np.mean(0)
        ec, gc = est - mu_e, gt_np - mu_g
        cov = gc.T @ ec / len(est)
        U, D, Vt = _la.svd(cov)
        S = np.eye(3)
        if _la.det(U) * _la.det(Vt) < 0:
            S[2, 2] = -1.0
        R = U @ S @ Vt
        s = np.trace(np.diag(D) @ S) / max(
            (ec ** 2).sum() / len(est), 1e-12)
        t_al = mu_g - s * R @ mu_e
        aligned_err = np.linalg.norm(
            (s * est @ R.T + t_al) - gt_np, axis=1)
    except Exception:
        aligned_err = np.zeros(len(est))
    # keyframe-trajectory ATE separates MAP quality from per-frame
    # REPLAY quality (replay bugs dominated the early r4 runs)
    kf_ate = kf_ate_now()
    n_degraded = sum(1 for (_, r, _) in slam.rel_records if r < 0)
    live_final = int(np.asarray(slam.map.kf_valid.sum()))

    per_frame_wall = [m["wall_ms"] for m in slam.metrics
                      if m.get("wall_ms") is not None]
    lc = slam.loop_closer
    record = {
        "metric": "endurance_full_pipeline_default_arena",
        "frames": n,
        "trajectory": args.trajectory,
        "unique_poses": args.unique,
        "image": [w, h],
        "arena": [cfg.map.max_keyframes, cfg.map.max_points],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "bisect": {"loop": not args.no_loop,
                   "gba_iters": (lc.gba_iters if lc is not None
                                 else None),
                   "cull": not args.no_cull,
                   "fuse": not args.no_fuse,
                   "local_ba": not args.no_local_ba},
        "fps_sustained": round(n / wall, 2),
        "wall_s": round(wall, 1),
        "kf_inserted_total": slam.kf_seq,
        "kf_live_final": live_final,
        "kf_recycled": slam.kf_seq - live_final,
        "peak_live_kf": peak_live_kf,
        "peak_live_points": peak_live_pt,
        "loops_closed": slam.n_loops_closed,
        "loops_rejected": getattr(lc, "n_rejected", 0) if lc else 0,
        "ate_rmse_m": round(ate, 4),
        "kf_ate_rmse_m": None if kf_ate is None else round(kf_ate, 4),
        "frame_err_p50": pct(aligned_err, 50),
        "frame_err_p95": pct(aligned_err, 95),
        "frame_err_max": round(float(aligned_err.max()), 3),
        "degraded_records": n_degraded,
        "checkpoints_lost": lost_frames,
        "track_wall_ms_p50": pct(per_frame_wall, 50),
        "track_wall_ms_p95": pct(per_frame_wall, 95),
        "mapping_ms_p50": pct(stage_hist["mapping"], 50),
        "mapping_ms_p95": pct(stage_hist["mapping"], 95),
        "loop_detect_ms_p50": pct(stage_hist["loop_detect"], 50),
        "loop_verify_ms_p50": pct(stage_hist["loop_verify"], 50),
        "loop_correct_ms_p50": pct(stage_hist["loop_correct"], 50),
        "vocab_retrain_ms": round(getattr(
            lc, "last_retrain_ms", 0.0), 1) if lc else 0.0,
        "profile_sampled_every": args.profile_every,
        "ok": bool(lost_frames == 0
                   and (slam.n_loops_closed >= 1 or args.no_loop)
                   and ate < 0.15 and slam.kf_seq > 64),
    }
    print(json.dumps(record))
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fp:
        json.dump(record, fp, indent=1)
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
