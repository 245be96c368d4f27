"""Long-trajectory endurance proof (SURVEY.md §5.7, round-2 verdict
item 3): 1,000+ synthetic RGB-D frames through the full System with a
bounded arena — keyframe culling + slot recycling must keep tracking
healthy and memory flat for the whole run.

  python scripts/run_long_sequence.py [--frames 1200]

Runs on JAX's default device.  Prints one JSON line with the outcome
and the device it ran on.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1200)
    args = ap.parse_args()

    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    import jax
    dev = jax.devices()[0]

    import numpy as np
    import jax.numpy as jnp
    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import CameraParams
    from active_orb_slam2_tpu.geometry.horn import umeyama_alignment
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, make_sequence, orbit_trajectory)
    from active_orb_slam2_tpu.io.trajectory import camera_centers
    from active_orb_slam2_tpu.models.system import OK, System

    cam = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                       width=320, height=240)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=512, n_levels=4),
        tracking=TrackingConfig(th_depth=10.0, kf_max_interval=8),
        map=MapConfig(max_keyframes=24, max_points=8192,
                      local_ba_keyframes=6, local_ba_points=1024))
    slam = System(cfg)

    n = args.frames
    lost = 0
    t0 = time.perf_counter()
    gt = []
    # slow sweep: 0.2 deg/frame -> heavy keyframe overlap, constant
    # forced insertions (kf_max_interval) against a 24-slot arena
    for i, (g, d, Twc) in enumerate(make_sequence(
            n, cam, world=default_world(),
            trajectory=orbit_trajectory(n, step_deg=0.2))):
        slam.track_rgbd(g, d, i / 30.0)
        gt.append(Twc[:3, 3])
        if i % 100 == 99:
            slam.flush()
            lost += int(slam._state != OK)
            print(f"[{i+1}/{n}] kf_seq={slam.kf_seq} "
                  f"live={slam.n_live_kf} state={slam._state} "
                  f"pts={int(np.asarray(slam.map.pt_valid).sum())}",
                  file=sys.stderr, flush=True)
    slam.flush()
    wall = time.perf_counter() - t0
    _, poses = slam.frame_trajectory()
    est = camera_centers(poses)
    *_, rmse = umeyama_alignment(jnp.asarray(est),
                                 jnp.asarray(np.stack(gt)),
                                 fix_scale=True)
    live = int(np.asarray(slam.map.kf_valid).sum())
    print(json.dumps({
        "metric": "long_sequence_endurance",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "frames": n,
        "kf_inserted_total": slam.kf_seq,
        "kf_live_final": live,
        "kf_arena": cfg.map.max_keyframes,
        "recycled": slam.kf_seq - live,
        "ate_rmse_m": round(float(rmse), 4),
        "checkpoints_lost": lost,
        "fps": round(n / wall, 2),
        "ok": bool(lost == 0 and slam.kf_seq > 2 * cfg.map.max_keyframes
                   and float(rmse) < 0.15),
    }))


if __name__ == "__main__":
    main()
