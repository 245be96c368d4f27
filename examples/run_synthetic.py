#!/usr/bin/env python
"""Self-contained demo: RGB-D SLAM on the synthetic box world (no
dataset required) with ATE self-scoring.

Usage: python examples/run_synthetic.py [--frames 60] [--loop]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import time

import numpy as np


def main():
    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--loop", action="store_true",
                    help="drive the closed-loop trajectory")
    ap.add_argument("--vga", action="store_true")
    args = ap.parse_args()

    import jax.numpy as jnp
    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import (
        CameraParams, umeyama_alignment)
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, loop_trajectory, make_sequence, orbit_trajectory)
    from active_orb_slam2_tpu.io.trajectory import camera_centers
    from active_orb_slam2_tpu.models.system import System

    if args.vga:
        cam = CameraParams(fx=525., fy=525., cx=319.5, cy=239.5, bf=40.,
                           width=640, height=480)
        orb = OrbConfig()
    else:
        cam = CameraParams(fx=260., fy=260., cx=159.5, cy=119.5, bf=20.8,
                           width=320, height=240)
        orb = OrbConfig(n_features=512, n_levels=4)
    cfg = SlamConfig(camera=cam, orb=orb,
                     tracking=TrackingConfig(th_depth=10.0),
                     map=MapConfig(max_keyframes=64, max_points=16384,
                                   local_ba_keyframes=8,
                                   local_ba_points=2048))
    traj = loop_trajectory(args.frames, radius=2.5) if args.loop \
        else orbit_trajectory(args.frames, step_deg=1.5)
    slam = System(cfg, use_loop_closing=True)

    gt, times = [], []
    for i, (g, d, Twc) in enumerate(make_sequence(
            args.frames, cam, world=default_world(), trajectory=traj)):
        t0 = time.perf_counter()
        slam.track_rgbd(g, d, i / 30.0)
        times.append(time.perf_counter() - t0)
        gt.append(Twc[:3, 3])

    ts, poses = slam.frame_trajectory()
    est = camera_centers(poses)
    _, _, _, _, rmse = umeyama_alignment(
        jnp.array(est), jnp.array(np.stack(gt)), fix_scale=True)
    t_arr = np.array(times[3:])
    print(f"frames: {len(times)}  kfs: {slam.kf_seq}  "
          f"points: {int(np.asarray(slam.map.pt_valid.sum()))}")
    print(f"median track: {np.median(t_arr)*1e3:.1f} ms  "
          f"loops: {slam.n_loops_closed}")
    print(f"ATE RMSE: {float(rmse)*1000:.1f} mm")


if __name__ == "__main__":
    main()
