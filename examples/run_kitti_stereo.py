#!/usr/bin/env python
"""Stereo SLAM on a KITTI odometry sequence
(reference: Examples/Stereo/stereo_kitti.cc).

Usage:
  python examples/run_kitti_stereo.py <kitti_root> <sequence> \
      [--settings KITTI00-02.yaml] [--traj CameraTrajectory.txt]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import sys
import time

import numpy as np


def main():
    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--traj", default="CameraTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-loop-closing", action="store_true")
    args = ap.parse_args()

    from active_orb_slam2_tpu.config import SlamConfig, load_settings
    from active_orb_slam2_tpu.io.datasets import KittiOdometryDataset
    from active_orb_slam2_tpu.models.system import System

    ds = KittiOdometryDataset(args.root, args.sequence)
    if args.settings:
        cfg = load_settings(args.settings, sensor="stereo")
    else:
        cfg = SlamConfig(sensor="stereo")
    slam = System(cfg, use_loop_closing=not args.no_loop_closing)

    times = []
    for i, (t, left, right) in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        t0 = time.perf_counter()
        slam.track_stereo(left, right, t)
        times.append(time.perf_counter() - t0)
        if i % 100 == 0:
            print(f"frame {i}/{len(ds)} state={slam.state} "
                  f"kfs={slam.kf_seq}", file=sys.stderr)

    slam.save_trajectory_kitti(args.traj)
    ts = np.array(times[2:])
    print(f"frames: {len(times)}  median track: {np.median(ts)*1e3:.1f} ms"
          f"  loops: {slam.n_loops_closed}")


if __name__ == "__main__":
    main()
