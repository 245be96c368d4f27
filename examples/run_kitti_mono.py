#!/usr/bin/env python
"""Monocular SLAM on a KITTI odometry sequence
(reference: Examples/Monocular/mono_kitti.cc — loads image_0 +
times.txt, tracks, saves KeyFrameTrajectoryTUM).

Usage:
  python examples/run_kitti_mono.py <kitti_root> <sequence> \
      [--settings KITTI00-02.yaml] [--traj KeyFrameTrajectory.txt]
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
    ap.add_argument("root", help="KITTI odometry root (contains sequences/)")
    ap.add_argument("sequence", help="sequence id, e.g. 00")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--traj", default="KeyFrameTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args()

    from active_orb_slam2_tpu.config import SlamConfig, load_settings
    from active_orb_slam2_tpu.io.datasets import KittiOdometryDataset
    from active_orb_slam2_tpu.models.system import System

    cfg = load_settings(args.settings, sensor="mono") if args.settings \
        else SlamConfig(sensor="mono")
    ds = KittiOdometryDataset(args.root, args.sequence)
    slam = System(cfg, use_loop_closing=True)

    times = []
    for i, (t, left, _right) in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        t0 = time.perf_counter()
        slam.track_mono(left, t)
        times.append(time.perf_counter() - t0)
        if i % 100 == 0:
            print(f"frame {i}/{len(ds)} state={slam.state} "
                  f"kfs={slam.kf_seq}", file=sys.stderr)

    slam.save_keyframe_trajectory_tum(args.traj)
    ts = np.array(times[2:])
    print(f"frames: {len(times)}  median track: {np.median(ts)*1e3:.1f} ms"
          f"  loops: {slam.n_loops_closed}")


if __name__ == "__main__":
    main()
