#!/usr/bin/env python
"""RGB-D SLAM on a TUM sequence (reference: Examples/RGB-D/rgbd_tum.cc).

Usage:
  python examples/run_tum_rgbd.py <sequence_dir> [--settings TUM1.yaml]
      [--traj CameraTrajectory.txt] [--kf-traj KeyFrameTrajectory.txt]
      [--max-frames N] [--no-loop-closing] [--ate]

Prints per-frame timing stats at exit like the reference examples
(median/mean tracking time) plus a JSONL metrics stream.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import json
import sys
import time

import numpy as np


def main():
    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None,
                    help="reference-format YAML (TUM1.yaml etc.)")
    ap.add_argument("--traj", default="CameraTrajectory.txt")
    ap.add_argument("--kf-traj", default="KeyFrameTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--ate", action="store_true",
                    help="evaluate ATE against groundtruth.txt")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    args = ap.parse_args()

    from active_orb_slam2_tpu.config import SlamConfig, load_settings
    from active_orb_slam2_tpu.io.datasets import TumRgbdDataset
    from active_orb_slam2_tpu.models.system import System

    if args.settings:
        cfg = load_settings(args.settings, sensor="rgbd")
    else:
        cfg = SlamConfig(sensor="rgbd")

    ds = TumRgbdDataset(args.sequence,
                        depth_factor=cfg.tracking.depth_map_factor)
    slam = System(cfg, use_loop_closing=not args.no_loop_closing)

    times = []
    for i, (t, gray, depth_mm) in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        t0 = time.perf_counter()
        slam.track_rgbd(gray, depth_mm, t)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            m = slam.metrics[-1] if slam.metrics else {}
            print(f"frame {i}/{len(ds)} state={slam.state} "
                  f"kfs={slam.kf_seq} inliers={m.get('n_inliers', 0)}",
                  file=sys.stderr)

    slam.save_trajectory_tum(args.traj)
    slam.save_keyframe_trajectory_tum(args.kf_traj)
    if args.metrics:
        with open(args.metrics, "w") as f:
            for m in slam.metrics:
                f.write(json.dumps(m) + "\n")

    ts = np.array(times[2:])
    print(f"frames: {len(times)}  median track: {np.median(ts)*1e3:.1f} ms"
          f"  mean: {ts.mean()*1e3:.1f} ms  loops: {slam.n_loops_closed}")

    if args.ate:
        from active_orb_slam2_tpu.utils.evaluate import evaluate_ate_tum
        rmse = evaluate_ate_tum(slam, ds.groundtruth())
        print(f"ATE RMSE: {rmse:.4f} m")


if __name__ == "__main__":
    main()
