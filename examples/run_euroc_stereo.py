#!/usr/bin/env python
"""Stereo SLAM on a EuRoC MAV sequence
(reference: Examples/Stereo/stereo_euroc.cc — loads the YAML LEFT/RIGHT
rectification blocks and remaps both images before tracking).

Usage:
  python examples/run_euroc_stereo.py <mav0_dir> \
      [--settings EuRoC.yaml] [--traj CameraTrajectory.txt]

<mav0_dir> is the sequence's ``mav0/`` directory (contains cam0/, cam1/).
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
    ap.add_argument("root", help="sequence mav0/ directory")
    ap.add_argument("--settings", default=None,
                    help="reference-format EuRoC.yaml (with LEFT/RIGHT "
                         "rectification blocks)")
    ap.add_argument("--traj", default="CameraTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-loop-closing", action="store_true")
    args = ap.parse_args()

    from active_orb_slam2_tpu.config import (
        SlamConfig, load_settings, load_rectification)
    from active_orb_slam2_tpu.io.datasets import (
        EurocDataset, stereo_rectify_maps)
    from active_orb_slam2_tpu.models.system import System

    rect = None
    if args.settings:
        cfg = load_settings(args.settings, sensor="stereo")
        blocks = load_rectification(args.settings)
        if blocks is None:
            # reference stereo_euroc.cc aborts when the LEFT/RIGHT
            # rectification blocks are missing; tracking on raw EuRoC
            # images would silently degrade ATE
            sys.exit("ERROR: settings file has no LEFT/RIGHT "
                     "rectification blocks; stereo EuRoC requires them "
                     "(see reference Examples/Stereo/EuRoC.yaml)")
        rect = stereo_rectify_maps(*blocks)
    else:
        cfg = SlamConfig(sensor="stereo")
    ds = EurocDataset(args.root, rectify_maps=rect)
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

    slam.save_trajectory_tum(args.traj)
    ts = np.array(times[2:])
    print(f"frames: {len(times)}  median track: {np.median(ts)*1e3:.1f} ms"
          f"  loops: {slam.n_loops_closed}")


if __name__ == "__main__":
    main()
