#!/usr/bin/env python
"""Active exploration demo (BASELINE config #5): the SLAM system drives
itself through the synthetic world — frontier goals, feature-safe A*,
replanning, relocalization recovery.

Usage: python examples/run_exploration.py [--steps 15]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np


def main():
    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=15)
    args = ap.parse_args()

    from active_orb_slam2_tpu.active import GridSpec2D
    from active_orb_slam2_tpu.active.explorer import run_exploration
    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import CameraParams
    from active_orb_slam2_tpu.io.synthetic import default_world
    from active_orb_slam2_tpu.models.system import System

    cam = CameraParams(fx=260., fy=260., cx=159.5, cy=119.5, bf=20.8,
                       width=320, height=240)
    cfg = SlamConfig(camera=cam,
                     orb=OrbConfig(n_features=512, n_levels=4),
                     tracking=TrackingConfig(th_depth=10.0),
                     map=MapConfig(max_keyframes=64, max_points=16384,
                                   local_ba_keyframes=8,
                                   local_ba_points=2048))
    slam = System(cfg, use_loop_closing=True)
    spec = GridSpec2D(origin_x=-4.0, origin_z=-4.0, resolution=0.25,
                      width=32, height=32)
    log = run_exploration(slam, default_world(n_boxes=4), spec,
                          n_steps=args.steps, start_xz=(0.0, -2.0))
    print(f"steps: {len(log.positions)}  replans: {log.replans}")
    print(f"coverage: {log.coverage[0]:.3f} -> {log.coverage[-1]:.3f}")
    print(f"map points: {log.n_points[0]} -> {log.n_points[-1]}")
    print(f"keyframes: {slam.kf_seq}  loops: {slam.n_loops_closed}")


if __name__ == "__main__":
    main()
