"""active_orb_slam2_tpu — a SLAM engine written as JAX array programs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``XinkeAE/Active-ORB-SLAM2`` (an ORB-SLAM2 fork with an active-exploration
layer, ICRA'18 "Feature-constrained Active Visual SLAM").

Design stance (see SURVEY.md §7.1):
  * Fixed-shape arena map state (SoA pytrees + validity masks) — no
    pointers, no mutexes; jit-stable shapes throughout.
  * Pure-functional pipeline, host-orchestrated: the reference's four
    OS threads (Tracking | LocalMapping | LoopClosing | Viewer) become
    jitted steps interleaved by a single-threaded orchestrator.
  * Data-dependent algorithms are reformulated mask-wise (fixed-K RANSAC,
    per-cell top-k feature distribution, tiled Hamming matrices).
  * Multi-chip scaling via jax.sharding Mesh + shard_map (distributed
    Schur-complement BA), not translated threads.

Layer map (mirrors SURVEY.md §1):
  geometry/  — L3 math: SE3/Sim3, projection, triangulation, Horn.
  ops/       — L2 vision ops: ORB pyramid/FAST/rBRIEF, matchers (Pallas).
  models/    — L1+L4+L5: map arena, tracking, local mapping, loop
               closing, optimizers, System API.
  parallel/  — distributed BA over device meshes.
  active/    — L7 fork layer: occupancy grid, frontiers, planner.
  io/        — dataset loaders, trajectory savers, PNG decode.
  utils/     — evaluation (ATE/RPE), metrics, profiling.
"""

__version__ = "0.1.0"
