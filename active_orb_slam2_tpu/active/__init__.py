"""Active exploration layer (L7) — the fork's contribution.

Array-program redesign of the Active-ORB-SLAM2 layer (SURVEY.md §2.4,
reconstructed from the ICRA'18 paper "Feature-constrained Active Visual
SLAM"): occupancy-grid mapping from the sparse map, frontier detection,
feature-visibility (localizability) scoring of candidate viewpoints, a
feature-safe planner, and a simulated-RGB-D replanning loop.
"""

from active_orb_slam2_tpu.active.occupancy import (  # noqa: F401
    GridSpec2D, build_occupancy_grid,
)
from active_orb_slam2_tpu.active.scoring import (  # noqa: F401
    build_visibility_scorer, score_grid_localizability,
)
from active_orb_slam2_tpu.active.frontier import (  # noqa: F401
    frontier_mask, frontier_goals,
)
from active_orb_slam2_tpu.active.planner import astar_plan  # noqa: F401
