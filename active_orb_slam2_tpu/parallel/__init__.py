"""Distributed execution: device meshes + sharded Schur-complement BA.

The reference has no distributed computing (SURVEY.md §2.5); this
package is the scaling layer: keyframe/point-partitioned global BA
with the reduced camera system psum'd across devices inside
shard_map.
"""

from active_orb_slam2_tpu.parallel.dist_ba import (  # noqa: F401
    PointEdges, anchor_block_order, build_point_major_edges,
    count_dropped_observations, global_ba, build_distributed_ba,
    inverse_permutation,
)
from active_orb_slam2_tpu.parallel.matcher import (  # noqa: F401
    build_sharded_matcher)
from active_orb_slam2_tpu.parallel.mesh import (  # noqa: F401
    initialize_distributed, make_host_chip_mesh, make_mesh)
