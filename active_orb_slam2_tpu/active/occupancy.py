"""Occupancy-grid mapping from the sparse SLAM map.

The fork publishes a ``nav_msgs/OccupancyGrid`` built by ray-casting
from each keyframe origin through each observed map point (SURVEY.md
§2.4): free cells along the ray, occupied at the endpoint, rebuilt as
the map deforms.  Fixed-shape form: ALL (keyframe, point) observation
rays at once — S samples per ray scattered into free/occupied counters.

Grid convention follows ROS: int8, -1 unknown, 0 free, 100 occupied.
The grid plane is x-z (camera ground plane).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.geometry.se3 import quat_conj, quat_rotate
from active_orb_slam2_tpu.models.map_state import MapState

UNKNOWN = -1
FREE = 0
OCCUPIED = 100


class GridSpec2D(NamedTuple):
    origin_x: float      # world x of cell (0, 0) corner
    origin_z: float
    resolution: float    # metres / cell
    width: int           # cells along x
    height: int          # cells along z


def build_occupancy_grid(spec: GridSpec2D, n_ray_samples: int = 48):
    """Compile (m: MapState) -> grid [height, width] int8."""

    @jax.jit
    def occupancy(m: MapState):
        K, F = m.kf_point.shape
        # keyframe origins (world)
        ow = -quat_rotate(quat_conj(m.kf_pose[:, :4]), m.kf_pose[:, 4:7])
        pt = jnp.clip(m.kf_point, 0)
        obs = (m.kf_point >= 0) & m.kf_valid[:, None] & m.pt_valid[pt]
        ends = m.pt_xyz[pt]                              # [K, F, 3]
        starts = jnp.broadcast_to(ow[:, None], ends.shape)

        # 2-D (x, z) rays, S samples strictly inside + endpoint
        s = (jnp.arange(n_ray_samples) + 0.5) / (n_ray_samples + 1.0)
        ray = starts[None] + s[:, None, None, None] * (ends - starts)[None]
        rx = ray[..., 0].ravel()
        rz = ray[..., 2].ravel()
        w_free = jnp.broadcast_to(obs[None], (n_ray_samples, K, F)).ravel()

        def cell_idx(x, z):
            cx = jnp.floor((x - spec.origin_x) / spec.resolution)
            cz = jnp.floor((z - spec.origin_z) / spec.resolution)
            inb = ((cx >= 0) & (cx < spec.width)
                   & (cz >= 0) & (cz < spec.height))
            flat = jnp.clip(cz, 0, spec.height - 1) * spec.width \
                + jnp.clip(cx, 0, spec.width - 1)
            return flat.astype(jnp.int32), inb

        n_cells = spec.width * spec.height
        fi, f_ok = cell_idx(rx, rz)
        free = jnp.zeros(n_cells).at[fi].add(
            (w_free & f_ok).astype(jnp.float32))
        ei, e_ok = cell_idx(ends[..., 0].ravel(), ends[..., 2].ravel())
        occ = jnp.zeros(n_cells).at[ei].add(
            (obs.ravel() & e_ok).astype(jnp.float32))

        grid = jnp.full(n_cells, UNKNOWN, jnp.int8)
        grid = jnp.where(free >= 2.0, jnp.int8(FREE), grid)
        grid = jnp.where(occ >= 2.0, jnp.int8(OCCUPIED), grid)
        return grid.reshape(spec.height, spec.width)

    return occupancy
