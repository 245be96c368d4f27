"""Sharded descriptor matching (SURVEY.md §2.5 TP row: "matcher
distance matrices sharded over descriptor rows").

Bulk matching problems — vocabulary training assignments, map-merge
candidate association, offline loop retrieval over thousands of
keyframes — build [M, N] Hamming matrices that outgrow one chip.  The
query axis is embarrassingly parallel: each device computes its row
block (the ±1 bit-matmul of ops/matching.py) and the row-wise
argmin/mutual checks stay local; only the [M]-sized results gather
back.  No collectives inside the matmul — one gather for the
output.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from active_orb_slam2_tpu.ops.matching import hamming_matrix, _best_two


def build_sharded_matcher(mesh: Mesh, axis: str = "shard",
                          max_dist: float = 50.0, ratio: float = 1.0):
    """Compile (desc_q [M,8], valid_q, desc_t [N,8], valid_t) ->
    (match_idx [M], dist [M]) with the query axis sharded over
    ``mesh``; targets replicated.

    Mutual-best check: each shard computes its rows' best; the column
    side needs the GLOBAL per-column best, obtained with one psum-min
    over the column-best distances — the only collective.
    """
    pspec = P(axis)
    rspec = P()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(pspec, pspec, rspec, rspec),
        out_specs=(pspec, pspec),
        check_vma=False)
    def matcher(dq, vq, dt, vt):
        d = hamming_matrix(dq, dt, vq, vt)            # [M/s, N]
        best, second, jbest = _best_two(d)
        # global column minima across shards (one psum-min each)
        col_best = jnp.min(d, axis=0)                 # [N] shard-local
        col_best = jax.lax.pmin(col_best, axis)
        # mutual: my row's best must BE the global column best
        mutual = best <= col_best[jbest] + 1e-6
        ok = (best <= max_dist) & (best < ratio * second) & mutual
        return jnp.where(ok, jbest, -1), best

    @jax.jit
    def run(desc_q, valid_q, desc_t, valid_t):
        return matcher(desc_q, valid_q, desc_t, valid_t)

    return run
