"""Descriptor matching: Hamming kernels + gated association searches.

Array-program redesign of the reference's ``src/ORBmatcher.cc`` [U]:

  * ``DescriptorDistance`` (bit-twiddle popcount, ~L1590) -> two forms:
    an exact ``lax.population_count`` path, and the matmul path — unpack
    bits to ±1 bfloat16 and compute the whole [M, N] distance matrix as
    one matmul:  hamming = (256 - <a, b>) / 2.  Products are ±1 and the
    f32 accumulation is exact, so this is bit-exact with popcount
    (SURVEY.md §2.5 'matcher distance matrices').  Which of the two is
    faster on the GPU: not measured.
  * ``SearchByProjection`` overloads (~4 variants) -> one masked dense
    distance matrix with projection-radius / scale-level / threshold
    gates.  The reference walks a 64x48 per-frame grid to prune; here
    the dense masked matrix replaces the grid walk.
  * rotation-consistency histogram (HISTO_LENGTH=30, keep top-3 bins).

Constants TH_LOW=50, TH_HIGH=100 and the 0.6-0.9 ratio tests match the
reference call sites.
"""

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INF = jnp.float32(1e9)


def pm_descriptors(desc_u32):
    """Unpack packed descriptors [N, 8] uint32 -> ±1 bfloat16 [N, 256].

    The matmul-side representation: bit b -> (2b - 1).
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc_u32[..., :, None] >> shifts[None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc_u32.shape[:-1] + (256,))
    return (2.0 * bits.astype(jnp.float32) - 1.0).astype(jnp.bfloat16)


def hamming_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """All-pairs Hamming distances [M, N] (float32, exact integers).

    Inputs are packed uint32 [., 8].  Invalid rows/cols get +INF.
    """
    a = pm_descriptors(desc_a)
    b = pm_descriptors(desc_b)
    dot = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    d = 0.5 * (256.0 - dot)
    if valid_a is not None:
        d = jnp.where(valid_a[:, None], d, INF)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, INF)
    return d


def hamming_popcount(desc_a, desc_b):
    """Exact popcount Hamming for [., 8] uint32 pairs (row-wise),
    the oracle/low-volume path (reference DescriptorDistance [U])."""
    x = desc_a ^ desc_b
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def _best_two(d):
    """Row-wise (best, second, argbest) of a distance matrix."""
    neg, idx = jax.lax.top_k(-d, 2)
    return -neg[..., 0], -neg[..., 1], idx[..., 0]


def match_mutual(d, max_dist: float = TH_LOW, ratio: float = 1.0):
    """Mutual-best match with ratio test on a gated distance matrix.

    Returns (match_idx [M] int32 into columns, -1 if none; dist [M]).
    Mirrors the reference's best/second-best + cross-check discipline.
    """
    best, second, jbest = _best_two(d)
    col_best_i = jnp.argmin(d, axis=0)                     # [N]
    mutual = col_best_i[jbest] == jnp.arange(d.shape[0])
    ok = (best <= max_dist) & (best < ratio * second) & mutual
    return jnp.where(ok, jbest, -1), best


def search_by_projection(proj_uv, radii, pred_level, query_desc, query_valid,
                         feats_uv, feats_level, feats_desc, feats_valid,
                         max_dist: float = TH_HIGH, ratio: float = 1.0,
                         level_window: int = 1):
    """Projection-gated association (reference SearchByProjection [U]).

    Args:
      proj_uv [M, 2]: projected map points;  radii [M]: per-point search
      radius in px (already scale-multiplied, th=15/7/1 per call site);
      pred_level [M]: predicted octave; query_desc [M, 8].
      feats_*: the frame's OrbFeatures fields [N, ...].
    Returns (match_idx [M] int32 into frame features, dist [M]).
    """
    d = hamming_matrix(query_desc, feats_desc, query_valid, feats_valid)
    du = proj_uv[:, 0:1] - feats_uv[None, :, 0]
    dv = proj_uv[:, 1:2] - feats_uv[None, :, 1]
    within = (du * du + dv * dv) <= (radii[:, None] * radii[:, None])
    lv_ok = (jnp.abs(feats_level[None, :] - pred_level[:, None])
             <= level_window)
    d = jnp.where(within & lv_ok, d, INF)
    return match_mutual(d, max_dist=max_dist, ratio=ratio)


def rotation_consistency_mask(angle_q, angle_t, match_idx):
    """Keep only matches whose angle difference falls in the 3 most
    populated of 30 orientation-histogram bins (reference
    ``ComputeThreeMaxima`` discipline [U]).

    Args:
      angle_q [M]: query feature angles; angle_t [N]: target angles;
      match_idx [M]: target index per query (-1 = unmatched).
    Returns bool [M] keep-mask (False where unmatched).
    """
    matched = match_idx >= 0
    rot = angle_q - angle_t[jnp.clip(match_idx, 0)]
    rot = jnp.mod(rot, 2.0 * jnp.pi)
    binw = 2.0 * jnp.pi / HISTO_LENGTH
    bin_id = jnp.clip((rot / binw).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bin_id].add(
        matched.astype(jnp.int32))
    top3 = jax.lax.top_k(hist, 3)[0]
    # bin must be among the top-3 counts, and (reference rule) bins 2/3
    # are dropped when under 10% of the max bin
    in_top3 = hist[bin_id] >= top3[2]
    big_enough = hist[bin_id].astype(jnp.float32) >= 0.1 * top3[0]
    return matched & in_top3 & big_enough
