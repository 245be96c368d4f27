"""The map arena: fixed-shape SoA state for points, keyframes, and the
observation/covisibility graph.

Replaces the reference's L1 pointer graph — ``MapPoint`` (``src/MapPoint.cc``
[U]), ``KeyFrame`` (``src/KeyFrame.cc`` [U]), ``Map`` (``src/Map.cc`` [U])
and every mutex in them — with one immutable pytree of preallocated
arrays + validity masks (SURVEY.md §7.1).  Growth writes into free
slots; culling clears masks; "UpdateConnections" is a single masked
matmul.

Key representational choice: observations are stored FORWARD, as the
per-keyframe feature->point index map ``kf_point [K, F]`` (-1 = none) —
the exact analog of ``Frame::mvpMapPoints``.  Everything the reference
derives from ``MapPoint::mObservations`` (covisibility weights, point
observer counts, descriptor refresh, normals) is recomputed batch-wise
from this one array, which keeps a single source of truth and makes
'SetBadFlag'-style bookkeeping impossible to get wrong.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.config import MapConfig, OrbConfig
from active_orb_slam2_tpu.geometry.se3 import se3_identity


class MapState(NamedTuple):
    """The whole map as one pytree.  Capacities are static.

    P = max_points, K = max_keyframes, F = n_features.
    """
    # ---- points (MapPoint arena) ----
    pt_xyz: jnp.ndarray        # [P, 3] world position
    pt_desc: jnp.ndarray       # [P, 8] uint32 distinctive descriptor
    pt_normal: jnp.ndarray     # [P, 3] mean viewing direction
    pt_min_dist: jnp.ndarray   # [P] scale-invariance near bound
    pt_max_dist: jnp.ndarray   # [P] scale-invariance far bound
    pt_valid: jnp.ndarray      # [P] bool
    pt_visible: jnp.ndarray    # [P] int32  (IncreaseVisible)
    pt_found: jnp.ndarray      # [P] int32  (IncreaseFound)
    pt_first_kf: jnp.ndarray   # [P] int32  creating KF slot
    # ---- keyframes ----
    kf_pose: jnp.ndarray       # [K, 7] Tcw
    kf_valid: jnp.ndarray      # [K] bool
    kf_frame_id: jnp.ndarray   # [K] int32 source frame id
    kf_uv: jnp.ndarray         # [K, F, 2] undistorted keypoints
    kf_ur: jnp.ndarray         # [K, F] right x-coord (<0 = mono)
    kf_level: jnp.ndarray      # [K, F] int32 octave
    kf_angle: jnp.ndarray      # [K, F] float32
    kf_desc: jnp.ndarray       # [K, F, 8] uint32
    kf_feat_valid: jnp.ndarray  # [K, F] bool
    kf_depth: jnp.ndarray      # [K, F] measured depth (<=0 invalid)
    kf_point: jnp.ndarray      # [K, F] int32 feature->point (-1 none)
    kf_parent: jnp.ndarray     # [K] int32 spanning-tree parent (-1 root)

    @property
    def max_points(self):
        return self.pt_xyz.shape[0]

    @property
    def max_keyframes(self):
        return self.kf_pose.shape[0]

    @property
    def n_features(self):
        return self.kf_uv.shape[1]


def empty_map(map_cfg: MapConfig, orb_cfg: OrbConfig) -> MapState:
    P, K, F = map_cfg.max_points, map_cfg.max_keyframes, orb_cfg.n_features
    return MapState(
        pt_xyz=jnp.zeros((P, 3), jnp.float32),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_normal=jnp.zeros((P, 3), jnp.float32),
        pt_min_dist=jnp.zeros((P,), jnp.float32),
        pt_max_dist=jnp.full((P,), 1e9, jnp.float32),
        pt_valid=jnp.zeros((P,), bool),
        pt_visible=jnp.zeros((P,), jnp.int32),
        pt_found=jnp.zeros((P,), jnp.int32),
        pt_first_kf=jnp.full((P,), -1, jnp.int32),
        kf_pose=jnp.tile(se3_identity()[None], (K, 1)),
        kf_valid=jnp.zeros((K,), bool),
        kf_frame_id=jnp.full((K,), -1, jnp.int32),
        kf_uv=jnp.zeros((K, F, 2), jnp.float32),
        kf_ur=jnp.full((K, F), -1.0, jnp.float32),
        kf_level=jnp.zeros((K, F), jnp.int32),
        kf_angle=jnp.zeros((K, F), jnp.float32),
        kf_desc=jnp.zeros((K, F, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((K, F), bool),
        kf_depth=jnp.zeros((K, F), jnp.float32),
        kf_point=jnp.full((K, F), -1, jnp.int32),
        kf_parent=jnp.full((K,), -1, jnp.int32),
    )


# ------------------------------------------------------------- derived views

def observation_indicator(m: MapState):
    """[K, P] bool: keyframe k observes point p.

    The transpose view of ``MapPoint::mObservations`` — built with one
    scatter from ``kf_point``.
    """
    K, F = m.kf_point.shape
    P = m.max_points
    kf_ids = jnp.broadcast_to(jnp.arange(K)[:, None], (K, F))
    obs = m.kf_point >= 0
    pt = jnp.clip(m.kf_point, 0)
    ind = jnp.zeros((K, P), bool)
    ind = ind.at[kf_ids.ravel(), pt.ravel()].max(obs.ravel())
    return ind & m.kf_valid[:, None] & m.pt_valid[None, :]


def point_observation_count(m: MapState):
    """[P] int32 — MapPoint::Observations() for every point at once."""
    return observation_indicator(m).sum(axis=0).astype(jnp.int32)


def covisibility_weights(m: MapState):
    """[K, K] int32 shared-point counts (KeyFrame::UpdateConnections
    ~L90-170 [U]) — one masked matmul instead of per-KF
    map-walks under mutexes."""
    ind = observation_indicator(m).astype(jnp.bfloat16)
    W = jnp.dot(ind, ind.T, preferred_element_type=jnp.float32)
    W = W.astype(jnp.int32)
    return W * (1 - jnp.eye(m.max_keyframes, dtype=jnp.int32))


def best_covisible(m: MapState, kf_idx, n: int,
                   min_weight: int = 0):
    """Top-n covisible KF slots of ``kf_idx`` (GetBestCovisibilityKeyFrames).

    Returns (idx [n], weights [n]); weight 0 entries are padding.
    """
    W = covisibility_weights(m)
    row = jnp.where(m.kf_valid, W[kf_idx], 0)
    row = jnp.where(jnp.arange(m.max_keyframes) == kf_idx, 0, row)
    row = jnp.where(row >= jnp.maximum(min_weight, 1), row, 0)
    w, idx = jax.lax.top_k(row, n)
    return jnp.where(w > 0, idx, -1), w


def allocate_slots(valid_mask, want: int):
    """Indices of the first ``want`` free slots (stable order).

    Returns (slots [want] int32, ok [want] bool) — ok False where the
    arena is full (caller must mask writes).
    """
    n = valid_mask.shape[0]
    order = jnp.argsort(valid_mask.astype(jnp.int32), stable=True)
    slots = order[:want]
    ok = ~valid_mask[slots]
    return slots.astype(jnp.int32), ok


def update_point_stats(m: MapState) -> MapState:
    """Batch recompute of per-point derived state: distinctive
    descriptor, mean normal, scale-invariance distances.

    Folds ``MapPoint::{ComputeDistinctiveDescriptors, UpdateNormalAndDepth}``
    (``src/MapPoint.cc`` ~L120-240 [U]) into one pass over the
    observation store.  Called after mapping updates, not per-frame.
    """
    from active_orb_slam2_tpu.geometry.se3 import quat_rotate, quat_conj
    K, F = m.kf_point.shape
    P = m.max_points
    obs = (m.kf_point >= 0) & m.kf_valid[:, None]
    pt = jnp.clip(m.kf_point, 0)

    # camera centers  Ow = -R^T t  for all KFs
    ow = -quat_rotate(quat_conj(m.kf_pose[:, :4]), m.kf_pose[:, 4:7])  # [K,3]

    # mean viewing direction: scatter-add unit vectors point<-cam
    vec = m.pt_xyz[pt] - ow[:, None, :]                   # [K, F, 3]
    dist = jnp.linalg.norm(vec, axis=-1)                  # [K, F]
    unit = vec / jnp.maximum(dist[..., None], 1e-9)
    flat_pt = pt.ravel()
    w = obs.ravel().astype(jnp.float32)
    nsum = jnp.zeros((P, 3)).at[flat_pt].add(unit.reshape(-1, 3) * w[:, None])
    cnt = jnp.zeros((P,)).at[flat_pt].add(w)
    normal = nsum / jnp.maximum(cnt[:, None], 1.0)
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    # scale-invariance distances from the reference keyframe = the
    # observation with the max kf slot id (stable, arbitrary-but-fixed
    # choice standing in for mpRefKF)
    slot_score = jnp.where(obs, jnp.arange(K)[:, None], -1)
    flat_score = slot_score.ravel()
    best_obs = jnp.full((P,), -1, jnp.int32).at[flat_pt].max(
        jnp.where(w > 0, flat_score, -1))
    # gather dist & level of that observation: build [P] from scatter-max
    # of (score, dist, level) packed — do it with argmax trick per point:
    # scatter dist/level where slot_score equals per-point max.
    is_ref = (slot_score.ravel() == best_obs[flat_pt]) & (w > 0)
    ref_dist = jnp.zeros((P,)).at[flat_pt].max(
        jnp.where(is_ref, dist.ravel(), 0.0))
    ref_level = jnp.zeros((P,), jnp.int32).at[flat_pt].max(
        jnp.where(is_ref, m.kf_level.ravel(), 0))

    scale = 1.2  # matches OrbConfig.scale_factor default
    level_factor = scale ** ref_level.astype(jnp.float32)
    max_dist = ref_dist * level_factor
    n_levels = 8
    min_dist = max_dist / (scale ** (n_levels - 1))

    # distinctive descriptor: the min-median-Hamming medoid over the
    # point's observations (reference ComputeDistinctiveDescriptors,
    # src/MapPoint.cc ~L120-180 [U]): build capped per-point observer
    # descriptor lists with one sort, then all pairwise Hamming per
    # point as a batched ±1 matmul and a masked median per row.
    med_desc, med_ok = _medoid_descriptors(m)

    has_obs = cnt > 0
    return m._replace(
        pt_normal=jnp.where(has_obs[:, None], normal, m.pt_normal),
        pt_min_dist=jnp.where(has_obs, min_dist, m.pt_min_dist),
        pt_max_dist=jnp.where(has_obs, jnp.maximum(max_dist, 1e-3),
                              m.pt_max_dist),
        pt_desc=jnp.where((has_obs & med_ok)[:, None], med_desc, m.pt_desc),
    )


def point_observer_descriptors(m: MapState, max_obs: int = 12):
    """Capped per-point observer descriptor lists, built from the
    forward store kf_point [K, F] with one sort (jit-safe).

    Returns (desc [P, O, 8] uint32, valid [P, O] bool).  Points with
    more than ``max_obs`` observations keep an arbitrary-but-fixed
    subset (sorted by flat (kf, feat) index, so earliest keyframes win —
    matching the reference's insertion-ordered observation map in
    spirit).
    """
    K, F = m.kf_point.shape
    Pn = m.max_points
    flat_pt = m.kf_point.ravel()
    ok = (flat_pt >= 0) & m.kf_valid.repeat(F) & m.kf_feat_valid.ravel()
    key = jnp.where(ok, flat_pt, Pn)
    order = jnp.argsort(key, stable=True)
    sorted_pt = key[order]
    first = jnp.searchsorted(sorted_pt, jnp.arange(Pn + 1), side="left")
    rank = jnp.arange(K * F) - first[jnp.clip(sorted_pt, 0, Pn)]
    keep = (sorted_pt < Pn) & (rank < max_obs)
    dst_p = jnp.where(keep, sorted_pt, Pn - 1)
    dst_o = jnp.where(keep, rank, 0).astype(jnp.int32)
    src_desc = m.kf_desc.reshape(-1, m.kf_desc.shape[-1])[order]
    desc = jnp.zeros((Pn, max_obs, m.kf_desc.shape[-1]), jnp.uint32)
    desc = desc.at[dst_p, dst_o].max(
        jnp.where(keep[:, None], src_desc, jnp.uint32(0)))
    valid = jnp.zeros((Pn, max_obs), bool).at[dst_p, dst_o].max(keep)
    return desc, valid


def _medoid_descriptors(m: MapState, max_obs: int = 12):
    """Min-median-Hamming medoid descriptor per point (the reference's
    ComputeDistinctiveDescriptors [U]), batched over all points.

    Pairwise Hamming per point is a ±1 matmul
    (bit-exact, see ops/matching.py); the median over the row's valid
    entries (self included, d=0, as in the reference) is a masked sort
    + per-point gather.  Returns (desc [P, 8] uint32, ok [P] bool).
    """
    desc, valid = point_observer_descriptors(m, max_obs=max_obs)
    P, O, _ = desc.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((desc[..., None] >> shifts) & jnp.uint32(1)).reshape(P, O, 256)
    pm = (2.0 * bits.astype(jnp.float32) - 1.0).astype(jnp.bfloat16)
    dot = jnp.einsum("poc,pqc->poq", pm, pm,
                     preferred_element_type=jnp.float32)
    d = 0.5 * (256.0 - dot)                                # [P, O, O]
    big = jnp.float32(1e9)
    d = jnp.where(valid[:, None, :], d, big)               # mask cols
    d_sorted = jnp.sort(d, axis=-1)
    cnt = valid.sum(-1)                                    # [P]
    med_idx = jnp.clip((cnt - 1) // 2, 0)                  # vDists[0.5(N-1)]
    med = jnp.take_along_axis(
        d_sorted, med_idx[:, None, None].astype(jnp.int32), axis=-1)[..., 0]
    med = jnp.where(valid, med, big)                       # mask rows
    best = jnp.argmin(med, axis=-1)                        # first min wins
    out = jnp.take_along_axis(desc, best[:, None, None], axis=1)[:, 0]
    return out, cnt > 0


