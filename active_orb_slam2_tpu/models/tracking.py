"""Per-frame tracking: motion-model matching, pose optimization, local-map
tracking, and keyframe insertion.

Array-program redesign of the reference's ``src/Tracking.cc`` front end
(SURVEY.md §3.2 call stack).  The ``Track()`` state machine's heavy
stages are three jitted fixed-shape steps:

  * :func:`build_track_step` — ``TrackWithMotionModel`` (~L780) +
    ``TrackLocalMap`` (~L850): projection-gated matching against the
    point arena, two pose optimizations, visibility counters.
  * :func:`build_create_keyframe` — ``CreateNewKeyFrame`` (~L1100):
    write the frame into a free KF slot, synthesize close points from
    depth (RGB-D/stereo).
  * ``StereoInitialization`` (~L510) is create_keyframe on an empty map.

Host-side control (lost/OK branching, keyframe decision) reads a few
scalars per frame; everything data-parallel stays on device.

Matching policy notes vs the reference: the motion-model search matches
map-point consensus descriptors (pt_desc) rather than last-frame feature
descriptors, and local-KF voting runs over the forward store kf_point —
both reformulations keep the same association semantics with fixed
shapes.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.config import SlamConfig
from active_orb_slam2_tpu.geometry.projection import (
    in_frustum, predict_scale, project_stereo)
from active_orb_slam2_tpu.geometry.se3 import (
    se3_apply, se3_compose, se3_identity, se3_inverse, quat_rotate, quat_conj)
from active_orb_slam2_tpu.models.frame import FrameData
from active_orb_slam2_tpu.models.map_state import MapState, allocate_slots
from active_orb_slam2_tpu.ops.pose_opt_kernel import select_pose_optimization
from active_orb_slam2_tpu.ops.matching import (
    search_by_projection, rotation_consistency_mask)


# retired-stats vector layout (track_step's packed per-frame scalars):
# [0] motion-stage inliers  [1] local-stage inliers  [2] tracking ok
# [3] close tracked         [4] close unmatched      [5] n associations
# [6] inserted KF slot (-1) [7] reference-KF slot
# [8:15] frame pose Tcw     [15:22] reference-KF pose Tcw
# [22] reference-KF frame id (generation tag: a slot can be culled AND
#      recycled while this frame is still in the device pipeline; the
#      host must not compose the record against the new tenant's pose)
STATS_POSE = slice(8, 15)
STATS_REF_POSE = slice(15, 22)
STATS_REF_FID = 22
STATS_LEN = 23


class TrackState(NamedTuple):
    """Carried between frames (the reference's Tracking members).

    The keyframe-decision state (frames-since-KF counter, reference-KF
    inlier count, last KF slot, monotone KF counter, frame id) lives ON
    DEVICE so ``NeedNewKeyFrame`` + ``CreateNewKeyFrame`` execute
    inside the fused per-frame program with ZERO staleness — the
    round-3 profiling showed host-side keyframe decisions lag the
    device by the retirement-batch depth, which starves the map on
    fast motion.  The host state machine mirrors these counters from
    the retired stats (boundedly stale, like the reference's mapping
    thread view).
    """
    pose: jnp.ndarray        # [7] Tcw of last tracked frame
    velocity: jnp.ndarray    # [7] Tcw_k (Tcw_{k-1})^-1 constant-velocity model
    vel_ok: jnp.ndarray      # bool — velocity meaningful
    assoc: jnp.ndarray       # [F] int32 feature->point of last frame
    angle: jnp.ndarray       # [F] last frame's keypoint orientations
    n_inliers: jnp.ndarray   # int32
    ok: jnp.ndarray          # bool — tracking good
    frame_id: jnp.ndarray    # int32 — id of the NEXT frame to track
    kf_seq: jnp.ndarray      # int32 — monotone keyframe counter
    last_kf_slot: jnp.ndarray     # int32 — newest KF slot (-1 none)
    last_kf_inliers: jnp.ndarray  # int32 — its inlier count at insert
    frames_since_kf: jnp.ndarray  # int32
    # temporal points (``Tracking::UpdateLastFrame`` ~L780 [U]): the
    # last frame's close depth features backprojected to world — in
    # localization-only mode the motion stage matches these alongside
    # the map points so tracking survives away from mapped regions
    # (the reference's mlpTemporalPoints; round-3 verdict Missing 4).
    # Index space = last frame's features, same as ``assoc``/``angle``.
    tmp_xyz: jnp.ndarray      # [F, 3] world positions
    tmp_desc: jnp.ndarray     # [F, 8] uint32 descriptors
    tmp_max_dist: jnp.ndarray  # [F] scale-invariance far bound
    tmp_ok: jnp.ndarray       # [F] bool — has usable close depth


def init_track_state(n_features: int) -> TrackState:
    return TrackState(
        pose=se3_identity(),
        velocity=se3_identity(),
        vel_ok=jnp.array(False),
        assoc=jnp.full((n_features,), -1, jnp.int32),
        angle=jnp.zeros((n_features,), jnp.float32),
        n_inliers=jnp.array(0, jnp.int32),
        ok=jnp.array(False),
        frame_id=jnp.array(0, jnp.int32),
        kf_seq=jnp.array(0, jnp.int32),
        last_kf_slot=jnp.array(-1, jnp.int32),
        last_kf_inliers=jnp.array(0, jnp.int32),
        frames_since_kf=jnp.array(0, jnp.int32),
        tmp_xyz=jnp.zeros((n_features, 3), jnp.float32),
        tmp_desc=jnp.zeros((n_features, 8), jnp.uint32),
        tmp_max_dist=jnp.zeros((n_features,), jnp.float32),
        tmp_ok=jnp.zeros((n_features,), bool),
    )


def _scale_radius(level, base):
    return base * (1.2 ** level.astype(jnp.float32))


def _match_candidates(cam, pose, xyz, desc, max_dist_bound, cand_ok,
                      frame: FrameData, radius_base, ratio,
                      max_dist, already, query_angle=None):
    """Project explicit candidate arrays and associate to frame features.

    xyz [C, 3] world, desc [C, 8], max_dist_bound [C] scale far bound,
    cand_ok [C] bool.  ``already`` [F] marks features that must not be
    re-matched.  ``query_angle`` [C] (optional): per-candidate reference
    keypoint orientations — when given, the HISTO_LENGTH rotation-
    consistency filter is applied exactly like the reference's
    motion-model SearchByProjection(Frame&, Frame&)
    (src/ORBmatcher.cc [U]); the local-map overload has no orientation
    check, matching the reference, so the local stage passes None.
    Returns (idx [C] int32 candidate->frame-feature or -1, ok [C]).
    """
    uvr, z = project_stereo(cam, se3_apply(pose, xyz))
    pred_lv = predict_scale(
        jnp.linalg.norm(xyz - _cam_center(pose)[None], axis=-1),
        max_dist_bound, 1.2, 8)
    x0, x1, y0, y1 = cam.bounds()    # undistorted image bounds [U]
    in_img = ((z > 0.2) & (uvr[:, 0] >= x0) & (uvr[:, 0] < x1)
              & (uvr[:, 1] >= y0) & (uvr[:, 1] < y1))
    ok = cand_ok & in_img
    radii = _scale_radius(pred_lv, radius_base)
    feat_free = frame.valid & ~already
    idx, dist = search_by_projection(
        uvr[:, :2], radii, pred_lv,
        desc, ok,
        frame.uv, frame.level, frame.desc, feat_free,
        max_dist=max_dist, ratio=ratio)
    if query_angle is not None:
        keep = rotation_consistency_mask(query_angle, frame.angle, idx)
        idx = jnp.where(keep, idx, -1)
    return jnp.where(ok, idx, -1), ok


def _match_against_points(cam, pose, m: MapState, cand_idx, cand_ok,
                          frame: FrameData, radius_base, ratio,
                          max_dist, already, query_angle=None):
    """Map-point overload of :func:`_match_candidates`: gathers the
    candidate arrays from the arena and scatters the matches back to a
    per-feature point-slot association.  Returns (assoc [F], ok [C])."""
    idx, ok = _match_candidates(
        cam, pose, m.pt_xyz[cand_idx], m.pt_desc[cand_idx],
        m.pt_max_dist[cand_idx], cand_ok, frame, radius_base, ratio,
        max_dist, already, query_angle=query_angle)
    # scatter: feature -> point slot
    assoc = jnp.full((frame.uv.shape[0],), -1, jnp.int32)
    src = jnp.where((idx >= 0) & ok, cand_idx, -1)
    assoc = assoc.at[jnp.clip(idx, 0)].max(src)
    return assoc, ok


def _cam_center(pose):
    return -quat_rotate(quat_conj(pose[:4]), pose[4:7])


def _pose_opt_from_assoc(pose_opt, cam, pose0, m: MapState,
                         frame: FrameData, assoc):
    """Motion-only BA over the current feature->point associations."""
    matched = (assoc >= 0) & frame.valid
    pt = jnp.clip(assoc, 0)
    pw = m.pt_xyz[pt]
    obs_uvr = jnp.concatenate([frame.uv, frame.ur[:, None]], axis=-1)
    has_stereo = frame.ur > 0
    res = pose_opt(cam, pose0, pw, obs_uvr, frame.level,
                   has_stereo, matched & m.pt_valid[pt])
    return res


def build_track_step(cfg: SlamConfig, local_cand: int = 2048):
    """Compile the per-frame tracking step WITH the fused keyframe
    decision + insertion.

    Returns jitted fn: (m, frame, st, allow_kf) -> (new_st, stats, m')
    where ``allow_kf`` (traced bool) gates NeedNewKeyFrame (host turns
    it off in localization-only mode / mapping-off benches) and stats
    packs the per-frame scalars including the inserted KF slot (-1 if
    none) for the host state machine.
    """
    cam = cfg.camera
    tcfg = cfg.tracking
    create_kf_fn = make_create_keyframe_fn(cfg)
    kf_min = max(tcfg.kf_min_interval, 1)
    max_kf = cfg.map.max_keyframes
    pose_opt = select_pose_optimization()

    @jax.jit
    def track_step(m: MapState, frame: FrameData, st: TrackState,
                   allow_kf=False, loc_mode=False):
        pred = jnp.where(st.vel_ok, se3_compose(st.velocity, st.pose),
                         st.pose)

        # ---- motion-model stage: re-find last frame's points -------------
        # Candidates are indexed by LAST-frame feature f: the map point
        # st.assoc[f], or — in localization-only mode — the temporal
        # point backprojected from f's depth (UpdateLastFrame's
        # mlpTemporalPoints [U]), which shares f's descriptor/angle.
        F = st.assoc.shape[0]
        prev_pts = jnp.where((st.assoc >= 0), st.assoc, 0)
        map_ok = (st.assoc >= 0) & m.pt_valid[prev_pts]
        use_tmp = loc_mode & st.tmp_ok & ~map_ok
        cand_xyz = jnp.where(use_tmp[:, None], st.tmp_xyz,
                             m.pt_xyz[prev_pts])
        cand_desc = jnp.where(use_tmp[:, None], st.tmp_desc,
                              m.pt_desc[prev_pts])
        cand_maxd = jnp.where(use_tmp, st.tmp_max_dist,
                              m.pt_max_dist[prev_pts])
        idx1, cok = _match_candidates(
            cam, pred, cand_xyz, cand_desc, cand_maxd,
            map_ok | use_tmp, frame,
            radius_base=15.0, ratio=tcfg.nn_ratio_motion,
            max_dist=100.0, already=jnp.zeros_like(frame.valid),
            query_angle=st.angle)
        matched_c = (idx1 >= 0) & cok
        # scatter to current features: map-point slots and (separately)
        # temporal candidate rows — temporal matches never enter the
        # map association, only the motion-only pose optimization
        assoc1 = jnp.full((F,), -1, jnp.int32).at[
            jnp.clip(idx1, 0)].max(
                jnp.where(matched_c & ~use_tmp, prev_pts, -1))
        tmp_src = jnp.full((F,), -1, jnp.int32).at[
            jnp.clip(idx1, 0)].max(
                jnp.where(matched_c & use_tmp,
                          jnp.arange(F, dtype=jnp.int32), -1))
        tmp_src = jnp.where(assoc1 >= 0, -1, tmp_src)
        pw1 = jnp.where((tmp_src >= 0)[:, None],
                        st.tmp_xyz[jnp.clip(tmp_src, 0)],
                        m.pt_xyz[jnp.clip(assoc1, 0)])
        obs_uvr1 = jnp.concatenate([frame.uv, frame.ur[:, None]], -1)
        valid1 = ((assoc1 >= 0) | (tmp_src >= 0)) & frame.valid
        res1 = pose_opt(
            cam, pred, pw1, obs_uvr1, frame.level, frame.ur > 0, valid1)
        # TrackReferenceKeyFrame-style fallback (reference ~L730 [U]):
        # if the motion-model stage collapses, discard its pose and
        # associations and let the local-map stage search wide from the
        # LAST frame's pose (the reference restarts from mLastFrame.mTcw,
        # not the velocity prediction that just failed).
        mm_ok = res1.n_inliers >= tcfg.min_inliers_track
        assoc1 = jnp.where(mm_ok & res1.inliers, assoc1, -1)
        pose = jnp.where(mm_ok, res1.pose, st.pose)
        # reference doubles the search window when the first pass fails
        # (SearchByProjection th=15 -> 2x, ~L800 [U]); our equivalent is
        # a wide local-stage radius
        local_radius = jnp.where(mm_ok, 4.0, 25.0)

        # ---- local-map stage --------------------------------------------
        # vote for local KFs through the forward observation store.
        # On motion-stage collapse assoc1 is all -1, so the vote source
        # falls back to the PREVIOUS frame's associations (st.assoc,
        # read before the clearing above) — otherwise the local-KF vote
        # would be empty and the wide search would have no candidates,
        # guaranteeing LOST (the round-3 dead-fallback bug).
        vote_src = jnp.where(mm_ok, assoc1, st.assoc)
        vote_mask_p = jnp.zeros((m.max_points,), bool).at[
            jnp.clip(vote_src, 0)].max(vote_src >= 0)
        matched_mask_p = jnp.zeros((m.max_points,), bool).at[
            jnp.clip(assoc1, 0)].max(assoc1 >= 0)
        obs_pt = jnp.clip(m.kf_point, 0)
        votes = jnp.sum(
            jnp.where((m.kf_point >= 0) & vote_mask_p[obs_pt]
                      & m.kf_valid[:, None], 1, 0), axis=1)   # [K]
        nloc = min(tcfg.max_local_keyframes, m.max_keyframes)
        vote_w, local_kf = jax.lax.top_k(votes, nloc)
        local_kf_ok = vote_w > 0

        # local point set: points observed by local KFs
        lk_points = jnp.clip(m.kf_point[local_kf], 0)         # [L, F]
        lk_obs = (m.kf_point[local_kf] >= 0) & local_kf_ok[:, None]
        local_mask = jnp.zeros((m.max_points,), bool).at[
            lk_points.ravel()].max(lk_obs.ravel())
        local_mask &= m.pt_valid

        # frustum cull + visibility counting
        vis, uv, z, dist, vcos = in_frustum(
            cam, pose, m.pt_xyz, m.pt_normal, m.pt_min_dist, m.pt_max_dist)
        cand_mask = local_mask & vis & ~matched_mask_p
        visible_mask = local_mask & vis

        # gather top-C candidates: top_k on the mask selects the C
        # lowest-index True entries (ties break by index), same set as
        # a stable argsort at a fraction of the sort cost
        _, cand_idx = jax.lax.top_k(cand_mask.astype(jnp.int32),
                                    local_cand)
        cand_ok = cand_mask[cand_idx]
        already = (assoc1 >= 0)
        assoc2, _ = _match_against_points(
            cam, pose, m, cand_idx, cand_ok, frame,
            radius_base=local_radius, ratio=tcfg.nn_ratio_local,
            max_dist=float(tcfg.th_high), already=already)
        assoc = jnp.where(assoc1 >= 0, assoc1, assoc2)

        res2 = _pose_opt_from_assoc(pose_opt, cam, pose, m, frame, assoc)
        assoc = jnp.where(res2.inliers, assoc, -1)
        pose = res2.pose

        found_mask = jnp.zeros((m.max_points,), bool).at[
            jnp.clip(assoc, 0)].max(assoc >= 0)

        velocity = se3_compose(pose, se3_inverse(st.pose))
        # localization-only mode survives on temporal points when the
        # map is out of view (the reference's mbVO visual-odometry
        # state, Tracking::Track ~L300 [U]): the motion stage counts
        # temporal inliers, so >= 20 there keeps tracking OK even with
        # too few map inliers
        ok = (res2.n_inliers >= tcfg.min_inliers_local) \
            | (loc_mode & (res1.n_inliers >= 20))
        # refresh the temporal-point ring from THIS frame's close depth
        # (UpdateLastFrame synthesizes points closer than ThDepth [U])
        Twc = se3_inverse(pose)
        t_z = frame.depth
        t_x = (frame.uv[:, 0] - cam.cx) / cam.fx * t_z
        t_y = (frame.uv[:, 1] - cam.cy) / cam.fy * t_z
        tmp_pw = se3_apply(Twc, jnp.stack([t_x, t_y, t_z], axis=-1))
        tmp_dist = jnp.linalg.norm(tmp_pw - _cam_center(pose)[None],
                                   axis=-1)
        new_st = st._replace(
            pose=pose, velocity=velocity,
            vel_ok=st.ok,
            assoc=assoc,
            angle=frame.angle,
            n_inliers=res2.n_inliers,
            ok=ok,
            tmp_xyz=tmp_pw,
            tmp_desc=frame.desc,
            tmp_max_dist=tmp_dist * (
                1.2 ** frame.level.astype(jnp.float32)),
            tmp_ok=frame.valid & (frame.depth > 0.1)
            & (frame.depth < tcfg.th_depth),
        )
        # visibility counters folded in (MapPoint::IncreaseVisible/Found)
        # — only the two counter arrays change, other map fields alias
        m_out = m._replace(
            pt_visible=m.pt_visible + visible_mask.astype(jnp.int32),
            pt_found=m.pt_found + found_mask.astype(jnp.int32))

        # ---- fused NeedNewKeyFrame + CreateNewKeyFrame ------------------
        # (Tracking::NeedNewKeyFrame ~L1010 [U], evaluated ON DEVICE so
        # insertion has zero staleness regardless of how deep the host
        # pipelines retirement)
        close = frame.valid & (frame.depth > 0.1) \
            & (frame.depth < tcfg.th_depth)
        close_tracked = (close & (assoc >= 0)).sum()
        close_unmatched = (close & (assoc < 0)).sum()
        since = st.frames_since_kf + 1
        live = m.kf_valid.sum()
        weak = res2.n_inliers < tcfg.kf_ref_ratio * jnp.maximum(
            st.last_kf_inliers, 1)
        need_close = (close_tracked < 100) & (close_unmatched > 70)
        need = (ok & allow_kf
                & (since >= kf_min)
                & (live < max_kf)
                & ((since >= tcfg.kf_max_interval)
                   | ((weak | need_close) & (res2.n_inliers > 15))))

        def insert(mm):
            m2, k, okk = create_kf_fn(mm, frame, pose, assoc,
                                      st.frame_id, st.kf_seq,
                                      st.last_kf_slot)
            return m2, jnp.where(okk, k, -1)

        def no_insert(mm):
            return mm, jnp.int32(-1)

        m_out, kf_slot = jax.lax.cond(need, insert, no_insert, m_out)
        inserted = kf_slot >= 0

        new_st = new_st._replace(
            frame_id=st.frame_id + 1,
            kf_seq=st.kf_seq + inserted.astype(jnp.int32),
            last_kf_slot=jnp.where(inserted, kf_slot, st.last_kf_slot),
            last_kf_inliers=jnp.where(inserted, res2.n_inliers,
                                      st.last_kf_inliers),
            frames_since_kf=jnp.where(inserted, 0, since),
        )

        # packed per-frame scalars + pose + ref-KF pose -> ONE
        # device->host pull for everything the host needs (metrics,
        # LOST detection, mapping/loop triggers, trajectory record)
        ref_slot = jnp.maximum(new_st.last_kf_slot, 0)
        stats = jnp.concatenate([jnp.stack([
            res1.n_inliers.astype(jnp.float32),
            res2.n_inliers.astype(jnp.float32),
            ok.astype(jnp.float32),
            close_tracked.astype(jnp.float32),
            close_unmatched.astype(jnp.float32),
            (assoc >= 0).sum().astype(jnp.float32),
            kf_slot.astype(jnp.float32),
            new_st.last_kf_slot.astype(jnp.float32),
        ]), pose, m_out.kf_pose[ref_slot],
            m_out.kf_frame_id[ref_slot].astype(jnp.float32)[None]])
        return new_st, stats, m_out

    return track_step


def make_create_keyframe_fn(cfg: SlamConfig, max_new_points: int = 512):
    """The pure (un-jitted) CreateNewKeyFrame body — used standalone by
    :func:`build_create_keyframe` (host init paths) AND traced into the
    fused per-frame step's lax.cond branch (device-side insertion).

    (m, frame, pose, assoc, frame_id, kf_seq, parent) ->
      (m, kf_slot, ok)
    """
    cam = cfg.camera
    close_depth = cfg.tracking.th_depth
    # a frame can contribute at most n_features new points; small
    # configs (n_features < 512) would otherwise broadcast-mismatch in
    # the rank gate below
    max_new_points = min(max_new_points, cfg.orb.n_features)

    def create_keyframe(m: MapState, frame: FrameData, pose, assoc,
                        frame_id, kf_seq, parent):
        kf_slots, kf_ok = allocate_slots(m.kf_valid, 1)
        k = kf_slots[0]
        ok = kf_ok[0]

        # new map points from depth: unmatched valid features with
        # usable depth (CreateNewKeyFrame's close-point synthesis [U]).
        # Reference rule: create all points closer than ThDepth, but if
        # fewer than 100 are close, take the 100 closest regardless.
        new_src = frame.valid & (assoc < 0) & (frame.depth > 0.1)
        order = jnp.argsort(jnp.where(new_src, frame.depth, jnp.inf),
                            stable=True)[:max_new_points]
        rank = jnp.arange(max_new_points)
        src_ok = new_src[order] & (
            (frame.depth[order] < close_depth) | (rank < 100))
        pt_slots, pt_free = allocate_slots(m.pt_valid, max_new_points)
        create = src_ok & pt_free & ok

        f_uv = frame.uv[order]
        f_depth = frame.depth[order]
        x = (f_uv[:, 0] - cam.cx) / cam.fx * f_depth
        y = (f_uv[:, 1] - cam.cy) / cam.fy * f_depth
        pc = jnp.stack([x, y, f_depth], axis=-1)
        Twc = se3_inverse(pose)
        pw = se3_apply(Twc, pc)
        ow = _cam_center(pose)
        vec = pw - ow[None]
        dist = jnp.linalg.norm(vec, axis=-1)
        normal = vec / jnp.maximum(dist[:, None], 1e-9)
        lv = frame.level[order].astype(jnp.float32)
        max_d = dist * (1.2 ** lv)
        min_d = max_d / (1.2 ** 7)

        def wr(arr, idx, val, mask):
            return arr.at[idx].set(jnp.where(
                mask.reshape((-1,) + (1,) * (val.ndim - 1)), val, arr[idx]))

        m = m._replace(
            pt_xyz=wr(m.pt_xyz, pt_slots, pw, create),
            pt_desc=wr(m.pt_desc, pt_slots, frame.desc[order], create),
            pt_normal=wr(m.pt_normal, pt_slots, normal, create),
            pt_min_dist=wr(m.pt_min_dist, pt_slots, min_d, create),
            pt_max_dist=wr(m.pt_max_dist, pt_slots, max_d, create),
            pt_valid=m.pt_valid.at[pt_slots].set(
                jnp.where(create, True, m.pt_valid[pt_slots])),
            pt_visible=wr(m.pt_visible, pt_slots,
                          jnp.ones_like(pt_slots), create),
            pt_found=wr(m.pt_found, pt_slots,
                        jnp.ones_like(pt_slots), create),
            pt_first_kf=wr(m.pt_first_kf, pt_slots,
                           jnp.full_like(pt_slots, kf_seq), create),
        )

        # keyframe record: existing assoc + newly created points
        kf_point = assoc
        kf_point = kf_point.at[order].set(
            jnp.where(create, pt_slots, kf_point[order]))
        m = m._replace(
            kf_pose=m.kf_pose.at[k].set(jnp.where(ok, pose, m.kf_pose[k])),
            kf_valid=m.kf_valid.at[k].set(ok | m.kf_valid[k]),
            kf_frame_id=m.kf_frame_id.at[k].set(
                jnp.where(ok, frame_id, m.kf_frame_id[k])),
            kf_uv=m.kf_uv.at[k].set(jnp.where(ok, frame.uv, m.kf_uv[k])),
            kf_ur=m.kf_ur.at[k].set(jnp.where(ok, frame.ur, m.kf_ur[k])),
            kf_level=m.kf_level.at[k].set(
                jnp.where(ok, frame.level, m.kf_level[k])),
            kf_angle=m.kf_angle.at[k].set(
                jnp.where(ok, frame.angle, m.kf_angle[k])),
            kf_desc=m.kf_desc.at[k].set(
                jnp.where(ok, frame.desc, m.kf_desc[k])),
            kf_feat_valid=m.kf_feat_valid.at[k].set(
                jnp.where(ok, frame.valid, m.kf_feat_valid[k])),
            kf_depth=m.kf_depth.at[k].set(
                jnp.where(ok, frame.depth, m.kf_depth[k])),
            kf_point=m.kf_point.at[k].set(
                jnp.where(ok, kf_point, m.kf_point[k])),
            kf_parent=m.kf_parent.at[k].set(
                jnp.where(ok, parent, m.kf_parent[k])),
        )
        return m, k, ok

    return create_keyframe


def build_create_keyframe(cfg: SlamConfig, max_new_points: int = 512):
    """Jitted keyframe insertion (also the RGB-D/stereo initializer)."""
    return jax.jit(make_create_keyframe_fn(cfg, max_new_points))


@jax.jit
def apply_visibility_counters(m: MapState, visible_mask, found_mask
                              ) -> MapState:
    """IncreaseVisible / IncreaseFound (MapPoint culling signals [U])."""
    return m._replace(
        pt_visible=m.pt_visible + visible_mask.astype(jnp.int32),
        pt_found=m.pt_found + found_mask.astype(jnp.int32),
    )
