"""Relocalization: recover a lost camera from the keyframe database.

Array-program redesign of ``Tracking::Relocalization`` (~L1230-1350 [U]) +
``KeyFrameDatabase::DetectRelocalizationCandidates`` (~L160-250 [U]) +
``PnPsolver`` (``src/PnPsolver.cc`` [U], EPnP-in-RANSAC):

  * candidates: dense BoW scoring against every keyframe (no covis
    exclusion, unlike loop detection);
  * per-candidate SearchByBoW as a dense Hamming matmul;
  * pose hypotheses: the reference's EPnP minimal solver is replaced by
    a batched 6-point DLT (normalized coordinates, [12, 12] eigh per
    hypothesis, SVD re-orthogonalization) — same RANSAC role, fully
    batched on device; all candidates x hypotheses evaluated in one
    vmapped program;
  * winner refined by the standard 4x10 pose optimization and accepted
    at >= 50 inliers, exactly the reference's bar.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.config import SlamConfig
from active_orb_slam2_tpu.geometry.projection import (
    CameraParams, predict_scale)
from active_orb_slam2_tpu.geometry.se3 import mat_to_quat, se3_apply
from active_orb_slam2_tpu.models.map_state import MapState
from active_orb_slam2_tpu.models.optimizer import pose_optimization
from active_orb_slam2_tpu.ops.matching import (
    hamming_matrix, match_mutual, search_by_projection)

CHI2_2D = 5.991


class RelocResult(NamedTuple):
    pose: jnp.ndarray       # [7]
    n_inliers: jnp.ndarray  # int32
    ok: jnp.ndarray         # bool
    assoc: jnp.ndarray      # [F] feature -> point slot (-1)


def _normalize(cam: CameraParams, uv):
    return jnp.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], axis=-1)


def pnp_dlt(pw, xn):
    """6+-point DLT pose from world points [S, 3] and normalized image
    coords [S, 2] -> pose [7] (Tcw).  Batched over leading axes."""
    S = pw.shape[-2]
    zeros = jnp.zeros_like(pw[..., 0])
    ones = jnp.ones_like(zeros)
    X, Y, Z = pw[..., 0], pw[..., 1], pw[..., 2]
    x, y = xn[..., 0], xn[..., 1]
    r1 = jnp.stack([X, Y, Z, ones, zeros, zeros, zeros, zeros,
                    -x * X, -x * Y, -x * Z, -x], axis=-1)
    r2 = jnp.stack([zeros, zeros, zeros, zeros, X, Y, Z, ones,
                    -y * X, -y * Y, -y * Z, -y], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)          # [..., 2S, 12]
    AtA = jnp.einsum('...ji,...jk->...ik', A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    p = vecs[..., :, 0].reshape(A.shape[:-2] + (3, 4))
    M = p[..., :3]
    # scale and chirality: make det(R) > 0 and points in front
    detM = jnp.linalg.det(M)
    s = jnp.sign(detM) * jnp.abs(detM) ** (1.0 / 3.0)
    s = jnp.where(jnp.abs(s) < 1e-12, 1e-12, s)
    M = M / s[..., None, None]
    t = p[..., 3] / s[..., None]
    # nearest rotation via SVD
    U, _, Vt = jnp.linalg.svd(M)
    R = U @ Vt
    dflip = jnp.linalg.det(R)
    U = U.at[..., :, 2].multiply(jnp.sign(dflip)[..., None])
    R = U @ Vt
    q = mat_to_quat(R)
    return jnp.concatenate([q, t], axis=-1)


def pnp_ransac(key, cam: CameraParams, pw, uv, level, valid,
               n_hyp: int = 256, min_set: int = 6):
    """Batched DLT-PnP RANSAC.  pw [M,3], uv [M,2].  Returns
    (pose [7], inliers [M], n_inliers)."""
    M = pw.shape[0]
    xn = _normalize(cam, uv)
    g = jax.random.gumbel(key, (n_hyp, M))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, picks = jax.lax.top_k(g, min_set)                # [n_hyp, S]
    poses = pnp_dlt(pw[picks], xn[picks])               # [n_hyp, 7]

    sigma2 = 1.2 ** (2.0 * level.astype(jnp.float32))

    def score(pose):
        from active_orb_slam2_tpu.geometry.se3 import se3_apply
        pc = se3_apply(pose, pw)
        z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        proj = jnp.stack([cam.fx * pc[:, 0] / z + cam.cx,
                          cam.fy * pc[:, 1] / z + cam.cy], axis=-1)
        err = jnp.sum((proj - uv) ** 2, axis=-1) / sigma2
        return valid & (err < CHI2_2D) & (pc[:, 2] > 0)

    inl = jax.vmap(score)(poses)
    counts = inl.sum(-1)
    best = jnp.argmax(counts)
    return poses[best], inl[best], counts[best]


def build_relocalizer(cfg: SlamConfig, n_candidates: int = 4):
    """Compile (m, frame, cand_kfs) -> RelocResult.

    ``cand_kfs`` [C] candidate KF slots (pad with -1).  BoW candidate
    selection runs on the host side (needs the LoopCloser's vocabulary);
    this device program does match + RANSAC + refine for all candidates
    at once and returns the best.
    """
    cam = cfg.camera

    @jax.jit
    def relocalize(m: MapState, frame, cand_kfs, key):
        F = frame.uv.shape[0]

        def per_candidate(kf, key):
            kf_ok = kf >= 0
            kfc = jnp.clip(kf, 0)
            va = frame.valid
            vb = m.kf_feat_valid[kfc] & (m.kf_point[kfc] >= 0) & kf_ok
            d = hamming_matrix(frame.desc, m.kf_desc[kfc], va, vb)
            idx, _ = match_mutual(d, max_dist=50.0, ratio=0.75)
            matched = idx >= 0
            pt = jnp.clip(m.kf_point[kfc][jnp.clip(idx, 0)], 0)
            ok = matched & m.pt_valid[pt] & kf_ok
            pw = m.pt_xyz[pt]
            pose, inl, n = pnp_ransac(key, cam, pw, frame.uv,
                                      frame.level, ok)
            # refine with the full 4x10 pose optimization
            obs_uvr = jnp.concatenate([frame.uv, frame.ur[:, None]], -1)
            res = pose_optimization(
                cam, pose, pw, obs_uvr, frame.level,
                frame.ur > 0, ok & inl)
            assoc = jnp.where(res.inliers & ok, pt, -1)

            # second chance (``Tracking::Relocalization`` ~L1300 [U]):
            # re-associate the candidate KF's points by PROJECTION at
            # the refined pose and optimize again — recovers the many
            # matches the BoW stage missed and de-flakes marginal
            # RANSAC winners.
            pts_idx = jnp.clip(m.kf_point[kfc], 0)
            pts_ok = (m.kf_point[kfc] >= 0) & m.pt_valid[pts_idx] & kf_ok
            xyz = m.pt_xyz[pts_idx]
            pc = se3_apply(res.pose, xyz)
            z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
            proj = jnp.stack([cam.fx * pc[:, 0] / z + cam.cx,
                              cam.fy * pc[:, 1] / z + cam.cy], axis=-1)
            dist = jnp.linalg.norm(pc, axis=-1)
            pred_lv = predict_scale(dist, m.pt_max_dist[pts_idx], 1.2, 8)
            radii = 10.0 * (1.2 ** pred_lv.astype(jnp.float32))
            idx2, _ = search_by_projection(
                proj, radii, pred_lv, m.pt_desc[pts_idx],
                pts_ok & (pc[:, 2] > 0), frame.uv, frame.level,
                frame.desc, frame.valid, max_dist=100.0, ratio=1.0,
                level_window=2)
            assoc2 = jnp.full((F,), -1, jnp.int32).at[
                jnp.clip(idx2, 0)].max(
                    jnp.where((idx2 >= 0) & pts_ok,
                              pts_idx.astype(jnp.int32), -1))
            assoc_u = jnp.where(assoc >= 0, assoc, assoc2)
            matched = assoc_u >= 0
            pt_u = jnp.clip(assoc_u, 0)
            res2 = pose_optimization(
                cam, res.pose, m.pt_xyz[pt_u], obs_uvr, frame.level,
                frame.ur > 0, matched & m.pt_valid[pt_u])
            assoc_f = jnp.where(res2.inliers & matched, assoc_u, -1)
            return res2.pose, res2.n_inliers, assoc_f

        keys = jax.random.split(key, n_candidates)
        poses, ns, assocs = jax.vmap(per_candidate)(cand_kfs, keys)
        best = jnp.argmax(ns)
        n = ns[best]
        return RelocResult(pose=poses[best], n_inliers=n,
                           ok=n >= 50, assoc=assocs[best])

    return relocalize
