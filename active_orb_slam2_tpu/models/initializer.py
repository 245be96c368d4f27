"""Monocular map initialization: homography/fundamental RANSAC race.

Array-program redesign of the reference's ``Initializer``
(``src/Initializer.cc`` [U], SURVEY.md §2.1): the two parallel threads
computing ``FindHomography`` and ``FindFundamental`` become two batched
hypothesis sweeps in one program (200 8-point RANSAC iterations each,
evaluated simultaneously); model selection by the reference's
``RH = SH / (SH + SF) > 0.40`` rule; reconstruction:

  * F path: E = K' F K, SVD -> 4 (R, t) chirality candidates.
  * H path: SVD-based decomposition (Faugeras) -> 8 candidates.
  * ``CheckRT``: every candidate triangulates ALL matches (batched DLT)
    and votes by depth/parallax/reprojection — a [n_cand, M] tensor op
    instead of per-candidate loops.

Coordinates are K-normalized throughout; thresholds follow the
reference (chi2 5.991 for H, 3.841 epipolar for F; both mapped to
normalized-coordinate sigmas).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.geometry.projection import CameraParams
from active_orb_slam2_tpu.geometry.se3 import mat_to_quat, se3_identity
from active_orb_slam2_tpu.geometry.triangulation import triangulate_dlt

SIGMA_PX = 1.0


class InitResult(NamedTuple):
    ok: jnp.ndarray          # bool
    pose2: jnp.ndarray       # [7] Tcw of frame 2 (frame 1 at identity)
    points: jnp.ndarray      # [M, 3] triangulated world points
    point_ok: jnp.ndarray    # [M] bool
    used_h: jnp.ndarray      # bool — which model won


def _dlt_h(x1, x2, w=None):
    """4+-point homography DLT: x2 ~ H x1.  Batched [., S, 2] -> [., 3, 3].
    Optional per-correspondence weights (inlier refit)."""
    o = jnp.ones_like(x1[..., 0])
    z = jnp.zeros_like(o)
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    r1 = jnp.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], -1)
    r2 = jnp.stack([u, v, o, z, z, z, -up * u, -up * v, -up], -1)
    A = jnp.concatenate([r1, r2], axis=-2)
    if w is not None:
        ww = jnp.concatenate([w, w], axis=-1)[..., None]
        AtA = jnp.einsum('...ji,...jk->...ik', A * ww, A)
    else:
        AtA = jnp.einsum('...ji,...jk->...ik', A, A)
    _, vec = jnp.linalg.eigh(AtA)
    return vec[..., :, 0].reshape(A.shape[:-2] + (3, 3))


def _dlt_f(x1, x2, w=None):
    """8-point fundamental DLT (rank-2 projected), optional weights."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    o = jnp.ones_like(u)
    A = jnp.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, o], -1)
    if w is not None:
        AtA = jnp.einsum('...ji,...jk->...ik', A * w[..., None], A)
    else:
        AtA = jnp.einsum('...ji,...jk->...ik', A, A)
    _, vec = jnp.linalg.eigh(AtA)
    F = vec[..., :, 0].reshape(A.shape[:-2] + (3, 3))
    U, s, Vt = jnp.linalg.svd(F)
    s = s.at[..., 2].set(0.0)
    return U @ (s[..., None] * Vt)


def _h_score(H, x1, x2, valid, sigma2):
    """Symmetric transfer score (reference CheckHomography [U])."""
    th = 5.991 * sigma2

    def transfer(H, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[..., :1])], -1)
        p = jnp.einsum('...ij,...nj->...ni', H, ah)
        w = jnp.where(jnp.abs(p[..., 2:]) < 1e-12, 1e-12, p[..., 2:])
        return jnp.sum((p[..., :2] / w - b) ** 2, axis=-1)

    Hinv = jnp.linalg.inv(H)
    e12 = transfer(H, x1, x2)
    e21 = transfer(Hinv, x2, x1)
    ok = valid & (e12 < th) & (e21 < th)
    score = jnp.where(valid & (e12 < th), th - e12, 0.0) + \
        jnp.where(valid & (e21 < th), th - e21, 0.0)
    return score.sum(-1), ok


def _f_score(F, x1, x2, valid, sigma2):
    """Epipolar-distance score (reference CheckFundamental [U])."""
    th = 3.841 * sigma2
    th_score = 5.991 * sigma2
    o = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, o], -1)
    p2 = jnp.concatenate([x2, o], -1)
    l2 = jnp.einsum('...ij,...nj->...ni', F, p1)       # line in image 2
    l1 = jnp.einsum('...ji,...nj->...ni', F, p2)       # line in image 1
    d2 = (jnp.einsum('...ni,...ni->...n', p2, l2) ** 2
          / jnp.maximum(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12))
    d1 = (jnp.einsum('...ni,...ni->...n', p1, l1) ** 2
          / jnp.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12))
    ok = valid & (d1 < th) & (d2 < th)
    score = jnp.where(valid & (d1 < th), th_score - d1, 0.0) + \
        jnp.where(valid & (d2 < th), th_score - d2, 0.0)
    return score.sum(-1), ok


def _decompose_e(E):
    """E -> 4 (R, t) candidates."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))[..., None, None]
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None, None]
    W = jnp.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    return jnp.stack([R1, R1, R2, R2]), jnp.stack([t, -t, t, -t])


def _decompose_h(H):
    """Faugeras SVD decomposition of a normalized-coords homography ->
    8 (R, t, n) candidates (reference ReconstructH ~L480-640 [U])."""
    U, s, Vt = jnp.linalg.svd(H)
    d1, d2, d3 = s[..., 0], s[..., 1], s[..., 2]
    detUV = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    V = jnp.swapaxes(Vt, -1, -2)

    eps = 1e-9
    x1 = jnp.sqrt(jnp.maximum((d1 ** 2 - d2 ** 2)
                              / jnp.maximum(d1 ** 2 - d3 ** 2, eps), 0.0))
    x3 = jnp.sqrt(jnp.maximum((d2 ** 2 - d3 ** 2)
                              / jnp.maximum(d1 ** 2 - d3 ** 2, eps), 0.0))

    Rs, ts = [], []
    # d' = d2 case (positive): 4 sign combos
    sin_t = jnp.sqrt(jnp.maximum((d1 ** 2 - d2 ** 2)
                                 * (d2 ** 2 - d3 ** 2), 0.0)) \
        / jnp.maximum((d1 + d3) * d2, eps)
    cos_t = (d2 ** 2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, eps)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = jnp.zeros(H.shape[:-2] + (3, 3))
            Rp = Rp.at[..., 0, 0].set(cos_t).at[..., 0, 2].set(-st)
            Rp = Rp.at[..., 1, 1].set(1.0)
            Rp = Rp.at[..., 2, 0].set(st).at[..., 2, 2].set(cos_t)
            tp = jnp.stack([e1 * x1, jnp.zeros_like(x1), -e3 * x3],
                           -1) * (d1 - d3)[..., None]
            R = detUV[..., None, None] * U @ Rp @ Vt
            t = jnp.einsum('...ij,...j->...i', U, tp)
            Rs.append(R)
            ts.append(t)
    # d' = -d2 case: 4 sign combos
    sin_p = jnp.sqrt(jnp.maximum((d1 ** 2 - d2 ** 2)
                                 * (d2 ** 2 - d3 ** 2), 0.0)) \
        / jnp.maximum((d1 - d3) * d2, eps)
    cos_p = (d1 * d3 - d2 ** 2) / jnp.maximum((d1 - d3) * d2, eps)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = jnp.zeros(H.shape[:-2] + (3, 3))
            Rp = Rp.at[..., 0, 0].set(cos_p).at[..., 0, 2].set(sp)
            Rp = Rp.at[..., 1, 1].set(-1.0)
            Rp = Rp.at[..., 2, 0].set(sp).at[..., 2, 2].set(-cos_p)
            tp = jnp.stack([e1 * x1, jnp.zeros_like(x1), e3 * x3],
                           -1) * (d1 + d3)[..., None]
            R = detUV[..., None, None] * U @ Rp @ Vt
            t = jnp.einsum('...ij,...j->...i', U, tp)
            Rs.append(R)
            ts.append(t)
    t_all = jnp.stack(ts)
    t_all = t_all / jnp.maximum(
        jnp.linalg.norm(t_all, axis=-1, keepdims=True), 1e-12)
    return jnp.stack(Rs), t_all


def _check_rt(R, t, x1, x2, valid, sigma2):
    """Triangulate all matches under candidate (R, t) and vote
    (reference CheckRT ~L650-780 [U]).  Batched over candidates."""
    n_cand = R.shape[0]
    eye34 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], -1)
    P2 = jnp.concatenate([R, t[..., :, None]], -1)      # [C, 3, 4]
    M = x1.shape[0]
    P1b = jnp.broadcast_to(eye34, (n_cand, M, 3, 4))
    P2b = jnp.broadcast_to(P2[:, None], (n_cand, M, 3, 4))
    x1b = jnp.broadcast_to(x1[None], (n_cand, M, 2))
    x2b = jnp.broadcast_to(x2[None], (n_cand, M, 2))
    xw, okt = triangulate_dlt(P1b, P2b, x1b, x2b)
    # depths in both views
    z1 = xw[..., 2]
    pc2 = jnp.einsum('cij,cnj->cni', R, xw) + t[:, None]
    z2 = pc2[..., 2]
    # parallax
    o2 = -jnp.einsum('cij,ci->cj', R, t)                # cam2 center
    r1 = xw
    r2 = xw - o2[:, None]
    cosp = jnp.sum(r1 * r2, -1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12)
    # reprojection (normalized coords)
    th = 4.0 * sigma2
    p1 = xw[..., :2] / jnp.maximum(z1[..., None], 1e-12)
    e1 = jnp.sum((p1 - x1[None]) ** 2, -1)
    p2 = pc2[..., :2] / jnp.maximum(z2[..., None], 1e-12)
    e2 = jnp.sum((p2 - x2[None]) ** 2, -1)
    good = (valid[None] & okt & (z1 > 0) & (z2 > 0)
            & (cosp < 0.99998) & (e1 < th) & (e2 < th))
    return good, xw, cosp


def build_initializer(cam: CameraParams, n_hyp: int = 200,
                      min_triangulated: int = 80,
                      min_parallax_deg: float = 1.0):
    """Compile (key, uv1 [M,2], uv2 [M,2], valid [M]) -> InitResult."""
    sigma_n = SIGMA_PX / cam.fx            # pixel sigma in normalized coords
    sigma2 = sigma_n * sigma_n

    def norm(uv):
        return jnp.stack([(uv[..., 0] - cam.cx) / cam.fx,
                          (uv[..., 1] - cam.cy) / cam.fy], -1)

    @jax.jit
    def initialize(key, uv1, uv2, valid):
        x1, x2 = norm(uv1), norm(uv2)
        M = x1.shape[0]
        g = jax.random.gumbel(key, (n_hyp, M))
        g = jnp.where(valid[None], g, -jnp.inf)
        _, picks = jax.lax.top_k(g, 8)                 # 8-point sets

        Hs = _dlt_h(x1[picks], x2[picks])
        Fs = _dlt_f(x1[picks], x2[picks])
        h_scores, _ = _h_score(Hs, x1[None], x2[None], valid[None], sigma2)
        f_scores, _ = _f_score(Fs, x1[None], x2[None], valid[None], sigma2)
        bh, bf = jnp.argmax(h_scores), jnp.argmax(f_scores)
        SH, SF = h_scores[bh], f_scores[bf]
        H, F = Hs[bh], Fs[bf]
        # least-squares refit over all RANSAC inliers (two rounds): the
        # 8-point minimal model is too noisy for the CheckRT gates
        for _ in range(2):
            _, h_inl = _h_score(H, x1, x2, valid, sigma2)
            _, f_inl = _f_score(F, x1, x2, valid, sigma2)
            H = _dlt_h(x1, x2, h_inl.astype(jnp.float32))
            F = _dlt_f(x1, x2, f_inl.astype(jnp.float32))
        _, h_inl = _h_score(H, x1, x2, valid, sigma2)
        _, f_inl = _f_score(F, x1, x2, valid, sigma2)
        use_h = SH / jnp.maximum(SH + SF, 1e-12) > 0.40

        # reconstruct both, select at the end (cheap enough batched)
        Rh, th_ = _decompose_h(H)                       # [8, 3, 3]
        Rf, tf = _decompose_e(F)                        # [4, ...]
        R_all = jnp.concatenate([Rh, Rf])
        t_all = jnp.concatenate([th_, tf])
        inl = jnp.where(use_h, h_inl, f_inl)
        good, xw, cosp = _check_rt(R_all, t_all, x1, x2, inl, sigma2)
        is_h_cand = jnp.arange(12) < 8
        cand_ok = jnp.where(use_h, is_h_cand, ~is_h_cand)
        counts = jnp.where(cand_ok, good.sum(-1), -1)
        best = jnp.argmax(counts)
        n_good = counts[best]
        # runner-up must be clearly worse (reference: secondBest < 0.75 best)
        second = jnp.sort(jnp.where(cand_ok, good.sum(-1), -1))[-2]
        # parallax of the 50th-best point must exceed the bound
        cosp_best = jnp.where(good[best], cosp[best], 1.0)
        kth = jnp.sort(cosp_best)[jnp.minimum(50, M - 1)]
        parallax_ok = kth < jnp.cos(jnp.deg2rad(min_parallax_deg))

        ok = ((n_good >= min_triangulated)
              & (second < 0.75 * n_good) & parallax_ok)
        q = mat_to_quat(R_all[best])
        pose2 = jnp.concatenate([q, t_all[best]])
        return InitResult(ok=ok, pose2=pose2, points=xw[best],
                          point_ok=good[best], used_h=use_h)

    return initialize
