"""Sim3 estimation between two keyframes: batched Horn RANSAC + refine.

Replaces the reference's ``Sim3Solver`` (``src/Sim3Solver.cc`` [U]):
Horn 1987 closed-form absolute orientation on 3-point minimal sets
inside RANSAC with both-direction reprojection checks.  Fixed-shape
reformulation (SURVEY.md §7.1): all ``n_hyp`` hypotheses are sampled
with one PRNG call and solved by one batched eigendecomposition; the
adaptive early-exit loop becomes a single argmax over inlier counts,
followed by a weighted-Horn refinement on the winner's inliers.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.geometry.horn import horn_align
from active_orb_slam2_tpu.geometry.projection import CameraParams
from active_orb_slam2_tpu.geometry.se3 import (
    quat_rotate, sim3_apply, sim3_inverse)

CHI2_SIM3 = 9.210   # reference maxError (99% chi2, 2 dof)


class Sim3Result(NamedTuple):
    sim3_ab: jnp.ndarray     # [8] maps b-camera coords -> a-camera coords
    inliers: jnp.ndarray     # [M] bool
    n_inliers: jnp.ndarray   # int32
    ok: jnp.ndarray          # bool


def _project(cam: CameraParams, pc):
    z = jnp.where(jnp.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    return jnp.stack([cam.fx * pc[..., 0] / z + cam.cx,
                      cam.fy * pc[..., 1] / z + cam.cy], axis=-1)


def sim3_ransac(key, cam: CameraParams, xyz_a, xyz_b, uv_a, uv_b,
                sigma2_a, sigma2_b, valid, n_hyp: int = 256,
                fix_scale: bool = False, min_inliers: int = 20
                ) -> Sim3Result:
    """Estimate S_ab with dst = a, src = b.

    Args:
      xyz_a/xyz_b [M, 3]: matched points in each keyframe's CAMERA frame
        (the reference's mvX3Dc1/mvX3Dc2).
      uv_a/uv_b [M, 2]: their observed pixels; sigma2_* [M]: per-level
        variance for the chi2 gate (1.2^(2 level)).
      valid [M] bool.
    """
    M = xyz_a.shape[0]
    w = jnp.where(valid, 1.0, 0.0)
    # sample 3 correspondence indices per hypothesis (Gumbel top-k over
    # valid entries -> distinct indices, one shot for all hypotheses)
    g = jax.random.gumbel(key, (n_hyp, M))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, picks = jax.lax.top_k(g, 3)                        # [n_hyp, 3]

    src = xyz_b[picks]                                     # [n_hyp, 3, 3]
    dst = xyz_a[picks]
    q, t, s = horn_align(src, dst, fix_scale=fix_scale)    # batched

    # both-direction reprojection check for every hypothesis x point
    def hyp_inliers(q, t, s):
        pa = s * quat_rotate(q[None], xyz_b) + t[None]     # b -> a frame
        ra = _project(cam, pa) - uv_a
        e_a = jnp.sum(ra * ra, axis=-1) / sigma2_a
        si = 1.0 / jnp.maximum(s, 1e-9)
        qi = q * jnp.array([1.0, -1, -1, -1])
        pb = si * quat_rotate(qi[None], xyz_a - t[None])
        rb = _project(cam, pb) - uv_b
        e_b = jnp.sum(rb * rb, axis=-1) / sigma2_b
        return valid & (e_a < CHI2_SIM3) & (e_b < CHI2_SIM3) \
            & (pa[:, 2] > 0) & (pb[:, 2] > 0)

    inl = jax.vmap(hyp_inliers)(q, t, s)                   # [n_hyp, M]
    counts = inl.sum(-1)
    best = jnp.argmax(counts)
    best_inl = inl[best]

    # refine with weighted Horn on the winner's inliers
    qr, tr, sr = horn_align(xyz_b, xyz_a,
                            weights=best_inl.astype(jnp.float32),
                            fix_scale=fix_scale)
    ref_inl = hyp_inliers(qr, tr, sr)
    use_ref = ref_inl.sum() >= counts[best]
    q_f = jnp.where(use_ref, qr, q[best])
    t_f = jnp.where(use_ref, tr, t[best])
    s_f = jnp.where(use_ref, sr, s[best])
    inl_f = jnp.where(use_ref, ref_inl, best_inl)
    n = inl_f.sum().astype(jnp.int32)
    sim3 = jnp.concatenate([q_f, t_f, s_f[None]])
    return Sim3Result(sim3_ab=sim3, inliers=inl_f, n_inliers=n,
                      ok=n >= min_inliers)


def optimize_sim3(cam: CameraParams, s_ab0, xyz_a, xyz_b, uv_a, uv_b,
                  sigma2_a, sigma2_b, valid, iters1: int = 5,
                  iters2: int = 10, fix_scale: bool = False,
                  chi2_th: float = 10.0, huber: float = 10.0 ** 0.5,
                  lam0: float = 1e-4):
    """``Optimizer::OptimizeSim3`` (``src/Optimizer.cc`` ~L910-1060 [U]):
    Levenberg-Marquardt over the RELATIVE Sim3 with BIDIRECTIONAL
    projection residuals, Huber robustification, and a mid-run inlier
    pruning pass — replacing the round-2 weighted-Horn refit, which
    minimized 3D point distance rather than reprojection error.

    Args mirror :func:`sim3_ransac` (camera-frame matched points +
    observed pixels per side).  ``s_ab0`` [8] is the initial estimate
    (Horn RANSAC winner — Horn stays the initializer, per the
    reference's Sim3Solver -> OptimizeSim3 ladder).

    Returns (s_ab [8], inliers [M] bool, n_inliers int32).
    """
    from active_orb_slam2_tpu.geometry.se3 import sim3_exp, sim3_compose

    def residuals(delta, w_mask):
        """Stacked bidirectional pixel residuals [M, 4], chi2 [M, 2]."""
        S = sim3_compose(sim3_exp(delta), s_ab0)
        pa = sim3_apply(S, xyz_b)                  # b -> a camera frame
        ra = (_project(cam, pa) - uv_a) / jnp.sqrt(sigma2_a)[:, None]
        Si = sim3_inverse(S)
        pb = sim3_apply(Si, xyz_a)                 # a -> b camera frame
        rb = (_project(cam, pb) - uv_b) / jnp.sqrt(sigma2_b)[:, None]
        r = jnp.concatenate([ra, rb], axis=-1)     # [M, 4]
        chi2 = jnp.stack([jnp.sum(ra * ra, -1), jnp.sum(rb * rb, -1)],
                         axis=-1)
        return jnp.where(w_mask[:, None], r, 0.0), chi2

    zero = jnp.zeros(7)

    def lm_phase(d_init, mask, n_iters):
        def body(carry, _):
            acc_delta, lam = carry

            def res_of(d):
                r, _ = residuals(d, mask)
                return r

            r = res_of(acc_delta)
            J = jax.jacfwd(res_of)(acc_delta)      # [M, 4, 7]
            # Huber IRLS weights on the per-edge norm (delta = sqrt(10),
            # applied per direction as the reference's robust kernel)
            e2 = jnp.sum(r * r, axis=-1)           # [M]
            e = jnp.sqrt(jnp.maximum(e2, 1e-12))
            w_h = jnp.where(e <= huber, 1.0, huber / e)
            w_h = jnp.where(mask, w_h, 0.0)
            H = jnp.einsum('mri,m,mrj->ij', J, w_h, J)
            g = -jnp.einsum('mri,m,mr->i', J, w_h, r)
            if fix_scale:
                # clamp the scale dof (reference VertexSim3Expmap
                # _fix_scale): identity row/col, zero gradient
                H = H.at[6, :].set(0.).at[:, 6].set(0.).at[6, 6].set(1.)
                g = g.at[6].set(0.)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(7)
            step = jnp.linalg.solve(Hd, g)
            cand = acc_delta + step

            def cost_of(d):
                rr, _ = residuals(d, mask)
                ee2 = jnp.sum(rr * rr, -1)
                ee = jnp.sqrt(jnp.maximum(ee2, 1e-12))
                # Huber cost
                c = jnp.where(ee <= huber, 0.5 * ee2,
                              huber * (ee - 0.5 * huber))
                return jnp.sum(jnp.where(mask, c, 0.0))

            better = cost_of(cand) <= cost_of(acc_delta)
            acc_delta = jnp.where(better, cand, acc_delta)
            lam = jnp.clip(jnp.where(better, lam * 0.5, lam * 10.0),
                           1e-9, 1e6)
            return (acc_delta, lam), None

        (d, _), _ = jax.lax.scan(body, (d_init, jnp.float32(lam0)), None,
                                 length=n_iters)
        return d

    # phase 1: all tentative correspondences
    d1 = lm_phase(zero, valid, iters1)
    _, chi2 = residuals(d1, valid)
    inl = valid & (chi2[:, 0] < chi2_th) & (chi2[:, 1] < chi2_th)
    # phase 2: continue from d1 with bad edges removed (reference:
    # remove chi2>10 edges, then 10 more iterations)
    d2 = lm_phase(d1, inl, iters2)
    _, chi2f = residuals(d2, inl)
    inl_f = inl & (chi2f[:, 0] < chi2_th) & (chi2f[:, 1] < chi2_th)
    s_out = sim3_compose(sim3_exp(d2), s_ab0)
    if fix_scale:
        s_out = s_out.at[7].set(s_ab0[7])
    return s_out, inl_f, inl_f.sum().astype(jnp.int32)
