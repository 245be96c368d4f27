"""DLT triangulation, batched.

Replaces the reference's per-pair SVD triangulation inside
``LocalMapping::CreateNewMapPoints`` (``src/LocalMapping.cc`` ~L210-360
[U]) and ``Initializer::Triangulate`` (``src/Initializer.cc`` [U]).

Fixed-shape form: one batched 4x4 eigen-solve over all candidate pairs
at once (jnp.linalg.eigh on [N, 4, 4] batches well and is exact).
"""

import jax.numpy as jnp

from active_orb_slam2_tpu.geometry.se3 import se3_to_mat44


def _projection_matrix(cam_K, Tcw):
    """K [3,3] + pose [...,7] -> P = K [R|t] [..., 3, 4]."""
    M = se3_to_mat44(Tcw)[..., :3, :]
    return jnp.einsum('ij,...jk->...ik', cam_K, M)


def _normalize_uv(cam_K, uv):
    """Pixels [..., 2] -> normalized camera coords via K^-1 (better f32
    conditioning for the DLT than raw pixel magnitudes)."""
    fx, fy = cam_K[0, 0], cam_K[1, 1]
    cx, cy = cam_K[0, 2], cam_K[1, 2]
    return jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)


def triangulate_dlt(P1, P2, uv1, uv2):
    """Batched two-view DLT.

    Args:
      P1, P2: projection matrices, broadcastable to [..., 3, 4].
      uv1, uv2: pixel observations [..., 2].
    Returns:
      (xw [..., 3] world points, ok [...] finite/valid mask).
    """
    rows = [
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)                      # [..., 4, 4]
    AtA = jnp.einsum('...ji,...jk->...ik', A, A)      # [..., 4, 4] sym PSD
    vals, vecs = jnp.linalg.eigh(AtA)
    x = vecs[..., :, 0]                                # smallest eigval
    w = x[..., 3]
    # rank check: a unique solution needs exactly ONE near-zero
    # eigenvalue; a zero-baseline / coincident-ray system has a 2-D
    # nullspace (vals[1] ~ 0 too) and any nullspace vector is garbage
    well_posed = vals[..., 1] > 1e-7 * jnp.maximum(vals[..., 3], 1e-12)
    ok = (jnp.abs(w) > 1e-9) & well_posed
    xw = x[..., :3] / jnp.where(ok, w, 1.0)[..., None]
    return xw, ok & jnp.all(jnp.isfinite(xw), axis=-1)


def triangulate_pairs(cam_K, Tcw1, Tcw2, uv1, uv2, refine_iters: int = 2):
    """Triangulate matched pixel pairs between two posed cameras.

    Works in normalized camera coordinates (P = [R|t], uv' = K^-1 uv)
    and polishes the DLT output with a couple of Gauss-Newton steps on
    the normalized reprojection error — needed for f32 accuracy.

    Shapes: Tcw* [7] or [..., 7]; uv* [..., 2]. Returns (xw, ok).
    """
    P1 = se3_to_mat44(Tcw1)[..., :3, :]
    P2 = se3_to_mat44(Tcw2)[..., :3, :]
    n1 = _normalize_uv(cam_K, uv1)
    n2 = _normalize_uv(cam_K, uv2)
    xw, ok = triangulate_dlt(P1, P2, n1, n2)

    def gn_step(xw):
        # residual r = [proj1(xw) - n1, proj2(xw) - n2]  (4-vector)
        def res_jac(P, n, x):
            pc = jnp.einsum('...ij,...j->...i',
                            P[..., :3], x) + P[..., 3]
            z = jnp.where(jnp.abs(pc[..., 2:3]) < 1e-9, 1e-9, pc[..., 2:3])
            proj = pc[..., :2] / z
            r = proj - n
            # d proj / d pc
            zz = z[..., 0]
            J_pc = jnp.stack([
                jnp.stack([1.0 / zz, jnp.zeros_like(zz),
                           -pc[..., 0] / (zz * zz)], -1),
                jnp.stack([jnp.zeros_like(zz), 1.0 / zz,
                           -pc[..., 1] / (zz * zz)], -1),
            ], axis=-2)                                   # [..., 2, 3]
            J = jnp.einsum('...ij,...jk->...ik', J_pc, P[..., :3])
            return r, J
        r1, J1 = res_jac(P1, n1, xw)
        r2, J2 = res_jac(P2, n2, xw)
        r = jnp.concatenate([r1, r2], axis=-1)            # [..., 4]
        J = jnp.concatenate([J1, J2], axis=-2)            # [..., 4, 3]
        H = jnp.einsum('...ji,...jk->...ik', J, J) + 1e-9 * jnp.eye(3)
        g = jnp.einsum('...ji,...j->...i', J, r)
        from active_orb_slam2_tpu.geometry.linalg3 import solve3
        return xw - solve3(H, g, eps=1e-30)

    for _ in range(refine_iters):
        xw = gn_step(xw)
    return xw, ok & jnp.all(jnp.isfinite(xw), axis=-1)
