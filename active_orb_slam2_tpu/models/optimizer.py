"""Batched Gauss-Newton / Levenberg-Marquardt optimizers: motion-only
pose optimization and Schur-complement bundle adjustment.

This is the array-program replacement for the reference's entire g2o stack
(``src/Optimizer.cc`` ~1250 LoC + ``Thirdparty/g2o`` ~20k LoC [U],
SURVEY.md §2.2): SE3-expmap vertices, mono/stereo projection edges,
Huber robust kernels, the BlockSolver_6_3 Schur trick, and the LM
damping loop — all as fixed-shape array programs:

  * residuals/Jacobians for ALL edges at once (vmapped closed forms,
    no autodiff in the hot loop — the 2x3/3x6 blocks are hand-derived
    exactly as g2o's ``EdgeSE3ProjectXYZ::linearizeOplus`` [U]);
  * per-point 3x3 Hessians + per-camera 6x6 blocks by segment-sum;
  * Schur reduction S = Hcc - Hcp Hpp^-1 Hpc as batched einsums;
  * the reduced camera system solved densely on-device;
  * LM as a ``lax.while_loop``-free bounded-iteration accept/reject
    loop (deterministic, interruption-equivalent to mbAbortBA's
    bounded slices — SURVEY.md §5.3).

Edge convention: every observation is a 3-vector residual
(u, v, uR); monocular observations mask the third component.  Matches
g2o's EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ pair with information
inv_sigma2(level) * I, Huber delta sqrt(5.991) mono / sqrt(7.815)
stereo (``Optimizer::PoseOptimization`` ~L230-380 [U]).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.geometry.projection import CameraParams
from active_orb_slam2_tpu.geometry.se3 import quat_rotate, se3_retract

CHI2_MONO = 5.991      # 95% chi2, 2 dof
CHI2_STEREO = 7.815    # 95% chi2, 3 dof
LOG_SCALE2 = 2.0 * jnp.log(1.2)


def inv_sigma2(level):
    """Per-level information weight 1 / 1.2^(2 level)."""
    return jnp.exp(-level.astype(jnp.float32) * LOG_SCALE2)


def _edge_residual_jac(cam: CameraParams, pose, pw, obs_uvr, has_stereo):
    """Residual + Jacobians for projection edges at one pose.

    Args:
      pose [7] Tcw; pw [E, 3] world points; obs_uvr [E, 3] (u, v, uR);
      has_stereo [E] bool.
    Returns:
      r [E, 3], J_pose [E, 3, 6] (d r / d [omega, nu], left-mult
      perturbation exp(delta) Tcw), J_point [E, 3, 3] (d r / d pw),
      depth_pos [E] bool.
    """
    q, t = pose[..., :4], pose[..., 4:7]
    pc = quat_rotate(q, pw) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    # scatter-free construction: stack the rows instead of .at[].set
    r = jnp.stack([u - obs_uvr[:, 0], v - obs_uvr[:, 1],
                   jnp.where(has_stereo, ur - obs_uvr[:, 2], 0.0)], -1)

    zero = jnp.zeros_like(x)
    # d(u,v,uR)/d pc  -> [E, 3, 3]
    J_pc = jnp.stack([
        jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        jnp.stack([cam.fx * iz, zero,
                   -cam.fx * x * iz2 + cam.bf * iz2], -1),
    ], axis=-2)
    J_pc = J_pc * jnp.stack(
        [jnp.ones_like(x), jnp.ones_like(x),
         has_stereo.astype(jnp.float32)], -1)[..., None]

    # d pc / d delta = [ -[pc]x | I ]  (left perturbation on Tcw)
    px = jnp.stack([
        jnp.stack([zero, -z, y], -1),
        jnp.stack([z, zero, -x], -1),
        jnp.stack([-y, x, zero], -1),
    ], axis=-2)
    J_pose = jnp.concatenate([jnp.einsum('eij,ejk->eik', J_pc, -px),
                              J_pc], axis=-1)           # [E, 3, 6]

    # d pc / d pw = R  (q may be [4] shared or [E, 4] per-edge)
    from active_orb_slam2_tpu.geometry.se3 import quat_to_mat
    R = quat_to_mat(q)
    if R.ndim == 2:
        J_point = jnp.einsum('eij,jk->eik', J_pc, R)
    else:
        J_point = jnp.einsum('eij,ejk->eik', J_pc, R)
    return r, J_pose, J_point, z > 0


def _edge_chi2(r, w_info, has_stereo):
    """Per-edge chi2 with information inv_sigma2 * I (g2o convention)."""
    return w_info * jnp.sum(r * r, axis=-1)


def cholesky_solve(h, b):
    """Unrolled Cholesky solve of one small SPD system given as nested
    lists of scalars: ``h`` [n][n], ``b`` [n] -> x as a list of n
    scalars.  Statically unrolled scalar math fuses into the
    surrounding program (and lowers inside a Pallas kernel), where a
    library solve would be a separate call with a column loop."""
    n = len(b)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = h[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = h[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def solve_spd(H, b, n: int = 6):
    """H [n, n] SPD (damped), b [n] -> x [n] (see cholesky_solve)."""
    return jnp.stack(cholesky_solve(
        [[H[i, j] for j in range(n)] for i in range(n)],
        [b[i] for i in range(n)]))


def _huber_weight(chi2, has_stereo, enabled=True):
    """Multiplicative IRLS weight from the Huber kernel at the reference
    deltas: rho'(chi2) = min(1, delta / sqrt(chi2))."""
    delta = jnp.where(has_stereo, jnp.sqrt(CHI2_STEREO), jnp.sqrt(CHI2_MONO))
    w = jnp.minimum(1.0, delta / jnp.sqrt(jnp.maximum(chi2, 1e-12)))
    return w if enabled else jnp.ones_like(w)


class PoseOptResult(NamedTuple):
    pose: jnp.ndarray      # [7]
    inliers: jnp.ndarray   # [E] bool
    n_inliers: jnp.ndarray  # int32
    chi2: jnp.ndarray      # float32 (inlier chi2 sum)


def _edge_terms_flat(cam: CameraParams, pose, pw, obs_uvr, has_stereo):
    """Component-form residuals + pose Jacobian for the LM hot loop.

    Everything here is flat [E] vectors instead of [E, 3, 6]-shaped
    arrays with tiny minor dimensions, and XLA fuses the whole
    linearization into a couple of passes.

    Returns (r [3][E], J [3][6][E], zpos [E]).
    """
    q, t = pose[..., :4], pose[..., 4:7]
    pc = quat_rotate(q, pw) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    st = has_stereo.astype(jnp.float32)
    r = [u - obs_uvr[:, 0], v - obs_uvr[:, 1],
         st * (ur - obs_uvr[:, 2])]

    zero = jnp.zeros_like(x)
    # J_pc rows (d residual_a / d pc)
    jpc = [
        [cam.fx * iz, zero, -cam.fx * x * iz2],
        [zero, cam.fy * iz, -cam.fy * y * iz2],
        [st * cam.fx * iz, zero, st * (-cam.fx * x * iz2 + cam.bf * iz2)],
    ]
    # px = [[0,-z,y],[z,0,-x],[-y,x,0]]; J_rot = -J_pc @ px, J_tr = J_pc
    px = [[zero, -z, y], [z, zero, -x], [-y, x, zero]]
    J = [[None] * 6 for _ in range(3)]
    for a in range(3):
        for i in range(3):
            J[a][i] = -(jpc[a][0] * px[0][i] + jpc[a][1] * px[1][i]
                        + jpc[a][2] * px[2][i])
            J[a][3 + i] = jpc[a][i]
    return r, J, z > 0


def pose_optimization(cam: CameraParams, pose0, pw, obs_uvr, level,
                      has_stereo, valid,
                      rounds: int = 4, iters_per_round: int = 10
                      ) -> PoseOptResult:
    """Motion-only BA: ``Optimizer::PoseOptimization`` (~L230-380 [U]).

    4 rounds x 10 LM iterations; after each round edges are
    reclassified by chi2 (5.991 mono / 7.815 stereo) and outliers
    excluded from the next round; the Huber kernel is dropped for the
    last two rounds, exactly the reference schedule.

    Args: pw [E,3] matched map points; obs_uvr [E,3]; level [E];
      has_stereo/valid [E] bool.
    """
    w_info = inv_sigma2(level)
    chi2_th = jnp.where(has_stereo, CHI2_STEREO, CHI2_MONO)

    def flat_chi2(pose):
        r, _, zpos = _edge_terms_flat(cam, pose, pw, obs_uvr, has_stereo)
        c2 = w_info * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
        return c2, zpos

    def compute_chi2(pose, inl):
        return flat_chi2(pose)

    def lm_round(pose, inliers, use_huber):
        # Damped GN with chi2-carried accept/reject: ONE linearization
        # per iteration (the current residual doubles as the acceptance
        # check of the previous step) — half the cost of classic LM at
        # the same 10-iteration budget.  Component form ([E] vectors)
        # throughout: see _edge_terms_flat.
        inl_f = inliers.astype(jnp.float32)

        def body(carry, _):
            pose, best_pose, best_chi2, lam = carry
            r, J, zpos = _edge_terms_flat(
                cam, pose, pw, obs_uvr, has_stereo)
            c2 = w_info * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
            gate = inl_f * zpos.astype(jnp.float32)
            chi2 = jnp.sum(c2 * gate)
            # acceptance of the PREVIOUS step, judged by this residual
            worse = chi2 > best_chi2
            lam = jnp.clip(jnp.where(worse, lam * 4.0, lam * 0.5),
                           1e-8, 1e2)
            best_pose = jnp.where(worse, best_pose, pose)
            best_chi2 = jnp.minimum(chi2, best_chi2)
            # step from the current linearization when accepted; on a
            # reject, fall back to the best pose (next iteration then
            # re-linearizes there under the larger damping)
            w = w_info * _huber_weight(c2, has_stereo, use_huber) * gate
            # normal equations via ONE matmul: M [7, 3E] holds the 6
            # Jacobian columns + the residual as rows; A = (M w) M^T
            # gives H = A[:6,:6], b = -A[:6,6] in a single [7,7] product.
            rows = [jnp.concatenate([J[0][i], J[1][i], J[2][i]])
                    for i in range(6)]
            rows.append(jnp.concatenate([r[0], r[1], r[2]]))
            M = jnp.stack(rows)                       # [7, 3E]
            w3 = jnp.concatenate([w, w, w])
            A = jnp.matmul(M * w3[None, :], M.T,
                           precision=jax.lax.Precision.HIGHEST)
            H = A[:6, :6]
            b = -A[:6, 6]
            step = solve_spd(
                H + lam * jnp.diag(jnp.diagonal(H)) + 1e-9 * jnp.eye(6), b)
            new_pose = jnp.where(worse, best_pose,
                                 se3_retract(pose, step))
            return (new_pose, best_pose, best_chi2, lam), None

        (cand, pose, chi2, lam), _ = jax.lax.scan(
            body, (pose, pose, jnp.float32(jnp.inf), jnp.float32(1e-4)),
            None, length=iters_per_round)
        # final acceptance of the last proposed step
        c2, zpos = flat_chi2(cand)
        cand_chi2 = jnp.sum(jnp.where(inliers & zpos, c2, 0.0))
        better = cand_chi2 <= chi2
        return (jnp.where(better, cand, pose),
                jnp.where(better, cand_chi2, chi2))

    pose = pose0
    inliers = valid
    for rnd in range(rounds):
        use_huber = rnd < 2
        pose, _ = lm_round(pose, inliers, use_huber)
        c2, zpos = compute_chi2(pose, inliers)
        inliers = valid & zpos & (c2 <= chi2_th)
    c2, zpos = compute_chi2(pose, inliers)
    chi2_sum = jnp.sum(jnp.where(inliers, c2, 0.0))
    return PoseOptResult(pose=pose, inliers=inliers,
                         n_inliers=inliers.sum().astype(jnp.int32),
                         chi2=chi2_sum)


# --------------------------------------------------------------- bundle adj.

class BAEdges(NamedTuple):
    """Fixed-shape edge list for a BA problem.

    E edges over Lt cameras (local + fixed) and Pl points.
    """
    cam_idx: jnp.ndarray    # [E] int32 into the camera block
    pt_idx: jnp.ndarray     # [E] int32 into the point block
    obs_uvr: jnp.ndarray    # [E, 3]
    level: jnp.ndarray      # [E] int32
    has_stereo: jnp.ndarray  # [E] bool
    valid: jnp.ndarray      # [E] bool


class BAResult(NamedTuple):
    poses: jnp.ndarray       # [Lt, 7]
    points: jnp.ndarray      # [Pl, 3]
    edge_inliers: jnp.ndarray  # [E] bool
    chi2: jnp.ndarray


def _ba_linearize(cam, poses, points, e: BAEdges, inliers, use_huber):
    """Residuals/Jacobians/weights for all edges at current estimate."""
    pw = points[e.pt_idx]
    pose_e = poses[e.cam_idx]
    r, J_pose, J_point, zpos = _edge_residual_jac(
        cam, pose_e, pw, e.obs_uvr, e.has_stereo)
    w_info = inv_sigma2(e.level)
    c2 = _edge_chi2(r, w_info, e.has_stereo)
    w = w_info * _huber_weight(c2, e.has_stereo, use_huber)
    w = jnp.where(inliers & zpos, w, 0.0)
    return r, J_pose, J_point, w, c2, zpos


def _ba_solve_step(cam, poses, points, e: BAEdges, fixed_cam, inliers,
                   lam, use_huber):
    """One Schur-reduced GN step.
    Returns (delta_poses, delta_points, chi2_at_current)."""
    Lt = poses.shape[0]
    Pl = points.shape[0]
    r, Jc, Jx, w, c2, zpos = _ba_linearize(cam, poses, points, e, inliers,
                                           use_huber)
    chi2 = jnp.sum(jnp.where(inliers & zpos, c2, 0.0))
    # zero camera Jacobians of fixed cameras
    cam_free = ~fixed_cam[e.cam_idx]
    Jc = Jc * cam_free[:, None, None]

    # per-camera 6x6 blocks + gradient
    Hcc = jnp.zeros((Lt, 6, 6)).at[e.cam_idx].add(
        jnp.einsum('eai,e,eaj->eij', Jc, w, Jc))
    bc = jnp.zeros((Lt, 6)).at[e.cam_idx].add(
        -jnp.einsum('eai,e,ea->ei', Jc, w, r))
    # per-point 3x3 + gradient
    Hpp = jnp.zeros((Pl, 3, 3)).at[e.pt_idx].add(
        jnp.einsum('eai,e,eaj->eij', Jx, w, Jx))
    bp = jnp.zeros((Pl, 3)).at[e.pt_idx].add(
        -jnp.einsum('eai,e,ea->ei', Jx, w, r))
    # camera-point coupling, densified per (point, camera): [Pl, Lt, 6, 3]
    A = jnp.einsum('eai,e,eaj->eij', Jc, w, Jx)           # [E, 6, 3]
    B = jnp.zeros((Pl, Lt, 6, 3)).at[e.pt_idx, e.cam_idx].add(A)

    # LM diagonal damping on both blocks BEFORE the reduction (matches a
    # damped dense solve exactly; verified against the dense oracle).
    eye3 = jnp.eye(3)
    eye6 = jnp.eye(6)
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-6 * eye3
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-6 * eye6
    from active_orb_slam2_tpu.geometry.linalg3 import inv3
    Hpp_inv = inv3(Hpp_d, eps=1e-30)

    C = jnp.einsum('plij,pjk->plik', B, Hpp_inv)          # [Pl, Lt, 6, 3]
    S_red = jnp.einsum('plik,pmjk->limj', C, B)           # [Lt,6,Lt,6]
    S = (_embed_diag(Hcc_d) - S_red.reshape(Lt * 6, Lt * 6))
    g = (bc - jnp.einsum('plik,pk->li', C, bp)).reshape(Lt * 6)

    # pin fixed cameras to identity rows
    fixed_rows = jnp.repeat(fixed_cam, 6)
    S = jnp.where(fixed_rows[:, None] | fixed_rows[None, :],
                  jnp.eye(Lt * 6), S)
    g = jnp.where(fixed_rows, 0.0, g)

    dc = jnp.linalg.solve(S, g).reshape(Lt, 6)
    dp = jnp.einsum('pij,pj->pi',
                    Hpp_inv, bp - jnp.einsum('plik,li->pk', B, dc))
    return dc, dp, chi2


def _embed_diag(blocks):
    """[L, 6, 6] block-diagonal -> [L*6, L*6] dense."""
    L = blocks.shape[0]
    out = jnp.zeros((L, 6, L, 6))
    out = out.at[jnp.arange(L), :, jnp.arange(L), :].set(blocks)
    return out.reshape(L * 6, L * 6)


def _ba_chi2(cam, poses, points, e: BAEdges, inliers):
    r, _, _, _, c2, zpos = _ba_linearize(cam, poses, points, e, inliers,
                                         use_huber=True)
    return jnp.sum(jnp.where(inliers & zpos, c2, 0.0))


def bundle_adjustment(cam: CameraParams, poses0, points0, e: BAEdges,
                      fixed_cam, iters_a: int = 5, iters_b: int = 10
                      ) -> BAResult:
    """Local/global BA with the reference's 5 + 10 schedule
    (``Optimizer::LocalBundleAdjustment`` ~L390-630 [U]): 5 LM
    iterations, chi2 outlier reclassification, 10 more iterations,
    final outlier flagging (caller erases those observations).

    Args:
      poses0 [Lt, 7]; points0 [Pl, 3]; fixed_cam [Lt] bool (the
      reference's fixed-KF ring); e: edge list.
    """
    with jax.default_matmul_precision("highest"):
        # f32 precision is load-bearing for the LM steps: a reduced-
        # precision matmul path (bf16 or TF32) stalls convergence — see
        # parallel/dist_ba.py
        return _bundle_adjustment(cam, poses0, points0, e, fixed_cam,
                                  iters_a, iters_b)


def _bundle_adjustment(cam: CameraParams, poses0, points0, e: BAEdges,
                       fixed_cam, iters_a: int = 5, iters_b: int = 10
                       ) -> BAResult:
    chi2_th = jnp.where(e.has_stereo, CHI2_STEREO, CHI2_MONO)

    def lm_iters(poses, points, inliers, n, use_huber):
        # carried-chi2 accept/reject: one linearization per iteration
        # (the current chi2 judges the previous step)
        def body(carry, _):
            poses, points, best_p, best_x, best_chi2, lam = carry
            dc, dp, chi2 = _ba_solve_step(cam, poses, points, e,
                                          fixed_cam, inliers, lam,
                                          use_huber)
            worse = chi2 > best_chi2
            lam = jnp.clip(jnp.where(worse, lam * 4.0, lam * 0.5),
                           1e-8, 1e2)
            best_p = jnp.where(worse, best_p, poses)
            best_x = jnp.where(worse, best_x, points)
            best_chi2 = jnp.minimum(chi2, best_chi2)
            new_poses = jnp.where(worse, best_p,
                                  jax.vmap(se3_retract)(poses, dc))
            new_points = jnp.where(worse, best_x, points + dp)
            return (new_poses, new_points, best_p, best_x, best_chi2,
                    lam), None
        (cand_p, cand_x, poses, points, best_chi2, _), _ = jax.lax.scan(
            body, (poses, points, poses, points, jnp.float32(jnp.inf),
                   jnp.float32(1e-4)), None, length=n)
        cand_chi2 = _ba_chi2(cam, cand_p, cand_x, e, inliers)
        better = cand_chi2 <= best_chi2
        return (jnp.where(better, cand_p, poses),
                jnp.where(better, cand_x, points))

    inliers = e.valid
    poses, points = lm_iters(poses0, points0, inliers, iters_a,
                             use_huber=True)
    # reclassify
    r, _, _, _, c2, zpos = _ba_linearize(cam, poses, points, e, inliers,
                                         use_huber=True)
    inliers = e.valid & zpos & (c2 <= chi2_th)
    poses, points = lm_iters(poses, points, inliers, iters_b,
                             use_huber=True)
    r, _, _, _, c2, zpos = _ba_linearize(cam, poses, points, e, inliers,
                                         use_huber=True)
    inliers = e.valid & zpos & (c2 <= chi2_th)
    chi2 = jnp.sum(jnp.where(inliers, c2, 0.0))
    return BAResult(poses=poses, points=points, edge_inliers=inliers,
                    chi2=chi2)
