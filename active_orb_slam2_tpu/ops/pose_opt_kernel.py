"""Fused pose optimization: one Pallas program on the Triton route.

``Optimizer::PoseOptimization`` (~L230-380 [U]) runs 4 rounds x 10
damped Gauss-Newton iterations over 1-2k projection edges, twice per
frame.  Each iteration depends on the one before, and each is a few
microseconds of arithmetic, so as an XLA loop it is bound by launches.
This kernel runs the whole optimization in ONE launch of one program:
the edge data is loaded once as E-wide vectors (E a power of two), the
6x6 normal equations accumulate through block reductions, and the
solve and retraction are scalar math between vector passes.

Numerics follow models/optimizer.py::pose_optimization (same damping
schedule, same chi2-carried accept/reject, same Huber deltas and
per-round reclassification); tests compare the two edge for edge.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from active_orb_slam2_tpu.geometry.projection import CameraParams
from active_orb_slam2_tpu.models.optimizer import (
    CHI2_MONO, CHI2_STEREO, PoseOptResult, cholesky_solve, inv_sigma2,
    pose_optimization)

# rows of the packed [16, E] edge input
_PW, _OBS, _WINFO, _STEREO, _VALID, _CHI2TH = 0, 3, 6, 7, 8, 9
_ROWS = 16


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def _quat_rotate(q, v):
    """Rotate a scalar-or-vector triplet v by the scalar quaternion q."""
    qw, qx, qy, qz = q
    vx, vy, vz = v
    # uv = q_vec x v;  out = v + 2*(qw*uv + q_vec x uv)
    uvx = qy * vz - qz * vy + qw * vx
    uvy = qz * vx - qx * vz + qw * vy
    uvz = qx * vy - qy * vx + qw * vz
    return (vx + 2.0 * (qy * uvz - qz * uvy),
            vy + 2.0 * (qz * uvx - qx * uvz),
            vz + 2.0 * (qx * uvy - qy * uvx))


def _so3_exp(wx, wy, wz):
    """Axis-angle -> quaternion (w, x, y, z) with the small-angle series
    of geometry/se3.py::_so3_exp."""
    t2 = wx * wx + wy * wy + wz * wz
    t = jnp.sqrt(t2)
    small = t < 1e-6
    k = jnp.where(small, 0.5 - t2 / 48.0,
                  jnp.sin(0.5 * t) / jnp.maximum(t, 1e-20))
    qw = jnp.where(small, 1.0 - t2 / 8.0, jnp.cos(0.5 * t))
    return qw, k * wx, k * wy, k * wz


def _left_jacobian_apply(wx, wy, wz, vx, vy, vz):
    """Jl(w) @ v with the series of geometry/se3.py."""
    t2 = wx * wx + wy * wy + wz * wz
    t = jnp.sqrt(t2)
    small = t < 1e-6
    a = jnp.where(small, 0.5 - t2 / 24.0,
                  (1.0 - jnp.cos(t)) / jnp.maximum(t2, 1e-20))
    b = jnp.where(small, 1.0 / 6.0 - t2 / 120.0,
                  (t - jnp.sin(t)) / jnp.maximum(t2 * t, 1e-20))
    # W v = w x v;  W^2 v = w x (w x v)
    w1x = wy * vz - wz * vy
    w1y = wz * vx - wx * vz
    w1z = wx * vy - wy * vx
    w2x = wy * w1z - wz * w1y
    w2y = wz * w1x - wx * w1z
    w2z = wx * w1y - wy * w1x
    return (vx + a * w1x + b * w2x,
            vy + a * w1y + b * w2y,
            vz + a * w1z + b * w2z)


def _retract(pose, step):
    """exp(step) * pose on scalar tuples (q..., t...), as
    geometry/se3.py::se3_retract."""
    qw, qx, qy, qz, tx, ty, tz = pose
    dwx, dwy, dwz, dvx, dvy, dvz = step
    eq = _so3_exp(dwx, dwy, dwz)
    etx, ety, etz = _left_jacobian_apply(dwx, dwy, dwz, dvx, dvy, dvz)
    nq = _quat_mul(eq, (qw, qx, qy, qz))
    inv = 1.0 / jnp.maximum(
        jnp.sqrt(nq[0] ** 2 + nq[1] ** 2 + nq[2] ** 2 + nq[3] ** 2), 1e-12)
    rx, ry, rz = _quat_rotate(eq, (tx, ty, tz))
    return (nq[0] * inv, nq[1] * inv, nq[2] * inv, nq[3] * inv,
            rx + etx, ry + ety, rz + etz)


def _dot(a, b):
    """Sum of products over paired entries, skipping structural zeros
    (None); None when every product is one."""
    out = None
    for x, y in zip(a, b):
        if x is not None and y is not None:
            out = x * y if out is None else out + x * y
    return out


def _build_kernel(cam: CameraParams, rounds: int, iters_per_round: int):
    fx, fy, cx, cy, bf = (float(cam.fx), float(cam.fy), float(cam.cx),
                          float(cam.cy), float(cam.bf))

    def linearize(pose, e):
        """Residual rows r[3], Jacobian rows J[3][6] (None = structural
        zero), per-edge chi2 and positive-depth mask, all [E]."""
        pcx, pcy, pcz = _quat_rotate(pose[:4], e["pw"])
        pcx, pcy, pcz = pcx + pose[4], pcy + pose[5], pcz + pose[6]
        zs = jnp.where(jnp.abs(pcz) < 1e-9, 1e-9, pcz)
        iz = 1.0 / zs
        iz2 = iz * iz
        u = fx * pcx * iz + cx
        v = fy * pcy * iz + cy
        stf = e["stf"]
        r = [u - e["obs"][0], v - e["obs"][1],
             stf * (u - bf * iz - e["obs"][2])]
        # d(u, v, uR)/d pc, row a = (p0, p1, p2); J_rot = -p @ [pc]x,
        # J_trans = p
        jpc = [(fx * iz, None, -fx * pcx * iz2),
               (None, fy * iz, -fy * pcy * iz2),
               (stf * fx * iz, None, stf * (bf - fx * pcx) * iz2)]
        J = []
        for p0, p1, p2 in jpc:
            rot = (_dot((p1, p2), (pcz, -pcy)),
                   _dot((p0, p2), (-pcz, pcx)),
                   _dot((p0, p1), (pcy, -pcx)))
            J.append([-x for x in rot] + [p0, p1, p2])
        c2 = e["w_info"] * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
        return r, J, c2, (pcz > 0).astype(jnp.float32)

    def kernel(pose_ref, edge_ref, out_ref, mask_ref):
        row = lambda i: edge_ref[i, :]                      # noqa: E731
        e = {"pw": (row(_PW), row(_PW + 1), row(_PW + 2)),
             "obs": (row(_OBS), row(_OBS + 1), row(_OBS + 2)),
             "w_info": row(_WINFO), "stf": row(_STEREO)}
        valid, chi2_th = row(_VALID), row(_CHI2TH)
        delta_h = jnp.sqrt(jnp.where(e["stf"] > 0, CHI2_STEREO, CHI2_MONO))
        lane = jax.lax.broadcasted_iota(jnp.int32, (8,), 0)
        pose_v = pose_ref[...]
        pose = tuple(jnp.sum(jnp.where(lane == i, pose_v, 0.0))
                     for i in range(7))
        inl = valid

        for rnd in range(rounds):
            use_huber = rnd < 2

            def body(_, carry, inl=inl, use_huber=use_huber):
                pose, best = carry[:7], carry[7:14]
                best_chi2, lam = carry[14], carry[15]
                r, J, c2, zpos = linearize(pose, e)
                gate = inl * zpos
                chi2 = jnp.sum(c2 * gate)
                # acceptance of the PREVIOUS step, judged by this residual
                worse = chi2 > best_chi2
                lam = jnp.clip(jnp.where(worse, lam * 4.0, lam * 0.5),
                               1e-8, 1e2)
                best = tuple(jnp.where(worse, b, p)
                             for b, p in zip(best, pose))
                best_chi2 = jnp.minimum(chi2, best_chi2)
                w = e["w_info"] * gate
                if use_huber:
                    w = w * jnp.minimum(
                        1.0, delta_h / jnp.sqrt(jnp.maximum(c2, 1e-12)))
                cols = [[J[a][i] for a in range(3)] for i in range(6)]
                H = [[None] * 6 for _ in range(6)]
                for i in range(6):
                    for j in range(i + 1):
                        d = _dot(cols[i], cols[j])
                        H[i][j] = H[j][i] = (jnp.float32(0.0) if d is None
                                             else jnp.sum(w * d))
                g = [-jnp.sum(w * _dot(cols[i], r)) for i in range(6)]
                damped = [[H[i][j] * (1.0 + lam) + 1e-9 if i == j
                           else H[i][j] for j in range(6)]
                          for i in range(6)]
                step = cholesky_solve(damped, g)
                new = _retract(pose, step)
                new = tuple(jnp.where(worse, b, n) for b, n in zip(best, new))
                return new + best + (best_chi2, lam)

            init = pose + pose + (jnp.float32(jnp.inf), jnp.float32(1e-4))
            out = jax.lax.fori_loop(0, iters_per_round, body, init)
            cand, best, best_chi2 = out[:7], out[7:14], out[14]
            # final acceptance of the last proposed step
            _, _, c2c, zposc = linearize(cand, e)
            better = jnp.sum(c2c * inl * zposc) <= best_chi2
            pose = tuple(jnp.where(better, c, b) for c, b in zip(cand, best))
            # chi2 reclassification for the next round
            _, _, c2r, zposr = linearize(pose, e)
            inl = valid * zposr * (c2r <= chi2_th).astype(jnp.float32)

        _, _, c2f, _ = linearize(pose, e)
        packed = pose + (jnp.sum(c2f * inl),)
        out_v = jnp.zeros((8,), jnp.float32)
        for i, x in enumerate(packed):
            out_v = jnp.where(lane == i, x, out_v)
        out_ref[...] = out_v
        mask_ref[...] = inl

    return kernel


def padded_edges(n: int) -> int:
    """Edge-vector width inside the kernel: the next power of two (the
    Triton route wants power-of-two blocks)."""
    return max(16, 1 << (n - 1).bit_length())


# warps of the single program: 8 beat 4 and 16 at E = 1024 and 2048 on
# an H100 (CHANGES.md)
_NUM_WARPS = 8


@functools.lru_cache(maxsize=None)
def _pose_opt_call(cam_key, e_pad: int, rounds: int, iters_per_round: int,
                   **call_options):
    kernel = _build_kernel(CameraParams(*cam_key), rounds, iters_per_round)
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((8,), jnp.float32),     # pose+chi2
                   jax.ShapeDtypeStruct((e_pad,), jnp.float32)],  # inliers
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1),
        name="pose_opt_fused",
        **call_options)


def pose_optimization_fused(cam: CameraParams, pose0, pw, obs_uvr, level,
                            has_stereo, valid,
                            rounds: int = 4, iters_per_round: int = 10,
                            **call_options) -> PoseOptResult:
    """The fused kernel with optimizer.pose_optimization's signature.

    Edges are padded to a power of two with ``valid`` false.
    ``call_options`` go to ``pl.pallas_call`` (tests run the kernel
    through the interpreter on the CPU).
    """
    E = pw.shape[0]
    e_pad = padded_edges(E)
    rows = [pw.T.astype(jnp.float32), obs_uvr.T.astype(jnp.float32),
            inv_sigma2(level)[None], has_stereo.astype(jnp.float32)[None],
            valid.astype(jnp.float32)[None],
            jnp.where(has_stereo, CHI2_STEREO, CHI2_MONO)[None]]
    edges = jnp.concatenate(rows, axis=0)                   # [10, E]
    edges = jnp.pad(edges, ((0, _ROWS - edges.shape[0]), (0, e_pad - E)))
    pose_in = jnp.concatenate([pose0.astype(jnp.float32),
                               jnp.zeros((1,), jnp.float32)])
    cam_key = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
               cam.width, cam.height)
    out, mask = _pose_opt_call(cam_key, e_pad, rounds, iters_per_round,
                               **call_options)(pose_in, edges)
    inliers = mask[:E] > 0.5
    return PoseOptResult(pose=out[:7], inliers=inliers,
                         n_inliers=inliers.sum().astype(jnp.int32),
                         chi2=out[7])


def select_pose_optimization():
    """The motion-only BA for this backend: the fused kernel on the GPU,
    the plain XLA function on the CPU."""
    backend = jax.default_backend()
    if backend == "gpu":
        return pose_optimization_fused
    if backend == "cpu":
        return pose_optimization
    raise NotImplementedError(f"no pose optimization for {backend!r}")
