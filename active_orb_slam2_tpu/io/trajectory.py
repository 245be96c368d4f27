"""Trajectory output in the reference's exact file formats.

``System::SaveTrajectoryTUM`` / ``SaveKeyFrameTrajectoryTUM`` /
``SaveTrajectoryKITTI`` (``src/System.cc`` ~L320-480 [U]):
  * TUM:   ``timestamp tx ty tz qx qy qz qw`` (camera-to-world)
  * KITTI: 12 floats, row-major 3x4 camera-to-world matrix

Like the reference, per-frame poses are stored RELATIVE to their
reference keyframe (``mlRelativeFramePoses``) and replayed against the
final (BA/loop-corrected) keyframe poses at save time.
"""

import numpy as np

from active_orb_slam2_tpu.geometry.se3 import (
    se3_compose, se3_inverse, se3_to_mat44, quat_to_mat)


def resolve_frame_poses(rel_records, kf_poses):
    """rel_records: list of (timestamp, ref_kf_slot, Tcr [7]) per frame;
    kf_poses: final [K, 7] Tcw.  Returns (timestamps, Tcw [N, 7]).

    Vectorized host-side replay (numpy): no device dispatch per
    record."""
    if not rel_records:
        return np.zeros((0,)), np.zeros((0, 7))
    kf = np.asarray(kf_poses, np.float64)
    ts = np.array([t for t, _, _ in rel_records])
    refs = np.array([r for _, r, _ in rel_records], np.int64)
    tcr = np.stack([np.asarray(c, np.float64)
                    for _, _, c in rel_records])
    # ref -1 = frozen ABSOLUTE record (its reference KF was culled with
    # no live parent): compose against identity
    ident = np.array([1.0, 0, 0, 0, 0, 0, 0])
    ref_pose = np.where((refs >= 0)[:, None], kf[np.maximum(refs, 0)],
                        ident[None])                      # [N, 7]

    def bquat_mul(a, b):                                  # [N,4]x[N,4]
        aw, ax, ay, az = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
        bw, bx, by, bz = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        return np.stack([
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw], axis=-1)

    def bquat_rot(q, v):                                  # [N,4],[N,3]
        qw, qv = q[:, :1], q[:, 1:]
        uv = np.cross(qv, v) + qw * v
        return v + 2.0 * np.cross(qv, uv)

    q = bquat_mul(tcr[:, :4], ref_pose[:, :4])
    t3 = bquat_rot(tcr[:, :4], ref_pose[:, 4:7]) + tcr[:, 4:7]
    out = np.concatenate([q, t3], axis=-1)
    n = np.linalg.norm(out[:, :4], axis=-1, keepdims=True)
    out[:, :4] /= np.maximum(n, 1e-12)
    return ts, out.astype(np.float32)


def save_tum(path, timestamps, poses_cw):
    """Write TUM format (camera-to-world)."""
    with open(path, "w") as f:
        for t, p in zip(timestamps, poses_cw):
            import jax.numpy as jnp
            twc = np.asarray(se3_inverse(jnp.asarray(p)))
            qw, qx, qy, qz = twc[:4]
            tx, ty, tz = twc[4:7]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")


def save_kitti(path, poses_cw):
    """Write KITTI format: row-major 3x4 of Twc per line."""
    import jax.numpy as jnp
    with open(path, "w") as f:
        for p in poses_cw:
            m = np.asarray(se3_to_mat44(se3_inverse(jnp.asarray(p))))
            row = m[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def camera_centers(poses_cw):
    """[N, 7] Tcw -> [N, 3] camera centers in world."""
    import jax.numpy as jnp
    p = jnp.asarray(poses_cw)
    R_t = quat_to_mat(p[:, :4])
    return np.asarray(-jnp.einsum('nij,ni->nj', R_t, p[:, 4:7]))
