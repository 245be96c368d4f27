"""Optimizer tests: pose optimization + Schur BA vs ground truth and a
dense-solve oracle on tiny problems (SURVEY.md §4, §7.4 item 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from active_orb_slam2_tpu.geometry import (
    CameraParams, project_stereo, se3_exp, se3_apply, se3_compose,
    se3_identity, se3_log, se3_inverse)
from active_orb_slam2_tpu.models.optimizer import (
    pose_optimization, bundle_adjustment, BAEdges)

CAM = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                   width=640, height=480)


def make_scene(rng, n=200):
    pw = rng.uniform([-2, -1.5, 2], [2, 1.5, 8], size=(n, 3)).astype(np.float32)
    T_true = se3_exp(jnp.array([0.03, -0.05, 0.02, 0.1, -0.2, 0.15]))
    uvr, z = project_stereo(CAM, se3_apply(T_true, jnp.array(pw)))
    return jnp.array(pw), T_true, uvr


def test_pose_optimization_converges(rng):
    pw, T_true, uvr = make_scene(rng)
    noise = jnp.array(rng.normal(size=uvr.shape).astype(np.float32) * 0.3)
    T0 = se3_compose(se3_exp(jnp.array([0.02, 0.01, -0.03, 0.1, 0.05, -0.1])),
                     T_true)
    res = pose_optimization(
        CAM, T0, pw, uvr + noise, jnp.zeros(200, jnp.int32),
        jnp.ones(200, bool), jnp.ones(200, bool))
    err = se3_log(se3_compose(res.pose, se3_inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 5e-3, np.asarray(err)
    assert int(res.n_inliers) > 190


def test_pose_optimization_rejects_outliers(rng):
    pw, T_true, uvr = make_scene(rng)
    uvr_noisy = np.asarray(uvr).copy()
    uvr_noisy[:40] += rng.uniform(30, 80, size=(40, 3))  # gross outliers
    T0 = se3_compose(se3_exp(jnp.array([0.01, 0.0, -0.01, 0.05, 0.0, -0.05])),
                     T_true)
    res = pose_optimization(
        CAM, T0, pw, jnp.array(uvr_noisy), jnp.zeros(200, jnp.int32),
        jnp.ones(200, bool), jnp.ones(200, bool))
    inl = np.asarray(res.inliers)
    assert inl[:40].sum() <= 3          # outliers flagged
    assert inl[40:].mean() > 0.95
    err = se3_log(se3_compose(res.pose, se3_inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 5e-3


def test_pose_optimization_mono_only(rng):
    pw, T_true, uvr = make_scene(rng)
    T0 = se3_compose(se3_exp(jnp.array([0.02, 0.01, 0.02, 0.08, -0.05, 0.1])),
                     T_true)
    res = pose_optimization(
        CAM, T0, pw, uvr, jnp.zeros(200, jnp.int32),
        jnp.zeros(200, bool), jnp.ones(200, bool))  # has_stereo = False
    err = se3_log(se3_compose(res.pose, se3_inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 1e-3


def _make_ba_problem(rng, n_cams=4, n_pts=60, noise=0.0, stereo=True):
    pw = rng.uniform([-2, -1.5, 3], [2, 1.5, 9],
                     size=(n_pts, 3)).astype(np.float32)
    poses = [se3_identity()]
    for i in range(n_cams - 1):
        tw = np.array([0.01, -0.01, 0.02, 0.25, 0.03, 0.02]) \
            * (1 + 0.1 * i)
        poses.append(se3_compose(se3_exp(jnp.array(tw, jnp.float32)),
                                 poses[-1]))
    poses = jnp.stack(poses)
    cam_idx, pt_idx, obs = [], [], []
    for c in range(n_cams):
        uvr, z = project_stereo(CAM, se3_apply(poses[c], jnp.array(pw)))
        for p in range(n_pts):
            cam_idx.append(c)
            pt_idx.append(p)
            obs.append(np.asarray(uvr[p]))
    obs = np.stack(obs) + rng.normal(size=(len(obs), 3)) * noise
    E = len(cam_idx)
    edges = BAEdges(
        cam_idx=jnp.array(cam_idx, jnp.int32),
        pt_idx=jnp.array(pt_idx, jnp.int32),
        obs_uvr=jnp.array(obs, jnp.float32),
        level=jnp.zeros(E, jnp.int32),
        has_stereo=jnp.full(E, stereo),
        valid=jnp.ones(E, bool))
    return poses, jnp.array(pw), edges


def test_ba_recovers_perturbed_state(rng):
    poses_true, pts_true, edges = _make_ba_problem(rng)
    poses0 = jax.vmap(se3_compose)(
        jax.vmap(se3_exp)(jnp.array(
            rng.normal(size=(4, 6)).astype(np.float32) * 0.01)), poses_true)
    poses0 = poses0.at[0].set(poses_true[0])  # keep fixed cam exact
    pts0 = pts_true + jnp.array(
        rng.normal(size=pts_true.shape).astype(np.float32) * 0.05)
    fixed = jnp.array([True, False, False, False])
    res = bundle_adjustment(CAM, poses0, pts0, edges, fixed)
    # gauge fixed by cam0: compare directly
    for c in range(1, 4):
        err = se3_log(se3_compose(res.poses[c], se3_inverse(poses_true[c])))
        assert float(jnp.linalg.norm(err)) < 2e-3, (c, np.asarray(err))
    pt_err = jnp.linalg.norm(res.points - pts_true, axis=-1)
    assert float(jnp.median(pt_err)) < 5e-3


def test_ba_flags_outlier_edges(rng):
    poses_true, pts_true, edges = _make_ba_problem(rng, noise=0.2)
    bad = np.zeros(edges.valid.shape[0], bool)
    bad[::17] = True
    obs = np.asarray(edges.obs_uvr).copy()
    obs[bad] += 50.0
    edges = edges._replace(obs_uvr=jnp.array(obs))
    fixed = jnp.array([True, False, False, False])
    res = bundle_adjustment(CAM, poses_true, pts_true, edges, fixed)
    inl = np.asarray(res.edge_inliers)
    assert inl[bad].sum() == 0
    assert inl[~bad].mean() > 0.9


def test_ba_schur_equals_dense_oracle(rng):
    """One GN step via Schur must equal the dense normal-equation solve
    on a tiny problem (fixed lambda, no robust kernel difference)."""
    from active_orb_slam2_tpu.models.optimizer import (
        _ba_solve_step, _ba_linearize)
    poses_true, pts_true, edges = _make_ba_problem(rng, n_cams=3, n_pts=10,
                                                   noise=0.5)
    fixed = jnp.array([True, False, False])
    inliers = edges.valid
    lam = jnp.float32(1e-5)
    dc, dp, _ = _ba_solve_step(CAM, poses_true, pts_true, edges, fixed,
                               inliers, lam, use_huber=True)

    # dense oracle
    r, Jc, Jx, w, _, _ = _ba_linearize(CAM, poses_true, pts_true, edges,
                                       inliers, use_huber=True)
    Jc = np.asarray(Jc) * np.asarray(~fixed)[np.asarray(edges.cam_idx)][:, None, None]
    Jx, r, w = np.asarray(Jx), np.asarray(r), np.asarray(w)
    nC, nP = 3 * 6, 10 * 3
    H = np.zeros((nC + nP, nC + nP))
    b = np.zeros(nC + nP)
    for e in range(r.shape[0]):
        c, p = int(edges.cam_idx[e]), int(edges.pt_idx[e])
        J = np.zeros((3, nC + nP))
        J[:, 6 * c:6 * c + 6] = Jc[e]
        J[:, nC + 3 * p:nC + 3 * p + 3] = Jx[e]
        H += w[e] * J.T @ J
        b += -w[e] * J.T @ r[e]
    # same damping as the Schur path
    H += np.diag(float(lam) * np.diag(H)) + 1e-6 * np.eye(nC + nP)
    # pin fixed camera
    for i in range(6):
        H[i, :] = 0; H[:, i] = 0; H[i, i] = 1; b[i] = 0
    delta = np.linalg.solve(H, b)
    np.testing.assert_allclose(np.asarray(dc).ravel(), delta[:nC],
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(dp).ravel(), delta[nC:],
                               atol=5e-4)


def _noisy_pose_problem(rng, E):
    """E noisy stereo/mono edges with 10% gross outliers."""
    from active_orb_slam2_tpu.geometry.se3 import se3_apply
    cam = CameraParams(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=30.0,
                       width=320, height=240)
    pw = jnp.asarray(rng.uniform(-2, 2, (E, 3)))
    pw = pw.at[:, 2].add(5.0)
    true_pose = jnp.array([0.9990482, 0.0, 0.0436194, 0.0,
                           0.1, -0.05, 0.2], jnp.float32)
    pc = se3_apply(true_pose, pw)
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    ur = u - cam.bf / pc[:, 2]
    obs = jnp.stack([u, v, ur], -1)
    obs = obs + jnp.asarray(rng.normal(0, 0.5, (E, 3)))
    out_sel = rng.random(E) < 0.1
    obs = jnp.where(jnp.asarray(out_sel)[:, None],
                    obs + jnp.asarray(rng.uniform(20, 80, (E, 3))), obs)
    level = jnp.asarray(rng.integers(0, 4, E).astype(np.int32))
    has_stereo = jnp.asarray(rng.random(E) < 0.5)
    valid = jnp.ones((E,), bool)
    pose0 = jnp.array([1.0, 0, 0, 0, 0.05, 0.0, 0.15], jnp.float32)
    return cam, true_pose, (pose0, pw, obs, level, has_stereo, valid)


def _check_fused_against_reference(rng, E):
    from active_orb_slam2_tpu.ops.pose_opt_kernel import (
        pose_optimization_fused)
    cam, true_pose, args = _noisy_pose_problem(rng, E)
    ref = pose_optimization(cam, *args)
    fus = pose_optimization_fused(cam, *args, interpret=True)
    assert fus.inliers.shape == (E,)
    np.testing.assert_allclose(np.asarray(fus.pose), np.asarray(ref.pose),
                               atol=2e-3)
    # inlier sets agree except borderline chi2 edges
    agree = (np.asarray(fus.inliers) == np.asarray(ref.inliers)).mean()
    assert agree > 0.97, agree
    assert abs(int(fus.n_inliers) - int(ref.n_inliers)) <= 0.03 * E
    # both recover the true pose
    err = np.linalg.norm(np.asarray(fus.pose[4:7] - true_pose[4:7]))
    assert err < 0.02, err


def test_fused_pose_opt_matches_reference_impl(rng):
    """The fused Pallas pose optimizer (run through the interpreter)
    must reproduce the XLA pose_optimization (same schedule, same
    accept/reject) to f32 tolerance on a realistic noisy problem."""
    _check_fused_against_reference(rng, 256)


@pytest.mark.parametrize("E", [1024, 1000])
def test_fused_pose_opt_widths(rng, E):
    """At a deployment width, and at one that the wrapper pads to the
    next power of two with invalid edges."""
    _check_fused_against_reference(rng, E)


@pytest.mark.parametrize("n,expect", [(5, 16), (256, 256), (1000, 1024),
                                      (2000, 2048)])
def test_fused_pose_opt_padding_width(n, expect):
    from active_orb_slam2_tpu.ops.pose_opt_kernel import padded_edges
    assert padded_edges(n) == expect


def test_pose_opt_choice_on_cpu():
    """The CPU backend takes the plain XLA function, never the kernel."""
    from active_orb_slam2_tpu.ops.pose_opt_kernel import (
        select_pose_optimization)
    assert jax.default_backend() == "cpu"
    assert select_pose_optimization() is pose_optimization


@pytest.mark.gpu
@pytest.mark.parametrize("E", [1024, 2000])
def test_fused_pose_opt_on_gpu(gpu, rng, E):
    """The kernel compiled for the card against the plain reference on
    the CPU device of the same process."""
    from active_orb_slam2_tpu.ops.pose_opt_kernel import (
        pose_optimization_fused)
    cam, _, args = _noisy_pose_problem(rng, E)
    cpu = jax.devices("cpu")[0]
    got = jax.jit(lambda *a: pose_optimization_fused(cam, *a))(
        *jax.device_put(args, gpu))
    ref = jax.jit(lambda *a: pose_optimization(cam, *a))(
        *jax.device_put(args, cpu))
    np.testing.assert_allclose(np.asarray(got.pose), np.asarray(ref.pose),
                               atol=2e-3)
    agree = (np.asarray(got.inliers) == np.asarray(ref.inliers)).mean()
    assert agree >= 0.97, agree
