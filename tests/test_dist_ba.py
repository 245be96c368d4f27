"""Distributed BA correctness: sharded result == single-device result
(SURVEY.md §4: fake 8-device CPU mesh)."""

import pytest
import numpy as np
import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.config import MapConfig, OrbConfig
from active_orb_slam2_tpu.geometry import (
    CameraParams, project_stereo, se3_apply, se3_compose, se3_exp,
    se3_identity, se3_inverse, se3_log)
from active_orb_slam2_tpu.models.map_state import empty_map
from active_orb_slam2_tpu.parallel import (
    PointEdges, build_distributed_ba, build_point_major_edges, global_ba,
    make_mesh)

CAM = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                   width=640, height=480)


def make_problem(rng, K=8, Pn=256, O=6, noise=0.3):
    """Synthetic multi-view problem in point-major layout."""
    pts = rng.uniform([-2, -1.5, 3], [2, 1.5, 9], (Pn, 3)).astype(np.float32)
    poses = [se3_identity()]
    for i in range(K - 1):
        poses.append(se3_compose(
            se3_exp(jnp.array([0.01, -0.02, 0.01, 0.3, 0.02, 0.05],
                              jnp.float32)), poses[-1]))
    poses = jnp.stack(poses)
    cams = rng.integers(0, K, size=(Pn, O)).astype(np.int32)
    obs = np.zeros((Pn, O, 3), np.float32)
    for p in range(Pn):
        for o in range(O):
            uvr, _ = project_stereo(
                CAM, se3_apply(poses[cams[p, o]], jnp.array(pts[p])))
            obs[p, o] = np.asarray(uvr)
    obs += rng.normal(size=obs.shape).astype(np.float32) * noise
    e = PointEdges(cam=jnp.array(cams), obs_uvr=jnp.array(obs),
                   level=jnp.zeros((Pn, O), jnp.int32),
                   has_stereo=jnp.ones((Pn, O), bool),
                   valid=jnp.ones((Pn, O), bool))
    return poses, jnp.array(pts), e


def perturb(rng, poses, pts):
    dp = jnp.array(rng.normal(size=(poses.shape[0], 6)).astype(np.float32)
                   * 0.01)
    poses0 = jax.vmap(se3_compose)(jax.vmap(se3_exp)(dp), poses)
    poses0 = poses0.at[0].set(poses[0])
    pts0 = pts + jnp.array(rng.normal(size=pts.shape).astype(np.float32)
                           * 0.05)
    return poses0, pts0


def test_global_ba_converges(rng):
    poses, pts, e = make_problem(rng)
    poses0, pts0 = perturb(rng, poses, pts)
    K, Pn = poses.shape[0], pts.shape[0]
    fixed = jnp.zeros(K, bool).at[0].set(True)
    out_poses, out_pts, chi2 = global_ba(
        CAM, poses0, jnp.ones(K, bool), pts0, jnp.ones(Pn, bool), e,
        fixed, iters=10, max_obs=6)
    for c in range(1, K):
        err = se3_log(se3_compose(out_poses[c], se3_inverse(poses[c])))
        assert float(jnp.linalg.norm(err)) < 3e-3, c


def test_distributed_matches_single_device(rng):
    poses, pts, e = make_problem(rng)
    poses0, pts0 = perturb(rng, poses, pts)
    K, Pn = poses.shape[0], pts.shape[0]
    kf_valid = jnp.ones(K, bool)
    pt_valid = jnp.ones(Pn, bool)
    fixed = jnp.zeros(K, bool).at[0].set(True)

    single = global_ba(CAM, poses0, kf_valid, pts0, pt_valid, e, fixed,
                       iters=5, max_obs=6)

    mesh = make_mesh(8)
    dist_fn = build_distributed_ba(mesh, CAM, iters=5, max_obs=6)
    dist = dist_fn(poses0, kf_valid, pts0, pt_valid, e, fixed)

    np.testing.assert_allclose(np.asarray(single[0]), np.asarray(dist[0]),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(single[1]), np.asarray(dist[1]),
                               atol=2e-3)


def test_point_major_edges_from_map(rng):
    """Observer-list inversion of the forward store."""
    m = empty_map(MapConfig(max_keyframes=8, max_points=64),
                  OrbConfig(n_features=16))
    m = m._replace(
        kf_valid=m.kf_valid.at[:3].set(True),
        kf_feat_valid=m.kf_feat_valid.at[:3].set(True),
        pt_valid=m.pt_valid.at[:4].set(True),
        kf_point=m.kf_point
        .at[0, 0].set(0).at[0, 1].set(1)
        .at[1, 3].set(0).at[1, 4].set(2)
        .at[2, 5].set(0),
        kf_uv=m.kf_uv.at[0, 0].set(jnp.array([10.0, 20.0]))
        .at[1, 3].set(jnp.array([30.0, 40.0]))
        .at[2, 5].set(jnp.array([50.0, 60.0])),
    )
    e = build_point_major_edges(m, max_obs=4)
    # point 0 observed by KFs 0, 1, 2
    assert int(e.valid[0].sum()) == 3
    cams0 = set(np.asarray(e.cam[0])[np.asarray(e.valid[0])].tolist())
    assert cams0 == {0, 1, 2}
    # observations carried over correctly (sorted by kf slot)
    uvs = np.asarray(e.obs_uvr[0, :3, :2])
    assert {tuple(u) for u in uvs.tolist()} == {
        (10.0, 20.0), (30.0, 40.0), (50.0, 60.0)}
    # point 1: single obs; point 3: none
    assert int(e.valid[1].sum()) == 1
    assert int(e.valid[3].sum()) == 0


def test_point_major_obs_cap(rng):
    """More observers than the cap -> truncated, not corrupted."""
    m = empty_map(MapConfig(max_keyframes=8, max_points=16),
                  OrbConfig(n_features=4))
    m = m._replace(
        kf_valid=m.kf_valid.at[:6].set(True),
        kf_feat_valid=m.kf_feat_valid.at[:6].set(True),
        pt_valid=m.pt_valid.at[0].set(True),
        kf_point=m.kf_point.at[:6, 0].set(0),
    )
    e = build_point_major_edges(m, max_obs=4)
    assert int(e.valid[0].sum()) == 4


def test_anchor_block_order_contiguous(rng):
    """Points must sort by their anchor keyframe's temporal rank, so an
    equal split of the permuted axis yields contiguous trajectory
    blocks (SURVEY.md §5.7 north-star partition)."""
    from active_orb_slam2_tpu.parallel import (
        anchor_block_order, inverse_permutation)
    Pn, O, K = 64, 4, 16
    cams = rng.integers(0, K, (Pn, O)).astype(np.int32)
    valid = np.ones((Pn, O), bool)
    valid[5] = False                       # orphan point -> sorts last
    e = PointEdges(cam=jnp.asarray(cams),
                   obs_uvr=jnp.zeros((Pn, O, 3)),
                   level=jnp.zeros((Pn, O), jnp.int32),
                   has_stereo=jnp.zeros((Pn, O), bool),
                   valid=jnp.asarray(valid))
    # kf_frame_id NOT monotone in slot: temporal rank must follow it
    fid = rng.permutation(K).astype(np.int32) * 10
    perm = np.asarray(anchor_block_order(e, jnp.asarray(fid)))
    rank = np.argsort(np.argsort(fid))
    anchors = np.where(valid, rank[cams], 2 ** 30).min(axis=1)
    sorted_anchors = anchors[perm]
    assert (np.diff(sorted_anchors) >= 0).all()
    assert perm[-1] == 5                   # orphan last
    inv = np.asarray(inverse_permutation(jnp.asarray(perm)))
    np.testing.assert_array_equal(perm[inv], np.arange(Pn))


@pytest.mark.slow
def test_distributed_matches_single_device_large_K(rng):
    """Parity at a keyframe count the round-2 dense replicated solve
    could not handle (K = 256 -> S would be [1536, 1536] per shard and
    O(K^3) to factor; the PCG path never materializes it)."""
    poses, pts, e = make_problem(rng, K=256, Pn=2048, O=4, noise=0.2)
    poses0, pts0 = perturb(rng, poses, pts)
    K, Pn = poses.shape[0], pts.shape[0]
    kf_valid = jnp.ones(K, bool)
    pt_valid = jnp.ones(Pn, bool)
    fixed = jnp.zeros(K, bool).at[0].set(True)

    # anchor-block partition before sharding
    from active_orb_slam2_tpu.parallel import (
        anchor_block_order, inverse_permutation)
    fid = jnp.arange(K, dtype=jnp.int32)
    perm = anchor_block_order(e, fid)
    inv = inverse_permutation(perm)
    e_p = jax.tree.map(lambda a: a[perm], e)
    pts_p = pts0[perm]
    ptv_p = pt_valid[perm]

    single = global_ba(CAM, poses0, kf_valid, pts0, pt_valid, e, fixed,
                       iters=3, cg_iters=64)

    mesh = make_mesh(8)
    dist_fn = build_distributed_ba(mesh, CAM, iters=3, cg_iters=64)
    d_poses, d_pts_p, d_chi2 = dist_fn(
        poses0, kf_valid, pts_p, ptv_p, e_p, fixed)
    d_pts = d_pts_p[inv]

    np.testing.assert_allclose(np.asarray(single[0]),
                               np.asarray(d_poses), atol=5e-4)
    np.testing.assert_allclose(np.asarray(single[1]),
                               np.asarray(d_pts), atol=5e-3)
    # and the optimization actually helped
    err0 = float(jnp.linalg.norm(poses0[1:] - poses[1:]))
    err1 = float(jnp.linalg.norm(d_poses[1:] - poses[1:]))
    assert err1 < 0.5 * err0, (err0, err1)


def test_count_dropped_observations():
    from active_orb_slam2_tpu.parallel import count_dropped_observations
    m = empty_map(MapConfig(max_keyframes=8, max_points=16),
                  OrbConfig(n_features=4))
    m = m._replace(
        kf_valid=m.kf_valid.at[:6].set(True),
        kf_feat_valid=m.kf_feat_valid.at[:6].set(True),
        pt_valid=m.pt_valid.at[0].set(True),
        kf_point=m.kf_point.at[:6, 0].set(0),
    )
    kept, dropped = count_dropped_observations(m, max_obs=4)
    assert int(kept) == 4 and int(dropped) == 2


def test_host_chip_mesh_matches_single_device(rng):
    """Multi-host mesh shape ("host", "chip"): points sharded over both
    axes, psums split within and across hosts — must agree
    with the single-device result (SURVEY.md §5.8)."""
    from active_orb_slam2_tpu.parallel import make_host_chip_mesh
    poses, pts, e = make_problem(rng, K=8, Pn=256, O=6)
    poses0, pts0 = perturb(rng, poses, pts)
    K, Pn = poses.shape[0], pts.shape[0]
    kf_valid = jnp.ones(K, bool)
    pt_valid = jnp.ones(Pn, bool)
    fixed = jnp.zeros(K, bool).at[0].set(True)

    single = global_ba(CAM, poses0, kf_valid, pts0, pt_valid, e, fixed,
                       iters=3, cg_iters=48)
    mesh = make_host_chip_mesh(n_hosts=2, n_chips=4)
    assert mesh.axis_names == ("host", "chip")
    dist_fn = build_distributed_ba(mesh, CAM, iters=3,
                                   axis=("host", "chip"), cg_iters=48)
    dist = dist_fn(poses0, kf_valid, pts0, pt_valid, e, fixed)
    np.testing.assert_allclose(np.asarray(single[0]), np.asarray(dist[0]),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(single[1]), np.asarray(dist[1]),
                               atol=2e-3)


def test_sharded_matcher_matches_single_device(rng):
    """Row-sharded Hamming matcher (TP, SURVEY.md §2.5) must agree with
    ops/matching.match_mutual on a replicated problem."""
    from active_orb_slam2_tpu.ops.matching import (
        hamming_matrix, match_mutual)
    from active_orb_slam2_tpu.parallel.matcher import build_sharded_matcher
    M, N = 256, 192
    dq = jnp.asarray(rng.integers(0, 2**32, (M, 8), dtype=np.uint32))
    dt = jnp.asarray(rng.integers(0, 2**32, (N, 8), dtype=np.uint32))
    # make some exact matches so real associations exist
    dt = dt.at[:64].set(dq[:64])
    vq = jnp.ones((M,), bool).at[3].set(False)
    vt = jnp.ones((N,), bool).at[7].set(False)

    ref_idx, ref_dist = match_mutual(
        hamming_matrix(dq, dt, vq, vt), max_dist=50.0, ratio=1.0)

    mesh = make_mesh(8)
    matcher = build_sharded_matcher(mesh, max_dist=50.0, ratio=1.0)
    idx, dist = matcher(dq, vq, dt, vt)
    # ties can resolve to different-but-equidistant targets; compare
    # match distance + agreement where the reference found a match
    matched = np.asarray(ref_idx) >= 0
    got = np.asarray(idx)
    assert (got[matched] >= 0).mean() > 0.95
    agree = got[matched] == np.asarray(ref_idx)[matched]
    assert agree.mean() > 0.95, agree.mean()
    np.testing.assert_allclose(np.asarray(dist)[matched & (got >= 0)],
                               np.asarray(ref_dist)[matched & (got >= 0)],
                               atol=1e-4)
