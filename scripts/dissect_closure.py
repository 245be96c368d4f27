"""Replay a dumped loop correction (build/badloop.npz, written when the
correction gate rejects a closure) stage by stage and print the map's
mean chi2 after each stage — the endurance postmortem tool (it found
the double-anchor overshoot and a matmul-precision divergence).

  python scripts/dissect_closure.py [dump.npz] [--precision X]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    from active_orb_slam2_tpu.models.loop_closing import BADLOOP_DUMP
    ap.add_argument("dump", nargs="?", default=BADLOOP_DUMP)
    ap.add_argument("--precision", default=None,
                    choices=(None, "default", "high", "highest"))
    ap.add_argument("--gba-iters", type=int, default=3)
    args = ap.parse_args()

    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    import jax
    if args.precision and args.precision != "default":
        jax.config.update("jax_default_matmul_precision", args.precision)
    import numpy as np
    import jax.numpy as jnp
    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import CameraParams
    from active_orb_slam2_tpu.models.map_state import (
        MapState, covisibility_weights)
    import active_orb_slam2_tpu.models.loop_closing as L
    from active_orb_slam2_tpu.geometry.se3 import (
        sim3_compose, sim3_from_se3, sim3_inverse)
    from active_orb_slam2_tpu.models.pose_graph import (
        build_essential_edges, optimize_essential_graph)
    from active_orb_slam2_tpu.parallel.dist_ba import (
        build_point_major_edges, global_ba)

    d = np.load(args.dump)
    fields = {f: jnp.asarray(d[f]) for f in MapState._fields}
    m = MapState(**fields)
    cur, loop = int(d["cur_kf"]), int(d["loop_kf"])
    li = jnp.asarray(d["li"])
    lj = jnp.asarray(d["lj"])
    new_n = int(d["new_n"])
    w, h = 320, 240
    f = 260.0
    cam = CameraParams(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
                       bf=f * 0.08, width=w, height=h)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1024,
                                               n_levels=8),
                     tracking=TrackingConfig(th_depth=8.0,
                                             kf_max_interval=8),
                     map=MapConfig())
    chi2 = jax.jit(lambda mm: L._map_mean_chi2(cam, mm))
    W = covisibility_weights(m)
    print("pre chi2:", round(float(chi2(m)), 3))
    s_cm = jnp.asarray(d["s_cm"])
    pre_sim3 = sim3_from_se3(m.kf_pose)
    corrected_scur = sim3_compose(s_cm, sim3_from_se3(m.kf_pose[loop]))
    group = (W[cur] >= cfg.map.covis_min_weight) \
        .at[cur].set(True) & m.kf_valid
    m1, anchor = L._apply_sim3_correction(
        m, pre_sim3, corrected_scur, jnp.asarray(cur), group)
    print("post stage1 chi2:", round(float(chi2(m1)), 3))
    m2 = L._fuse_loop_points(m1, jnp.asarray(cur), jnp.asarray(loop),
                             W, cfg)
    loop_rel = sim3_compose(corrected_scur, sim3_inverse(pre_sim3[loop]))
    edges = build_essential_edges(pre_sim3, m2.kf_valid, m2.kf_parent,
                                  W, li, lj, max_loop=32)
    E0 = edges.meas_ji.shape[0] - 32
    edges = edges._replace(
        meas_ji=edges.meas_ji.at[E0 + new_n].set(loop_rel))
    cur_sim3 = sim3_from_se3(m2.kf_pose)
    fixed = jnp.zeros(m2.max_keyframes, bool) \
        .at[loop].set(True) | ~m2.kf_valid
    opt_sim3, pgc = optimize_essential_graph(cur_sim3, edges, fixed)
    m3 = L._apply_posegraph_result(m2, cur_sim3, opt_sim3,
                                   preferred_anchor=anchor)
    print("post-pg chi2:", round(float(chi2(m3)), 3),
          " pg internal:", round(float(pgc), 4))
    pedges = build_point_major_edges(m3)
    gfixed = jnp.zeros(m3.max_keyframes, bool).at[loop].set(True)
    mm = m3
    for it in range(args.gba_iters):
        poses, pts, _ = global_ba(cam, mm.kf_pose, mm.kf_valid,
                                  mm.pt_xyz, mm.pt_valid, pedges,
                                  gfixed, iters=1, cg_iters=24)
        mm = mm._replace(kf_pose=poses, pt_xyz=pts)
        print(f"post-gba{it+1} chi2:", round(float(chi2(mm)), 3))


if __name__ == "__main__":
    main()
