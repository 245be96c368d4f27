#!/usr/bin/env python3
"""Run the SLAM main path once on a GPU and check what comes out.

    python chip_smoke.py          # one GPU: device, kernels, rgbd, stereo
    python chip_smoke.py --four   # four GPUs: sharded global BA only

Phases (each prints its own lines, prefixed with its name):

  device   JAX must see a GPU (no CPU fallback); prints the device kind,
           the device count and the card's name and power limit.
  kernels  every kernel of the per-frame path against the plain
           reference run on the CPU device in the same process: pose
           optimization at E = 1024 and E = 2048, and the ORB extractor
           on a 640x480 image (patch gather bit-exact; keypoints,
           angles and descriptors within stated targets).
  rgbd     ``System`` with mapping and loop closing at VGA, 1024
           features and the default arena over a seeded synthetic loop;
           fails on LOST, on no closed loop, or on rigid ATE >= 0.15 m.
  stereo   60 frames of the KITTI-shaped stereo deployment (1226x370,
           2000 features, default arena); fails on LOST or ATE >= 0.25 m.
  four     (``--four`` only) the sharded global BA over four GPUs at
           K=512, Pn=65,536, O=8 against single-GPU ``global_ba``.

Any failed phase makes the exit code non-zero.  The last line of
standard output is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FAILED = []


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(phase, ok, msg):
    say(phase, ("ok   " if ok else "FAIL ") + msg)
    if not ok:
        FAILED.append(f"{phase}: {msg}")


# ---------------------------------------------------------------- device

def phase_device(jax, want: int):
    devs = jax.devices()
    d = devs[0]
    say("device", f"platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        say("device", "FAIL no GPU visible to JAX")
        return None
    if len(devs) < want:
        say("device", f"FAIL {want} GPUs needed, {len(devs)} visible")
        return None
    # a child process that never touches JAX
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        say("device", f"FAIL nvidia-smi: {smi.stderr.strip()}")
        return None
    for line in smi.stdout.strip().splitlines():
        say("device", f"nvidia-smi: {line.strip()}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _timed(fn, *args, reps=20):
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# --------------------------------------------------------------- kernels

def pose_problem(E, seed=0):
    """Noisy stereo/mono edges with 10% gross outliers (the pose
    optimizer's test problem at width E)."""
    import jax.numpy as jnp
    from active_orb_slam2_tpu.geometry.projection import CameraParams
    from active_orb_slam2_tpu.geometry.se3 import se3_apply
    rng = np.random.default_rng(seed)
    cam = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                       width=640, height=480)
    pw = rng.uniform(-2, 2, (E, 3)).astype(np.float32)
    pw[:, 2] += 5.0
    true_pose = np.array([0.9990482, 0.0, 0.0436194, 0.0, 0.1, -0.05, 0.2],
                         np.float32)
    pc = np.asarray(se3_apply(jnp.asarray(true_pose), jnp.asarray(pw)))
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    obs = np.stack([u, v, u - cam.bf / pc[:, 2]], -1)
    obs += rng.normal(0, 0.5, (E, 3))
    out = rng.random(E) < 0.1
    obs[out] += rng.uniform(20, 80, (int(out.sum()), 3))
    args = (np.array([1.0, 0, 0, 0, 0.05, 0.0, 0.15], np.float32), pw,
            obs.astype(np.float32),
            rng.integers(0, 8, E).astype(np.int32), rng.random(E) < 0.5,
            np.ones((E,), bool))
    return cam, args


def check_pose_optimization(jax, cpu, E):
    from active_orb_slam2_tpu.models.optimizer import pose_optimization
    from active_orb_slam2_tpu.ops.pose_opt_kernel import (
        select_pose_optimization)
    cam, args = pose_problem(E)
    args = jax.device_put(args)
    chosen = select_pose_optimization()
    gpu_fn = jax.jit(lambda *a: chosen(cam, *a))
    plain_fn = jax.jit(lambda *a: pose_optimization(cam, *a))
    got = gpu_fn(*args)
    ref = plain_fn(*jax.device_put(args, cpu))
    dpose = float(np.abs(np.asarray(got.pose) - np.asarray(ref.pose)).max())
    agree = float((np.asarray(got.inliers)
                   == np.asarray(ref.inliers)).mean())
    ms_chosen = _timed(gpu_fn, *args)
    ms_plain = _timed(plain_fn, *args)
    check("kernels", dpose <= 2e-3 and agree >= 0.97,
          f"pose_opt E={E} ({chosen.__name__} on GPU vs plain on CPU): "
          f"max|dpose|={dpose:.3g} (<=2e-3) inlier agreement={agree:.4f} "
          f"(>=0.97)")
    say("kernels", f"pose_opt E={E} GPU time: {chosen.__name__} "
        f"{ms_chosen:.3f} ms, plain XLA {ms_plain:.3f} ms")


def check_orb(jax, cpu, width=640, height=480, n_features=1024):
    import jax.numpy as jnp
    from active_orb_slam2_tpu.config import OrbConfig
    from active_orb_slam2_tpu.geometry import CameraParams
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, loop_trajectory, render_rgbd)
    from active_orb_slam2_tpu.ops.image import pad_image, resize_bilinear
    from active_orb_slam2_tpu.ops.orb import (
        _level_sizes, build_extractor, extract_patches)
    cfg = OrbConfig(n_features=n_features, n_levels=8)
    cam = rgbd_config(width=width, height=height).camera
    gray, _ = render_rgbd(default_world(n_boxes=0), cam,
                          loop_trajectory(150, radius=2.5)[10])
    img = np.clip(gray, 0, 255).astype(np.uint8).astype(np.float32)
    extract = build_extractor(cfg, height, width)
    f_gpu = jax.device_get(extract(jnp.asarray(img)))
    f_cpu = jax.device_get(extract(jax.device_put(img, cpu)))

    # raw patch gather: bit-exact at level 0 and at a resized level
    gather = jax.jit(extract_patches, static_argnums=3)
    rng = np.random.default_rng(1)
    exact = True
    for lvl in (0, 3):
        h, w = _level_sizes(height, width, cfg)[lvl]
        lev = np.asarray(resize_bilinear(jax.device_put(img, cpu), h, w))
        padded = np.asarray(pad_image(jax.device_put(lev, cpu), cfg.pad))
        ys = rng.integers(0, h, n_features).astype(np.int32)
        xs = rng.integers(0, w, n_features).astype(np.int32)
        p_gpu = np.asarray(gather(jnp.asarray(padded), ys, xs, cfg.pad))
        p_cpu = np.asarray(gather(*jax.device_put((padded, ys, xs), cpu),
                                  cfg.pad))
        exact &= bool(np.array_equal(p_gpu, p_cpu))
    check("kernels", exact, "patch gather GPU == CPU bit for bit "
          "(levels 0 and 3)")

    def keyset(f):
        v = np.asarray(f.valid)
        keys = np.stack([np.round(np.asarray(f.uv)[:, 0] * 64),
                         np.round(np.asarray(f.uv)[:, 1] * 64),
                         np.asarray(f.level)], -1).astype(np.int64)
        return {tuple(k): i for i, k in enumerate(keys) if v[i]}

    kg, kc = keyset(f_gpu), keyset(f_cpu)
    shared = sorted(set(kg) & set(kc))
    agree = len(shared) / max(len(set(kg) | set(kc)), 1)
    ig = np.array([kg[k] for k in shared])
    ic = np.array([kc[k] for k in shared])
    dang = np.angle(np.exp(1j * (np.asarray(f_gpu.angle)[ig]
                                 - np.asarray(f_cpu.angle)[ic])))
    x = np.bitwise_xor(np.asarray(f_gpu.desc)[ig],
                       np.asarray(f_cpu.desc)[ic])
    ham = np.unpackbits(x.view(np.uint8), axis=1).sum(1)
    check("kernels", agree >= 0.99 and ham.mean() <= 2.0,
          f"ORB {width}x{height}: {len(kg)} GPU / {len(kc)} CPU keypoints, "
          f"set agreement={agree:.4f} (>=0.99), descriptor Hamming "
          f"mean={ham.mean():.3f} max={ham.max()} of 256 (mean<=2)")
    say("kernels", f"ORB angle |diff| on shared keypoints: mean "
        f"{np.abs(dang).mean():.2e} rad, max {np.abs(dang).max():.2e} rad")


def phase_kernels(jax):
    cpu = jax.devices("cpu")[0]
    for E in (1024, 2048):
        check_pose_optimization(jax, cpu, E)
    check_orb(jax, cpu)


# -------------------------------------------------------------- sequences

def render_sequence(world, cam, poses, stereo_base=None, supersample=2):
    """Render frames in a thread pool (numpy releases the GIL)."""
    from active_orb_slam2_tpu.io.synthetic import render_rgbd

    def one(Twc):
        g, d = render_rgbd(world, cam, Twc, supersample=supersample)
        g = np.clip(g, 0, 255).astype(np.uint8)
        if stereo_base is None:
            return g, np.clip(d * 1e3, 0, 65535).astype(np.uint16)
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array(
            [stereo_base, 0.0, 0.0], np.float32)
        gr, _ = render_rgbd(world, cam, Twc_r, supersample=supersample)
        return g, np.clip(gr, 0, 255).astype(np.uint8)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(one, poses))


def rigid_ate(slam, gt):
    import jax.numpy as jnp
    from active_orb_slam2_tpu.geometry.horn import umeyama_alignment
    from active_orb_slam2_tpu.io.trajectory import camera_centers
    _, poses = slam.frame_trajectory()
    est = camera_centers(poses)
    *_, rmse = umeyama_alignment(jnp.asarray(est, jnp.float32),
                                 jnp.asarray(gt, jnp.float32),
                                 fix_scale=True)
    return float(rmse)


def run_sequence(slam, frames, fps, kind):
    """Track every frame; returns (wall ms per frame, lost frames)."""
    from active_orb_slam2_tpu.models.system import LOST
    track = slam.track_rgbd if kind == "rgbd" else slam.track_stereo
    t0 = time.perf_counter()
    for i, (a, b) in enumerate(frames):
        track(a, b, i / fps)
    slam.flush()
    ms = (time.perf_counter() - t0) / len(frames) * 1e3
    lost = sum(1 for m in slam.metrics if m.get("state") == LOST)
    return ms, lost + int(slam.state == LOST)


def rgbd_config(n_features=1024, n_levels=8, width=640, height=480,
                map_cfg=None):
    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import CameraParams
    f = 525.0 * width / 640.0
    cam = CameraParams(fx=f, fy=f, cx=(width - 1) / 2.0,
                       cy=(height - 1) / 2.0, bf=f * 40.0 / 525.0,
                       width=width, height=height)
    return SlamConfig(
        camera=cam, orb=OrbConfig(n_features=n_features, n_levels=n_levels),
        tracking=TrackingConfig(th_depth=8.0, kf_max_interval=8),
        map=map_cfg or MapConfig())


# The loop: one lap of LAP poses, then on past the start for the rest of
# FRAMES, so that consecutive keyframes revisit the first ones (loop
# detection asks for three consistent detections in a row).
RGBD_LAP, RGBD_FRAMES = 150, 210


def phase_rgbd(jax, cfg=None, lap=RGBD_LAP, n=RGBD_FRAMES):
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, loop_trajectory)
    from active_orb_slam2_tpu.models.system import System
    cfg = cfg or rgbd_config()
    traj = loop_trajectory(lap, radius=2.5)
    poses = [traj[i % (lap - 1)] for i in range(n)]
    t0 = time.perf_counter()
    frames = render_sequence(default_world(n_boxes=0), cfg.camera, poses)
    say("rgbd", f"rendered {n} frames {cfg.camera.width}x"
        f"{cfg.camera.height} in {time.perf_counter() - t0:.1f} s")
    slam = System(cfg, use_mapping=True, use_loop_closing=True)
    ms, lost = run_sequence(slam, frames, cfg.fps, "rgbd")
    ate = rigid_ate(slam, np.stack([p[:3, 3] for p in poses]))
    walls = [m["wall_ms"] for m in slam.metrics
             if m.get("wall_ms") is not None][n // 2:]
    say("rgbd", f"{ms:.2f} ms/frame over all {n} frames (compiles "
        f"included); enqueue-to-retire median of the second half "
        f"{np.median(walls) if walls else float('nan'):.2f} ms; "
        f"keyframes={slam.kf_seq} loops_closed={slam.n_loops_closed}")
    check("rgbd", lost == 0, f"lost frames={lost}")
    check("rgbd", slam.n_loops_closed >= 1,
          f"loops closed={slam.n_loops_closed} (>=1)")
    check("rgbd", ate < 0.15, f"rigid ATE={ate:.4f} m (<0.15)")
    return slam, frames[-1]


def report_memory(jax, slam, last_frame):
    """Compiled memory of the fused track step, and the device peak."""
    g, d = last_frame
    packed = np.stack([g, (d & 0xFF).astype(np.uint8),
                       (d >> 8).astype(np.uint8)])
    flag = slam._flag(False)
    compiled = slam._fused_step("rgbd").lower(
        packed, slam.map, slam.track, flag, flag).compile()
    say("rgbd", f"track step memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    say("rgbd", f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


def phase_stereo(jax, n=60):
    from active_orb_slam2_tpu.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry import CameraParams
    from active_orb_slam2_tpu.io.synthetic import (
        default_world, loop_trajectory)
    from active_orb_slam2_tpu.models.system import System
    w, h, f, base = 1226, 370, 707.0, 0.12
    cam = CameraParams(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
                       bf=f * base, width=w, height=h)
    cfg = SlamConfig(
        camera=cam, orb=OrbConfig(n_features=2000, n_levels=8),
        tracking=TrackingConfig(th_depth=35.0 * base, kf_max_interval=8),
        map=MapConfig(), fps=10.0, sensor="stereo")
    poses = loop_trajectory(150, radius=2.5)[:n]
    frames = render_sequence(default_world(n_boxes=0), cam, poses,
                             stereo_base=base, supersample=1)
    slam = System(cfg, use_mapping=True, use_loop_closing=True)
    ms, lost = run_sequence(slam, frames, cfg.fps, "stereo")
    ate = rigid_ate(slam, np.stack([p[:3, 3] for p in poses]))
    say("stereo", f"{ms:.2f} ms/frame over {n} frames (compiles "
        f"included); keyframes={slam.kf_seq}")
    check("stereo", lost == 0, f"lost frames={lost}")
    check("stereo", ate < 0.25, f"rigid ATE={ate:.4f} m (<0.25)")


# ------------------------------------------------------------------ four

def phase_four(jax, K=512, Pn=65536, O=8):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from active_orb_slam2_tpu.geometry.projection import CameraParams
    from active_orb_slam2_tpu.io.synthetic import synthetic_ba_problem
    from active_orb_slam2_tpu.parallel.dist_ba import (
        anchor_block_order, build_distributed_ba, global_ba,
        inverse_permutation)
    from active_orb_slam2_tpu.parallel.mesh import make_mesh

    cam = CameraParams(fx=400., fy=400., cx=320., cy=320., bf=40.,
                       width=640, height=640)
    iters, cg = 10, 48
    poses, kf_valid, points, pt_valid, e, fixed = synthetic_ba_problem(
        K=K, Pn=Pn, O=O)
    perm = anchor_block_order(e, jnp.arange(K, dtype=jnp.int32))
    inv = np.asarray(inverse_permutation(perm))
    e_p = jax.tree.map(lambda a: a[perm], e)

    mesh = make_mesh(4)
    shard = NamedSharding(mesh, P("shard"))
    rep = NamedSharding(mesh, P())
    sharded = jax.device_put((points[perm], pt_valid[perm], e_p), shard)
    replicated = jax.device_put((poses, kf_valid, fixed), rep)
    every = set(mesh.devices.flat)
    spread = all(a.sharding.device_set == every
                 for a in jax.tree.leaves(sharded))
    check("four", spread, f"sharded inputs cover all {len(every)} devices")

    dist = build_distributed_ba(mesh, cam, iters=iters, cg_iters=cg)
    args = (replicated[0], replicated[1], sharded[0], sharded[1],
            sharded[2], replicated[2])
    ms_dist = _timed(dist, *args, reps=3)
    out = jax.device_get(dist(*args))

    one = jax.jit(lambda *a: global_ba(cam, *a, iters=iters, cg_iters=cg))
    prob = jax.device_put((poses, kf_valid, points, pt_valid, e, fixed),
                          jax.devices()[0])
    ms_one = _timed(one, *prob, reps=3)
    ref = jax.device_get(one(*prob))

    dt = float(np.abs(out[0][:, 4:7] - ref[0][:, 4:7]).max())
    dchi = abs(float(out[2]) - float(ref[2])) / max(abs(float(ref[2])),
                                                    1e-12)
    dpts = float(np.abs(out[1][inv] - ref[1]).max())
    check("four", dt <= 1e-3 and dchi <= 1e-3,
          f"sharded vs single-GPU global BA (K={K}, Pn={Pn}, O={O}, "
          f"{iters} LM x {cg} CG): translation max|d|={dt:.3g} (<=1e-3), "
          f"chi2 {float(out[2]):.6g} vs {float(ref[2]):.6g}, relative diff="
          f"{dchi:.3g} (<=1e-3), point max|d|={dpts:.3g}")
    say("four", f"wall per solve: sharded over 4 GPUs {ms_dist:.1f} ms, "
        f"single GPU {ms_one:.1f} ms")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded global BA over four GPUs")
    args = ap.parse_args()

    from active_orb_slam2_tpu.utils.runtime import configure_compile_cache
    configure_compile_cache()
    import jax

    want = 4 if args.four else 1
    device = phase_device(jax, want)
    if device is None:
        return 1
    t0 = time.perf_counter()
    if args.four:
        phase_four(jax)
    else:
        for name, fn in (("kernels", phase_kernels),
                         ("rgbd", phase_rgbd), ("stereo", phase_stereo)):
            t = time.perf_counter()
            out = fn(jax)
            if name == "rgbd":
                report_memory(jax, *out)
            say(name, f"phase wall {time.perf_counter() - t:.1f} s")
    say("summary", f"total wall {time.perf_counter() - t0:.1f} s, "
        f"{len(FAILED)} failed check(s)")
    if FAILED:
        for f in FAILED:
            say("summary", f"FAILED {f}")
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
