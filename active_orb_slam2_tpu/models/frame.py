"""Frame construction: ORB extraction + per-feature stereo/depth info.

Replaces the reference's ``Frame`` constructors (``src/Frame.cc`` [U]):
the RGB-D path (``ComputeStereoFromRGBD`` ~L530-560: depth -> virtual
right coordinate uR = u - bf/d) and keypoint undistortion.  The 64x48
feature grid (``AssignFeaturesToGrid``) has no equivalent here — the
dense masked distance matrix in ops/matching.py replaces grid lookups.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.config import SlamConfig
from active_orb_slam2_tpu.geometry.projection import CameraParams
from active_orb_slam2_tpu.ops.orb import OrbFeatures, build_extractor


class FrameData(NamedTuple):
    """One frame's measurements, fixed shape [N = n_features]."""
    uv: jnp.ndarray        # [N, 2] keypoint pixels (undistorted)
    level: jnp.ndarray     # [N] int32
    angle: jnp.ndarray     # [N]
    response: jnp.ndarray  # [N]
    desc: jnp.ndarray      # [N, 8] uint32
    valid: jnp.ndarray     # [N] bool
    ur: jnp.ndarray        # [N] virtual right x-coord (<0 = mono)
    depth: jnp.ndarray     # [N] metric depth (<=0 = none)


def frame_from_features(feats: OrbFeatures, cam: CameraParams,
                        depth_map: Optional[jnp.ndarray] = None,
                        dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
                        ) -> FrameData:
    """Attach depth / virtual-right info to extracted features.

    ``depth_map`` is a metric-depth image [H, W] (already divided by
    DepthMapFactor); 0 marks missing depth, as in TUM RGB-D.

    ``dist`` is the static radtan tuple (k1, k2, p1, p2, k3); when any
    coefficient is nonzero, keypoints are undistorted like
    ``Frame::UndistortKeyPoints`` (``src/Frame.cc`` ~L330-390 [U]) —
    depth is sampled at the RAW detector coordinates (the depth image
    shares the camera's distortion), while ``uv``/``ur`` are ideal
    pinhole coordinates for all downstream geometry, matching the
    reference's mvKeys/mvKeysUn split.
    """
    n = feats.uv.shape[0]
    raw_uv = feats.uv
    if any(float(v) != 0.0 for v in dist):
        from active_orb_slam2_tpu.ops.undistort import undistort_points
        uv = undistort_points(cam, dist, raw_uv)
    else:
        uv = raw_uv
    if depth_map is not None:
        h, w = depth_map.shape
        xi = jnp.clip(jnp.round(raw_uv[:, 0]).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(jnp.round(raw_uv[:, 1]).astype(jnp.int32), 0, h - 1)
        d = depth_map[yi, xi]
        has_d = (d > 0) & feats.valid
        ur = jnp.where(has_d, uv[:, 0] - cam.bf / jnp.maximum(d, 1e-6),
                       -1.0)
        depth = jnp.where(has_d, d, 0.0)
    else:
        ur = jnp.full((n,), -1.0, jnp.float32)
        depth = jnp.zeros((n,), jnp.float32)
    return FrameData(uv=uv, level=feats.level, angle=feats.angle,
                     response=feats.response, desc=feats.desc,
                     valid=feats.valid, ur=ur, depth=depth)


def build_frame_pipeline(cfg: SlamConfig):
    """Jitted (image, depth?) -> (FrameData, n_depth) for the camera.

    Inputs are transfer-optimized: gray may be uint8 and depth uint16
    millimetres (4x/2x smaller host->device transfers than float32 —
    significant when the device link is thin); conversion happens
    on-device inside the jitted program.
    """
    cam = cfg.camera
    dist = cfg.distortion
    extract = build_extractor(cfg.orb, cam.height, cam.width)

    @jax.jit
    def make_rgbd(image, depth_map):
        img = image.astype(jnp.float32)
        depth = depth_map.astype(jnp.float32)
        if depth_map.dtype == jnp.uint16:
            depth = depth * jnp.float32(1e-3)      # mm -> m
        frame = frame_from_features(extract(img), cam, depth, dist)
        n_depth = (frame.valid & (frame.depth > 0.1)).sum()
        return frame, n_depth.astype(jnp.int32)

    @jax.jit
    def make_rgbd_packed(packed):
        """Single-transfer variant: [3, H, W] uint8 — row 0 = gray,
        rows 1/2 = lo/hi bytes of depth in millimetres (byte-packed: one
        small host->device transfer per frame)."""
        img = packed[0].astype(jnp.float32)
        depth = (packed[1].astype(jnp.float32)
                 + 256.0 * packed[2].astype(jnp.float32)) \
            * jnp.float32(1e-3)
        frame = frame_from_features(extract(img), cam, depth, dist)
        n_depth = (frame.valid & (frame.depth > 0.1)).sum()
        return frame, n_depth.astype(jnp.int32)
    make_rgbd.packed = make_rgbd_packed

    @jax.jit
    def make_mono(image):
        img = image.astype(jnp.float32)
        frame = frame_from_features(extract(img), cam, None, dist)
        return frame, jnp.int32(0)

    return make_rgbd, make_mono


def build_stereo_pipeline(cfg: SlamConfig):
    """Jitted (left, right) -> (FrameData, n_depth): extract ORB on both
    rectified images (the reference spawns two extraction threads,
    ``Frame`` stereo ctor [U]; here one program covers both), then
    row-SAD stereo matching (ops/stereo)."""
    from active_orb_slam2_tpu.ops.stereo import compute_stereo_matches
    cam = cfg.camera
    extract = build_extractor(cfg.orb, cam.height, cam.width)

    @jax.jit
    def make_stereo(left, right):
        il = left.astype(jnp.float32)
        ir = right.astype(jnp.float32)
        fl = extract(il)
        fr = extract(ir)
        ur, depth = compute_stereo_matches(cam, fl, fr, il, ir)
        n = fl.uv.shape[0]
        frame = FrameData(
            uv=fl.uv, level=fl.level, angle=fl.angle,
            response=fl.response, desc=fl.desc, valid=fl.valid,
            ur=jnp.where(fl.valid, ur, -1.0),
            depth=jnp.where(fl.valid, depth, 0.0))
        n_depth = (frame.valid & (frame.depth > 0.1)).sum()
        return frame, n_depth.astype(jnp.int32)

    return make_stereo
