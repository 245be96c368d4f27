"""Stereo matching: left/right ORB association + subpixel SAD refine.

Array-program redesign of ``Frame::ComputeStereoMatches``
(``src/Frame.cc`` ~L400-520 [U]): the per-row candidate walk becomes a
fully masked [N_l, N_r] Hamming matrix with row-band and disparity
gates; the per-keypoint +-5 px SAD slide becomes one gathered
[N, 11, 21] strip tensor and a vectorized 11-tap SAD + parabola fit.

Outputs align with the RGB-D virtual-right convention: per left
feature, the refined right x-coordinate ``uR`` and metric depth
(bf / disparity), invalid entries < 0.
"""

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.geometry.projection import CameraParams
from active_orb_slam2_tpu.ops.matching import hamming_matrix

PATCH = 5      # SAD half-window (11 x 11)
SLIDE = 5      # +-5 px search


def compute_stereo_matches(cam: CameraParams, feats_l, feats_r,
                           img_l, img_r, min_disp: float = 0.1,
                           max_dist: float = 100.0):
    """Match left->right, refine subpixel, return (ur [N], depth [N]).

    feats_l/feats_r: OrbFeatures of the rectified pair; img_l/img_r:
    the (grayscale, float) images for the SAD refinement.
    """
    # disparity ceiling: disp = bf / Z, reference uses minZ = baseline
    # (Frame::ComputeStereoMatches maxD = mbf / minZ [U]) -> disp <= fx
    max_disp = cam.fx
    uv_l, uv_r = feats_l.uv, feats_r.uv

    d = hamming_matrix(feats_l.desc, feats_r.desc,
                       feats_l.valid, feats_r.valid)
    # row band: |v_l - v_r| <= 2 * scale of the right keypoint's level
    band = 2.0 * 1.2 ** feats_r.level.astype(jnp.float32)
    row_ok = jnp.abs(uv_l[:, 1:2] - uv_r[None, :, 1]) <= band[None, :]
    disp = uv_l[:, 0:1] - uv_r[None, :, 0]
    disp_ok = (disp > min_disp) & (disp < max_disp)
    # levels within one octave
    lv_ok = jnp.abs(feats_l.level[:, None] - feats_r.level[None, :]) <= 1
    d = jnp.where(row_ok & disp_ok & lv_ok, d, 1e9)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
    matched = best_d <= max_dist

    # subpixel SAD refinement at level 0 around the matched column
    h, w = img_l.shape
    pad = PATCH + SLIDE + 2
    il = jnp.pad(img_l, pad, mode="edge")
    ir = jnp.pad(img_r, pad, mode="edge")

    yl = jnp.clip(jnp.round(uv_l[:, 1]).astype(jnp.int32), 0, h - 1) + pad
    xl = jnp.clip(jnp.round(uv_l[:, 0]).astype(jnp.int32), 0, w - 1) + pad
    xr0 = jnp.clip(jnp.round(uv_r[best, 0]).astype(jnp.int32), 0, w - 1) + pad
    yr = jnp.clip(jnp.round(uv_r[best, 1]).astype(jnp.int32), 0, h - 1) + pad

    def patch(img, y, x, half_w):
        return jax.lax.dynamic_slice(
            img, (y - PATCH, x - half_w),
            (2 * PATCH + 1, 2 * half_w + 1))

    pl = jax.vmap(lambda y, x: patch(il, y, x, PATCH))(yl, xl)
    strip = jax.vmap(lambda y, x: patch(ir, y, x, PATCH + SLIDE))(yr, xr0)

    # 11 SAD taps: strip columns [s, s + 11) vs left patch
    def sad_at(s):
        seg = jax.lax.dynamic_slice_in_dim(
            strip, s, 2 * PATCH + 1, axis=2)
        return jnp.abs(seg - pl).sum((1, 2))
    sads = jnp.stack([sad_at(s) for s in range(2 * SLIDE + 1)], axis=1)

    k = jnp.argmin(sads, axis=1)
    k_c = jnp.clip(k, 1, 2 * SLIDE - 1)
    s0 = jnp.take_along_axis(sads, (k_c - 1)[:, None], 1)[:, 0]
    s1 = jnp.take_along_axis(sads, k_c[:, None], 1)[:, 0]
    s2 = jnp.take_along_axis(sads, (k_c + 1)[:, None], 1)[:, 0]
    denom = jnp.maximum(s0 + s2 - 2 * s1, 1e-6)
    delta = jnp.clip(0.5 * (s0 - s2) / denom, -1.0, 1.0)
    ur = (xr0 - pad).astype(jnp.float32) + (k_c - SLIDE) + delta

    disparity = uv_l[:, 0] - ur
    ok = matched & (disparity > min_disp) & (disparity < max_disp)
    # outlier filter: SAD distance vs median (reference 1.5*1.4*median)
    sad_best = s1
    med = jnp.median(jnp.where(ok, sad_best, jnp.nan))
    med = jnp.where(jnp.isnan(med), jnp.inf, med)
    ok &= sad_best <= 2.1 * med
    depth = jnp.where(ok, cam.bf / jnp.maximum(disparity, 1e-6), 0.0)
    ur_out = jnp.where(ok, ur, -1.0)
    return ur_out, depth
