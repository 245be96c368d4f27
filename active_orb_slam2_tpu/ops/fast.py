"""FAST-16 corner detection as a whole-image vectorized score map.

Array-program reformulation of the reference's per-cell ``cv::FAST`` calls
in ``ORBextractor::ComputeKeyPointsOctTree`` (``src/ORBextractor.cc``
~L610-700 [U]).  Instead of branchy per-pixel arc tests, we compute for
EVERY pixel the maximal threshold at which it is still a FAST-9/16
corner ("corner score", same semantics as OpenCV's FAST score):

  score(p) = max over 9-long arcs A of  min_{i in A} |I[p+c_i] - I[p]|
             taken over arcs that are entirely brighter / darker.

A pixel is a corner at threshold t iff score(p) > t — so ONE score map
serves both the reference's iniThFAST=20 pass and its minThFAST=7
per-cell fallback (SURVEY.md §7.4 item 1).

The 16 circle neighbours are materialized as shifted images; the min
over 9 consecutive arc elements uses a log-doubling reduction (4 rolls
instead of 16x9 pairwise mins).  Everything is fusible elementwise
math that XLA fuses into a few passes over the image.
"""

import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock —
# the standard FAST-16 ring.
CIRCLE_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9/16


def _ring_diffs(img):
    """[16, H, W] of I[p + c_i] - I[p] (wrap-around borders; caller masks)."""
    shifted = [jnp.roll(img, (-dy, -dx), axis=(0, 1))
               for dy, dx in CIRCLE_OFFSETS]
    return jnp.stack(shifted, axis=0) - img[None]


def _arc_extrema(x):
    """For stacked ring values x [16, H, W], return per-rotation min and
    max over the 9 consecutive elements starting at each index
    (circular), via log-doubling."""
    def doubling(v, op):
        m2 = op(v, jnp.roll(v, -1, axis=0))
        m4 = op(m2, jnp.roll(m2, -2, axis=0))
        m8 = op(m4, jnp.roll(m4, -4, axis=0))
        return op(m8, jnp.roll(v, -8, axis=0))
    return doubling(x, jnp.minimum), doubling(x, jnp.maximum)


def fast_score_map(img, border: int = 3):
    """Corner score for every pixel of [H, W] float image.

    Returns scores [H, W] float32; 0 where not a corner at any t > 0.
    ``border`` pixels at the edge are zeroed (ring would wrap).

    Internally bfloat16: pixel values and their differences are
    integers <= 255, exactly representable, so the halved memory
    traffic is free (the [16, H, W] ring stack is the bandwidth cost).
    """
    d = _ring_diffs(img.astype(jnp.bfloat16))
    amin, amax = _arc_extrema(d)
    # bright arc: all 9 diffs > t  -> score contribution min(diff) = amin
    # dark arc:   all 9 diffs < -t -> contribution min(-diff) = -amax
    score = jnp.maximum(jnp.max(amin, axis=0), jnp.max(-amax, axis=0))
    score = jnp.maximum(score, 0.0).astype(jnp.float32)
    h, w = img.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = ((ys >= border) & (ys < h - border) &
                (xs >= border) & (xs < w - border))
    return jnp.where(interior, score, 0.0)


def nms3x3(score):
    """3x3 non-maximum suppression: keep score where it equals the local
    max (reference relies on cv::FAST's built-in NMS [U])."""
    import jax
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    return jnp.where((score >= pooled) & (score > 0.0), score, 0.0)
