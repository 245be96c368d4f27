"""ORB feature extraction: pyramid -> FAST -> distribute -> orient -> rBRIEF.

Array-program redesign of the reference's ``ORBextractor::operator()``
(``src/ORBextractor.cc`` ~L740, the #1 hot kernel — SURVEY.md §3.2):

  * ``ComputePyramid`` (~L550) -> static per-level resize chain.
  * per-cell FAST w/ threshold fallback + ``DistributeOctTree`` (~L400)
    -> one corner-score map per level, per-cell top-k candidates, then a
    global per-level top-n_l by response.  The quadtree's goal (spatially
    uniform best-response selection) is preserved; the data-dependent
    tree walk is not (SURVEY.md §7.4 item 1).
  * ``IC_Angle`` (~L70) -> batched circular-patch moments over gathered
    31x31 patches.
  * ``GaussianBlur + computeOrbDescriptor`` (~L700) -> separable blur,
    then steered 256-pair BRIEF sampled with one [K, 256] gather; bits
    packed into uint32[8] so Hamming distance rides
    ``lax.population_count`` (and a ±1 bit-matmul).

Divergence note: the reference's learned ``bit_pattern_31_`` table is
not reproduced (no copying); we generate a deterministic BRIEF G-II
pattern (p1 ~ N(0, (S/5)^2), p2 ~ N(p1, (S/10)^2), seed 1234).  The
vocabulary is self-trained on the same descriptors, so internal
consistency is what matters (SURVEY.md §7.2 phase 6).

Everything is fixed-shape: exactly ``n_features`` slots with a validity
mask come out regardless of image content.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from active_orb_slam2_tpu.config import OrbConfig
from active_orb_slam2_tpu.ops.image import gaussian_blur, resize_bilinear, pad_image
from active_orb_slam2_tpu.ops.fast import fast_score_map, nms3x3

HALF_PATCH = 15  # IC_Angle / BRIEF patch radius (reference PATCH_SIZE=31)


class OrbFeatures(NamedTuple):
    """Fixed-size feature set for one frame (mask-valid slots)."""
    uv: jnp.ndarray        # [N, 2] float32 — (x, y) at level-0 scale
    level: jnp.ndarray     # [N] int32 — pyramid octave
    angle: jnp.ndarray     # [N] float32 — orientation (radians)
    response: jnp.ndarray  # [N] float32 — FAST corner score
    desc: jnp.ndarray      # [N, 8] uint32 — 256-bit rBRIEF
    valid: jnp.ndarray     # [N] bool


@functools.lru_cache(maxsize=None)
def descriptor_pattern(seed: int = 1234):
    """Deterministic 256-pair BRIEF sampling pattern [256, 4] int32
    (x1, y1, x2, y2), clipped to the radius-15 DISC so every rotation
    of a tap stays inside the 31x31 patch."""
    rng = np.random.default_rng(seed)
    s = 2 * HALF_PATCH + 1
    p1 = rng.normal(0.0, s / 5.0, size=(256, 2))
    p2 = p1 + rng.normal(0.0, s / 10.0, size=(256, 2))

    def to_disc(p):
        n = np.linalg.norm(p, axis=-1, keepdims=True)
        return p * np.minimum(1.0, (HALF_PATCH - 1e-3) / np.maximum(n, 1e-9))

    pat = np.concatenate([to_disc(p1), to_disc(p2)], axis=1)
    return np.round(pat).astype(np.int32)  # columns: x1, y1, x2, y2


@functools.lru_cache(maxsize=None)
def _circular_mask():
    """Boolean [31, 31] circular patch mask (radius 15) and coordinate
    grids for the intensity-centroid moments (numpy; converted to device
    constants at trace time — caching jnp arrays leaks tracers)."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs * xs + ys * ys) <= r * r + 1
    return (mask.astype(np.float32), xs.astype(np.float32),
            ys.astype(np.float32))


def _level_sizes(h: int, w: int, cfg: OrbConfig):
    return [(max(int(round(h / cfg.scale_factor ** l)), 64),
             max(int(round(w / cfg.scale_factor ** l)), 64))
            for l in range(cfg.n_levels)]


def _features_per_level(cfg: OrbConfig):
    """Geometric distribution of the feature budget over levels, exactly
    as the reference's ORBextractor ctor (nDesiredFeaturesPerScale [U])."""
    f = 1.0 / cfg.scale_factor
    n0 = cfg.n_features * (1 - f) / (1 - f ** cfg.n_levels)
    ns = [int(round(n0 * f ** l)) for l in range(cfg.n_levels - 1)]
    ns.append(max(cfg.n_features - sum(ns), 0))
    return ns


def _detect_level(score, n_keep: int, cfg: OrbConfig):
    """Distribute: per-cell top-k candidates -> global top-n_keep.

    ``score`` is the NMS'd corner-score map with the iniTh/minTh
    per-cell fallback already applied.  Returns (ys, xs, resp) with
    fixed length n_keep; resp == 0 marks empty slots.
    """
    h, w = score.shape
    cs = cfg.cell_size
    hc, wc = -(-h // cs), -(-w // cs)
    pad_h, pad_w = hc * cs - h, wc * cs - w
    sp = jnp.pad(score, ((0, pad_h), (0, pad_w)))
    cells = sp.reshape(hc, cs, wc, cs).transpose(0, 2, 1, 3)
    cells = cells.reshape(hc * wc, cs * cs)
    # per-cell top-k via k max+mask passes: cheap reductions vs
    # lax.top_k's sort-based lowering over [C, cs*cs]
    vals_l, idx_l = [], []
    x = cells
    rows = jnp.arange(hc * wc, dtype=jnp.int32)
    for _ in range(cfg.cell_top_k):
        i = jnp.argmax(x, axis=1).astype(jnp.int32)
        v = jnp.take_along_axis(x, i[:, None], axis=1)[:, 0]
        vals_l.append(v)
        idx_l.append(i)
        x = x.at[rows, i].set(-jnp.inf)
    vals = jnp.stack(vals_l, axis=1)                      # [C, k]
    idx = jnp.stack(idx_l, axis=1)
    cell_ids = jnp.arange(hc * wc, dtype=jnp.int32)[:, None]
    ys = (cell_ids // wc) * cs + idx // cs
    xs = (cell_ids % wc) * cs + idx % cs
    vflat, yflat, xflat = vals.ravel(), ys.ravel(), xs.ravel()
    resp, take = jax.lax.top_k(vflat, n_keep)
    return yflat[take], xflat[take], resp


def _threshold_fallback(score, cfg: OrbConfig):
    """Reference behaviour: detect at iniThFAST; cells with no such
    corner fall back to minThFAST (``ComputeKeyPointsOctTree`` [U])."""
    h, w = score.shape
    cs = cfg.cell_size
    hc, wc = -(-h // cs), -(-w // cs)
    pass_hi = score > cfg.ini_th_fast
    ph = jnp.pad(pass_hi, ((0, hc * cs - h), (0, wc * cs - w)))
    cell_has_hi = ph.reshape(hc, cs, wc, cs).any(axis=(1, 3))
    cell_has_hi = jnp.repeat(jnp.repeat(cell_has_hi, cs, 0), cs, 1)[:h, :w]
    eligible = (score > cfg.min_th_fast) & (pass_hi | ~cell_has_hi)
    return jnp.where(eligible, score, 0.0)


N_ANGLE_BINS = 30   # canonical ORB: steering quantized to 12 degrees
_PATCH_LO = 3       # 31x31 working window inside the 40x40 raw patch
_P40 = 40


@functools.lru_cache(maxsize=None)
def _moment_matrix():
    """[40, 40, 2] constant: circular-masked (gx, gy) placed at the
    31x31 working window of the raw patch (IC_Angle moments [U])."""
    mask, gx, gy = _circular_mask()
    G = np.zeros((_P40, _P40, 2), np.float32)
    sl = slice(_PATCH_LO, _PATCH_LO + 2 * HALF_PATCH + 1)
    G[sl, sl, 0] = mask * gx
    G[sl, sl, 1] = mask * gy
    return G


@functools.lru_cache(maxsize=None)
def _blur_matrices(ksize: int = 7, sigma: float = 2.0):
    """Banded [31, 40] matrices B such that ``B @ raw40 @ B.T`` is the
    Gaussian-blurred 31x31 working window (blur halo lives in the raw
    patch, so no edge handling is needed)."""
    from active_orb_slam2_tpu.ops.image import _gaussian_kernel1d
    g = _gaussian_kernel1d(ksize, sigma)
    n = 2 * HALF_PATCH + 1
    B = np.zeros((n, _P40), np.float32)
    for r in range(n):
        B[r, r:r + ksize] = g      # blurred row r = raw rows r..r+6
    return B


@functools.lru_cache(maxsize=None)
def _tap_matrix(seed: int = 1234, nb: int = N_ANGLE_BINS):
    """One-hot tap-selection tensor [nb, 961, 512] bfloat16.

    For angle bin b, tap t (512 = 256 pairs x 2 endpoints) reads flat
    patch pixel S[b, :, t].argmax().  Multiplying the flattened blurred
    patch by S performs the steered-BRIEF sampling as one contraction
    instead of a gather.  Whether a gather is faster on the GPU: not
    measured.
    """
    pat = descriptor_pattern(seed).astype(np.float64)     # [256, 4]
    px = np.concatenate([pat[:, 0], pat[:, 2]])           # [512]
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    n = 2 * HALF_PATCH + 1
    S = np.zeros((nb, n * n, 512), np.float32)
    for b in range(nb):
        th = (b + 0.5) * 2.0 * np.pi / nb
        c, s = np.cos(th), np.sin(th)
        rx = np.clip(np.round(c * px - s * py), -HALF_PATCH, HALF_PATCH)
        ry = np.clip(np.round(s * px + c * py), -HALF_PATCH, HALF_PATCH)
        flat = ((ry + HALF_PATCH) * n + (rx + HALF_PATCH)).astype(np.int64)
        S[b, flat, np.arange(512)] = 1.0
    return S.astype(np.float32)


def extract_patches(img_padded, ys, xs, pad: int):
    """Gather [K, 40, 40] raw float32 patches around (ys, xs).

    ``img_padded`` [Hp, Wp] float32 is a level image with a ``pad`` px
    border; ys/xs [K] int32 are keypoint coordinates in unpadded image
    space.  The patch covers offsets [-18, +21] around the keypoint:
    BRIEF/IC need +-15 and the 7x7 blur halo +-18; the last three rows
    and columns are slack that no consumer reads.  Windows that would
    leave the padded image are clamped inside it.
    """
    hp, wp = img_padded.shape
    y0 = jnp.clip(ys + pad - 18, 0, hp - _P40).astype(jnp.int32)
    x0 = jnp.clip(xs + pad - 18, 0, wp - _P40).astype(jnp.int32)
    return jax.vmap(lambda y, x: jax.lax.dynamic_slice(
        img_padded, (y, x), (_P40, _P40)))(y0, x0)


def _keypoint_stage(img_padded, ys, xs, pad: int):
    """IC_Angle + blur + steered BRIEF for all keypoints of one level.

    One patch gather, then batched contractions: per-patch Gaussian
    blur (banded matrices), intensity-centroid moments (masked einsum),
    and binned-steering BRIEF taps (one-hot contraction).
    Returns (angles [K], desc [K, 8] uint32).
    """
    raw = extract_patches(img_padded, ys, xs, pad)          # [K, 40, 40]
    K = raw.shape[0]

    G = jnp.asarray(_moment_matrix())
    m = jnp.einsum('kpq,pqc->kc', raw, G)                   # [K, 2]
    angles = jnp.arctan2(m[:, 1], m[:, 0])

    B = jnp.asarray(_blur_matrices())                       # [31, 40]
    blurred = jnp.einsum('rp,kpq,cq->krc', B, raw, B)       # [K, 31, 31]

    nb = N_ANGLE_BINS
    step = 2.0 * jnp.pi / nb
    bins = jnp.floor(jnp.mod(angles, 2.0 * jnp.pi) / step).astype(jnp.int32)
    bins = jnp.clip(bins, 0, nb - 1)
    onehot = jax.nn.one_hot(bins, nb, dtype=jnp.bfloat16)   # [K, nb]
    S = jnp.asarray(_tap_matrix()).astype(jnp.bfloat16)     # [nb, 961, 512]
    flat = blurred.reshape(K, -1).astype(jnp.bfloat16)      # [K, 961]
    taps_all = jax.lax.dot_general(
        flat, S, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)                 # [K, nb, 512]
    taps = jnp.einsum('kbt,kb->kt', taps_all, onehot.astype(jnp.float32))
    v1, v2 = taps[:, :256], taps[:, 256:]
    bits = (v1 < v2).astype(jnp.uint32)                     # [K, 256]
    lanes = bits.reshape(K, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    desc = jnp.sum(lanes * weights[None, None, :], axis=-1,
                   dtype=jnp.uint32)                        # [K, 8]
    return angles, desc


def build_extractor(cfg: OrbConfig, height: int, width: int):
    """Return a jit-compiled ``image [H, W] float32 -> OrbFeatures``.

    Static shapes throughout; call once per (cfg, H, W).
    """
    sizes = _level_sizes(height, width, cfg)
    n_per_level = _features_per_level(cfg)
    pad = cfg.pad

    def extract(img):
        outs = []
        for lvl in range(cfg.n_levels):
            h, w = sizes[lvl]
            # each level resized straight from level 0 (the reference
            # chains level (l-1) -> l; direct resize is equivalent for
            # bilinear to f32 tolerance and lets every level's work
            # start immediately instead of serializing on the chain)
            level_img = resize_bilinear(img, h, w)
            score = nms3x3(fast_score_map(level_img))
            score = _threshold_fallback(score, cfg)
            n_l = n_per_level[lvl]
            ys, xs, resp = _detect_level(score, n_l, cfg)
            padded = pad_image(level_img, pad)
            ang, desc = _keypoint_stage(padded, ys, xs, pad)
            scale = cfg.scale_factor ** lvl
            uv = jnp.stack([xs.astype(jnp.float32) * scale,
                            ys.astype(jnp.float32) * scale], axis=-1)
            outs.append(OrbFeatures(
                uv=uv,
                level=jnp.full((n_l,), lvl, jnp.int32),
                angle=ang,
                response=resp,
                desc=desc,
                valid=resp > 0.0,
            ))
        return OrbFeatures(*[jnp.concatenate(parts, axis=0)
                             for parts in zip(*outs)])

    return jax.jit(extract)
