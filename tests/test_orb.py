"""ORB extractor + matcher tests on synthetic textured images."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from active_orb_slam2_tpu.config import OrbConfig
from active_orb_slam2_tpu.ops.image import pad_image, resize_bilinear
from active_orb_slam2_tpu.ops.orb import (
    build_extractor, descriptor_pattern, extract_patches)
from active_orb_slam2_tpu.ops.matching import (
    hamming_matrix, hamming_popcount, pm_descriptors, match_mutual,
    search_by_projection, rotation_consistency_mask)


def checkerboard_texture(rng, h=120, w=160, n_blobs=150):
    """Gradient-rich random blob image — plenty of FAST corners."""
    img = np.full((h, w), 64.0, dtype=np.float32)
    ys = rng.integers(6, h - 6, n_blobs)
    xs = rng.integers(6, w - 6, n_blobs)
    vals = rng.uniform(100, 255, n_blobs)
    sizes = rng.integers(2, 6, n_blobs)
    for y, x, v, s in zip(ys, xs, vals, sizes):
        img[y:y + s, x:x + s] = v
    return img


CFG = OrbConfig(n_features=256, n_levels=4)


def test_extractor_shapes_and_validity(rng):
    img = checkerboard_texture(rng)
    ext = build_extractor(CFG, *img.shape)
    f = ext(jnp.array(img))
    assert f.uv.shape == (256, 2)
    assert f.desc.shape == (256, 8)
    assert f.desc.dtype == jnp.uint32
    n_valid = int(f.valid.sum())
    assert n_valid > 100, n_valid
    # valid keypoints must land inside the image
    uv = np.asarray(f.uv)[np.asarray(f.valid)]
    assert (uv[:, 0] >= 0).all() and (uv[:, 0] < 160).all()
    assert (uv[:, 1] >= 0).all() and (uv[:, 1] < 120).all()


def test_extractor_empty_image():
    """Flat image -> no corners -> all slots invalid, no NaNs."""
    ext = build_extractor(CFG, 120, 160)
    f = ext(jnp.full((120, 160), 128.0))
    assert int(f.valid.sum()) == 0
    assert np.isfinite(np.asarray(f.uv)).all()


def test_descriptors_stable_under_translation(rng):
    """Shift the image by 8px: matched descriptors should be close."""
    img = checkerboard_texture(rng)
    img2 = np.roll(img, (0, 8), axis=(0, 1))
    ext = build_extractor(CFG, *img.shape)
    fa, fb = ext(jnp.array(img)), ext(jnp.array(img2))
    d = hamming_matrix(fa.desc, fb.desc, fa.valid, fb.valid)
    idx, dist = match_mutual(d, max_dist=60.0)
    matched = np.asarray(idx) >= 0
    assert matched.sum() > 40, matched.sum()
    # matches should mostly be the 8px shift
    uva = np.asarray(fa.uv)[matched]
    uvb = np.asarray(fb.uv)[np.asarray(idx)[matched]]
    dx = uvb[:, 0] - uva[:, 0]
    good = np.abs(dx - 8) < 2.5
    assert good.mean() > 0.7, good.mean()


def test_hamming_mxu_equals_popcount(rng):
    a = jnp.array(rng.integers(0, 2**32, size=(32, 8), dtype=np.uint32))
    b = jnp.array(rng.integers(0, 2**32, size=(48, 8), dtype=np.uint32))
    d_mat = np.asarray(hamming_matrix(a, b))
    d_pop = np.zeros((32, 48), np.int32)
    for i in range(32):
        d_pop[i] = np.asarray(hamming_popcount(a[i][None].repeat(48, 0), b))
    np.testing.assert_array_equal(d_mat.astype(np.int32), d_pop)


def test_pm_descriptors_signs(rng):
    a = jnp.array([[1, 0, 0, 0, 0, 0, 0, 0]], dtype=jnp.uint32)
    pm = np.asarray(pm_descriptors(a)).astype(np.float32)
    assert pm[0, 0] == 1.0 and (pm[0, 1:] == -1.0).all()


def test_search_by_projection_gates(rng):
    """Distance gate: a perfect descriptor match outside the radius must
    be rejected."""
    desc = jnp.array(rng.integers(0, 2**32, size=(4, 8), dtype=np.uint32))
    feats_uv = jnp.array([[10.0, 10.0], [100.0, 100.0],
                          [12.0, 10.0], [50.0, 50.0]])
    proj_uv = jnp.array([[11.0, 10.0]])
    idx, dist = search_by_projection(
        proj_uv, jnp.array([5.0]), jnp.array([0]),
        desc[:1], jnp.array([True]),
        feats_uv, jnp.zeros(4, jnp.int32), desc, jnp.ones(4, bool),
        max_dist=256.0)
    assert int(idx[0]) in (0, 2)  # same descriptor also at index 0...
    # now move all features out of radius
    idx2, _ = search_by_projection(
        proj_uv, jnp.array([5.0]), jnp.array([0]),
        desc[:1], jnp.array([True]),
        feats_uv + 100.0, jnp.zeros(4, jnp.int32), desc, jnp.ones(4, bool),
        max_dist=256.0)
    assert int(idx2[0]) == -1


def test_rotation_consistency(rng):
    """90% of matches rotated by 0.3 rad, 10% outliers at random angles:
    outliers must be dropped."""
    m = 100
    aq = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    at = aq - 0.3
    at[:10] = rng.uniform(0, 2 * np.pi, 10)  # outliers
    keep = np.asarray(rotation_consistency_mask(
        jnp.array(aq), jnp.array(at), jnp.arange(m, dtype=jnp.int32)))
    assert keep[10:].mean() > 0.95
    assert keep[:10].mean() < 0.4


def test_pattern_deterministic():
    p1 = descriptor_pattern()
    p2 = descriptor_pattern()
    assert (p1 == p2).all()
    assert p1.shape == (256, 4)
    assert np.abs(p1).max() <= 15


@pytest.mark.parametrize("resized", [False, True])
@pytest.mark.parametrize("where", ["interior", "border"])
def test_extract_patches_matches_slicing(rng, resized, where):
    """The patch gather equals numpy slicing of the padded level image,
    including clamped windows at the borders and a bilinear-resized
    (non-integer) level."""
    img = checkerboard_texture(rng)
    if resized:
        img = np.asarray(resize_bilinear(jnp.asarray(img), 83, 111))
        assert not np.allclose(img, np.round(img))
    pad = CFG.pad
    padded = np.asarray(pad_image(jnp.asarray(img), pad))
    h, w = img.shape
    if where == "interior":
        ys = rng.integers(0, h, 64)
        xs = rng.integers(0, w, 64)
    else:
        ys = np.array([0, 0, h - 1, h - 1, 1, h - 2, 3, h // 2])
        xs = np.array([0, w - 1, 0, w - 1, w // 2, 2, w - 3, 0])
    out = np.asarray(extract_patches(jnp.asarray(padded),
                                      jnp.asarray(ys, jnp.int32),
                                      jnp.asarray(xs, jnp.int32), pad))
    hp, wp = padded.shape
    for k, (y, x) in enumerate(zip(ys, xs)):
        y0 = min(max(y + pad - 18, 0), hp - 40)
        x0 = min(max(x + pad - 18, 0), wp - 40)
        np.testing.assert_array_equal(out[k],
                                      padded[y0:y0 + 40, x0:x0 + 40])


@pytest.mark.gpu
def test_patch_gather_on_gpu(gpu, rng):
    """float32 gathers are exact: the card and the CPU agree bit for
    bit on a non-integer image."""
    img = rng.uniform(0, 255, (200, 280)).astype(np.float32)
    ys = rng.integers(0, 152, 512).astype(np.int32)
    xs = rng.integers(0, 232, 512).astype(np.int32)
    cpu = jax.devices("cpu")[0]
    f = jax.jit(extract_patches, static_argnums=3)
    got = f(*jax.device_put((img, ys, xs), gpu), 24)
    ref = f(*jax.device_put((img, ys, xs), cpu), 24)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
