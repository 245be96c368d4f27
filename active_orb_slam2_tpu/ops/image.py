"""Image primitives: separable Gaussian blur, bilinear resize, padding.

Replaces the reference's OpenCV usage in the ORB front end:
``cv::GaussianBlur(7x7, sigma=2)`` and ``cv::resize`` inside
``ORBextractor::ComputePyramid`` (``src/ORBextractor.cc`` ~L550-600 [U]).

Formulations:
  * blur = shift-and-accumulate along each axis (elementwise chains
    that XLA fuses into ~2 passes over the image, instead of a
    1-channel ``conv_general_dilated``),
  * resize = two constant banded matmuls (separable bilinear weights)
    instead of XLA's gather-based ``jax.image.resize``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(ksize: int, sigma: float):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur of [H, W] (edge-replicate padding)."""
    k = _gaussian_kernel1d(ksize, sigma)
    r = ksize // 2
    x = jnp.pad(img, ((r, r), (r, r)), mode="edge")
    H, W = img.shape
    # shift-and-accumulate: 7 multiply-adds per axis, all fusable
    acc = None
    for i in range(ksize):
        term = x[i:i + H, :] * float(k[i])
        acc = term if acc is None else acc + term
    x = acc
    acc = None
    for i in range(ksize):
        term = x[:, i:i + W] * float(k[i])
        acc = term if acc is None else acc + term
    return acc


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int):
    """Banded bilinear interpolation matrix [n_in, n_out] float32 with
    jax.image.resize's 'bilinear' (half-pixel centers) convention."""
    scale = n_in / n_out
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(centers).astype(np.int64)
    frac = (centers - lo).astype(np.float32)
    w = np.zeros((n_in, n_out), np.float32)
    lo0 = np.clip(lo, 0, n_in - 1)
    lo1 = np.clip(lo + 1, 0, n_in - 1)
    w[lo0, np.arange(n_out)] += 1.0 - frac
    w[lo1, np.arange(n_out)] += frac
    return w


def resize_bilinear(img, out_h: int, out_w: int):
    """Bilinear resize of [H, W] to [out_h, out_w] as two matmuls."""
    h, w = img.shape
    if (h, w) == (out_h, out_w):
        return img
    wy = jnp.asarray(_resize_weights(h, out_h))      # [H, out_h]
    wx = jnp.asarray(_resize_weights(w, out_w))      # [W, out_w]
    tmp = jnp.matmul(wy.T, img, precision=jax.lax.Precision.HIGHEST)
    return jnp.matmul(tmp, wx, precision=jax.lax.Precision.HIGHEST)


def pad_image(img, pad: int):
    """Edge-replicate pad on both axes (reference EDGE_THRESHOLD border)."""
    return jnp.pad(img, ((pad, pad), (pad, pad)), mode="edge")
