"""Closed-form small linear algebra.

XLA lowers tiny LU/inverse ops to column loops with dynamic slicing
(slow, and batched variants serialize); 3x3 systems appear in every
hot geometric path (point Hessians in the Schur trick, SE3 log maps,
triangulation refinement), so they get adjugate closed forms that fuse
into the surrounding kernels.
"""

import jax.numpy as jnp


def inv3(A, eps: float = 0.0):
    """Batched closed-form inverse of [..., 3, 3] via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    if eps:
        det = jnp.where(jnp.abs(det) < eps,
                        jnp.where(det < 0, -eps, eps), det)
    idet = 1.0 / det
    adj = jnp.stack([
        jnp.stack([A00, A01, A02], -1),
        jnp.stack([A10, A11, A12], -1),
        jnp.stack([A20, A21, A22], -1),
    ], -2)
    return adj * idet[..., None, None]


def solve3(A, b, eps: float = 0.0):
    """Batched solve of [..., 3, 3] x = [..., 3] via the adjugate."""
    return jnp.einsum('...ij,...j->...i', inv3(A, eps=eps), b)
