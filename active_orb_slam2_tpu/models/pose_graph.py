"""Sim3 pose-graph optimization (the essential graph).

Replaces ``Optimizer::OptimizeEssentialGraph`` (``src/Optimizer.cc``
~L640-900 [U]): 7-DoF Sim3 vertices over spanning-tree + loop +
strong-covisibility (w >= 100) edges, Levenberg iterations, then SE3
recovery with scale division (``sim3_to_se3``).

Fixed-shape form: a fixed-size edge list; per-edge 7-vector residuals
``r = log(S_meas^-1 · S_j · S_i^-1)`` with Jacobians by forward-mode
autodiff (this is a per-loop-event path, not per-frame — trace cost
over hand-derived Sim3 adjoints is the right trade); dense [7K, 7K]
normal equations assembled by scatter-add and solved on device.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from active_orb_slam2_tpu.geometry.se3 import (
    sim3_compose, sim3_exp, sim3_inverse, sim3_log)


class Sim3Edges(NamedTuple):
    """Relative Sim3 constraints i -> j (fixed shape E)."""
    i: jnp.ndarray        # [E] int32
    j: jnp.ndarray        # [E] int32
    meas_ji: jnp.ndarray  # [E, 8]  measured S_j * S_i^-1
    valid: jnp.ndarray    # [E] bool
    weight: jnp.ndarray   # [E] information scale


def _edge_residual(delta_i, delta_j, S_i, S_j, meas_ji):
    Si = sim3_compose(sim3_exp(delta_i), S_i)
    Sj = sim3_compose(sim3_exp(delta_j), S_j)
    return sim3_log(sim3_compose(sim3_inverse(meas_ji),
                                 sim3_compose(Sj, sim3_inverse(Si))))


def optimize_essential_graph(kf_sim3, edges: Sim3Edges, fixed,
                             iters: int = 20, lam0: float = 1e-6):
    """GN/LM over the pose graph.

    Args:
      kf_sim3 [K, 8]; fixed [K] bool (reference fixes the loop KF).
    Returns (optimized [K, 8], final chi2).
    """
    with jax.default_matmul_precision("highest"):
        # the [7K, 7K] dense solve is conditioning-sensitive; a
        # reduced-precision matmul path degrades the LM steps (see
        # parallel/dist_ba.py)
        return _optimize_essential_graph(kf_sim3, edges, fixed, iters,
                                         lam0)


def _optimize_essential_graph(kf_sim3, edges: Sim3Edges, fixed,
                              iters: int = 20, lam0: float = 1e-6):
    K = kf_sim3.shape[0]
    zero = jnp.zeros(7)

    res_fn = jax.vmap(_edge_residual, in_axes=(None, None, 0, 0, 0))

    def linearize(S):
        Si, Sj = S[edges.i], S[edges.j]

        def one(si, sj, m):
            r = _edge_residual(zero, zero, si, sj, m)
            Ji = jax.jacfwd(lambda d: _edge_residual(d, zero, si, sj, m))(zero)
            Jj = jax.jacfwd(lambda d: _edge_residual(zero, d, si, sj, m))(zero)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(one)(Si, Sj, edges.meas_ji)
        w = jnp.where(edges.valid, edges.weight, 0.0)
        return r, Ji, Jj, w

    def chi2_of(S):
        Si, Sj = S[edges.i], S[edges.j]
        r = res_fn(zero, zero, Si, Sj, edges.meas_ji)
        w = jnp.where(edges.valid, edges.weight, 0.0)
        return jnp.sum(w * jnp.sum(r * r, axis=-1))

    def body(carry, _):
        S, lam, _ = carry
        r, Ji, Jj, w = linearize(S)
        # assemble H [K,7,K,7] and g [K,7] by block scatter-add
        Hii = jnp.einsum('eai,e,eaj->eij', Ji, w, Ji)
        Hjj = jnp.einsum('eai,e,eaj->eij', Jj, w, Jj)
        Hij = jnp.einsum('eai,e,eaj->eij', Ji, w, Jj)
        gi = -jnp.einsum('eai,e,ea->ei', Ji, w, r)
        gj = -jnp.einsum('eai,e,ea->ei', Jj, w, r)

        Hb = jnp.zeros((K, K, 7, 7))
        Hb = Hb.at[edges.i, edges.i].add(Hii)
        Hb = Hb.at[edges.j, edges.j].add(Hjj)
        Hb = Hb.at[edges.i, edges.j].add(Hij)
        Hb = Hb.at[edges.j, edges.i].add(
            jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((K, 7)).at[edges.i].add(gi).at[edges.j].add(gj)

        H = Hb.transpose(0, 2, 1, 3).reshape(7 * K, 7 * K)
        # the constant diagonal term is a GAUGE PRIOR, not just jitter:
        # under heavy keyframe recycling the tree+covis edge set can
        # leave components disconnected from the pinned loop keyframe,
        # and their global gauge directions are then singular — with a
        # 1e-8 floor the solve launched such components 1e7 m away
        # (r4 tour endurance).  1e-3 anchors free vertices softly to
        # their current estimates (edge-backed entries are O(1..1e3),
        # so constrained directions are unaffected).
        H = H + lam * jnp.diag(jnp.diagonal(H)) + 1e-3 * jnp.eye(7 * K)
        rows = jnp.repeat(fixed, 7)
        H = jnp.where(rows[:, None] | rows[None, :], jnp.eye(7 * K), H)
        gv = jnp.where(rows, 0.0, g.reshape(-1))

        # damped GN normal matrix is symmetric PD: Cholesky is 2.4x
        # cheaper than the pivoted LU on this backend
        from jax.scipy.linalg import cho_factor, cho_solve
        d = cho_solve(cho_factor(H, lower=True), gv).reshape(K, 7)
        d = d * (~fixed)[:, None]
        S_new = jax.vmap(lambda dd, ss: sim3_compose(sim3_exp(dd), ss))(d, S)
        c_old, c_new = chi2_of(S), chi2_of(S_new)
        accept = c_new <= c_old
        S = jnp.where(accept, S_new, S)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 8.0), 1e-9, 1e2)
        return (S, lam, jnp.where(accept, c_new, c_old)), None

    (S, _, chi2), _ = jax.lax.scan(
        body, (kf_sim3, jnp.float32(lam0), jnp.float32(0.0)),
        None, length=iters)
    return S, chi2


def build_essential_edges(kf_sim3, kf_valid, kf_parent, covis_W,
                          loop_i, loop_j, strong_th: int = 100,
                          max_strong: int = 512, max_loop: int = 32):
    """Assemble the essential-graph edge list from the arena
    (spanning tree + loop edges + strong covisibility [U]).

    kf_sim3 here are the PRE-correction estimates used as measurements;
    call before overwriting poses with corrected values.
    Returns a fixed-shape Sim3Edges.
    """
    K = kf_sim3.shape[0]
    max_strong = min(max_strong, K * K)

    def rel(i, j):
        return sim3_compose(kf_sim3[j], sim3_inverse(kf_sim3[i]))

    # spanning tree: edge (parent -> k)
    ks = jnp.arange(K, dtype=jnp.int32)
    pi = jnp.maximum(kf_parent, 0)
    tree_valid = kf_valid & (kf_parent >= 0) & kf_valid[pi]
    tree_meas = jax.vmap(rel)(pi, ks)

    # strong covisibility edges (upper triangle, w >= strong_th)
    W = jnp.where(kf_valid[:, None] & kf_valid[None, :], covis_W, 0)
    W = jnp.triu(W, 1)
    flat = W.ravel()
    vals, idx = jax.lax.top_k(flat, max_strong)
    ci = (idx // K).astype(jnp.int32)
    cj = (idx % K).astype(jnp.int32)
    cov_valid = vals >= strong_th
    cov_meas = jax.vmap(rel)(ci, cj)

    # loop edges (caller-provided index arrays, padded with -1)
    li = jnp.maximum(loop_i, 0)
    lj = jnp.maximum(loop_j, 0)
    loop_valid = (loop_i >= 0) & (loop_j >= 0)
    loop_meas = jax.vmap(rel)(li, lj)

    return Sim3Edges(
        i=jnp.concatenate([pi, ci, li]),
        j=jnp.concatenate([ks, cj, lj]),
        meas_ji=jnp.concatenate([tree_meas, cov_meas, loop_meas]),
        valid=jnp.concatenate([tree_valid, cov_valid, loop_valid]),
        weight=jnp.concatenate([jnp.ones(K), jnp.ones(max_strong),
                                jnp.full(loop_i.shape, 5.0)]),
    )
