"""Batched constrained point-to-plane ICP.

Fills in the reference's unimplemented ``p2plane`` refinement variant
(reference icp.py:81-83 ``assert False`` — the CLI surface
``--refineICPmethod`` exists in train.py:36 but only ``p2p`` ever
worked). Point-to-plane minimizes the projection of the residual onto
the destination surface normal, which converges tighter than
point-to-point on locally planar LiDAR scans (car panels): sliding
along a panel is free, so sparse resampling of the same surface stops
fighting the estimate. This targets the <2 cm accuracy bucket.

Design, mirroring icp/p2point.py:
- normals are estimated ONCE per destination cloud from the k-NN
  covariance; the smallest-eigenvector is extracted by power iteration
  on ``tr(C) I − C`` (same eigenvectors, spectrum reversed) — branch-free
  elementwise work instead of a batched ``eigh`` (no orientation step: the
  point-to-plane cost is sign-invariant in the normal).
- each iteration: brute-force NN correspondences (shared with p2point,
  at HIGHEST precision), radius gate, then a CLOSED-FORM 3x3
  normal-equation solve for the ground-plane-constrained increment
  (yaw theta about the weighted source centroid + XY translation),
  linearized per iteration exactly like Open3D's Gauss-Newton step but
  with 3 unknowns instead of 6.
- fitness / inlier RMSE are computed from point-to-POINT nearest
  distances, identical to icp_p2point_batch, so the refinement gate
  (icp/p2point.py refine_predictions) scores both methods on the same
  scale.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.icp.p2point import (
    HIGHEST,
    _center_pair,
    _nn_correspondences,
    _uncenter,
)

KNN_CHUNK = 512
_INVALID = 1e30


def _knn_covariance_normals(points, mask, k: int):
    """Normals for ONE padded cloud (n, 3) via k-NN PCA.

    Invalid (padded) points never enter a neighborhood; points with
    fewer than 3 valid neighbors get an arbitrary unit normal (they are
    masked out of correspondences anyway, or contribute a meaningless
    but finite residual that the radius gate bounds)."""
    n = points.shape[0]
    invalid = jnp.where(mask, 0.0, _INVALID)  # (n,)
    # normals do not move with the cloud; centring keeps the expanded
    # distances precise at range (icp/p2point.py _center_pair)
    w = mask.astype(points.dtype)
    points = points - (jnp.sum(points * w[:, None], axis=0)
                       / jnp.maximum(jnp.sum(w), 1.0))

    def chunk_fn(chunk):
        d2 = (
            jnp.sum(chunk ** 2, axis=1)[:, None]
            - 2.0 * jnp.matmul(chunk, points.T, precision=HIGHEST)
            + jnp.sum(points ** 2, axis=1)[None, :]
        )
        d2 = jnp.maximum(d2, 0.0) + invalid[None, :]
        neg, idx = jax.lax.top_k(-d2, k)  # (c, k)
        return idx, -neg

    pad = (-n) % KNN_CHUNK
    pts_p = jnp.pad(points, ((0, pad), (0, 0)))
    idx, d2 = jax.lax.map(chunk_fn, pts_p.reshape(-1, KNN_CHUNK, 3))
    idx = idx.reshape(-1, k)[:n]
    d2 = d2.reshape(-1, k)[:n]

    nbrs = points[idx]  # (n, k, 3)
    w = (d2 < _INVALID / 2).astype(jnp.float32)  # valid-neighbor weights
    wsum = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1.0)
    mu = jnp.sum(nbrs * w[..., None], axis=1) / wsum  # (n, 3)
    cen = (nbrs - mu[:, None, :]) * w[..., None]
    cov = jnp.einsum("nki,nkj->nij", cen, cen) / wsum[..., None]  # (n,3,3)

    # smallest eigenvector of cov by INVERSE iteration on (cov + eps I):
    # for near-planar neighborhoods cov is ~singular along the normal, so
    # each solve amplifies the normal direction by ~lambda_2/eps — the
    # convergence rate is independent of the IN-plane anisotropy that
    # makes plain power iteration on (tr I - cov) crawl at patch
    # boundaries (elongated neighborhoods: gap ratio -> 1)
    tr = cov[:, 0, 0] + cov[:, 1, 1] + cov[:, 2, 2]
    eps = (1e-6 * tr + 1e-12)[:, None, None]
    M = cov + eps * jnp.eye(3)[None]
    # deterministic start off any symmetry axis
    v = jnp.broadcast_to(
        jnp.asarray([0.577350269, 0.577350269, 0.577350269], jnp.float32),
        (points.shape[0], 3),
    )
    for _ in range(4):
        v = jnp.linalg.solve(M, v[..., None])[..., 0]
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=1, keepdims=True), 1e-20)
    return v


def estimate_normals_batch(points, mask, k: int = 16):
    """(B, n, 3) padded clouds -> (B, n, 3) unit normals (jit, vmapped)."""
    return _normals_jit(jnp.asarray(points, jnp.float32),
                        jnp.asarray(mask, bool), int(k))


@partial(jax.jit, static_argnums=(2,))
def _normals_jit(points, mask, k):
    return jax.vmap(lambda p, m: _knn_covariance_normals(p, m, k))(
        points, mask
    )


def _estimate_yaw_translation_p2plane(p, q, nrm, w):
    """Closed-form constrained Gauss-Newton increment minimizing
    sum w ((Rz(theta)(p - pbar) + pbar + t - q) . n)^2 linearized in
    theta; returns the EXACT (R, t) world-frame increment.

    Unknowns are (theta, tx, ty, tz): the rotation is yaw-only (the
    ground-plane constraint) but the full 3-DoF translation is kept,
    matching the constrained point-to-point estimator
    (icp/p2point.py:_estimate_yaw_translation, whose centroid
    difference carries z)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    p_bar = jnp.sum(w[:, None] * p, axis=0) / wsum
    pt = p - p_bar
    r = jnp.sum((p - q) * nrm, axis=1)  # (n,)
    a = -pt[:, 1] * nrm[:, 0] + pt[:, 0] * nrm[:, 1]  # d residual / d theta
    A = jnp.stack([a, nrm[:, 0], nrm[:, 1], nrm[:, 2]], axis=1)  # (n, 4)
    Aw = A * w[:, None]
    # Levenberg-style damping relative to the system scale: a sparse or
    # single-panel correspondence set leaves (theta, t) directions
    # near-unobservable, and an undamped solve can jump kilometers
    H = jnp.matmul(Aw.T, A, precision=HIGHEST)
    tr_h = jnp.trace(H)
    H = H + (1e-6 * tr_h + 1e-9) * jnp.eye(4)
    g = jnp.matmul(Aw.T, r, precision=HIGHEST)
    x = jnp.linalg.solve(H, -g)
    # trust region per iteration: ICP increments near a valid basin are
    # small; anything larger is divergence, not progress
    theta = jnp.clip(x[0], -0.3, 0.3)
    t_lin = x[1:]
    t_norm = jnp.linalg.norm(t_lin)
    t_lin = t_lin * (jnp.minimum(t_norm, 1.0) / jnp.maximum(t_norm, 1e-20))
    x = jnp.concatenate([theta[None], t_lin])
    c, s = jnp.cos(theta), jnp.sin(theta)
    R = jnp.eye(3)
    R = R.at[0, 0].set(c).at[0, 1].set(-s).at[1, 0].set(s).at[1, 1].set(c)
    # rotation was taken about p_bar: fold into a world-frame transform
    t = p_bar - jnp.matmul(R, p_bar, precision=HIGHEST) + x[1:]
    return R, t


def _icp_single_p2plane(src, src_mask, dst, dst_mask, dst_normals, init_R,
                        init_t, radius, its):
    radius2 = radius * radius
    src, dst, init_t, c = _center_pair(src, dst, dst_mask, init_R, init_t)

    def body(carry, _):
        R, t = carry
        moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
        idx, d2 = _nn_correspondences(moved, dst, dst_mask)
        w = (src_mask & (d2 < radius2)).astype(jnp.float32)
        q = dst[idx]
        nrm = dst_normals[idx]
        R_inc, t_inc = _estimate_yaw_translation_p2plane(moved, q, nrm, w)
        has = jnp.sum(w) > 0
        R_inc = jnp.where(has, R_inc, jnp.eye(3))
        t_inc = jnp.where(has, t_inc, jnp.zeros(3))
        return (jnp.matmul(R_inc, R, precision=HIGHEST),
                jnp.matmul(R_inc, t, precision=HIGHEST) + t_inc), None

    (R, t), _ = jax.lax.scan(body, (init_R, init_t), None, length=its)
    moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
    idx, d2 = _nn_correspondences(moved, dst, dst_mask)
    inlier = (src_mask & (d2 < radius2)).astype(jnp.float32)
    n_src = jnp.maximum(jnp.sum(src_mask.astype(jnp.float32)), 1.0)
    n_in = jnp.sum(inlier)
    fitness = n_in / n_src
    inlier_rmse = jnp.sqrt(jnp.sum(inlier * d2) / jnp.maximum(n_in, 1.0))
    return R, _uncenter(R, t, c), fitness, inlier_rmse


@partial(jax.jit, static_argnums=(8,))
def _icp_batch_p2plane(src, src_mask, dst, dst_mask, dst_normals, init_R,
                       init_t, radius, its):
    return jax.vmap(
        lambda a, am, b, bm, bn, r0, t0: _icp_single_p2plane(
            a, am, b, bm, bn, r0, t0, radius, its
        )
    )(src, src_mask, dst, dst_mask, dst_normals, init_R, init_t)


def icp_p2plane_batch(src, src_mask, dst, dst_mask, init_transforms,
                      radius: float = 0.2, its: int = 30, knn: int = 16,
                      dst_normals=None):
    """Batched ground-plane-constrained point-to-plane ICP.

    Same contract as icp_p2point_batch (icp/p2point.py:161); the
    unconstrained variant is deliberately not offered — every reference
    call site sets with_constraint=True (icp.py:76,98,128).

    ``dst_normals``: optional precomputed (B, N, 3) normals (reused
    across cascade stages); estimated from ``knn`` neighbors otherwise.
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    src_mask = jnp.asarray(src_mask, bool)
    dst_mask = jnp.asarray(dst_mask, bool)
    if dst_normals is None:
        dst_normals = estimate_normals_batch(dst, dst_mask, k=knn)
    init_R = jnp.asarray(init_transforms[:, :3, :3], jnp.float32)
    init_t = jnp.asarray(init_transforms[:, :3, 3], jnp.float32)
    R, t, fitness, rmse = _icp_batch_p2plane(
        src, src_mask, dst, dst_mask, dst_normals, init_R, init_t,
        float(radius), int(its),
    )
    R, t = np.asarray(R), np.asarray(t)
    out = np.tile(np.eye(4, dtype=np.float64), (len(R), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out, np.asarray(fitness), np.asarray(rmse)
