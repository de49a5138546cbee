"""Fast Global Registration, batched on-device.

On-device implementation of the algorithm behind the reference's
``icp_o3_gicp_fast`` variant (reference icp.py:121-143, which calls the
Open3D fork's ``registration_fast_based_on_feature_matching`` with the
fork-only constrained option): Zhou, Park & Koltun, "Fast Global
Registration", ECCV 2016.

Pipeline (paper §3, Open3D FastGlobalRegistration.cpp semantics):

1. FPFH feature correspondences, RECIPROCAL test — keep (p, q) only when
   q is p's nearest feature neighbor AND p is q's (paper §5 "Fast
   feature matching", o3 option ``use_absolute_scale``/reciprocal).
2. Tuple test — random correspondence triplets pass when all three edge
   ratios ||p_i-p_j|| / ||q_i-q_j|| lie in [tau, 1/tau], tau = 0.9
   (o3 ``tuple_test_``/``tuple_scale_``); correspondences that appear in
   at least one passing tuple survive. Fixed-count sampling + scatter-max
   keeps shapes static.
3. Graduated non-convexity over the scaled Geman-McClure penalty
   rho(r) = mu r^2 / (mu + r^2): mu starts at (cloud diameter)^2 and is
   divided by ``division_factor`` (1.4, o3 default) every 4 iterations
   (paper §4; o3 ``decrease_mu_``/``maximum_correspondence_distance_``).
   Each iteration computes line-process weights
   l_pq = (mu / (mu + r^2))^2 and solves the weighted least-squares
   rigid subproblem IN CLOSED FORM — weighted yaw Procrustes under the
   ground-plane constraint (the fork's behavior), weighted Kabsch
   otherwise. The paper linearizes and takes one Gauss-Newton step; the
   closed form solves the same subproblem exactly, so convergence is at
   least as fast per iteration and there is no 6x6 solve in the loop.

Everything after the host-side voxel downsample is one jitted, vmapped
launch over the pair batch — replacing the reference's per-sample C++
calls.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.icp.p2point import (
    HIGHEST,
    _estimate_full,
    _estimate_yaw_translation,
)


def _mutual_correspondences(feat_src, mask_src, feat_dst, mask_dst):
    """Reciprocal nearest-neighbor matches in feature space.

    Returns (idx (N,), valid (N,) bool): src point i matches dst point
    idx[i]; valid where the match is mutual and both points are real.
    """
    d2 = (
        jnp.sum(feat_src ** 2, axis=1)[:, None]
        # HIGHEST: fed to argmin; TF32 would flip near-tied matches
        - 2.0 * jnp.matmul(feat_src, feat_dst.T, precision=HIGHEST)
        + jnp.sum(feat_dst ** 2, axis=1)[None, :]
    )
    d2 = jnp.where(mask_src[:, None], d2, jnp.inf)
    d2 = jnp.where(mask_dst[None, :], d2, jnp.inf)
    fwd = jnp.argmin(d2, axis=1)          # src -> dst
    bwd = jnp.argmin(d2, axis=0)          # dst -> src
    mutual = bwd[fwd] == jnp.arange(feat_src.shape[0])
    valid = mask_src & mask_dst[fwd] & mutual
    return fwd, valid


def _tuple_test(p, q, valid, rng_key, num_tuples: int, tau: float):
    """Keep correspondences that appear in >=1 edge-ratio-consistent
    random triplet (paper §5; o3 AdvancedMatching tuple test)."""
    n = p.shape[0]
    prob = valid.astype(jnp.float32)
    prob = prob / jnp.maximum(jnp.sum(prob), 1.0)
    picks = jax.random.choice(
        rng_key, n, (num_tuples, 3), replace=True, p=prob
    )  # (T, 3)
    pi = p[picks]  # (T, 3, 3)
    qi = q[picks]

    def edge(a, i, j):
        return jnp.linalg.norm(a[:, i] - a[:, j], axis=1)

    ok = jnp.ones(num_tuples, bool)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        dp = edge(pi, i, j)
        dq = edge(qi, i, j)
        r = dp / jnp.maximum(dq, 1e-12)
        ok &= (r > tau) & (r < 1.0 / tau)
    # all three picked correspondences must be real
    ok &= jnp.all(valid[picks], axis=1)

    keep = jnp.zeros(n, bool)
    # scatter-or: a correspondence survives if any passing tuple uses it
    keep = keep.at[picks.reshape(-1)].max(
        jnp.repeat(ok, 3), mode="drop"
    )
    return valid & keep


def _fgr_single(src, src_mask, dst, dst_mask, feat_src, feat_dst, rng_key,
                iters: int, division_factor: float, tau: float,
                num_tuples: int, with_constraint: bool,
                distance_threshold: float):
    """FGR for one padded pair. Returns (R, t, fitness, inlier_rmse)."""
    corr_idx, corr_valid = _mutual_correspondences(
        feat_src, src_mask, feat_dst, dst_mask
    )
    q_all = dst[corr_idx]
    keep = _tuple_test(src, q_all, corr_valid, rng_key, num_tuples, tau)
    # fall back to the mutual set if the tuple test annihilates everything
    keep = jnp.where(jnp.sum(keep) >= 3, keep, corr_valid)

    # mu_init = squared diameter of the source cloud (paper §4)
    lo = jnp.min(jnp.where(src_mask[:, None], src, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(src_mask[:, None], src, -jnp.inf), axis=0)
    diam = jnp.linalg.norm(hi - lo)
    mu0 = jnp.maximum(diam * diam, 1e-6)

    base_w = keep.astype(jnp.float32)

    def body(carry, it):
        R, t, mu = carry
        moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
        r2 = jnp.sum((moved - q_all) ** 2, axis=1)
        l = (mu / (mu + r2)) ** 2
        w = base_w * l
        if with_constraint:
            R_inc, t_inc = _estimate_yaw_translation(moved, q_all, w)
        else:
            R_inc, t_inc = _estimate_full(moved, q_all, w)
        has = jnp.sum(w) > 1e-9
        R_inc = jnp.where(has, R_inc, jnp.eye(3))
        t_inc = jnp.where(has, t_inc, jnp.zeros(3))
        R_new = jnp.matmul(R_inc, R, precision=HIGHEST)
        t_new = jnp.matmul(R_inc, t, precision=HIGHEST) + t_inc
        # graduated non-convexity schedule: anneal every 4 iterations
        mu = jnp.where((it + 1) % 4 == 0, mu / division_factor, mu)
        mu = jnp.maximum(mu, distance_threshold * distance_threshold)
        return (R_new, t_new, mu), None

    (R, t, _), _ = jax.lax.scan(
        body, (jnp.eye(3), jnp.zeros(3), mu0), jnp.arange(iters)
    )

    # final inlier stats over the kept correspondence set
    moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
    err2 = jnp.sum((moved - q_all) ** 2, axis=1)
    inlier = base_w * (err2 < distance_threshold ** 2)
    n_in = jnp.sum(inlier)
    fitness = n_in / jnp.maximum(jnp.sum(base_w), 1.0)
    rmse = jnp.sqrt(jnp.sum(inlier * err2) / jnp.maximum(n_in, 1.0))
    return R, t, fitness, rmse


@partial(jax.jit, static_argnames=(
    "iters", "num_tuples", "with_constraint"))
def fgr_batch_jit(src, src_mask, dst, dst_mask, feat_src, feat_dst, keys,
                  iters: int = 64, division_factor: float = 1.4,
                  tau: float = 0.9, num_tuples: int = 1000,
                  with_constraint: bool = True,
                  distance_threshold: float = 0.075):
    """Vmapped FGR over a batch of padded pairs."""
    return jax.vmap(
        lambda a, am, b, bm, fa, fb, k: _fgr_single(
            a, am, b, bm, fa, fb, k, iters, division_factor, tau,
            num_tuples, with_constraint, distance_threshold,
        )
    )(src, src_mask, dst, dst_mask, feat_src, feat_dst, keys)
