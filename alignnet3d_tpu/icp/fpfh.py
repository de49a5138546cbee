"""FPFH features + RANSAC global registration, on-device.

JAX implementation of the reference's Open3D global-registration pipeline
(reference icp.py:85-119, tp_utils/pointcloud.py:1192-1206): voxel
downsample -> normal estimation -> FPFH descriptors -> feature
correspondences -> RANSAC over constrained rigid transforms. Everything
after the (host-side, vectorized-numpy) voxel downsample runs as fixed-
shape batched device code:

- normals: kNN covariance + smallest eigenvector of a 3x3 (closed-form
  eigen-decomposition via jnp.linalg.eigh, vmapped), oriented toward the
  sensor origin — the right orientation for LiDAR scans;
- SPFH/FPFH: the standard Darboux-frame angle triplet (alpha, phi, theta)
  histogrammed into 3x11 bins over the radius neighborhood, then the
  distance-weighted neighbor average (Rusu et al. 2009) — built with
  one-hot scatter adds so shapes stay static;
- RANSAC: K hypotheses evaluated in parallel with vmap — each samples
  ``ransac_n`` feature correspondences, checks the edge-length consistency
  gate (o3.CorrespondenceCheckerBasedOnEdgeLength(0.9), icp.py:100),
  estimates the (optionally yaw-constrained) transform in closed form and
  scores inliers over the full correspondence set. The reference burns 4M
  sequential iterations with 500-validation early exit (icp.py:101); here
  a few thousand parallel hypotheses in one launch are equivalent
  coverage of the 1-DoF-rotation problem.
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

N_BINS = 11  # per angle feature, 33-dim FPFH total (Open3D layout)


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     max_points: int | None = None):
    """Centroid-per-voxel downsample (o3.voxel_down_sample equivalent),
    vectorized numpy (host-side prep)."""
    pts = np.asarray(points, np.float64)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    # lexicographic voxel id
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 3))
    np.add.at(sums, inv, pts)
    out = sums / counts[:, None]
    if max_points is not None and len(out) > max_points:
        pick = np.random.default_rng(0).choice(len(out), max_points,
                                               replace=False)
        out = out[pick]
    return out.astype(np.float32)


def _knn_indices(points, mask, k):
    """(N, k) nearest-neighbor indices among valid points (self included)."""
    d2 = (
        jnp.sum(points ** 2, axis=1)[:, None]
        # HIGHEST: ranked by top_k; TF32 would flip near-tied neighbours
        - 2.0 * jnp.matmul(points, points.T, precision=HIGHEST)
        + jnp.sum(points ** 2, axis=1)[None, :]
    )
    d2 = jnp.where(mask[None, :], d2, jnp.inf)
    neg = -jnp.maximum(d2, 0.0)
    negk, idx = jax.lax.top_k(neg, k)
    return idx, -negk


def estimate_normals(points, mask, k: int = 16):
    """Per-point unit normals from kNN covariance, oriented toward the
    origin (the sensor)."""
    idx, _ = _knn_indices(points, mask, k)
    neigh = points[idx]  # (N, k, 3)
    mean = jnp.mean(neigh, axis=1, keepdims=True)
    centered = neigh - mean
    cov = jnp.einsum("nkd,nke->nde", centered, centered) / k
    # smallest eigenvector of each 3x3
    w, v = jnp.linalg.eigh(cov)
    normals = v[:, :, 0]
    # orient toward sensor at origin: n . (0 - p) >= 0
    flip = jnp.sum(normals * (-points), axis=1) < 0
    normals = jnp.where(flip[:, None], -normals, normals)
    return normals


def _pair_features(p, n_p, q, n_q):
    """Darboux angle triplet (alpha, phi, theta) for a point pair."""
    d = q - p
    dist = jnp.linalg.norm(d, axis=-1)
    d_unit = d / jnp.maximum(dist, 1e-12)[..., None]
    u = n_p
    v = jnp.cross(d_unit, u)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    w = jnp.cross(u, v)
    alpha = jnp.sum(v * n_q, axis=-1)                      # [-1, 1]
    phi = jnp.sum(u * d_unit, axis=-1)                     # [-1, 1]
    theta = jnp.arctan2(jnp.sum(w * n_q, axis=-1),
                        jnp.sum(u * n_q, axis=-1))         # [-pi, pi]
    return alpha, phi, theta, dist


def _histogram(vals, lo, hi, weights):
    """(..., K) one-hot histogram over N_BINS, weighted; static shapes."""
    scaled = (vals - lo) / (hi - lo) * N_BINS
    b = jnp.clip(scaled.astype(jnp.int32), 0, N_BINS - 1)
    onehot = jax.nn.one_hot(b, N_BINS, dtype=jnp.float32)
    return jnp.sum(onehot * weights[..., None], axis=-2)


@partial(jax.jit, static_argnames=("k",))
def fpfh_features(points, mask, radius, k: int = 32):
    """(N, 33) FPFH descriptors for one padded cloud.

    k nearest neighbors gated by ``radius`` approximate the radius search
    (o3.KDTreeSearchParamHybrid(radius, max_nn), pointcloud.py:1197-1200).
    """
    normals = estimate_normals(points, mask)
    idx, _ = _knn_indices(points, mask, k)
    neigh = points[idx]          # (N, k, 3)
    neigh_n = normals[idx]
    p = points[:, None, :]
    n_p = normals[:, None, :]
    alpha, phi, theta, dist = _pair_features(p, n_p, neigh, neigh_n)
    valid = (
        mask[:, None] & mask[idx] & (dist > 1e-9) & (dist <= radius)
    ).astype(jnp.float32)

    spfh = jnp.concatenate([
        _histogram(alpha, -1.0, 1.0, valid),
        _histogram(phi, -1.0, 1.0, valid),
        _histogram(theta, -np.pi, np.pi, valid),
    ], axis=-1)  # (N, 33)
    counts = jnp.maximum(jnp.sum(valid, axis=1), 1.0)
    spfh = spfh / counts[:, None] * 100.0  # percentage bins like Open3D

    # FPFH(p) = SPFH(p) + mean_q (1/omega) SPFH(q), omega = |p - q|
    w_neigh = jnp.where(valid > 0, 1.0 / jnp.maximum(dist, 1e-6), 0.0)
    neigh_spfh = spfh[idx]  # (N, k, 33)
    weighted = jnp.einsum("nk,nkf->nf", w_neigh, neigh_spfh)
    fpfh = spfh + weighted / counts[:, None]
    return fpfh, normals


def _feature_correspondences(feat_src, mask_src, feat_dst, mask_dst):
    """Nearest-neighbor in feature space for each src point (index, valid)."""
    d2 = (
        jnp.sum(feat_src ** 2, axis=1)[:, None]
        # HIGHEST: fed to argmin; TF32 would flip near-tied matches
        - 2.0 * jnp.matmul(feat_src, feat_dst.T, precision=HIGHEST)
        + jnp.sum(feat_dst ** 2, axis=1)[None, :]
    )
    d2 = jnp.where(mask_dst[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1)
    return idx


@partial(jax.jit, static_argnames=("num_hypotheses", "ransac_n",
                                   "with_constraint", "mutual_filter"))
def ransac_registration(src, src_mask, dst, dst_mask, src_feat, dst_feat,
                        rng_key, distance_threshold,
                        num_hypotheses: int = 2048, ransac_n: int = 4,
                        with_constraint: bool = True,
                        edge_length_ratio: float = 0.9,
                        mutual_filter: bool = True):
    """Parallel-hypothesis RANSAC over feature correspondences.

    ``mutual_filter`` keeps only reciprocal feature matches (the same
    pruning icp/fgr.py:50-66 uses — VERDICT r2 item 4: the RANSAC set
    previously had no pruning, which undersampled good hypotheses on
    sparse long-range scans), falling back to the unpruned set when
    fewer than ``ransac_n`` reciprocal matches survive.

    Returns (R (3,3), t (3,), fitness, inlier_rmse) for ONE pair.
    """
    corr = _feature_correspondences(src_feat, src_mask, dst_feat, dst_mask)
    dst_corr = dst[corr]  # (N, 3)
    corr_valid = src_mask & dst_mask[corr]
    n = src.shape[0]
    if mutual_filter:
        bwd = _feature_correspondences(dst_feat, dst_mask, src_feat, src_mask)
        mutual = bwd[corr] == jnp.arange(n)
        mutual_valid = corr_valid & mutual
        enough = jnp.sum(mutual_valid) >= ransac_n
        corr_valid = jnp.where(enough, mutual_valid, corr_valid)

    def hypothesis(key):
        pick = jax.random.choice(key, n, (ransac_n,), replace=False,
                                 p=corr_valid / jnp.sum(corr_valid))
        p = src[pick]
        q = dst_corr[pick]
        # edge-length checker (o3.CorrespondenceCheckerBasedOnEdgeLength)
        dp = jnp.linalg.norm(p[:, None] - p[None, :], axis=-1)
        dq = jnp.linalg.norm(q[:, None] - q[None, :], axis=-1)
        off = ~jnp.eye(ransac_n, dtype=bool)
        ratio_ok = jnp.all(
            jnp.where(
                off,
                (dp > edge_length_ratio * dq) & (dq > edge_length_ratio * dp),
                True,
            )
        )
        w = jnp.ones(ransac_n)
        if with_constraint:
            R, t = _estimate_yaw_translation(p, q, w)
        else:
            R, t = _estimate_full(p, q, w)
        moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
        err = jnp.linalg.norm(moved - dst_corr, axis=1)
        inlier = corr_valid & (err < distance_threshold)
        score = jnp.where(ratio_ok, jnp.sum(inlier), -1.0)
        return score, R, t

    keys = jax.random.split(rng_key, num_hypotheses)
    # Hypothesis chunking: a flat vmap materializes the (K, N) inlier
    # error matrix, which at K=16k x N=2k (x B pairs once batch-vmapped)
    # exceeds HBM. lax.map serializes chunks of 2048 hypotheses, keeping
    # peak memory at the K=2048 level while the reduction (per-chunk
    # best, then best-of-bests) is exact. Tie-break order between equal
    # scores differs from the flat argmax; scores are integer inlier
    # counts so ties are benign.
    chunk = 2048

    def eval_chunk(ks):
        s, r, tt = jax.vmap(hypothesis)(ks)
        b = jnp.argmax(s)
        return s[b], r[b], tt[b]

    if num_hypotheses > chunk:
        # pad up to a chunk multiple (extra hypotheses are harmless under
        # the best-of reduction) so odd K never falls back to the flat
        # vmap and its HBM blow-up
        n_chunks = -(-num_hypotheses // chunk)
        pad = n_chunks * chunk - num_hypotheses
        if pad:
            keys = jnp.concatenate([keys, keys[:pad]])
        scores, Rs, ts = jax.lax.map(
            eval_chunk, keys.reshape(n_chunks, chunk, 2)
        )
    else:
        scores, Rs, ts = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(scores)
    R, t = Rs[best], ts[best]
    # final inlier stats
    moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
    err = jnp.linalg.norm(moved - dst_corr, axis=1)
    inlier = (corr_valid & (err < distance_threshold)).astype(jnp.float32)
    n_in = jnp.sum(inlier)
    fitness = n_in / jnp.maximum(jnp.sum(corr_valid.astype(jnp.float32)), 1.0)
    rmse = jnp.sqrt(jnp.sum(inlier * err ** 2) / jnp.maximum(n_in, 1.0))
    return R, t, fitness, rmse


@partial(jax.jit, static_argnames=("k",))
def fpfh_features_batch(points, mask, radius, k: int = 32):
    """Vmapped (B, N, 33) FPFH descriptors over a batch of padded clouds."""
    return jax.vmap(lambda p, m: fpfh_features(p, m, radius, k=k))(
        points, mask
    )


@partial(jax.jit, static_argnames=("num_hypotheses", "ransac_n",
                                   "with_constraint", "mutual_filter"))
def ransac_registration_batch(src, src_mask, dst, dst_mask, src_feat,
                              dst_feat, keys, distance_threshold,
                              num_hypotheses: int = 2048, ransac_n: int = 4,
                              with_constraint: bool = True,
                              edge_length_ratio: float = 0.9,
                              mutual_filter: bool = True):
    """Vmapped parallel-hypothesis RANSAC over a batch of pairs."""
    return jax.vmap(
        lambda a, am, b, bm, fa, fb, k: ransac_registration(
            a, am, b, bm, fa, fb, k, distance_threshold,
            num_hypotheses=num_hypotheses, ransac_n=ransac_n,
            with_constraint=with_constraint,
            edge_length_ratio=edge_length_ratio,
            mutual_filter=mutual_filter,
        )
    )(src, src_mask, dst, dst_mask, src_feat, dst_feat, keys)


def prep_downsampled_batch(clouds, masks, voxel_size: float,
                           max_points: int = 2048):
    """Host-side voxel downsample of a chunk of padded clouds into one
    padded (B, max_points, 3) array + mask (the only non-device stage of
    the global-registration pipeline)."""
    b = len(clouds)
    pts = np.zeros((b, max_points, 3), np.float32)
    msk = np.zeros((b, max_points), bool)
    for i in range(b):
        cloud = clouds[i][masks[i]] if masks is not None else clouds[i]
        down = voxel_downsample(cloud, voxel_size, max_points=max_points)
        c = min(len(down), max_points)
        pts[i, :c] = down[:c]
        msk[i, :c] = True
    return pts, msk


def global_registration_batch(src, src_mask, dst, dst_mask,
                              voxel_size: float = 0.05, seed: int = 0,
                              method: str = "ransac",
                              with_constraint: bool = True,
                              max_points: int = 2048,
                              num_hypotheses: int = 2048,
                              mutual_filter: bool = True):
    """Batched FPFH global registration for a chunk of padded pairs.

    ``method``: 'ransac' (reference icp_o3_gicp, icp.py:85-105) or 'fgr'
    (reference icp_o3_gicp_fast, icp.py:121-143 — see icp/fgr.py).
    Replaces the per-pair Python loop with three device launches
    (features x2, registration). Returns (transforms (B,4,4), fitness,
    rmse) numpy.
    """
    radius_feature = voxel_size * 5.0
    distance_threshold = voxel_size * 1.5
    sp, sm = prep_downsampled_batch(src, src_mask, voxel_size, max_points)
    dp, dm = prep_downsampled_batch(dst, dst_mask, voxel_size, max_points)
    sp_j, sm_j = jnp.asarray(sp), jnp.asarray(sm)
    dp_j, dm_j = jnp.asarray(dp), jnp.asarray(dm)
    sf, _ = fpfh_features_batch(sp_j, sm_j, radius_feature)
    df, _ = fpfh_features_batch(dp_j, dm_j, radius_feature)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(sp))
    if method == "ransac":
        R, t, fit, rmse = ransac_registration_batch(
            sp_j, sm_j, dp_j, dm_j, sf, df, keys, distance_threshold,
            num_hypotheses=num_hypotheses, with_constraint=with_constraint,
            mutual_filter=mutual_filter,
        )
    elif method == "fgr":
        from alignnet3d_tpu.icp.fgr import fgr_batch_jit

        R, t, fit, rmse = fgr_batch_jit(
            sp_j, sm_j, dp_j, dm_j, sf, df, keys,
            with_constraint=with_constraint,
            distance_threshold=distance_threshold,
        )
    else:
        raise ValueError(f"unknown global registration method {method!r}")
    R, t = np.asarray(R), np.asarray(t)
    out = np.tile(np.eye(4), (len(R), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out, np.asarray(fit), np.asarray(rmse)


def fpfh_ransac_pair(src_full: np.ndarray, dst_full: np.ndarray,
                     voxel_size: float = 0.05, seed: int = 0,
                     num_hypotheses: int = 2048,
                     with_constraint: bool = True,
                     max_points: int = 2048):
    """Full pipeline for one pair of raw clouds (reference icp_o3_gicp,
    icp.py:85-105): downsample, features, RANSAC. Returns (4x4, fitness,
    rmse)."""
    radius_feature = voxel_size * 5.0
    distance_threshold = voxel_size * 1.5

    def prep(cloud):
        down = voxel_downsample(cloud, voxel_size, max_points=max_points)
        pad = max_points - len(down)
        pts = np.pad(down, ((0, max(0, pad)), (0, 0)))[:max_points]
        msk = np.zeros(max_points, bool)
        msk[: min(len(down), max_points)] = True
        return jnp.asarray(pts), jnp.asarray(msk)

    sp, sm = prep(src_full)
    dp, dm = prep(dst_full)
    sf, _ = fpfh_features(sp, sm, radius_feature)
    df, _ = fpfh_features(dp, dm, radius_feature)
    R, t, fit, rmse = ransac_registration(
        sp, sm, dp, dm, sf, df, jax.random.PRNGKey(seed),
        distance_threshold, num_hypotheses=num_hypotheses,
        with_constraint=with_constraint,
    )
    out = np.eye(4)
    out[:3, :3] = np.asarray(R)
    out[:3, 3] = np.asarray(t)
    return out, float(fit), float(rmse)
