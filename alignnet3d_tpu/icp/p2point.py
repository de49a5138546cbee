"""Batched on-device ICP with the ground-plane constraint.

On-device replacement for the reference's per-sample CPU calls into a
forked Open3D C++ library (reference icp.py:69-143; the fork adds a
``with_constraint`` flag that restricts the estimated motion to yaw +
translation, cf. the Python port ICP.constrain_transform,
pointcloud.py:1208-1254).

Design:
- the WHOLE val set of cloud pairs runs as a vmapped batch on device; each
  iteration is: brute-force nearest neighbor (chunked (B, n1, n2) distance
  matrix -> argmin, a pure-matmul workload),
  radius-gated correspondences, then a CLOSED-FORM weighted yaw+translation
  update (no SVD needed under the constraint; the unconstrained variant
  uses a 3x3 Kabsch SVD).
- fixed iteration count + masking keeps every shape static for XLA.
- clouds are padded to a common length with mask weights; padded points
  never become correspondences.
- every product whose result is index-valued (the distances fed to argmin)
  or moves a whole cloud runs at HIGHEST precision: a TF32 product keeps
  about three decimal digits, which flips near-tied correspondences and
  moves a point 20 m out by millimetres.

This inverts the reference's cost model: instead of ~1k sequential C++
calls at ~ms each, one jit launch aligns the entire set.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.geometry import get_mat_angle

NN_CHUNK = 512
HIGHEST = jax.lax.Precision.HIGHEST


def _nn_correspondences(src, dst, dst_mask):
    """For each src point: index + squared distance of nearest valid dst
    point. Chunked over src to bound the (chunk, n2) distance matrix."""
    n1 = src.shape[0]
    d2_invalid = jnp.where(dst_mask, 0.0, jnp.inf)  # (n2,)

    def chunk_fn(chunk):
        # (c, n2) squared distances via |a|^2 - 2ab + |b|^2
        d2 = (
            jnp.sum(chunk ** 2, axis=1)[:, None]
            - 2.0 * jnp.matmul(chunk, dst.T, precision=HIGHEST)
            + jnp.sum(dst ** 2, axis=1)[None, :]
        )
        # |a-b|^2 via expansion can go slightly negative at convergence —
        # clamp so downstream sqrt stays finite
        d2 = jnp.maximum(d2, 0.0) + d2_invalid[None, :]
        idx = jnp.argmin(d2, axis=1)
        return idx, jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]

    pad = (-n1) % NN_CHUNK
    src_p = jnp.pad(src, ((0, pad), (0, 0)))
    chunks = src_p.reshape(-1, NN_CHUNK, 3)
    idx, d2 = jax.lax.map(chunk_fn, chunks)
    return idx.reshape(-1)[:n1], d2.reshape(-1)[:n1]


def _center_pair(src, dst, dst_mask, init_R, init_t):
    """Shift a pair so that the valid dst points' centroid is the origin.

    The expanded distance |a|^2 - 2ab + |b|^2 loses float32 precision
    with |a|^2: a point 20 m out carries 400 m^2, so its squared distances
    are good to about 2e-5 m^2 — enough to flip neighbours and the radius
    gate, and to make two backends' ICP runs drift millimetres apart.
    Returns the shifted clouds, the initial translation in the shifted
    frame and the shift ``c``; a transform (R, t) found there is
    (R, t + c - R c) in the original frame."""
    w = dst_mask.astype(jnp.float32)
    c = jnp.sum(dst * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    t0 = init_t + jnp.matmul(init_R, c, precision=HIGHEST) - c
    return src - c, dst - c, t0, c


def _uncenter(R, t, c):
    return t + c - jnp.matmul(R, c, precision=HIGHEST)


def _estimate_yaw_translation(p, q, w):
    """Weighted closed-form (yaw, translation) minimizing
    sum w |Rz(yaw) p + t - q|^2 — the constrained Procrustes step."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    p_bar = jnp.sum(w[:, None] * p, axis=0) / wsum
    q_bar = jnp.sum(w[:, None] * q, axis=0) / wsum
    a = p - p_bar
    b = q - q_bar
    num = jnp.sum(w * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]))
    den = jnp.sum(w * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]))
    yaw = jnp.arctan2(num, den)
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    R = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    R = R.at[0, 0].set(c).at[0, 1].set(-s).at[1, 0].set(s).at[1, 1].set(c)
    t = q_bar - jnp.matmul(R, p_bar, precision=HIGHEST)
    return R, t


def _estimate_full(p, q, w):
    """Unconstrained weighted Kabsch (3x3 SVD)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    p_bar = jnp.sum(w[:, None] * p, axis=0) / wsum
    q_bar = jnp.sum(w[:, None] * q, axis=0) / wsum
    H = jnp.matmul(((p - p_bar) * w[:, None]).T, q - q_bar,
                   precision=HIGHEST)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(d)
    R = jnp.matmul(jnp.matmul(Vt.T, D, precision=HIGHEST), U.T,
                   precision=HIGHEST)
    t = q_bar - jnp.matmul(R, p_bar, precision=HIGHEST)
    return R, t


def _icp_single(src, src_mask, dst, dst_mask, init_R, init_t, radius, its,
                with_constraint):
    """Run `its` ICP iterations for one padded pair. Returns (R, t, fitness,
    inlier_rmse)."""
    radius2 = radius * radius
    src, dst, init_t, c = _center_pair(src, dst, dst_mask, init_R, init_t)

    def body(carry, _):
        R, t = carry
        moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
        idx, d2 = _nn_correspondences(moved, dst, dst_mask)
        w = (src_mask & (d2 < radius2)).astype(jnp.float32)
        q = dst[idx]
        if with_constraint:
            R_inc, t_inc = _estimate_yaw_translation(moved, q, w)
        else:
            R_inc, t_inc = _estimate_full(moved, q, w)
        # no correspondences -> keep current transform
        has = jnp.sum(w) > 0
        R_inc = jnp.where(has, R_inc, jnp.eye(3))
        t_inc = jnp.where(has, t_inc, jnp.zeros(3))
        # composing in TF32 would drift the transform over the iterations
        R_new = jnp.matmul(R_inc, R, precision=HIGHEST)
        t_new = jnp.matmul(R_inc, t, precision=HIGHEST) + t_inc
        return (R_new, t_new), None

    (R, t), _ = jax.lax.scan(body, (init_R, init_t), None, length=its)
    moved = jnp.matmul(src, R.T, precision=HIGHEST) + t
    idx, d2 = _nn_correspondences(moved, dst, dst_mask)
    inlier = (src_mask & (d2 < radius2)).astype(jnp.float32)
    n_src = jnp.maximum(jnp.sum(src_mask.astype(jnp.float32)), 1.0)
    n_in = jnp.sum(inlier)
    fitness = n_in / n_src
    inlier_rmse = jnp.sqrt(jnp.sum(inlier * d2) / jnp.maximum(n_in, 1.0))
    return R, _uncenter(R, t, c), fitness, inlier_rmse


from functools import partial


@partial(jax.jit, static_argnums=(7,))
def _icp_batch_constrained(src, src_mask, dst, dst_mask, init_R, init_t,
                           radius, its):
    return jax.vmap(
        lambda a, am, b, bm, r0, t0: _icp_single(
            a, am, b, bm, r0, t0, radius, its, True
        )
    )(src, src_mask, dst, dst_mask, init_R, init_t)


@partial(jax.jit, static_argnums=(7,))
def _icp_batch_full(src, src_mask, dst, dst_mask, init_R, init_t, radius, its):
    return jax.vmap(
        lambda a, am, b, bm, r0, t0: _icp_single(
            a, am, b, bm, r0, t0, radius, its, False
        )
    )(src, src_mask, dst, dst_mask, init_R, init_t)


def icp_p2point_batch(src, src_mask, dst, dst_mask, init_transforms,
                      radius: float = 0.2, its: int = 30,
                      with_constraint: bool = True):
    """Batched point-to-point ICP.

    Args:
      src, dst: (B, N, 3) padded clouds; masks (B, N) bool valid flags.
      init_transforms: (B, 4, 4) initial guesses.
      radius: correspondence gate (reference uses 0.1 for refinement,
        icp.py:69/76; 0.10 standalone, icp.py:185).
      its: fixed iteration count (o3 ICPConvergenceCriteria max_iteration).
    Returns (transforms (B,4,4), fitness (B,), inlier_rmse (B,)) numpy.
    """
    init_R = jnp.asarray(init_transforms[:, :3, :3], jnp.float32)
    init_t = jnp.asarray(init_transforms[:, :3, 3], jnp.float32)
    fn = _icp_batch_constrained if with_constraint else _icp_batch_full
    R, t, fitness, rmse = fn(
        jnp.asarray(src, jnp.float32), jnp.asarray(src_mask, bool),
        jnp.asarray(dst, jnp.float32), jnp.asarray(dst_mask, bool),
        init_R, init_t, float(radius), int(its),
    )
    R, t = np.asarray(R), np.asarray(t)
    out = np.tile(np.eye(4, dtype=np.float64), (len(R), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out, np.asarray(fitness), np.asarray(rmse)


# ----------------------------------------------------------- cloud batching


def pad_full_clouds(dataset, file_indices, max_points: int = 4096,
                    seed: int = 0, pad_to: int | None = None):
    """Assemble the FULL (non-subsampled) clouds for the given samples as
    padded (B, N, 3) arrays + masks; clouds above ``max_points`` are
    uniformly subsampled (deterministic).

    ``pad_to`` fixes the padded length (e.g. a dataset-global cap) so that
    successive chunks share one compiled ICP executable; by default the
    chunk's own max count is used."""
    rng = np.random.default_rng(seed)
    rows = dataset.rows(file_indices)
    n_cap = pad_to if pad_to is not None else max(
        1,
        min(
            max_points,
            int(max(
                dataset.counts1[rows].max(initial=1),
                dataset.counts2[rows].max(initial=1),
            )),
        ),
    )
    out = []
    for k in (1, 2):
        counts = getattr(dataset, f"counts{k}")[rows]
        offsets = getattr(dataset, f"offsets{k}")[rows]
        points = getattr(dataset, f"points{k}")
        b = len(rows)
        arr = np.zeros((b, n_cap, 3), np.float32)
        mask = np.zeros((b, n_cap), bool)
        for i in range(b):
            c = int(counts[i])
            pts = points[offsets[i]: offsets[i] + c]
            if c > n_cap:
                pick = rng.choice(c, n_cap, replace=False)
                pts = pts[pick]
                c = n_cap
            arr[i, :c] = pts
            mask[i, :c] = True
        out.append((arr, mask))
    return out[0], out[1]


def refine_predictions(cfg, val_idxs, pred_translations, pred_angles,
                       pred_centers, its: int = 30, radius: float = 0.1,
                       dataset=None, pair_chunk: int = 128,
                       max_points: int = 4096, gate: bool = False,
                       gate_max_dyaw_deg: float = 15.0,
                       gate_max_dxy: float = 0.5,
                       method: str = "p2p"):
    """ICP-refine network predictions over the whole val set
    (replaces reference train.py:461-484's per-sample C++ loop).

    Initial transforms: get_mat_angle(pred_t, pred_a, center=pred_center)
    (reference train.py:465-467). Returns (dict with refined world-frame
    translations/angles, elapsed seconds).

    ``gate`` (framework addition, cfg key evaluation.refinement_gate):
    the reference applies refinement blanket to every pair
    (train.py:463-484), but ICP from a good init DEGRADES accuracy at
    large relative rotations — the scans see different object faces and
    the partial-overlap chamfer minimum sits away from the truth
    (docs/RESULTS.md "ICP refinement behavior"). Gating accepts the
    refined transform per pair only when BOTH hold:
    - it scores better than the init on the radius-gated registration
      quality (fitness up, or equal fitness with inlier RMSE down) — the
      init's score comes from a 0-iteration ICP call;
    - it stays inside a trust region around the network init
      (|dyaw| <= gate_max_dyaw_deg, |dxy| <= gate_max_dxy) — a refinement
      that jumps far from a near-perfect init is chasing the wrong basin,
      and chamfer alone cannot see that under partial overlap.

    ``method``: 'p2p' (reference train.py:36's only working choice) or
    'p2plane' (icp/p2plane.py — fills the reference's asserted-out
    variant, icp.py:81-83). Gate scoring stays point-to-point for both
    so the acceptance decision is method-independent.
    """
    from alignnet3d_tpu.data.provider import PackedDataset

    if method == "p2plane":
        from alignnet3d_tpu.icp.p2plane import icp_p2plane_batch

        icp_fn = icp_p2plane_batch
    else:
        assert method == "p2p", f"unknown refinement method {method!r}"
        icp_fn = partial(icp_p2point_batch, with_constraint=True)

    if dataset is None:
        dataset = PackedDataset(cfg.data.basepath)
    n = len(val_idxs)
    rows = dataset.rows(val_idxs)
    global_pad = max(1, min(max_points, int(max(
        dataset.counts1[rows].max(initial=1),
        dataset.counts2[rows].max(initial=1),
    ))))
    out_t = np.empty((n, 3), np.float32)
    out_a = np.empty((n, 1), np.float32)
    elapsed = 0.0
    for s in range(0, n, pair_chunk):
        e = min(s + pair_chunk, n)
        (src, src_mask), (dst, dst_mask) = pad_full_clouds(
            dataset, val_idxs[s:e], max_points=max_points,
            pad_to=global_pad,
        )
        init = np.stack([
            get_mat_angle(pred_translations[i], pred_angles[i],
                          rotation_center=pred_centers[i])
            for i in range(s, e)
        ])
        t0 = time.time()
        tf, fit, rmse = icp_fn(
            src, src_mask, dst, dst_mask, init, radius=radius, its=its,
        )
        if gate:
            # score the INIT with a 0-iteration pass (same NN/radius gate)
            tf0, fit0, rmse0 = icp_p2point_batch(
                src, src_mask, dst, dst_mask, init, radius=radius, its=0,
                with_constraint=True,
            )
            yaw = np.arctan2(tf[:, 1, 0], tf[:, 0, 0])
            yaw0 = np.arctan2(tf0[:, 1, 0], tf0[:, 0, 0])
            dyaw = np.abs(
                np.rad2deg((yaw - yaw0 + np.pi) % (2 * np.pi) - np.pi)
            )
            dxy = np.linalg.norm(tf[:, :2, 3] - tf0[:, :2, 3], axis=1)
            better = (fit > fit0 + 1e-9) | (
                (fit >= fit0 - 1e-9) & (rmse <= rmse0 + 1e-9)
            )
            accept = better & (dyaw <= gate_max_dyaw_deg) & (
                dxy <= gate_max_dxy
            )
            tf = np.where(accept[:, None, None], tf, tf0)
        elapsed += time.time() - t0
        out_t[s:e] = tf[:, :3, 3]
        out_a[s:e, 0] = np.arctan2(tf[:, 1, 0], tf[:, 0, 0])
    return {"translations": out_t, "angles": out_a}, elapsed


def multistart_global_registration(src, src_mask, dst, dst_mask,
                                   num_yaw_hypotheses: int = 16,
                                   coarse_its: int = 15,
                                   refine_its: int = 30,
                                   coarse_radius: float = 1.0,
                                   radius: float = 0.1):
    """Initialization-free registration via parallel yaw multi-start.

    On-device replacement for the reference's FPFH + RANSAC / FGR global
    registration (icp.py:85-143): K yaw hypotheses around the centroid
    translation run coarse constrained ICP in parallel (one batched launch);
    the hypothesis with the best inlier RMSE wins and is refined. Rather
    than porting the feature+RANSAC pipeline (pointcloud.py:1192-1206), the
    search over the 1-DoF rotation is simply enumerated — the problem's
    rotation space is a circle.
    """
    b, n, _ = src.shape
    yaws = np.linspace(-np.pi, np.pi, num_yaw_hypotheses, endpoint=False)
    # centroid-difference translation init (reference get_centroid_init,
    # icp.py:62-66), rotation about the source centroid
    src_f = np.asarray(src, np.float64)
    m1 = np.asarray(src_mask, bool)[..., None]
    m2 = np.asarray(dst_mask, bool)[..., None]
    c1 = (src_f * m1).sum(1) / np.maximum(m1.sum(1), 1)
    c2 = (np.asarray(dst, np.float64) * m2).sum(1) / np.maximum(m2.sum(1), 1)

    inits = np.empty((b, num_yaw_hypotheses, 4, 4))
    for j, yaw in enumerate(yaws):
        for i in range(b):
            inits[i, j] = get_mat_angle(c2[i] - c1[i], yaw, rotation_center=c1[i])

    # coarse pass: flatten hypotheses into the batch axis
    K = num_yaw_hypotheses
    rep = lambda x: np.repeat(x, K, axis=0)  # noqa: E731
    tf, fit, rmse = icp_p2point_batch(
        rep(src), rep(src_mask), rep(dst), rep(dst_mask),
        inits.reshape(b * K, 4, 4), radius=coarse_radius, its=coarse_its,
    )
    # score: prefer high fitness, break ties with low rmse
    score = np.asarray(fit).reshape(b, K) - 0.1 * np.asarray(rmse).reshape(b, K)
    best = np.argmax(score, axis=1)
    best_tf = tf.reshape(b, K, 4, 4)[np.arange(b), best]
    # fine pass from the winning hypothesis
    tf2, fit2, rmse2 = icp_p2point_batch(
        src, src_mask, dst, dst_mask, best_tf, radius=radius, its=refine_its
    )
    return tf2, fit2, rmse2
