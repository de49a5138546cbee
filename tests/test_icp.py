"""ICP correctness: recover known rigid motions (the reference's C++ fork is
unobservable, so closed-form alignments are the oracle — SURVEY.md §7.6)."""

import numpy as np
import pytest

from alignnet3d_tpu.geometry import get_mat_angle, transform_points
from alignnet3d_tpu.icp.p2point import (
    icp_p2point_batch,
    multistart_global_registration,
)


def _box_cloud(rng, n=400, extents=(2.0, 1.0, 0.8)):
    """Points on the surface of a box (axis-aligned, centered)."""
    pts = rng.uniform(-1, 1, (n, 3)) * np.asarray(extents)
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    for k in range(3):
        sel = axis == k
        pts[sel, k] = sign[sel] * extents[k]
    return pts


def _pad(clouds, n_max=None):
    n_max = n_max or max(len(c) for c in clouds)
    arr = np.zeros((len(clouds), n_max, 3), np.float32)
    mask = np.zeros((len(clouds), n_max), bool)
    for i, c in enumerate(clouds):
        arr[i, : len(c)] = c
        mask[i, : len(c)] = True
    return arr, mask


def test_icp_recovers_small_yaw_translation(rng):
    """Constrained ICP must recover a small ground-plane motion from a
    near-identity init to sub-centimeter accuracy."""
    b = 4
    srcs, dsts, gts = [], [], []
    for i in range(b):
        src = _box_cloud(rng) + np.array([5.0, 3.0, 0.0])
        gt_yaw = rng.uniform(-0.15, 0.15)
        gt_t = rng.uniform(-0.3, 0.3, 3) * np.array([1, 1, 0.2])
        M = get_mat_angle(gt_t, gt_yaw)
        dsts.append(transform_points(src, M))
        srcs.append(src)
        gts.append((gt_t, gt_yaw))
    src_a, src_m = _pad(srcs)
    dst_a, dst_m = _pad(dsts)
    init = np.tile(np.eye(4), (b, 1, 1))
    tf, fitness, rmse = icp_p2point_batch(
        src_a, src_m, dst_a, dst_m, init, radius=0.5, its=50
    )
    for i in range(b):
        gt_t, gt_yaw = gts[i]
        yaw = np.arctan2(tf[i, 1, 0], tf[i, 0, 0])
        assert abs(yaw - gt_yaw) < 2e-3, (yaw, gt_yaw)
        assert np.linalg.norm(tf[i, :3, 3] - get_mat_angle(gt_t, gt_yaw)[:3, 3]) < 2e-2
        assert fitness[i] > 0.99
        assert rmse[i] < 1e-2


def test_icp_constraint_projects_out_tilt(rng):
    """With a tilted (non-yaw) true motion, the constrained estimate stays
    yaw-only: R[2,:2] == 0 and |det| == 1."""
    src = _box_cloud(rng)
    cx, sx = np.cos(0.2), np.sin(0.2)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    dst = src @ Rx.T + np.array([0.1, 0.05, 0.0])
    src_a, src_m = _pad([src])
    dst_a, dst_m = _pad([dst])
    tf, _, _ = icp_p2point_batch(
        src_a, src_m, dst_a, dst_m, np.eye(4)[None], radius=1.0, its=20
    )
    assert np.allclose(tf[0, 2, :2], 0.0, atol=1e-6)
    assert np.allclose(tf[0, :2, 2], 0.0, atol=1e-6)
    assert np.linalg.det(tf[0, :3, :3]) == pytest.approx(1.0, abs=1e-5)


def test_icp_unconstrained_recovers_full_rotation(rng):
    src = _box_cloud(rng)
    cx, sx = np.cos(0.1), np.sin(0.1)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Rz = get_mat_angle(None, 0.1)[:3, :3]
    R = Rx @ Rz
    t = np.array([0.05, -0.02, 0.03])
    dst = src @ R.T + t
    src_a, src_m = _pad([src])
    dst_a, dst_m = _pad([dst])
    tf, fit, rmse = icp_p2point_batch(
        src_a, src_m, dst_a, dst_m, np.eye(4)[None], radius=0.5, its=50,
        with_constraint=False,
    )
    assert np.allclose(tf[0, :3, :3], R, atol=1e-3)
    assert np.allclose(tf[0, :3, 3], t, atol=5e-3)


def test_icp_padding_invariance(rng):
    """Padded garbage points must not affect the result."""
    src = _box_cloud(rng, n=200)
    M = get_mat_angle([0.1, -0.05, 0.0], 0.05)
    dst = transform_points(src, M)
    a1, m1 = _pad([src], n_max=200)
    d1, dm1 = _pad([dst], n_max=200)
    a2, m2 = _pad([src], n_max=512)
    d2, dm2 = _pad([dst], n_max=512)
    # poison the padding region
    a2[0, 200:] = 1e3
    d2[0, 200:] = -1e3
    tf1, _, _ = icp_p2point_batch(a1, m1, d1, dm1, np.eye(4)[None], 0.5, 30)
    tf2, _, _ = icp_p2point_batch(a2, m2, d2, dm2, np.eye(4)[None], 0.5, 30)
    np.testing.assert_allclose(tf1, tf2, atol=1e-5)


def test_icp_no_correspondences_keeps_init(rng):
    """Clouds farther apart than the radius: transform stays at the init."""
    src = _box_cloud(rng, n=50)
    dst = src + np.array([100.0, 0, 0])
    a, m = _pad([src])
    d, dm = _pad([dst])
    init = get_mat_angle([1.0, 2.0, 0.0], 0.3)[None]
    tf, fitness, _ = icp_p2point_batch(a, m, d, dm, init, radius=0.1, its=5)
    np.testing.assert_allclose(tf, init, atol=1e-6)
    assert fitness[0] == 0.0


def test_multistart_recovers_large_yaw(rng):
    """Initialization-free registration handles a 120-degree yaw the local
    method cannot."""
    src = _box_cloud(rng, n=300, extents=(2.0, 1.0, 0.8)) + np.array([4.0, 2.0, 0.0])
    gt_yaw = 2.1
    gt_t = np.array([0.4, -0.2, 0.0])
    M = get_mat_angle(gt_t, gt_yaw)
    dst = transform_points(src, M)
    a, m = _pad([src])
    d, dm = _pad([dst])
    tf, fit, rmse = multistart_global_registration(
        a, m, d, dm, num_yaw_hypotheses=16
    )
    moved = transform_points(src, tf[0])
    err = np.abs(moved - dst).max()
    assert err < 0.05, err
    assert fit[0] > 0.95


class _FakePacked:
    """Duck-typed PackedDataset slice for refine_predictions tests."""

    def __init__(self, clouds1, clouds2):
        for k, clouds in ((1, clouds1), (2, clouds2)):
            counts = np.array([len(c) for c in clouds], np.int64)
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            setattr(self, f"counts{k}", counts)
            setattr(self, f"offsets{k}", offsets)
            setattr(self, f"points{k}",
                    np.concatenate(clouds).astype(np.float32))

    def rows(self, idxs):
        return np.asarray(idxs)


def test_gated_refinement_trust_region(rng):
    """Gate mechanics (framework addition, VERDICT item 4): a zero-size
    trust region returns exactly the init composition; the default gate
    returns, per pair, either the init or the ungated refinement, and
    never moves further from the init than the trust bounds."""
    from alignnet3d_tpu.icp.p2point import refine_predictions

    b = 6
    clouds1, clouds2, gt_t, gt_yaw = [], [], [], []
    for i in range(b):
        src = _box_cloud(rng, n=300) + np.array([6.0, 2.0, 0.0])
        yaw = rng.uniform(-1.2, 1.2)
        t = rng.uniform(-0.5, 0.5, 3) * np.array([1, 1, 0.1])
        M = get_mat_angle(t, yaw)
        clouds1.append(src)
        clouds2.append(transform_points(src, M))
        gt_t.append(M[:3, 3])  # world-frame translation
        gt_yaw.append(yaw)
    ds = _FakePacked(clouds1, clouds2)
    pred_t = np.asarray(gt_t, np.float32)
    pred_a = np.asarray(gt_yaw, np.float32).reshape(-1, 1)
    pred_c = np.zeros((b, 3), np.float32)  # world-frame preds
    idxs = list(range(b))

    zero_gate, _ = refine_predictions(
        None, idxs, pred_t, pred_a, pred_c, its=20, dataset=ds,
        gate=True, gate_max_dyaw_deg=0.0, gate_max_dxy=0.0,
    )
    np.testing.assert_allclose(zero_gate["translations"], pred_t, atol=1e-5)
    np.testing.assert_allclose(
        zero_gate["angles"].ravel(), pred_a.ravel(), atol=1e-5
    )

    ungated, _ = refine_predictions(
        None, idxs, pred_t, pred_a, pred_c, its=20, dataset=ds,
    )
    gated, _ = refine_predictions(
        None, idxs, pred_t, pred_a, pred_c, its=20, dataset=ds, gate=True,
    )
    for i in range(b):
        took_init = np.allclose(
            gated["translations"][i], pred_t[i], atol=1e-5
        ) and np.allclose(gated["angles"][i], pred_a[i], atol=1e-5)
        took_refined = np.allclose(
            gated["translations"][i], ungated["translations"][i], atol=1e-5
        ) and np.allclose(gated["angles"][i], ungated["angles"][i], atol=1e-5)
        assert took_init or took_refined
        dyaw = np.rad2deg(abs(
            (gated["angles"][i, 0] - pred_a[i, 0] + np.pi) % (2 * np.pi)
            - np.pi
        ))
        assert dyaw <= 15.0 + 1e-6
        assert np.linalg.norm(
            gated["translations"][i, :2] - pred_t[i, :2]
        ) <= 0.5 + 1e-6


def _nn_reference(src, dst, mask):
    """float64 brute-force nearest valid dst point per src point."""
    s = np.asarray(src, np.float64)
    d = np.asarray(dst, np.float64)
    d2 = np.sum((s[:, None, :] - d[None, :, :]) ** 2, axis=-1)
    d2[:, ~np.asarray(mask)] = np.inf
    idx = np.argmin(d2, axis=1)
    return idx, d2[np.arange(len(s)), idx], d2


def _assert_nn_matches(src, dst, mask, idx, d2, eps=1e-5):
    """Indices equal the float64 reference except on near ties (the two
    candidates' squared distances within ``eps`` of the cloud's scale)."""
    ri, rd, full = _nn_reference(src, dst, mask)
    idx = np.asarray(idx)
    scale = 1.0 + np.max(np.sum(np.asarray(dst, np.float64) ** 2, -1))
    off = idx != ri
    if off.any():
        gap = np.abs(full[np.arange(len(idx)), idx] - rd) / scale
        assert np.all(gap[off] <= eps), float(gap[off].max())
    np.testing.assert_allclose(np.asarray(d2), rd, rtol=1e-4, atol=1e-5)


def test_nn_correspondences_match_f64(rng):
    """Chunked NN search (icp/p2point.py) against float64 brute force,
    with src lengths below, at and above the chunk size and padded dst."""
    import jax.numpy as jnp

    from alignnet3d_tpu.icp.p2point import _nn_correspondences

    for n1, n2, nv in [(16, 40, 33), (130, 700, 650), (1025, 1300, 1300)]:
        src = rng.normal(size=(n1, 3)).astype(np.float32)
        dst = rng.normal(size=(n2, 3)).astype(np.float32)
        mask = np.zeros(n2, bool)
        mask[:nv] = True
        i, d = _nn_correspondences(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
        assert i.shape == (n1,) and d.shape == (n1,)
        _assert_nn_matches(src, dst, mask, i, d)


def test_nn_correspondences_vmap_over_pairs(rng):
    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.icp.p2point import _nn_correspondences

    src = rng.normal(size=(3, 256, 3)).astype(np.float32)
    dst = rng.normal(size=(3, 256, 3)).astype(np.float32)
    mask = np.ones((3, 256), bool)
    i, d = jax.vmap(_nn_correspondences)(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    for b in range(3):
        _assert_nn_matches(src[b], dst[b], mask[b], i[b], d[b])


def test_icp_scores_precise_far_from_origin(rng):
    """A pair 19 m out: the init's inlier RMSE (a 0-iteration pass, what
    the refinement gate compares) matches float64 — the distances are
    taken about the pair's centroid, not the sensor origin."""
    src = _box_cloud(rng, n=600).astype(np.float32)
    src += np.array([17.0, 8.0, -1.0], np.float32)
    dst = (src + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    init = np.eye(4)[None]
    _, fit, rmse = icp_p2point_batch(src[None], np.ones((1, 600), bool),
                                     dst[None], np.ones((1, 600), bool),
                                     init, radius=0.1, its=0)
    d2 = np.sum((src[:, None].astype(np.float64) - dst[None]) ** 2, -1)
    nearest = d2.min(axis=1)
    inl = nearest < 0.01
    assert float(fit[0]) == pytest.approx(inl.mean())
    assert float(rmse[0]) == pytest.approx(np.sqrt(nearest[inl].mean()),
                                           rel=1e-4)
