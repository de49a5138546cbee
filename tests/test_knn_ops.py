"""knn/edge-feature ops against brute-force numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alignnet3d_tpu.ops.knn import get_edge_feature, knn, pairwise_distance


def assert_knn_matches_f64(points, idx, k, eps=1e-5):
    """``idx`` (B, N, k) equals the float64 brute force, rank by rank,
    except where the two candidates' squared distances differ by at most
    ``eps`` times the row's distance scale (a near tie that float32
    rounding may order either way)."""
    p = np.asarray(points, np.float64)
    d = np.sum((p[:, :, None, :] - p[:, None, :, :]) ** 2, axis=-1)
    ref = np.argsort(d, axis=-1, kind="stable")[..., :k]
    got = np.asarray(idx)
    assert got.shape == ref.shape
    diff = got != ref
    if diff.any():
        d_got = np.take_along_axis(d, got, -1)
        d_ref = np.take_along_axis(d, ref, -1)
        scale = 1.0 + np.sum(p ** 2, axis=-1).max(axis=-1)[:, None, None]
        gap = np.abs(d_got - d_ref) / scale
        assert np.all(gap[diff] <= eps), float(gap[diff].max())


def test_pairwise_distance_matches_numpy(rng):
    pts = rng.normal(size=(2, 16, 3)).astype(np.float32)
    neg = np.asarray(pairwise_distance(jnp.asarray(pts)))
    ref = -np.sum(
        (pts[:, :, None, :] - pts[:, None, :, :]) ** 2, axis=-1
    )
    np.testing.assert_allclose(neg, ref, atol=1e-4)


def test_knn_selects_nearest(rng):
    pts = rng.normal(size=(1, 32, 3)).astype(np.float32)
    idx = np.asarray(knn(pairwise_distance(jnp.asarray(pts)), k=5))
    d = np.linalg.norm(pts[0][:, None] - pts[0][None], axis=-1)
    ref = np.argsort(d, axis=1)[:, :5]
    # compare as sets (ties may reorder)
    for i in range(32):
        assert set(idx[0, i]) == set(ref[i]), i
    # nearest neighbor of a point is itself
    assert all(idx[0, i, 0] == i for i in range(32))


def test_edge_features(rng):
    pts = rng.normal(size=(1, 8, 3)).astype(np.float32)
    nn_idx = knn(pairwise_distance(jnp.asarray(pts)), k=3)
    edge = np.asarray(get_edge_feature(jnp.asarray(pts), nn_idx))
    assert edge.shape == (1, 8, 3, 6)
    i, j = 2, 1
    neighbor = pts[0, np.asarray(nn_idx)[0, i, j]]
    np.testing.assert_allclose(edge[0, i, j, :3], pts[0, i], atol=1e-6)
    np.testing.assert_allclose(
        edge[0, i, j, 3:], neighbor - pts[0, i], atol=1e-6
    )


def test_knn_approximate_mostly_agrees():
    """approx_max_k kNN (partial reduction, ops/knn.py) must recover most
    of the exact neighbor set on a random cloud — the graph conv only
    needs a high-recall neighborhood, not an exact one.

    NOTE: on the CPU backend approx_max_k reduces to an exact top-k, so
    the recall bound only bites on an accelerator; the
    shape/validity/self-neighbor assertions below are the real CPU-side
    coverage (they catch wiring bugs: wrong axis, sign convention on
    neg_dist, k mishandling)."""
    import numpy as np

    from alignnet3d_tpu.ops.knn import knn, pairwise_distance

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 256, 3)).astype(np.float32)
    d = pairwise_distance(pts)
    exact = np.asarray(knn(d, 20))
    approx = np.asarray(knn(d, 20, approximate=True))
    assert approx.shape == (2, 256, 20)
    assert approx.min() >= 0 and approx.max() < 256
    # with the correct sign convention every point's nearest neighbor
    # (distance 0) is itself — it must appear in its own approx set
    self_hit = np.mean([
        i in approx[b, i] for b in range(2) for i in range(256)
    ])
    assert self_hit > 0.99, self_hit
    recall = np.mean([
        len(set(exact[b, i]) & set(approx[b, i])) / 20.0
        for b in range(2) for i in range(256)
    ])
    assert recall > 0.9, recall


@pytest.mark.parametrize("b,n,k", [(2, 128, 20), (3, 200, 8), (1, 256, 1)])
def test_knn_matches_f64_brute_force(b, n, k):
    rng = np.random.default_rng(7 + n)
    pts = jnp.asarray(rng.normal(size=(b, n, 3)), jnp.float32)
    assert_knn_matches_f64(pts, knn(pairwise_distance(pts), k), k)


def test_knn_self_first_and_ties():
    # duplicate points force exact distance ties; top_k orders them by
    # ascending index, like a stable sort of the float64 distances, and
    # a point or its earlier twin comes first
    pts = np.zeros((1, 132, 3), np.float32)
    pts[0, :, 0] = np.repeat(np.arange(66, dtype=np.float32), 2)
    idx = np.asarray(knn(pairwise_distance(jnp.asarray(pts)), 6))
    assert_knn_matches_f64(pts, idx, 6, eps=0.0)
    assert all(idx[0, i, 0] == i - i % 2 for i in range(132))


def test_knn_odd_n():
    rng = np.random.default_rng(3)
    pts = jnp.asarray(rng.normal(size=(2, 383, 3)), jnp.float32)
    assert_knn_matches_f64(pts, knn(pairwise_distance(pts), 10), 10)


def test_pairwise_distance_pins_highest_precision():
    """The product ranked by top_k runs at HIGHEST whatever the global
    default, so a TF32 default cannot reorder neighbours."""
    x = jnp.zeros((1, 8, 3))
    with jax.default_matmul_precision("tensorfloat32"):
        jaxpr = str(jax.make_jaxpr(pairwise_distance)(x))
    assert "precision=(Precision.HIGHEST, Precision.HIGHEST)" in jaxpr


@pytest.mark.gpu
def test_knn_on_gpu_matches_f64(gpu):
    rng = np.random.default_rng(11)
    pts = jnp.asarray(rng.normal(size=(4, 512, 3)) * 5.0, jnp.float32)
    with jax.default_matmul_precision("tensorfloat32"):
        idx = jax.jit(lambda p: knn(pairwise_distance(p), 20))(pts)
    assert_knn_matches_f64(pts, idx, 20)
