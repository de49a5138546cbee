"""180-degree flip resolution by chamfer comparison."""

import numpy as np
import jax.numpy as jnp

from alignnet3d_tpu.geometry import get_mat_angle, transform_points
from alignnet3d_tpu.ops.flip_resolve import apply_flip_resolution


def _asym_cloud(rng, n=256):
    """Asymmetric structured cloud (L-shape) so theta vs theta+pi are
    distinguishable."""
    n1 = n // 2
    a = np.stack([rng.uniform(0, 2.0, n1), rng.uniform(0, 0.8, n1),
                  rng.uniform(0, 0.5, n1)], axis=1)
    b = np.stack([rng.uniform(0, 0.6, n - n1), rng.uniform(0, 2.0, n - n1),
                  rng.uniform(0, 0.4, n - n1)], axis=1)
    return np.concatenate([a, b]).astype(np.float32)


def test_resolves_planted_flips(rng):
    b = 8
    pcs1, pcs2, t, a, c = [], [], [], [], []
    gt_angles = rng.uniform(-np.pi / 2, np.pi / 2, b)
    planted = np.arange(b) % 2 == 0  # flip every other prediction
    for i in range(b):
        pc1 = _asym_cloud(rng) + np.array([6, 3, 0], np.float32)
        center = pc1.mean(axis=0)
        trans = rng.uniform(-0.5, 0.5, 3)
        M = get_mat_angle(trans, gt_angles[i], center)
        pc2 = transform_points(pc1, M).astype(np.float32)
        pred_angle = gt_angles[i] + (np.pi if planted[i] else 0.0)
        pcs1.append(pc1); pcs2.append(pc2)
        t.append(trans); a.append(pred_angle); c.append(center)
    corrected, flip = apply_flip_resolution(
        np.stack(pcs1), np.stack(pcs2), np.stack(t), np.asarray(a),
        np.stack(c),
    )
    # every planted flip detected, no false flips
    np.testing.assert_array_equal(flip, planted)
    d = np.abs((corrected - gt_angles + np.pi) % (2 * np.pi) - np.pi)
    assert np.max(d) < 1e-5


def test_no_flip_on_correct_predictions(rng):
    pc1 = _asym_cloud(rng) + np.array([5, 0, 0], np.float32)
    center = pc1.mean(axis=0)
    M = get_mat_angle([0.2, 0.1, 0], 0.4, center)
    pc2 = transform_points(pc1, M).astype(np.float32)
    corrected, flip = apply_flip_resolution(
        pc1[None], pc2[None], np.array([[0.2, 0.1, 0]]), np.array([0.4]),
        center[None],
    )
    assert not flip[0]
    assert abs(corrected[0] - 0.4) < 1e-6


def test_chamfer_scores_precise_far_from_origin(rng):
    """Clouds 19 m out: the expanded |a|^2 - 2ab + |b|^2 distance would
    cancel most of float32's digits (|a|^2 = 361 m^2); the scores must
    still match a float64 chamfer."""
    import jax.numpy as jnp

    from alignnet3d_tpu.ops.flip_resolve import resolve_flips

    b = 4
    pcs1 = np.stack([_asym_cloud(rng, 512) for _ in range(b)])
    pcs1 += np.array([18.0, 5.0, -1.5], np.float32)
    pcs2 = pcs1 + rng.normal(0, 0.02, pcs1.shape).astype(np.float32)
    t = np.zeros((b, 3), np.float32)
    ang = rng.normal(0, 0.05, b).astype(np.float32)
    c = pcs1.mean(axis=1)
    _, d, _ = resolve_flips(jnp.asarray(pcs1), jnp.asarray(pcs2),
                            jnp.asarray(t), jnp.asarray(ang), jnp.asarray(c))
    p1 = pcs1.astype(np.float64) - c[:, None]
    cs, sn = np.cos(ang.astype(np.float64)), np.sin(ang.astype(np.float64))
    moved = np.stack([cs[:, None] * p1[..., 0] - sn[:, None] * p1[..., 1],
                      sn[:, None] * p1[..., 0] + cs[:, None] * p1[..., 1],
                      p1[..., 2]], -1) + c[:, None]
    want = [np.mean(np.sqrt(np.min(np.sum(
        (m[:, None] - q[None].astype(np.float64)) ** 2, -1), 1)))
        for m, q in zip(moved, pcs2)]
    np.testing.assert_allclose(np.asarray(d), want, rtol=2e-5)
