"""Inference-time 180-degree flip resolution.

Models trained with ``accept_inverted_angle`` output yaw known only mod
pi (~50% of predictions are flipped; see docs/RESULTS.md). But the two
hypotheses are geometrically distinguishable: apply both to cloud1 and
keep the one that lands closer to cloud2. One batched device launch —
a (B, N, N) chamfer comparison — resolves the whole eval set.

This is a framework addition (``evaluation.resolve_flips``), not a
reference behavior; the reference ships the ambiguity to the eval_180
metric instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.ops.transforms import apply_rigid


def _one_sided_chamfer(moved, target):
    """Mean over points of the nearest-neighbor distance (B,)."""
    # Centred on the target (the expanded distance loses float32
    # precision with |a|^2 at range) and at HIGHEST: the two scores are
    # compared per pair, and a TF32 product (about three decimal digits)
    # can flip the decision on a near tie.
    c = jnp.mean(target, axis=1, keepdims=True)
    moved, target = moved - c, target - c
    d2 = (
        jnp.sum(moved ** 2, axis=-1)[:, :, None]
        - 2.0 * jnp.einsum("bnd,bmd->bnm", moved, target,
                           precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(target ** 2, axis=-1)[:, None, :]
    )
    return jnp.mean(jnp.sqrt(jnp.maximum(jnp.min(d2, axis=2), 0.0)), axis=1)


@jax.jit
def resolve_flips(pcs1, pcs2, translations, angles, centers):
    """Pick theta vs theta+pi per pair by alignment quality.

    Args:
      pcs1, pcs2: (B, N, 3) subsampled clouds.
      translations: (B, 3); angles: (B,); centers: (B, 3) rotation centers.
    Returns (B,) bool — True where theta+pi aligns better — and the two
    chamfer scores.
    """
    moved = apply_rigid(pcs1, translations, angles, centers)
    moved_flip = apply_rigid(pcs1, translations, angles + jnp.pi, centers)
    d = _one_sided_chamfer(moved, pcs2)
    d_flip = _one_sided_chamfer(moved_flip, pcs2)
    return d_flip < d, d, d_flip


def apply_flip_resolution(pcs1, pcs2, translations, angles, centers):
    """Numpy wrapper: returns corrected angles (flips applied)."""
    flip, d, d_flip = resolve_flips(
        jnp.asarray(pcs1, jnp.float32), jnp.asarray(pcs2, jnp.float32),
        jnp.asarray(translations, jnp.float32).reshape(-1, 3),
        jnp.asarray(angles, jnp.float32).reshape(-1),
        jnp.asarray(centers, jnp.float32).reshape(-1, 3),
    )
    flip = np.asarray(flip)
    out = np.asarray(angles, np.float64).reshape(-1).copy()
    out = np.where(flip, out + np.pi, out)
    out = (out + np.pi) % (2 * np.pi) - np.pi
    return out, flip
