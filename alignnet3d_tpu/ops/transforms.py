"""Batched rigid transforms of point clouds, in JAX.

The reference rotates per sample with ``tf.map_fn`` over 3x3 matrices
(models/tp8.py:125, 365); here the whole batch is one einsum.

Both einsums run at HIGHEST precision: a TF32 product keeps about three
decimal digits, which moves a point 20 m out by millimetres — a large
share of the 2 cm success bucket.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rotation_matrix_z(angles: jax.Array) -> jax.Array:
    """(B,) yaw angles -> (B, 3, 3) rotation matrices about +z."""
    c, s = jnp.cos(angles), jnp.sin(angles)
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zeros], axis=-1),
            jnp.stack([s, c, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )


def rotate_points_z(points: jax.Array, angles: jax.Array) -> jax.Array:
    """Rotate (B, N, 3) points by per-sample yaw ``angles`` (B,).

    Note: computes ``points @ R`` (matrix on the RIGHT, not transposed),
    matching the reference's ``tf.matmul(pcs, rotation_mats)``
    (tp8.py:127, 366). Since ``p @ R = R^T p``, passing angle ``-a`` here
    rotates points by ``+a`` in the usual convention.
    """
    return jnp.einsum("bnd,bde->bne", points, rotation_matrix_z(angles),
                      precision=jax.lax.Precision.HIGHEST)


def transform_pcs(
    pcs: jax.Array,
    translations: jax.Array | None = None,
    angles: jax.Array | None = None,
    rotation_centers: jax.Array | None = None,
) -> jax.Array:
    """Batched port of reference tf_transform_pcs (tp8.py:361-371),
    preserving its exact (idiosyncratic) semantics:

    - points are shifted by ``-rotation_centers`` then rotated via
      ``p @ Rz(angle)``,
    - then shifted by ``-translations`` (note the sign: the reference
      *subtracts* the translation), then shifted back by
      ``+rotation_centers``.

    Only used by the ``p2p`` loss, where the same function is applied to both
    prediction and ground truth, so the sign convention cancels.
    """
    if rotation_centers is not None:
        pcs = pcs - rotation_centers[:, None, :]
    if angles is not None:
        pcs = rotate_points_z(pcs, angles)
    if translations is not None:
        pcs = pcs - translations[:, None, :]
    if rotation_centers is not None:
        pcs = pcs + rotation_centers[:, None, :]
    return pcs


def apply_rigid(
    pcs: jax.Array,
    translations: jax.Array,
    angles: jax.Array,
    rotation_centers: jax.Array,
) -> jax.Array:
    """Standard forward rigid motion: rotate (B,N,3) ``pcs`` by yaw about
    per-sample centers, then translate. Matches numpy
    ``geometry.get_mat_angle`` applied to points: ``R(p - c) + c + t``."""
    rot = rotation_matrix_z(angles)
    centered = pcs - rotation_centers[:, None, :]
    rotated = jnp.einsum("bde,bne->bnd", rot, centered,
                         precision=jax.lax.Precision.HIGHEST)
    return rotated + (rotation_centers + translations)[:, None, :]
