"""Dynamic-graph ops: pairwise distances, k-NN, edge features — the public
API behind the DGCNN backbone (reference utils/tf_util_dgcnn.py:638-706).

All batched: the (B, N, N) distance matrix is one matmul, top-k runs
on device. Exposed standalone so custom models can compose them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pairwise_distance(points: jax.Array) -> jax.Array:
    """Negative squared pairwise distances, shape (B, N, N).

    Sign convention matches the reference (tf_util_dgcnn.py:638-657):
    LARGER means closer, so ``top_k`` on the output selects neighbors.
    """
    # HIGHEST: the result is ranked by top_k, and a TF32 product (about
    # three decimal digits) would flip near-tied neighbours.
    inner = jnp.einsum("bnd,bmd->bnm", points, points,
                       precision=jax.lax.Precision.HIGHEST)
    sq = jnp.sum(jnp.square(points), axis=-1)
    return 2.0 * inner - sq[:, :, None] - sq[:, None, :]


def knn(neg_dist: jax.Array, k: int = 20,
        approximate: bool = False) -> jax.Array:
    """Indices of the k nearest neighbors, shape (B, N, k)
    (reference tf_util_dgcnn.py:660-671).

    ``approximate`` uses ``jax.lax.approx_max_k``, a partial-reduction
    top-k (recall ~0.95 at default settings). Graph convs are robust to a
    slightly perturbed neighbor set; enable via
    ``model.options.dgcnn_approx_knn`` (off by default — exact reference
    semantics)."""
    if approximate:
        _, idx = jax.lax.approx_max_k(neg_dist, k)
        return idx
    _, idx = jax.lax.top_k(neg_dist, k)
    return idx


def gather_rows(values: jax.Array, nn_idx: jax.Array) -> jax.Array:
    """Neighbor row lookup: (B, N, C) x (B, N, k) -> (B, N, k, C).

    FLAT row gather over the merged (B*N) axis: XLA lowers a batched
    ``take_along_axis`` to a general gather with per-element index
    arithmetic, while a flat ``jnp.take`` of whole rows is a plain row
    copy.
    """
    b, n, c = values.shape
    kk = nn_idx.shape[-1]
    offsets = (jnp.arange(b, dtype=nn_idx.dtype) * n)[:, None, None]
    flat_idx = (nn_idx + offsets).reshape(-1)
    return jnp.take(
        values.reshape(b * n, c), flat_idx, axis=0
    ).reshape(b, n, kk, c)


def get_edge_feature(points: jax.Array, nn_idx: jax.Array,
                     k: int = 20) -> jax.Array:
    """Edge features ``[x_i, x_j - x_i]``, shape (B, N, k, 2C)
    (reference tf_util_dgcnn.py:674-706).

    Uses the flat row gather (``gather_rows``); semantics identical to
    take_along_axis (tests/test_knn_ops.py).
    """
    del k  # implied by nn_idx shape
    neighbors = gather_rows(points, nn_idx)
    central = points[:, :, None, :]
    return jnp.concatenate(
        [jnp.broadcast_to(central, neighbors.shape), neighbors - central],
        axis=-1,
    )
