"""Point-cloud encoder backbones.

The reference implements its per-point "shared MLP" as 1xC conv2d stacks
(models/tp8.py:49-59) and DGCNN edge convs (tp8.py:30-46,
utils/tf_util_dgcnn.py:638-706). Here every one of those is a dense layer
over the channel axis: a ``(B*N, C) @ (C, F)`` matmul, fused by XLA with
bias/BN/ReLU. The N-wide maxpool is a single ``jnp.max`` over the point
axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from alignnet3d_tpu.models.batchnorm import batch_norm
from alignnet3d_tpu.models.layers import Module, Scope, dense, dropout


def _pool(stable: bool):
    """Max-pool op for the training graph: ``stable_max`` routes the
    gradient through a stop-gradient'd argmax one-hot instead of XLA's
    equality-mask reduce_max VJP, which jit can corrupt by
    rematerializing the operand (ops/stable_max.py has the full account
    and measured failure). Forward values are identical either way."""
    if stable:
        from alignnet3d_tpu.ops.stable_max import stable_max

        return stable_max
    return jnp.max


@dataclasses.dataclass(frozen=True)
class PointNetBackbone(Module):
    """Per-point shared-MLP stack + symmetric max over points.

    Equivalent of reference ``_get_pointnet`` (tp8.py:49-59): each listed
    layer is dense -> BN -> ReLU applied pointwise; the output is the
    channel-wise max over all N points, shape (B, layer_sizes[-1]).
    """

    layer_sizes: Sequence[int]
    dtype: Any = jnp.float32
    # remat-stable max-grad routing (ops/stable_max.py — XLA's reduce_max
    # VJP can drop cotangents under jit). Train-graph only; forward values
    # are identical.
    stable_max_grad: bool = False

    def __call__(self, scope: Scope, points: jax.Array, train: bool,
                 momentum) -> jax.Array:
        pool = _pool(self.stable_max_grad and train)
        x = points.astype(self.dtype)
        for i, width in enumerate(self.layer_sizes):
            x = dense(scope.child(f"conv{i + 1}"), x, width, self.dtype)
            x = batch_norm(scope.child(f"bn{i + 1}"), x, train, momentum,
                           self.dtype)
            x = jax.nn.relu(x)
        return pool(x, 1)


@dataclasses.dataclass(frozen=True)
class DGCNNBackbone(Module):
    """Dynamic-graph edge-conv stack (reference ``_get_dgcnn``, tp8.py:30-46).

    knn on the raw xyz pairwise distances (k=20, tf_util_dgcnn.py:660-671),
    edge features ``[x_i, x_j - x_i]`` (tf_util_dgcnn.py:674-706), conv
    stack on edges, max over neighbors, final 1x1 conv, max over points.

    The (B, N, N) pairwise-distance matrix is one batched matmul; top-k runs
    on device via ``jax.lax.top_k``.
    """

    layer_sizes: Sequence[int]
    k: int = 20
    dtype: Any = jnp.float32
    # approximate top-k for the graph (lax.approx_max_k, ops/knn.py)
    approx_knn: bool = False
    # remat-stable max-grad routing (ops/stable_max.py), train-graph only
    stable_max_grad: bool = False

    def __call__(self, scope: Scope, points: jax.Array, train: bool,
                 momentum) -> jax.Array:
        assert len(self.layer_sizes) >= 2, "dgcnn needs >= 2 layers"
        pool = _pool(self.stable_max_grad and train)
        from alignnet3d_tpu.ops.knn import (
            gather_rows,
            knn,
            pairwise_distance,
        )

        x = points.astype(self.dtype)
        k = min(self.k, x.shape[1])
        # The graph is built in f32 (at HIGHEST, ops/knn.py) whatever the
        # compute dtype, so the neighbour set does not depend on it.
        # The graph is non-differentiable, as in the reference.
        xg = jax.lax.stop_gradient(x.astype(jnp.float32))
        nn_idx = knn(pairwise_distance(xg), k, approximate=self.approx_knn)

        # First edge conv via the linear split (docs/DESIGN.md §4b-ii):
        # conv1 is linear in the edge feature [x_i, x_j - x_i], so
        #   conv1(edge_ij) = P x_i + Q (x_j - x_i) + b = U_i + V_j - b
        # with U = conv1([x, -x]) and V = conv1([0, x]). U and V are two
        # tiny (B, N, C)-matmuls; the (B, N, k, 2C) edge tensor and the
        # k-expanded conv1 matmul (contraction dim 2C=6) never
        # materialize — only V's rows are gathered. Same math and the
        # same param tree (conv1 keeps its (2C, C1) kernel), so
        # checkpoints, BN batch stats, and autodiff are unchanged
        # (tests/test_model.py::test_dgcnn_edge_linear_split_parity).
        conv1 = scope.child("conv1")
        u = dense(conv1, jnp.concatenate([x, -x], axis=-1),
                  self.layer_sizes[0], self.dtype)
        v = dense(conv1, jnp.concatenate([jnp.zeros_like(x), x], axis=-1),
                  self.layer_sizes[0], self.dtype)
        bias1 = conv1.params["bias"].astype(self.dtype)
        h = u[:, :, None, :] + gather_rows(v, nn_idx) - bias1
        h = batch_norm(scope.child("bn1"), h, train, momentum, self.dtype)
        h = jax.nn.relu(h)
        for i, width in enumerate(self.layer_sizes[1:-1], start=1):
            h = dense(scope.child(f"conv{i + 1}"), h, width, self.dtype)
            h = batch_norm(scope.child(f"bn{i + 1}"), h, train, momentum,
                           self.dtype)
            h = jax.nn.relu(h)
        h = pool(h, 2)  # max over neighbors -> (B, N, F)
        i = len(self.layer_sizes)
        h = dense(scope.child(f"conv{i}"), h, self.layer_sizes[-1],
                  self.dtype)
        h = batch_norm(scope.child(f"bn{i}"), h, train, momentum, self.dtype)
        h = jax.nn.relu(h)
        return pool(h, 1)


@dataclasses.dataclass(frozen=True)
class MLPHead(Module):
    """FC stack with BN+ReLU on all but the last layer, dropout before the
    final linear layer (reference ``get_mlp``, tp8.py:75-82).

    ``dropout_keep`` is the KEEP probability, as in the reference configs
    (e.g. 0.7 in s1transformer options).
    """

    layer_sizes: Sequence[int]
    dropout_keep: float | None = None
    dtype: Any = jnp.float32

    def __call__(self, scope: Scope, x: jax.Array, train: bool,
                 momentum) -> jax.Array:
        x = x.astype(self.dtype)
        for i, width in enumerate(self.layer_sizes[:-1]):
            x = dense(scope.child(f"fc{i + 1}"), x, width, self.dtype)
            x = batch_norm(scope.child(f"bn{i + 1}"), x, train, momentum,
                           self.dtype)
            x = jax.nn.relu(x)
        if self.dropout_keep is not None:
            x = dropout(scope, x, 1.0 - self.dropout_keep,
                        deterministic=not train)
        n = len(self.layer_sizes)
        return dense(scope.child(f"fc{n}"), x, self.layer_sizes[-1],
                     self.dtype)


# variable-tree name of each backbone's subtree
BACKBONE_NAMES = {"pointnet": "PointNetBackbone_0",
                  "dgcnn": "DGCNNBackbone_0"}


def make_backbone(backbone: str, layer_sizes: Sequence[int], dtype,
                  approx_knn: bool = False,
                  stable_max_grad: bool = False) -> Module:
    if backbone == "pointnet":
        return PointNetBackbone(layer_sizes=tuple(layer_sizes), dtype=dtype,
                                stable_max_grad=stable_max_grad)
    if backbone == "dgcnn":
        return DGCNNBackbone(layer_sizes=tuple(layer_sizes), dtype=dtype,
                             approx_knn=approx_knn,
                             stable_max_grad=stable_max_grad)
    raise ValueError(f"unknown backbone {backbone!r}")
