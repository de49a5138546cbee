"""The flagship AlignNet model: Siamese 3-stage canonicalizing encoder +
relative-pose head.

Reference architecture: models/tp8.py:101-158 ("tp8"). Weight sharing
between the two clouds is automatic here — a single ``EmbeddingNet``
submodule applied to both inputs (the reference uses
``tf.variable_scope('siamese', reuse=AUTO_REUSE)``, tp8.py:140-143).

Design choices:
- every per-point op is a batched dense matmul (see backbones.py);
- the per-sample stage-2 de-rotation is ONE batched einsum over (B,3,3)
  rotation matrices instead of the reference's ``tf.map_fn`` (tp8.py:125);
- both clouds run through the shared encoder in a single fused call by
  stacking them on the batch axis (2B effective batch), which doubles the
  rows of every matmul per step and keeps BN statistics identical to the
  reference's twin-tower graph (both towers share the same BN moving
  stats; with stacking, train-time batch stats are computed over both
  clouds at once — the one intentional difference, noted in
  ``stack_siamese``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.models.backbones import (
    BACKBONE_NAMES,
    MLPHead,
    make_backbone,
)
from alignnet3d_tpu.models.layers import Module, Scope
from alignnet3d_tpu.ops.angle_codec import logits_to_angle
from alignnet3d_tpu.ops.transforms import rotate_points_z


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model hyperparameters, extracted from the config tree
    (configs/default.json: model.*)."""

    backbone: str = "pointnet"
    num_points: int = 512
    num_bins: int = 50
    s1_backbone: Sequence[int] = (64, 128, 256)
    s1_mlp: Sequence[int] = (512, 256)
    s1_dropout_keep: float = 0.7
    s2_backbone: Sequence[int] = (64, 128, 512)
    s2_mlp: Sequence[int] = (512, 256)
    s2_dropout_keep: float = 0.7
    embedding: Sequence[int] = (64, 128, 1024)
    remaining_mlp: Sequence[int] = (512, 256)
    remaining_dropout_keep: float = 0.7
    compute_dtype: str = "float32"
    # approximate kNN for the dgcnn graph (lax.approx_max_k, ops/knn.py)
    # — off by default: exact reference semantics
    dgcnn_approx_knn: bool = False
    # Remat-stable max-pool gradient routing (ops/stable_max.py): works
    # around XLA's reduce_max VJP dropping cotangents under jit on the
    # CPU backend (tests/test_stable_max.py). Forward values identical;
    # the training gradient routes to the first argmax slot. Opt in via
    # model.options.stable_max_grad; chip_smoke.py measures whether the
    # GPU backend needs it.
    stable_max_grad: bool = False
    # Per-view canonical shape-completion decoder (framework addition,
    # 0 = off = reference semantics). When > 0, each view's embedding
    # additionally decodes ``completion_points`` canonical-frame points,
    # supervised by a flip-aware chamfer against the union of both views
    # in the GT canonical frame (losses.py). Rationale: docs/RESULTS.md
    # "per-view center identifiability" — the fine-bucket floor is each
    # view's shape understanding; the decoder forces the embedding to
    # carry full object extent and adds a gradient path that pulls the
    # predicted canonical frame (s2 center + yaw) onto the shape.
    completion_points: int = 0
    # True = run both clouds through the encoder as one stacked 2B batch
    # (shared BN batch stats); False = two calls like the reference graph.
    stack_siamese: bool = True

    @classmethod
    def from_config(cls, cfg: Any) -> "ModelSpec":
        opts = cfg.model.options
        return cls(
            backbone=cfg.model.backbone,
            num_points=cfg.model.num_points,
            num_bins=cfg.model.angles.num_bins,
            s1_backbone=tuple(opts.s1transformer[0]),
            s1_mlp=tuple(opts.s1transformer[1][0]),
            s1_dropout_keep=opts.s1transformer[1][1],
            s2_backbone=tuple(opts.s2transformer[0]),
            s2_mlp=tuple(opts.s2transformer[1][0]),
            s2_dropout_keep=opts.s2transformer[1][1],
            embedding=tuple(opts.embedding),
            remaining_mlp=tuple(opts.remaining_transform_prediction[0]),
            remaining_dropout_keep=opts.remaining_transform_prediction[1],
            compute_dtype=cfg.tpu.compute_dtype if cfg.has("tpu") else "float32",
            dgcnn_approx_knn=bool(
                opts.has("dgcnn_approx_knn") and opts.dgcnn_approx_knn
            ),
            stable_max_grad=bool(
                opts.has("stable_max_grad") and opts.stable_max_grad
            ),
            completion_points=(
                int(opts.completion_points)
                if opts.has("completion_points") else 0
            ),
        )

    @property
    def dtype(self):
        return jnp.dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class TransformerNet(Module):
    """Backbone -> flatten -> MLP head (reference get_transformer_net,
    tp8.py:89-98). Head width is 3 (+ 2*num_bins when predicting angles)."""

    spec: ModelSpec
    backbone_sizes: Sequence[int]
    mlp_sizes: Sequence[int]
    dropout_keep: float
    with_angles: bool

    def __call__(self, scope: Scope, points, train, momentum):
        spec = self.spec
        feat = make_backbone(
            spec.backbone, self.backbone_sizes, spec.dtype,
            approx_knn=spec.dgcnn_approx_knn,
            stable_max_grad=spec.stable_max_grad,
        )(scope.child(BACKBONE_NAMES[spec.backbone]), points, train,
          momentum)
        head_width = 3 + (2 * spec.num_bins if self.with_angles else 0)
        return MLPHead(
            layer_sizes=tuple(self.mlp_sizes) + (head_width,),
            dropout_keep=self.dropout_keep,
            dtype=spec.dtype,
        )(scope.child("MLPHead_0"), feat, train, momentum)


@dataclasses.dataclass(frozen=True)
class EmbeddingNet(Module):
    """3-stage canonicalizer + final embedding (reference get_embedding_net,
    tp8.py:101-132):

    stage 1: mean-center -> transformer1 -> absolute center estimate
    stage 2: center on s1 -> transformer2 -> refined center + yaw logits
    stage 3: center on s2, de-rotate by predicted yaw -> embedding backbone
    """

    spec: ModelSpec

    def __call__(self, scope: Scope, points, train, momentum):
        spec = self.spec
        center_mean = jnp.mean(points, axis=1)  # (B, 3)
        centered = points - center_mean[:, None, :]

        s1_delta = TransformerNet(
            spec, spec.s1_backbone, spec.s1_mlp, spec.s1_dropout_keep,
            with_angles=False,
        )(scope.child("transformer1"), centered, train, momentum)
        s1_center = s1_delta + center_mean

        centered_s1 = points - s1_center[:, None, :]
        s2_out = TransformerNet(
            spec, spec.s2_backbone, spec.s2_mlp, spec.s2_dropout_keep,
            with_angles=True,
        )(scope.child("transformer2"), centered_s1, train, momentum)
        s2_center = s2_out[:, :3] + s1_center
        s2_angle_logits = s2_out[:, 3:]

        centered_s2 = points - s2_center[:, None, :]
        s2_angles = logits_to_angle(
            s2_angle_logits.astype(jnp.float32),
            spec.num_bins,
            residual_scale=np.pi / spec.num_bins,
        )
        # reference: pcs @ Rz(-angle) per sample via map_fn (tp8.py:125-127);
        # here one batched einsum.
        normalized = rotate_points_z(centered_s2, -s2_angles)

        embedding = make_backbone(
            spec.backbone, spec.embedding, spec.dtype,
            approx_knn=spec.dgcnn_approx_knn,
            stable_max_grad=spec.stable_max_grad,
        )(scope.child(BACKBONE_NAMES[spec.backbone]), normalized, train,
          momentum)

        completion = None
        if spec.completion_points > 0:
            # canonical-frame shape completion decoded from the embedding
            # alone: the decoder cannot see the pose error, so matching the
            # GT canonical target pressures s2_center/s2_angles (through
            # ``normalized``) toward the shape-consistent frame.
            m = spec.completion_points
            comp = MLPHead(
                layer_sizes=(256, 3 * m),
                dropout_keep=None,
                dtype=spec.dtype,
            )(scope.child("completion"), embedding, train, momentum)
            completion = comp.reshape(comp.shape[0], m, 3)

        return (embedding, center_mean, s1_center, s2_center,
                s2_angle_logits, completion)


@dataclasses.dataclass(frozen=True)
class AlignNet(Module):
    """Siamese relative-pose network (reference get_model, tp8.py:135-158).

    Returns the reference's ``end_points`` dict:
      pred_s1_pc{1,2}centers, pred_s2_pc{1,2}centers,
      pred_pc{1,2}angle_logits, pred_translations,
      pred_remaining_angle_logits.
    """

    spec: ModelSpec

    def __call__(self, scope: Scope, pcs1, pcs2, train: bool, momentum=0.9):
        spec = self.spec
        encoder = EmbeddingNet(spec)
        enc_scope = scope.child("siamese")

        if spec.stack_siamese:
            b = pcs1.shape[0]
            stacked = jnp.concatenate([pcs1, pcs2], axis=0)
            emb, cm, s1c, s2c, s2logits, comp = encoder(
                enc_scope, stacked, train, momentum)
            emb1, emb2 = emb[:b], emb[b:]
            s1_center1, s1_center2 = s1c[:b], s1c[b:]
            s2_center1, s2_center2 = s2c[:b], s2c[b:]
            logits1, logits2 = s2logits[:b], s2logits[b:]
            comp1, comp2 = (comp[:b], comp[b:]) if comp is not None else (None, None)
        else:
            emb1, _, s1_center1, s2_center1, logits1, comp1 = encoder(
                enc_scope, pcs1, train, momentum)
            emb2, _, s1_center2, s2_center2, logits2, comp2 = encoder(
                enc_scope, pcs2, train, momentum)

        combined = jnp.concatenate([emb1, emb2], axis=-1)
        head = MLPHead(
            layer_sizes=tuple(spec.remaining_mlp) + (3 + 2 * spec.num_bins,),
            dropout_keep=spec.remaining_dropout_keep,
            dtype=spec.dtype,
        )(scope.child("remaining"), combined, train, momentum)
        out = head.astype(jnp.float32)
        end_points = {
            "pred_s1_pc1centers": s1_center1.astype(jnp.float32),
            "pred_s1_pc2centers": s1_center2.astype(jnp.float32),
            "pred_s2_pc1centers": s2_center1.astype(jnp.float32),
            "pred_s2_pc2centers": s2_center2.astype(jnp.float32),
            "pred_pc1angle_logits": logits1.astype(jnp.float32),
            "pred_pc2angle_logits": logits2.astype(jnp.float32),
            # translation = head delta + (s2_center2 - s2_center1), tp8.py:155
            "pred_translations": out[:, :3]
            + (s2_center2 - s2_center1).astype(jnp.float32),
            "pred_remaining_angle_logits": out[:, 3:],
        }
        if comp1 is not None:
            end_points["pred_pc1completions"] = comp1.astype(jnp.float32)
            end_points["pred_pc2completions"] = comp2.astype(jnp.float32)
        return end_points
