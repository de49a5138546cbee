"""Serving path: BN-folded, fusion-friendly inference engine.

Training uses the model with live batch-norm statistics; at serving
time every BatchNorm is an affine map with frozen stats, so it folds into
the preceding dense layer:

    y = ((x W + b) - mu) * g / sqrt(v + eps) + beta
      = x (W * s) + (b - mu) * s + beta,   s = g / sqrt(v + eps)

(The reference cannot do this — its graph keeps the tf.cond BN at eval,
utils/tf_util.py:488-491.) The folded encoder is then three pure
relu-dense chains + max-pools per cloud (``fused_pointnet_xla``), plus the
small MLP heads and the batched de-rotation einsum. DGCNN folds the same
way into an exact-kNN graph and ``folded_edge_stage``.

``build_inference_fn(spec, variables)`` returns a jittable function with
the exact eval-mode semantics of ``AlignNet.apply(train=False)`` —
parity-tested in tests/test_serving.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from alignnet3d_tpu.models.alignnet import ModelSpec
from alignnet3d_tpu.models.backbones import BACKBONE_NAMES
from alignnet3d_tpu.ops.angle_codec import logits_to_angle
from alignnet3d_tpu.ops.knn import gather_rows, knn, pairwise_distance
from alignnet3d_tpu.ops.quant import fused_pointnet_int8, quantize_weights_int8
from alignnet3d_tpu.ops.transforms import rotate_points_z

BN_EPS = 1e-3


def fused_pointnet_xla(points, weights, biases, compute_dtype=jnp.bfloat16):
    """Folded PointNet backbone: relu-dense chain + max over points.

    points: (B, N, C); weights[i]: (C_i, C_{i+1}); biases[i]: (C_{i+1},).
    Operands in ``compute_dtype``, float32 accumulation. Returns
    (B, F_last) float32.
    """
    h = points.astype(compute_dtype)
    for w, b in zip(weights, biases):
        h = jnp.dot(h, w.astype(compute_dtype),
                    preferred_element_type=jnp.float32)
        h = jnp.maximum(h + b.astype(jnp.float32), 0.0)
        h = h.astype(compute_dtype)
    return jnp.max(h.astype(jnp.float32), axis=1)


def folded_edge_stage(points, nn_idx, w1, b1, w2, b2,
                      compute_dtype=jnp.bfloat16):
    """Folded DGCNN edge stage: (B, N, C) x (B, N, k) -> (B, N, C2) f32.

    Equal to
        e = get_edge_feature(points, nn_idx)          # (B, N, k, 2C)
        h = relu(e @ w1 + b1); h = relu(h @ w2 + b2)
        return h.max(axis=2)
    with w1 of shape (2C, C1) and BN folded into (w, b). The first conv
    is split like the training graph (models/backbones.py): with
    w1 = [P; Q], ``e_ij @ w1 = x_i (P - Q) + x_j Q = U_i + V_j``, so only
    the rows of V are gathered and the (B, N, k, 2C) edge tensor never
    exists.
    """
    c = points.shape[-1]
    assert w1.shape[0] == 2 * c, (w1.shape, c)
    x = points.astype(compute_dtype)
    p_w, q_w = w1[:c], w1[c:]
    u = jnp.dot(x, (p_w - q_w).astype(compute_dtype),
                preferred_element_type=jnp.float32) + b1
    v = jnp.dot(x, q_w.astype(compute_dtype),
                preferred_element_type=jnp.float32)
    h = jnp.maximum(u[:, :, None, :] + gather_rows(v, nn_idx), 0.0)
    h = jnp.dot(h.astype(compute_dtype), w2.astype(compute_dtype),
                preferred_element_type=jnp.float32)
    h = jnp.maximum(h + b2, 0.0)
    return jnp.max(h, axis=2)


def _fold_dense_bn(dense, bn_params, bn_stats):
    """Fold (dense -> EmaBatchNorm) into a single (W, b)."""
    w = np.asarray(dense["kernel"], np.float32)
    b = np.asarray(dense["bias"], np.float32)
    scale = np.asarray(bn_params["scale"], np.float32)
    beta = np.asarray(bn_params["bias"], np.float32)
    mu = np.asarray(bn_stats["mean"], np.float32)
    var = np.asarray(bn_stats["var"], np.float32)
    s = scale / np.sqrt(var + BN_EPS)
    return w * s[None, :], (b - mu) * s + beta


def _fold_chain(params, stats, prefix: str, n_layers: int,
                conv: bool = True):
    """Fold an n-layer dense+BN chain named ``{conv|fc}{i}``/``bn{i}``."""
    base = "conv" if conv else "fc"
    weights, biases = [], []
    for i in range(1, n_layers + 1):
        w, b = _fold_dense_bn(
            params[f"{base}{i}"], params[f"bn{i}"], stats[f"bn{i}"]
        )
        weights.append(jnp.asarray(w))
        biases.append(jnp.asarray(b))
    return weights, biases


class _FoldedMLPHead:
    """MLP head: folded BN hidden layers + final linear (dropout is a no-op
    at inference)."""

    def __init__(self, params, stats, n_hidden: int):
        self.weights, self.biases = (
            _fold_chain(params, stats, "", n_hidden, conv=False)
            if n_hidden else ([], [])
        )
        final = params[f"fc{n_hidden + 1}"]
        self.w_final = jnp.asarray(np.asarray(final["kernel"], np.float32))
        self.b_final = jnp.asarray(np.asarray(final["bias"], np.float32))

    def __call__(self, x, compute_dtype):
        h = x.astype(compute_dtype)
        for w, b in zip(self.weights, self.biases):
            h = jnp.dot(h, w.astype(compute_dtype),
                        preferred_element_type=jnp.float32)
            h = jnp.maximum(h + b.astype(jnp.float32), 0.0)
            h = h.astype(compute_dtype)
        out = jnp.dot(h, self.w_final.astype(compute_dtype),
                      preferred_element_type=jnp.float32)
        return out + self.b_final


class _FoldedDGCNN:
    """Folded DGCNN backbone: exact-kNN graph + ``folded_edge_stage`` +
    final dense/max.

    The reference's 3-layer DGCNN shape (tp8.py:30-46: two edge convs,
    max over neighbors, one point conv, max over points) is the only one
    any config uses.
    """

    def __init__(self, params, stats, n_layers: int, k: int = 20):
        assert n_layers == 3, "folded dgcnn path expects 3 conv layers"
        w, b = _fold_chain(params, stats, "conv", n_layers)
        (self.w1, self.w2, self.w3), (self.b1, self.b2, self.b3) = w, b
        self.k = k

    def __call__(self, points, compute_dtype):
        # the graph is built in f32 like the training backbone's
        xg = points.astype(jnp.float32)
        nn_idx = knn(pairwise_distance(xg), min(self.k, points.shape[1]))
        h = folded_edge_stage(points, nn_idx, self.w1, self.b1,
                              self.w2, self.b2, compute_dtype)
        h = h.astype(compute_dtype)
        h = jnp.dot(h, self.w3.astype(compute_dtype),
                    preferred_element_type=jnp.float32)
        h = jnp.maximum(h + self.b3.astype(jnp.float32), 0.0)
        return jnp.max(h, axis=1)


class _FoldedTransformer:
    def __init__(self, params, stats, n_backbone: int, n_mlp: int,
                 int8: bool = False, backbone: str = "pointnet"):
        self.backbone = backbone
        name = BACKBONE_NAMES[backbone]
        if backbone == "dgcnn":
            assert not int8, "int8 serving is pointnet-only"
            self.dgcnn = _FoldedDGCNN(params[name], stats[name], n_backbone)
            self.bb_q = None
        else:
            bp = params[name]
            bs = stats[name]
            self.bb_w, self.bb_b = _fold_chain(bp, bs, "conv", n_backbone)
            self.bb_q = quantize_weights_int8(self.bb_w) if int8 else None
        self.head = _FoldedMLPHead(
            params["MLPHead_0"], stats["MLPHead_0"], n_mlp
        )

    def __call__(self, points, compute_dtype):
        if self.backbone == "dgcnn":
            feat = self.dgcnn(points, compute_dtype)
        elif self.bb_q is not None:
            feat = fused_pointnet_int8(points, self.bb_q, self.bb_b)
        else:
            feat = fused_pointnet_xla(points, self.bb_w, self.bb_b,
                                      compute_dtype=compute_dtype)
        return self.head(feat, compute_dtype)


def build_inference_fn(spec: ModelSpec, variables,
                       compute_dtype=jnp.bfloat16,
                       quantize: str | None = None):
    """Return ``fn(pcs1, pcs2) -> end_points`` with folded weights.

    pointnet folds into relu-dense chains (fused_pointnet_xla); dgcnn
    folds into exact-kNN + ``folded_edge_stage`` + a final dense/max.

    ``quantize`` (framework addition, default off = exact eval-mode
    semantics): 'embedding' runs the fat embedding chain in dynamic
    int8 (ops/quant.py); 'backbones' additionally quantizes the s1/s2
    transformer backbones (their MLP heads and the relative-pose head
    stay in ``compute_dtype``). Accuracy deltas per scope are an
    eval-time measurement (docs/RESULTS.md).
    """
    assert spec.backbone in ("pointnet", "dgcnn"), spec.backbone
    assert quantize in (None, "embedding", "backbones"), quantize
    dgcnn = spec.backbone == "dgcnn"
    assert not (dgcnn and quantize), "int8 serving is pointnet-only"
    params = variables["params"]
    stats = variables["batch_stats"]
    enc_p, enc_s = params["siamese"], stats["siamese"]

    int8_bb = quantize == "backbones"
    t1 = _FoldedTransformer(
        enc_p["transformer1"], enc_s["transformer1"],
        len(spec.s1_backbone), len(spec.s1_mlp), int8=int8_bb,
        backbone=spec.backbone,
    )
    t2 = _FoldedTransformer(
        enc_p["transformer2"], enc_s["transformer2"],
        len(spec.s2_backbone), len(spec.s2_mlp), int8=int8_bb,
        backbone=spec.backbone,
    )
    name = BACKBONE_NAMES[spec.backbone]
    if dgcnn:
        emb_dgcnn = _FoldedDGCNN(enc_p[name], enc_s[name],
                                 len(spec.embedding))
        emb_q = None
    else:
        emb_w, emb_b = _fold_chain(enc_p[name], enc_s[name], "conv",
                                   len(spec.embedding))
        emb_q = quantize_weights_int8(emb_w) if quantize is not None else None
    remaining = _FoldedMLPHead(
        params["remaining"], stats["remaining"], len(spec.remaining_mlp)
    )

    residual_scale = np.pi / spec.num_bins

    def encode(points):
        center_mean = jnp.mean(points, axis=1)
        s1_delta = t1(points - center_mean[:, None, :], compute_dtype)
        s1_center = s1_delta[:, :3] + center_mean
        s2_out = t2(points - s1_center[:, None, :], compute_dtype)
        s2_center = s2_out[:, :3] + s1_center
        s2_logits = s2_out[:, 3:]
        s2_angles = logits_to_angle(s2_logits, spec.num_bins, residual_scale)
        normalized = rotate_points_z(
            points - s2_center[:, None, :], -s2_angles
        )
        if dgcnn:
            emb = emb_dgcnn(normalized, compute_dtype)
        elif emb_q is not None:
            emb = fused_pointnet_int8(normalized, emb_q, emb_b)
        else:
            emb = fused_pointnet_xla(normalized, emb_w, emb_b,
                                     compute_dtype=compute_dtype)
        return emb, s1_center, s2_center, s2_logits

    def forward(pcs1, pcs2):
        b = pcs1.shape[0]
        stacked = jnp.concatenate([pcs1, pcs2], axis=0)
        emb, s1c, s2c, logits = encode(stacked)
        emb1, emb2 = emb[:b], emb[b:]
        out = remaining(jnp.concatenate([emb1, emb2], axis=-1),
                        compute_dtype)
        s2_center1, s2_center2 = s2c[:b], s2c[b:]
        return {
            "pred_s1_pc1centers": s1c[:b],
            "pred_s1_pc2centers": s1c[b:],
            "pred_s2_pc1centers": s2_center1,
            "pred_s2_pc2centers": s2_center2,
            "pred_pc1angle_logits": logits[:b],
            "pred_pc2angle_logits": logits[b:],
            "pred_translations": out[:, :3] + (s2_center2 - s2_center1),
            "pred_remaining_angle_logits": out[:, 3:],
        }

    return forward
