"""Training losses: multi-stage 'separate' loss and dense 'p2p' loss.

Reference semantics: models/tp8.py:304-407. Pure functions of
(end_points, labels); all math in float32; fully batched.

Shape-hygiene note (intentional fix, documented): the reference's angle
residual loss broadcasts a (B,) prediction against a (B,1) label, producing
a (B,B) cross-sample matrix whose mean it minimizes (tp8.py:278-279); its
stage-3 target similarly mixes a (B,1) GT with a (B,) prediction
(tp8.py:327). This build aligns every term to shape (B,) — the intended
per-sample pairing. The quirk it DOES preserve (flag-controlled) is the
inverted-angle selection: the reference's ``tf.cond(loss > loss_180, ...)``
keeps the LARGER loss (tp8.py:288); mode 'reference_max' reproduces that,
mode 'min' picks the smaller.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.ops.angle_codec import (
    angle2class,
    logits_to_angle,
    soft_angle_targets,
)
from alignnet3d_tpu.ops.transforms import rotate_points_z, transform_pcs


@dataclasses.dataclass(frozen=True)
class LossSpec:
    loss: str = "separate"  # 'separate' | 'p2p'
    num_bins: int = 50
    angle_factor: float = 1.0
    early_stage_factor: float = 0.5
    accept_inverted_angle: bool = False
    soft_angle_classes: bool = False
    soft_angle_sigma_deg: float = 5.0
    inverted_angle_mode: str = "reference_max"  # 'reference_max' | 'min'
    composite_translation: bool = False
    flip_aware_composite: bool = False
    # weight of the per-view canonical-completion chamfer term (framework
    # addition; requires model.options.completion_points > 0). 0 = off.
    completion_weight: float = 0.0
    # weight of the cross-view center-consistency term (framework addition;
    # see docs/RESULTS.md "per-view center identifiability"). 0 = off.
    center_consistency_weight: float = 0.0
    center_consistency_frame: str = "canonical"  # 'canonical' | 'world'

    @classmethod
    def from_config(cls, cfg: Any) -> "LossSpec":
        opts = cfg.training.loss.options
        return cls(
            loss=cfg.training.loss.loss,
            num_bins=cfg.model.angles.num_bins,
            angle_factor=cfg.model.options.angle_factor,
            early_stage_factor=cfg.model.options.early_stage_factor,
            accept_inverted_angle=cfg.model.angles.accept_inverted_angle,
            soft_angle_classes=opts.soft_angle_classes,
            soft_angle_sigma_deg=opts.soft_angle_classes_sigma_in_degree,
            inverted_angle_mode=(
                opts.inverted_angle_mode
                if opts.has("inverted_angle_mode")
                else "reference_max"
            ),
            composite_translation=(
                opts.composite_translation
                if opts.has("composite_translation") else False
            ),
            flip_aware_composite=(
                opts.flip_aware_composite
                if opts.has("flip_aware_composite") else False
            ),
            completion_weight=(
                float(opts.completion_weight)
                if opts.has("completion_weight") else 0.0
            ),
            center_consistency_weight=(
                float(opts.center_consistency_weight)
                if opts.has("center_consistency_weight") else 0.0
            ),
            center_consistency_frame=(
                opts.center_consistency_frame
                if opts.has("center_consistency_frame") else "canonical"
            ),
        )

    def __post_init__(self):
        # flip_aware rebases the COMPOSITE stage-3 target; without
        # composite_translation it would be silently ignored and an
        # experiment would run without the feature it meant to test
        if self.flip_aware_composite and not self.composite_translation:
            raise ValueError(
                "flip_aware_composite requires composite_translation=true"
            )
        if self.center_consistency_frame not in ("canonical", "world"):
            raise ValueError(
                "center_consistency_frame must be 'canonical' or 'world', "
                f"got {self.center_consistency_frame!r}"
            )


def huber(error: jax.Array, delta: float) -> jax.Array:
    """Mean huber loss (reference huber_loss, tp8.py:173-178)."""
    abs_error = jnp.abs(error)
    quadratic = jnp.minimum(abs_error, delta)
    linear = abs_error - quadratic
    return jnp.mean(0.5 * jnp.square(quadratic) + delta * linear)


def _angle_loss(logits: jax.Array, target_angles: jax.Array, spec: LossSpec):
    """Bin CE + 20x huber on the normalized residual of the TARGET bin
    (reference _tf_get_angle_loss, tp8.py:266-281). target_angles: (B,)."""
    num_bins = spec.num_bins
    class_logits = logits[:, :num_bins]
    residuals_normalized = logits[:, num_bins:]

    target_classes, target_residuals = angle2class(target_angles, num_bins)

    if spec.soft_angle_classes:
        # Reference quirk note: tf8.py:253-263 evaluates the Normal CDFs on a
        # DEGREE grid but feeds RADIAN targets. We convert targets to degrees
        # (the intended semantics); flag is off in every experiment config.
        targets_deg = jnp.rad2deg(jnp.mod(target_angles, 2.0 * np.pi))
        dist = soft_angle_targets(targets_deg, num_bins, spec.soft_angle_sigma_deg)
        logp = jax.nn.log_softmax(class_logits, axis=-1)
        class_loss = jnp.mean(-jnp.sum(dist * logp, axis=-1))
    else:
        logp = jax.nn.log_softmax(class_logits, axis=-1)
        class_loss = jnp.mean(
            -jnp.take_along_axis(logp, target_classes[:, None], axis=-1)[:, 0]
        )

    onehot = jax.nn.one_hot(target_classes, num_bins, dtype=logits.dtype)
    residual_label = target_residuals / (np.pi / num_bins)
    pred_residual = jnp.sum(residuals_normalized * onehot, axis=1)
    residual_loss = huber(pred_residual - residual_label, delta=1.0)

    return jnp.stack(
        [class_loss + 20.0 * residual_loss, class_loss, residual_loss]
    )


def _angle_losses(logits, target_angles, spec: LossSpec):
    """Optionally evaluate the loss at theta and theta+pi and select one
    (reference tf_get_angle_losses, tp8.py:284-291)."""
    losses = _angle_loss(logits, target_angles, spec)
    if spec.accept_inverted_angle:
        losses_180 = _angle_loss(logits, target_angles + np.pi, spec)
        if spec.inverted_angle_mode == "reference_max":
            pick_first = losses[0] > losses_180[0]  # reference keeps the larger
        else:
            pick_first = losses[0] < losses_180[0]
        losses = jnp.where(pick_first, losses, losses_180)
    return losses  # (3,): total, class, residual


def _sq_chamfer(pred: jax.Array, target: jax.Array) -> jax.Array:
    """Symmetric squared chamfer per sample: (B, M, 3) vs (B, K, 3) -> (B,).

    Squared distances keep the gradient finite at zero; the (B, M, K)
    matrix is one batched matmul plus two row/col min-reductions.
    The min-reductions route gradients via ``stable_min``: this loss is
    only ever differentiated, and jax 0.9.0's reduce_min VJP has the
    same remat cotangent-drop hazard as reduce_max (ops/stable_max.py).
    """
    from alignnet3d_tpu.ops.stable_max import stable_min

    d2 = (
        jnp.sum(pred ** 2, axis=-1)[:, :, None]
        - 2.0 * jnp.einsum("bmd,bkd->bmk", pred, target)
        + jnp.sum(target ** 2, axis=-1)[:, None, :]
    )
    d2 = jnp.maximum(d2, 0.0)
    return jnp.mean(stable_min(d2, 2), axis=1) + jnp.mean(
        stable_min(d2, 1), axis=1
    )


def _completion_loss(pcs1, pcs2, pc1_centers, pc2_centers,
                     pc1_angles, pc2_angles, end_points) -> jax.Array:
    """Per-view canonical shape-completion chamfer (framework addition;
    no reference analogue — see docs/RESULTS.md "per-view center
    identifiability").

    Target: the union of BOTH views mapped to the GT canonical object
    frame (``Rz(-a_i)(p - c_i)`` — same convention as the model's stage-3
    normalization, alignnet.py). Both views decode against the same
    target, so the two embeddings must agree on one complete shape.
    Flip-aware: with ``accept_inverted_angle`` training the network may
    canonicalize at theta+pi; each view independently scores against the
    target and its 180-degree flip and keeps the min.
    """
    u1 = rotate_points_z(pcs1 - pc1_centers[:, None, :], -pc1_angles)
    u2 = rotate_points_z(pcs2 - pc2_centers[:, None, :], -pc2_angles)
    union = jnp.concatenate([u1, u2], axis=1)  # (B, 2N, 3)
    union_flip = union * jnp.asarray([-1.0, -1.0, 1.0], union.dtype)

    total = 0.0
    for key in ("pred_pc1completions", "pred_pc2completions"):
        comp = end_points[key]
        cd = jnp.minimum(_sq_chamfer(comp, union),
                         _sq_chamfer(comp, union_flip))
        total = total + 0.5 * jnp.mean(cd)
    return total


def loss_separate(
    pcs1, pcs2, translations, rel_angles, pc1_centers, pc2_centers,
    pc1_angles, pc2_angles, end_points, spec: LossSpec,
):
    """Multi-stage loss (reference _get_loss_separate, tp8.py:304-354).

    Returns (scalar loss, aux dict of per-stage scalars for logging).
    """
    batch_size = translations.shape[0]
    pc1_angles = pc1_angles.reshape(-1)
    pc2_angles = pc2_angles.reshape(-1)
    rel_angles = rel_angles.reshape(-1)

    s1_t = 0.5 * (
        huber(end_points["pred_s1_pc1centers"] - pc1_centers, 1.0)
        + huber(end_points["pred_s1_pc2centers"] - pc2_centers, 1.0)
    )
    pc1_s2_t = huber(end_points["pred_s2_pc1centers"] - pc1_centers, 1.0)
    pc2_s2_t = huber(end_points["pred_s2_pc2centers"] - pc2_centers, 1.0)
    s2_t = 0.5 * (pc1_s2_t + pc2_s2_t)

    a1 = _angle_losses(end_points["pred_pc1angle_logits"], pc1_angles, spec)
    a2 = _angle_losses(end_points["pred_pc2angle_logits"], pc2_angles, spec)
    s2_a = 0.5 * (a1[0] + a2[0])

    scale = np.pi / spec.num_bins
    pc1_pred = logits_to_angle(
        end_points["pred_pc1angle_logits"], spec.num_bins, residual_scale=scale
    )
    pc2_pred = logits_to_angle(
        end_points["pred_pc2angle_logits"], spec.num_bins, residual_scale=scale
    )

    if spec.composite_translation:
        # Framework addition (flag-controlled, off = reference semantics).
        # At eval the predicted translation is interpreted as acting about
        # the PREDICTED s2 center and re-based to the GT rotation center
        # (reference train.py:465-467, evaluation.py:129):
        #   t' = -s + Rz(a) s + t,  s = c_gt - c_pred.
        # The reference trains t against the GT translation directly, so
        # any center error leaks into t' as (Rz(a) - I) s. Train the
        # (t, center) PAIR on the re-based translation instead — the exact
        # quantity the metric scores. Rz uses the GT relative angle (the
        # angle branch is near-exact at convergence and this keeps the
        # term differentiable).
        rebase_angle = rel_angles
        if spec.flip_aware_composite:
            # accept_inverted_angle training leaves ~half the predictions at
            # theta+pi; the eval rebase then happens at the FLIPPED angle, so
            # a compensation trained at theta is wrong by (Rz(a+pi)-Rz(a)) s
            # = -2 Rz(a) s_xy — exactly the error floor docs/RESULTS.md
            # attributes to s2-center identifiability. Detect, per sample,
            # which hypothesis the network is actually committing to (its
            # decoded total angle vs the GT) and rebase the training target
            # at THAT angle. Non-differentiable indicator (argmax decode +
            # stop_gradient) — it only routes the loss.
            remaining_pred = logits_to_angle(
                end_points["pred_remaining_angle_logits"], spec.num_bins,
                residual_scale=scale,
            )
            pred_total = (pc2_pred - pc1_pred) + remaining_pred
            diff = jnp.mod(pred_total - rel_angles + np.pi, 2.0 * np.pi) - np.pi
            flip = jax.lax.stop_gradient(jnp.abs(diff) > (np.pi / 2.0))
            rebase_angle = rel_angles + np.pi * flip.astype(rel_angles.dtype)
        s = pc1_centers - end_points["pred_s2_pc1centers"]
        ca, sa = jnp.cos(rebase_angle), jnp.sin(rebase_angle)
        rot_s = jnp.stack(
            [ca * s[:, 0] - sa * s[:, 1],
             sa * s[:, 0] + ca * s[:, 1],
             s[:, 2]],
            axis=1,
        )
        rebased = end_points["pred_translations"] - s + rot_s
        s3_t = huber(rebased - translations, 2.0)
    else:
        s3_t = huber(end_points["pred_translations"] - translations, 2.0)

    remaining_target = (pc2_angles - pc1_angles) - (pc2_pred - pc1_pred)
    a3 = _angle_losses(
        end_points["pred_remaining_angle_logits"], remaining_target, spec
    )

    cons_loss = None
    if spec.center_consistency_weight > 0.0:
        # Cross-view center-consistency (framework addition; no reference
        # analogue — docs/RESULTS.md "per-view center identifiability").
        # The absolute s2 center loss above bounds each view's error; this
        # term penalizes only the DIFFERENTIAL component between the two
        # views' errors — the part the relative task cannot cancel and the
        # composite-trained t head cannot learn to compensate (the
        # common-mode component is shape-conditional and therefore
        # predictable; the differential is per-view noise). 'canonical'
        # compares the errors in the GT object frame (same Rz(-a_i)
        # convention as _completion_loss / the model's stage-3
        # normalization); 'world' compares them directly, which equals
        # supervising the predicted center DIFFERENCE against the GT
        # translation (t = c2 - c1 in this label convention).
        e1 = end_points["pred_s2_pc1centers"] - pc1_centers
        e2 = end_points["pred_s2_pc2centers"] - pc2_centers
        if spec.center_consistency_frame == "canonical":
            e1 = rotate_points_z(e1[:, None, :], -pc1_angles)[:, 0, :]
            e2 = rotate_points_z(e2[:, None, :], -pc2_angles)[:, 0, :]
        cons_loss = huber(e1 - e2, delta=1.0)

    esf = spec.early_stage_factor
    loss_translation = esf * (s1_t + s2_t) + s3_t
    if cons_loss is not None:
        loss_translation = (
            loss_translation + spec.center_consistency_weight * cons_loss
        )
    loss_angle = esf * s2_a + a3[0]
    loss = loss_translation + spec.angle_factor * loss_angle

    comp_loss = None
    if spec.completion_weight > 0.0:
        if "pred_pc1completions" not in end_points:
            raise ValueError(
                "completion_weight > 0 requires model.options."
                "completion_points > 0 (no completion head in end_points)"
            )
        comp_loss = _completion_loss(
            pcs1, pcs2, pc1_centers, pc2_centers,
            pc1_angles, pc2_angles, end_points,
        )
        loss = loss + spec.completion_weight * comp_loss
    # the reference divides the (already batch-mean) loss by batch size again
    # (tp8.py:334) — preserved, it only rescales the LR.
    per_transform_loss = loss / batch_size

    aux = {
        "losses/translation": loss_translation,
        "losses/angle": loss_angle,
        "losses_stages/stage1_transl_loss": s1_t,
        "losses_stages/stage2_pc1_transl_loss": pc1_s2_t,
        "losses_stages/stage2_pc2_transl_loss": pc2_s2_t,
        "losses_stages/stage3_transl_loss": s3_t,
        "losses_stages/stage2_pc1_angle_loss": a1[0],
        "losses_stages/stage2_pc1_angle_class_loss": a1[1],
        "losses_stages/stage2_pc1_angle_residual_loss": a1[2],
        "losses_stages/stage2_pc2_angle_loss": a2[0],
        "losses_stages/stage2_pc2_angle_class_loss": a2[1],
        "losses_stages/stage2_pc2_angle_residual_loss": a2[2],
        "losses_stages/stage3_angle_loss": a3[0],
        "losses_stages/stage3_angle_class_loss": a3[1],
        "losses_stages/stage3_angle_residual_loss": a3[2],
    }
    if comp_loss is not None:
        aux["losses_stages/completion_loss"] = comp_loss
    if cons_loss is not None:
        aux["losses_stages/center_consistency_loss"] = cons_loss
    return per_transform_loss, aux


def loss_p2p(
    pcs1, pcs2, translations, rel_angles, pc1_centers, pc2_centers,
    pc1_angles, pc2_angles, end_points, spec: LossSpec,
):
    """Dense point-to-point loss (reference _get_loss_p2p, tp8.py:374-398):
    transform pcs1 by the predicted vs GT motion and penalize mean squared
    point distance; with accept_inverted_angle the reference computes a
    '180' variant that is IDENTICAL to the first (tp8.py:389-394) so the min
    is a no-op — preserved by simply not recomputing it."""
    batch_size = translations.shape[0]
    scale = np.pi / spec.num_bins
    pred_angles = (
        logits_to_angle(end_points["pred_pc2angle_logits"], spec.num_bins, scale)
        - logits_to_angle(end_points["pred_pc1angle_logits"], spec.num_bins, scale)
        + logits_to_angle(
            end_points["pred_remaining_angle_logits"], spec.num_bins, scale
        )
    )
    pred = transform_pcs(
        pcs1,
        end_points["pred_translations"],
        pred_angles,
        end_points["pred_s2_pc1centers"],
    )
    gt = transform_pcs(pcs1, translations, rel_angles.reshape(-1), pc1_centers)
    # reference: tf.norm over axis=1 (the POINT axis) -> (B, 3) per-coordinate
    # norms, then mean of squares — preserved.
    point_distances = jnp.linalg.norm(pred - gt, axis=1)
    loss = jnp.mean(jnp.square(point_distances))
    per_transform_loss = loss / batch_size
    return per_transform_loss, {"losses/p2p": loss}


def get_loss(*args, spec: LossSpec):
    """Dispatch (reference get_loss, tp8.py:401-407)."""
    if spec.loss == "separate":
        return loss_separate(*args, spec=spec)
    if spec.loss == "p2p":
        return loss_p2p(*args, spec=spec)
    raise ValueError(f"unknown loss {spec.loss!r}")
