"""Model forward/loss tests: shapes, siamese weight sharing, BN semantics,
gradient flow (reference models/tp8.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu.models.batchnorm import EmaBatchNorm
from alignnet3d_tpu.models.losses import LossSpec, get_loss

B, N = 4, 64
SPEC = ModelSpec(
    num_points=N,
    num_bins=8,
    s1_backbone=(16, 32),
    s1_mlp=(32,),
    s2_backbone=(16, 32),
    s2_mlp=(32,),
    embedding=(16, 64),
    remaining_mlp=(32,),
)


def _init(spec=SPEC):
    model = AlignNet(spec)
    rng = jax.random.PRNGKey(0)
    pcs = jnp.zeros((B, N, 3))
    variables = model.init(
        {"params": rng, "dropout": jax.random.PRNGKey(1)}, pcs, pcs, train=False
    )
    return model, variables


def _batch(rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    return (
        jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32),
        jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32),
    )


def test_forward_shapes():
    model, variables = _init()
    pcs1, pcs2 = _batch()
    out = model.apply(variables, pcs1, pcs2, train=False)
    assert out["pred_translations"].shape == (B, 3)
    assert out["pred_s1_pc1centers"].shape == (B, 3)
    assert out["pred_s2_pc2centers"].shape == (B, 3)
    assert out["pred_pc1angle_logits"].shape == (B, 2 * SPEC.num_bins)
    assert out["pred_remaining_angle_logits"].shape == (B, 2 * SPEC.num_bins)
    for v in out.values():
        assert np.all(np.isfinite(np.asarray(v)))


def test_siamese_weight_sharing():
    """Swapping the two inputs swaps the per-cloud outputs exactly — only
    possible if both towers share weights (reference tp8.py:140-143)."""
    model, variables = _init()
    pcs1, pcs2 = _batch()
    out_a = model.apply(variables, pcs1, pcs2, train=False)
    out_b = model.apply(variables, pcs2, pcs1, train=False)
    np.testing.assert_allclose(
        np.asarray(out_a["pred_s2_pc1centers"]),
        np.asarray(out_b["pred_s2_pc2centers"]),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(out_a["pred_pc1angle_logits"]),
        np.asarray(out_b["pred_pc2angle_logits"]),
        rtol=1e-5, atol=1e-5,
    )


def test_translation_centered_on_s2_centers():
    """pred_translations = head + (s2_center2 - s2_center1) (tp8.py:155):
    translating pc2 by a constant shifts pred_translations by ~that amount
    via the center difference."""
    model, variables = _init()
    pcs1, pcs2 = _batch()
    out = model.apply(variables, pcs1, pcs2, train=False)
    shift = jnp.asarray([5.0, -3.0, 0.0])
    out_shifted = model.apply(variables, pcs1, pcs2 + shift, train=False)
    delta_centers = np.asarray(
        out_shifted["pred_s2_pc2centers"] - out["pred_s2_pc2centers"]
    )
    # stage centers are translation-equivariant up to BN nonlinearity on
    # mean-centered input; they should move close to the shift
    assert np.allclose(delta_centers, np.asarray(shift)[None, :], atol=1.0)


def test_train_mode_updates_batch_stats():
    model, variables = _init()
    pcs1, pcs2 = _batch()
    out, mutated = model.apply(
        variables, pcs1, pcs2, train=True, momentum=0.5,
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)},
    )
    old = jax.tree_util.tree_leaves(variables["batch_stats"])
    new = jax.tree_util.tree_leaves(mutated["batch_stats"])
    assert any(
        not np.allclose(np.asarray(a), np.asarray(b)) for a, b in zip(old, new)
    )


def test_batchnorm_train_uses_batch_stats_eval_uses_ema():
    bn = EmaBatchNorm()
    x = jnp.asarray(np.random.default_rng(0).normal(3.0, 2.0, (512, 8)), jnp.float32)
    variables = bn.init(jax.random.PRNGKey(0), x, train=False, momentum=0.9)
    y, mutated = bn.apply(
        variables, x, train=True, momentum=0.0, mutable=["batch_stats"]
    )
    # train output is normalized with batch stats: ~zero mean, unit var
    assert abs(float(jnp.mean(y))) < 1e-4
    assert abs(float(jnp.var(y)) - 1.0) < 2e-2
    # momentum=0 -> EMA jumps straight to the batch stats
    np.testing.assert_allclose(
        np.asarray(mutated["batch_stats"]["mean"]),
        np.asarray(jnp.mean(x, axis=0)), rtol=1e-5,
    )
    # eval with those stats now also normalizes
    y_eval = bn.apply(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]},
        x, train=False, momentum=0.9,
    )
    assert abs(float(jnp.mean(y_eval))) < 1e-3


def test_batchnorm_ema_momentum_schedule():
    bn = EmaBatchNorm()
    x = jnp.ones((16, 4)) * 10.0
    variables = bn.init(jax.random.PRNGKey(0), x, train=False, momentum=0.9)
    _, mutated = bn.apply(
        variables, x, train=True, momentum=0.5, mutable=["batch_stats"]
    )
    # ema = 0.5 * 0 + 0.5 * 10 = 5
    np.testing.assert_allclose(np.asarray(mutated["batch_stats"]["mean"]), 5.0)


LOSS_SPEC = LossSpec(num_bins=SPEC.num_bins, accept_inverted_angle=True)


def _labels(rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    return (
        jnp.asarray(rng.normal(size=(B, 3)), jnp.float32),  # translations
        jnp.asarray(rng.uniform(-np.pi, np.pi, (B, 1)), jnp.float32),  # rel_angles
        jnp.asarray(rng.normal(size=(B, 3)), jnp.float32),  # pc1_centers
        jnp.asarray(rng.normal(size=(B, 3)), jnp.float32),  # pc2_centers
        jnp.asarray(rng.uniform(-np.pi, np.pi, (B, 1)), jnp.float32),
        jnp.asarray(rng.uniform(-np.pi, np.pi, (B, 1)), jnp.float32),
    )


@pytest.mark.parametrize("loss_name", ["separate", "p2p"])
def test_loss_finite_and_differentiable(loss_name):
    model, variables = _init()
    pcs1, pcs2 = _batch()
    labels = _labels()
    spec = LossSpec(
        loss=loss_name, num_bins=SPEC.num_bins, accept_inverted_angle=True
    )

    def loss_fn(params):
        out = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            pcs1, pcs2, train=False,
        )
        loss, aux = get_loss(pcs1, pcs2, *labels, out, spec=spec)
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    assert np.isfinite(float(loss))
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(g))) for g in flat)
    assert any(float(jnp.max(jnp.abs(g))) > 0 for g in flat)


def test_zero_error_gives_small_separate_loss():
    """Feed end_points that exactly match the labels: every stage loss
    should be ~0 except angle class CE at its floor (perfect logits)."""
    labels = _labels()
    translations, rel_angles, pc1c, pc2c, pc1a, pc2a = labels
    nb = SPEC.num_bins
    from alignnet3d_tpu.ops.angle_codec import angle2class

    def perfect_logits(angles):
        cls, res = angle2class(angles.reshape(-1), nb)
        class_logits = jax.nn.one_hot(cls, nb) * 100.0
        residuals = jnp.zeros((B, nb)).at[jnp.arange(B), cls].set(
            res / (np.pi / nb)
        )
        return jnp.concatenate([class_logits, residuals], axis=1)

    end_points = {
        "pred_s1_pc1centers": pc1c,
        "pred_s1_pc2centers": pc2c,
        "pred_s2_pc1centers": pc1c,
        "pred_s2_pc2centers": pc2c,
        "pred_pc1angle_logits": perfect_logits(pc1a),
        "pred_pc2angle_logits": perfect_logits(pc2a),
        "pred_translations": translations,
        "pred_remaining_angle_logits": None,
    }
    # remaining target = (pc2a - pc1a) - (pred2 - pred1); with near-perfect
    # bin+residual decoding, pred diff ~ true diff so target ~ 0
    end_points["pred_remaining_angle_logits"] = perfect_logits(
        jnp.zeros((B, 1))
    )
    spec = LossSpec(num_bins=nb, accept_inverted_angle=False)
    pcs1, pcs2 = _batch()
    loss, aux = get_loss(
        pcs1, pcs2, translations, rel_angles, pc1c, pc2c, pc1a, pc2a,
        end_points, spec=spec,
    )
    assert float(aux["losses_stages/stage1_transl_loss"]) < 1e-6
    assert float(aux["losses_stages/stage3_transl_loss"]) < 1e-6
    assert float(aux["losses_stages/stage2_pc1_angle_residual_loss"]) < 1e-3
    assert float(aux["losses_stages/stage3_angle_residual_loss"]) < 1e-3


def test_composite_translation_loss_matches_metric_rebase():
    """With composite_translation on, stage-3 is zero exactly when the
    metric's re-based translation (geometry.translate_transform_to_new_
    center_of_rotation, used by evaluation.evaluate) equals the GT — even
    when the predicted center is off. The plain loss penalizes the same
    prediction."""
    from alignnet3d_tpu.geometry import (
        rotation_matrix_z,
        translate_transform_to_new_center_of_rotation,
    )

    labels = _labels()
    translations, rel_angles, pc1c, pc2c, pc1a, pc2a = labels
    rng = np.random.default_rng(5)
    # imperfect centers, like a real stage-2 prediction
    pred_centers = pc1c + jnp.asarray(
        rng.normal(scale=0.2, size=(B, 3)), jnp.float32
    )
    # the t that makes the COMPOSITE transform exact about pred_centers:
    # t = gt_t + s - Rz(a) s,  s = c_gt - c_pred
    s = np.asarray(pc1c - pred_centers, np.float64)
    rot = rotation_matrix_z(np.asarray(rel_angles).reshape(-1))
    t_consistent = (
        np.asarray(translations, np.float64)
        + s - np.einsum("bij,bj->bi", rot, s)
    )
    # sanity: metric rebase of (t_consistent, a, pred_centers) == gt_t
    rebased = translate_transform_to_new_center_of_rotation(
        t_consistent, np.asarray(rel_angles).reshape(-1),
        np.asarray(pred_centers), np.asarray(pc1c),
    )
    np.testing.assert_allclose(rebased, np.asarray(translations), atol=1e-5)

    nb = SPEC.num_bins
    dummy_logits = jnp.zeros((B, 2 * nb))
    end_points = {
        "pred_s1_pc1centers": pc1c,
        "pred_s1_pc2centers": pc2c,
        "pred_s2_pc1centers": pred_centers,
        "pred_s2_pc2centers": pc2c,
        "pred_pc1angle_logits": dummy_logits,
        "pred_pc2angle_logits": dummy_logits,
        "pred_remaining_angle_logits": dummy_logits,
        "pred_translations": jnp.asarray(t_consistent, jnp.float32),
    }
    pcs1, pcs2 = _batch()
    args = (pcs1, pcs2, translations, rel_angles, pc1c, pc2c, pc1a, pc2a,
            end_points)
    _, aux_comp = get_loss(
        *args, spec=LossSpec(num_bins=nb, composite_translation=True)
    )
    _, aux_plain = get_loss(*args, spec=LossSpec(num_bins=nb))
    assert float(aux_comp["losses_stages/stage3_transl_loss"]) < 1e-6
    assert float(aux_plain["losses_stages/stage3_transl_loss"]) > 1e-3


def test_flip_aware_composite_rebases_at_the_predicted_flip():
    """A network committing to theta+pi (the accept_inverted_angle regime)
    with a translation that is metric-exact AT theta+pi: flip_aware_composite
    scores it ~0; the plain composite loss (rebase at GT theta) penalizes
    it by ~|2 s_xy| — the exact eval-time error mode docs/RESULTS.md
    attributes to the 2cm-bucket floor."""
    from alignnet3d_tpu.geometry import (
        rotation_matrix_z,
        translate_transform_to_new_center_of_rotation,
    )
    from alignnet3d_tpu.ops.angle_codec import angle2class

    translations, rel_angles, pc1c, pc2c, pc1a, pc2a = _labels()
    nb = SPEC.num_bins
    rng = np.random.default_rng(11)
    pred_centers = pc1c + jnp.asarray(
        rng.normal(scale=0.2, size=(B, 3)), jnp.float32
    )

    def perfect_logits(angles):
        cls, res = angle2class(jnp.asarray(angles).reshape(-1), nb)
        class_logits = jax.nn.one_hot(cls, nb) * 100.0
        residuals = jnp.zeros((B, nb)).at[jnp.arange(B), cls].set(
            res / (np.pi / nb)
        )
        return jnp.concatenate([class_logits, residuals], axis=1)

    # decoded total angle = (pc2 - pc1) + remaining = rel + pi  (flipped)
    pc1_logits = perfect_logits(pc1a)
    pc2_logits = perfect_logits(pc2a)
    from alignnet3d_tpu.ops.angle_codec import logits_to_angle

    scale = np.pi / nb
    pc1_dec = logits_to_angle(pc1_logits, nb, scale)
    pc2_dec = logits_to_angle(pc2_logits, nb, scale)
    remaining = rel_angles.reshape(-1) + np.pi - (pc2_dec - pc1_dec)
    remaining_logits = perfect_logits(remaining)

    # t that is metric-exact when rebased at the FLIPPED angle
    flipped = np.asarray(rel_angles, np.float64).reshape(-1) + np.pi
    s = np.asarray(pc1c - pred_centers, np.float64)
    rot = rotation_matrix_z(flipped)
    t_consistent = (
        np.asarray(translations, np.float64)
        + s - np.einsum("bij,bj->bi", rot, s)
    )
    rebased = translate_transform_to_new_center_of_rotation(
        t_consistent, flipped, np.asarray(pred_centers), np.asarray(pc1c)
    )
    np.testing.assert_allclose(rebased, np.asarray(translations), atol=1e-5)

    end_points = {
        "pred_s1_pc1centers": pc1c,
        "pred_s1_pc2centers": pc2c,
        "pred_s2_pc1centers": pred_centers,
        "pred_s2_pc2centers": pc2c,
        "pred_pc1angle_logits": pc1_logits,
        "pred_pc2angle_logits": pc2_logits,
        "pred_remaining_angle_logits": remaining_logits,
        "pred_translations": jnp.asarray(t_consistent, jnp.float32),
    }
    pcs1, pcs2 = _batch()
    args = (pcs1, pcs2, translations, rel_angles, pc1c, pc2c, pc1a, pc2a,
            end_points)
    base = dict(num_bins=nb, accept_inverted_angle=True,
                composite_translation=True)
    _, aux_flip = get_loss(
        *args, spec=LossSpec(flip_aware_composite=True, **base)
    )
    _, aux_plain = get_loss(*args, spec=LossSpec(**base))
    assert float(aux_flip["losses_stages/stage3_transl_loss"]) < 1e-5
    assert float(aux_plain["losses_stages/stage3_transl_loss"]) > 1e-2


def test_flip_aware_composite_noop_when_unflipped():
    """When the decoded total angle matches the GT, flip_aware_composite
    must reduce exactly to composite_translation."""
    translations, rel_angles, pc1c, pc2c, pc1a, pc2a = _labels()
    nb = SPEC.num_bins
    rng = np.random.default_rng(13)
    from alignnet3d_tpu.ops.angle_codec import angle2class

    def perfect_logits(angles):
        cls, res = angle2class(jnp.asarray(angles).reshape(-1), nb)
        class_logits = jax.nn.one_hot(cls, nb) * 100.0
        residuals = jnp.zeros((B, nb)).at[jnp.arange(B), cls].set(
            res / (np.pi / nb)
        )
        return jnp.concatenate([class_logits, residuals], axis=1)

    from alignnet3d_tpu.ops.angle_codec import logits_to_angle

    pc1_logits = perfect_logits(pc1a)
    pc2_logits = perfect_logits(pc2a)
    scale = np.pi / nb
    dec_diff = (
        logits_to_angle(pc2_logits, nb, scale)
        - logits_to_angle(pc1_logits, nb, scale)
    )
    remaining_logits = perfect_logits(rel_angles.reshape(-1) - dec_diff)
    end_points = {
        "pred_s1_pc1centers": pc1c,
        "pred_s1_pc2centers": pc2c,
        "pred_s2_pc1centers": pc1c + jnp.asarray(
            rng.normal(scale=0.2, size=(B, 3)), jnp.float32
        ),
        "pred_s2_pc2centers": pc2c,
        "pred_pc1angle_logits": pc1_logits,
        "pred_pc2angle_logits": pc2_logits,
        "pred_remaining_angle_logits": remaining_logits,
        "pred_translations": jnp.asarray(
            rng.normal(size=(B, 3)), jnp.float32
        ),
    }
    pcs1, pcs2 = _batch()
    args = (pcs1, pcs2, translations, rel_angles, pc1c, pc2c, pc1a, pc2a,
            end_points)
    base = dict(num_bins=nb, accept_inverted_angle=True,
                composite_translation=True)
    _, aux_flip = get_loss(
        *args, spec=LossSpec(flip_aware_composite=True, **base)
    )
    _, aux_plain = get_loss(*args, spec=LossSpec(**base))
    np.testing.assert_allclose(
        float(aux_flip["losses_stages/stage3_transl_loss"]),
        float(aux_plain["losses_stages/stage3_transl_loss"]),
        rtol=1e-6,
    )


def test_inverted_angle_modes_differ():
    """mode 'reference_max' keeps the larger of (theta, theta+pi) losses —
    the reference tf.cond quirk (tp8.py:288); 'min' keeps the smaller."""
    rng = np.random.default_rng(7)
    logits = jnp.asarray(rng.normal(size=(B, 2 * SPEC.num_bins)), jnp.float32)
    angles = jnp.asarray(rng.uniform(-np.pi, np.pi, (B,)), jnp.float32)
    from alignnet3d_tpu.models.losses import _angle_loss, _angle_losses

    base = LossSpec(num_bins=SPEC.num_bins, accept_inverted_angle=True)
    ref = _angle_losses(logits, angles, base)
    fixed = _angle_losses(
        logits, angles,
        LossSpec(num_bins=SPEC.num_bins, accept_inverted_angle=True,
                 inverted_angle_mode="min"),
    )
    l0 = _angle_loss(logits, angles, base)[0]
    l180 = _angle_loss(logits, angles + np.pi, base)[0]
    assert float(ref[0]) == pytest.approx(float(jnp.maximum(l0, l180)), abs=1e-6)
    assert float(fixed[0]) == pytest.approx(float(jnp.minimum(l0, l180)), abs=1e-6)


def test_flip_aware_requires_composite():
    # flip_aware_composite without composite_translation would silently
    # train the plain loss; the spec rejects the misconfiguration
    import pytest

    with pytest.raises(ValueError, match="composite_translation"):
        LossSpec(flip_aware_composite=True, composite_translation=False)


def test_dgcnn_approx_knn_forward():
    """model.options.dgcnn_approx_knn routes the graph build through
    lax.approx_max_k (ops/knn.py) and the forward still runs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from alignnet3d_tpu.config import config_from_dict
    from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec

    cfg = config_from_dict({
        "model": {
            "model": "tp8", "backbone": "dgcnn", "num_points": 64,
            "options": {
                "angle_factor": 1.0, "early_stage_factor": 0.5,
                "s1transformer": [[16, 32], [[32], 0.7]],
                "s2transformer": [[16, 32], [[32], 0.7]],
                "embedding": [16, 64],
                "remaining_transform_prediction": [[32], 0.7],
                "dgcnn_approx_knn": True,
            },
            "angles": {"num_bins": 8, "accept_inverted_angle": True},
        },
    })
    spec = ModelSpec.from_config(cfg)
    assert spec.dgcnn_approx_knn
    m = AlignNet(spec)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 64, 3)),
                    jnp.float32)
    v = m.init({"params": jax.random.PRNGKey(0),
                "dropout": jax.random.PRNGKey(1)}, x, x, train=False)
    out = m.apply(v, x, x, train=False)
    assert np.all(np.isfinite(out["pred_translations"]))


def test_dgcnn_edge_linear_split_parity():
    """The first edge conv's linear split (backbones.py: conv1(edge) =
    U_i + V_j - b) matches the naive edge-tensor path exactly — values,
    train-mode BN batch stats, AND parameter gradients — on the same
    params. The naive reference below materializes the (B, N, k, 2C)
    edge tensor like reference tf_util_dgcnn.py:674-706."""
    from alignnet3d_tpu.models.backbones import DGCNNBackbone
    from alignnet3d_tpu.ops.knn import get_edge_feature, knn, pairwise_distance

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 40, 3)), jnp.float32)
    layers = (16, 24, 32)
    k = 5
    backbone = DGCNNBackbone(layer_sizes=layers, k=k)
    variables = backbone.init(
        {"params": jax.random.PRNGKey(0)}, x, train=True, momentum=0.9)
    params = variables["params"]

    def naive(params_dict, pts):
        """Edge-tensor forward with the same params (f32, train-mode BN)."""
        nn_idx = knn(pairwise_distance(pts), k)
        h = get_edge_feature(pts, nn_idx)
        for i, width in enumerate(layers[:-1]):
            p = params_dict[f"conv{i + 1}"]
            h = h @ p["kernel"] + p["bias"]
            bn = params_dict[f"bn{i + 1}"]
            mean = jnp.mean(h, axis=(0, 1, 2))
            var = jnp.mean(jnp.square(h), axis=(0, 1, 2)) - jnp.square(mean)
            h = (h - mean) * jax.lax.rsqrt(var + 1e-3)
            h = jax.nn.relu(h * bn["scale"] + bn["bias"])
        h = jnp.max(h, axis=2)
        p = params_dict[f"conv{len(layers)}"]
        h = h @ p["kernel"] + p["bias"]
        bn = params_dict[f"bn{len(layers)}"]
        mean = jnp.mean(h, axis=(0, 1))
        var = jnp.mean(jnp.square(h), axis=(0, 1)) - jnp.square(mean)
        h = (h - mean) * jax.lax.rsqrt(var + 1e-3)
        h = jax.nn.relu(h * bn["scale"] + bn["bias"])
        return jnp.max(h, axis=1)

    out_split, mutated = backbone.apply(
        variables, x, train=True, momentum=0.9, mutable=["batch_stats"])
    out_naive = naive(params, x)
    np.testing.assert_allclose(out_split, out_naive, rtol=2e-5, atol=2e-5)

    # train-mode BN batch stats feed the EMA identically: at momentum m,
    # ema' = m*ema + (1-m)*batch, ema0 = (0, 1)
    pre1 = (get_edge_feature(x, knn(pairwise_distance(x), k))
            @ params["conv1"]["kernel"] + params["conv1"]["bias"])
    want_mean = 0.9 * 0.0 + 0.1 * jnp.mean(pre1, axis=(0, 1, 2))
    got_mean = mutated["batch_stats"]["bn1"]["mean"]
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-5, atol=1e-6)

    # gradient parity on every param leaf
    def loss_split(p):
        out = backbone.apply(
            {**variables, "params": p}, x, train=True, momentum=0.9,
            mutable=["batch_stats"])[0]
        return jnp.sum(jnp.sin(out))

    g_split = jax.grad(loss_split)(params)
    g_naive = jax.grad(lambda p: jnp.sum(jnp.sin(naive(p, x))))(params)
    flat_s = jax.tree_util.tree_leaves_with_path(g_split)
    flat_n = dict(jax.tree_util.tree_leaves_with_path(g_naive))
    for path, leaf in flat_s:
        np.testing.assert_allclose(
            leaf, flat_n[path], rtol=5e-4, atol=5e-5,
            err_msg=str(path))
