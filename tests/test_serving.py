"""Serving-path parity: BN-folded inference == the model's eval forward;
the folded DGCNN edge stage == the edge-tensor graph."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu.ops.knn import get_edge_feature, knn, pairwise_distance
from alignnet3d_tpu.serving import build_inference_fn, folded_edge_stage

SPEC = ModelSpec(
    num_points=128, num_bins=8,
    s1_backbone=(16, 32), s1_mlp=(32,),
    s2_backbone=(16, 32), s2_mlp=(32,),
    embedding=(16, 64), remaining_mlp=(32,),
)


def _trained_variables():
    """Variables with non-trivial BN stats (a few train steps)."""
    model = AlignNet(SPEC)
    x = jnp.zeros((4, SPEC.num_points, 3))
    v = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, x, train=False,
    )
    rng = np.random.default_rng(0)
    variables = v
    for i in range(3):
        a = jnp.asarray(rng.normal(size=(4, SPEC.num_points, 3)), jnp.float32)
        b = jnp.asarray(rng.normal(size=(4, SPEC.num_points, 3)), jnp.float32)
        _, mut = model.apply(
            variables, a, b, train=True, momentum=0.5,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(i)},
        )
        variables = {"params": variables["params"],
                     "batch_stats": mut["batch_stats"]}
    return model, variables


def test_folded_serving_matches_flax_eval():
    model, variables = _trained_variables()
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=(8, SPEC.num_points, 3)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(8, SPEC.num_points, 3)), jnp.float32)
    ref = model.apply(variables, a, b, train=False)
    # float32 serving path for a tight comparison
    serve = build_inference_fn(SPEC, variables, compute_dtype=jnp.float32)
    got = serve(a, b)
    for key in ref:
        np.testing.assert_allclose(
            np.asarray(ref[key]), np.asarray(got[key]),
            rtol=2e-4, atol=2e-4, err_msg=key,
        )


def test_folded_serving_bf16_close():
    model, variables = _trained_variables()
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.normal(size=(8, SPEC.num_points, 3)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(8, SPEC.num_points, 3)), jnp.float32)
    ref = model.apply(variables, a, b, train=False)
    serve = build_inference_fn(SPEC, variables, compute_dtype=jnp.bfloat16)
    got = serve(a, b)
    # bf16 through the stacked stages costs several cm on an untrained net
    # with unit-gaussian inputs — which is why f32 is the accuracy-parity
    # serving default and bf16 the throughput option.
    np.testing.assert_allclose(
        np.asarray(ref["pred_s2_pc1centers"]),
        np.asarray(got["pred_s2_pc1centers"]), atol=0.15,
    )


def _edge_reference(points, nn_idx, w1, b1, w2, b2):
    """The (B, N, k, 2C) edge tensor through two dense layers, max over k
    (reference tf_util_dgcnn.py:674-706 + tp8.py:30-46)."""
    e = get_edge_feature(points, nn_idx)
    hi = jax.lax.Precision.HIGHEST
    h = jnp.maximum(jnp.matmul(e, w1, precision=hi) + b1, 0.0)
    h = jnp.maximum(jnp.matmul(h, w2, precision=hi) + b2, 0.0)
    return jnp.max(h, axis=2)


@pytest.mark.parametrize("b,n,k,c2", [(2, 128, 8, 128), (1, 200, 20, 128),
                                      (3, 256, 5, 128), (2, 160, 10, 256)])
def test_folded_edge_stage_matches_edge_graph(b, n, k, c2):
    rng = np.random.default_rng(n)
    pts = jnp.asarray(rng.normal(size=(b, n, 3)), jnp.float32)
    idx = knn(pairwise_distance(pts), k)
    w1 = jnp.asarray(rng.normal(size=(6, 64)) / 2.0, jnp.float32)
    b1 = jnp.asarray(rng.normal(size=(64,)) * 0.1, jnp.float32)
    w2 = jnp.asarray(rng.normal(size=(64, c2)) / 8.0, jnp.float32)
    b2 = jnp.asarray(rng.normal(size=(c2,)) * 0.1, jnp.float32)
    want = np.asarray(_edge_reference(pts, idx, w1, b1, w2, b2))
    got = np.asarray(folded_edge_stage(pts, idx, w1, b1, w2, b2,
                                       compute_dtype=jnp.float32))
    assert got.shape == (b, n, c2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.slow
def test_folded_dgcnn_serving_matches_flax_eval():
    """Folded DGCNN path (folded_edge_stage) vs model.apply eval mode. 3-layer backbones per the reference shape
    (tp8.py:30-46)."""
    spec = ModelSpec(
        num_points=96, num_bins=8, backbone="dgcnn",
        s1_backbone=(16, 32, 32), s1_mlp=(32,),
        s2_backbone=(16, 32, 32), s2_mlp=(32,),
        embedding=(16, 32, 64), remaining_mlp=(32,),
    )
    model = AlignNet(spec)
    x = jnp.zeros((4, spec.num_points, 3))
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, x, train=False,
    )
    rng = np.random.default_rng(0)
    for i in range(2):
        a = jnp.asarray(rng.normal(size=(4, spec.num_points, 3)), jnp.float32)
        b = jnp.asarray(rng.normal(size=(4, spec.num_points, 3)), jnp.float32)
        _, mut = model.apply(
            variables, a, b, train=True, momentum=0.5,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(i)},
        )
        variables = {"params": variables["params"],
                     "batch_stats": mut["batch_stats"]}
    a = jnp.asarray(rng.normal(size=(6, spec.num_points, 3)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(6, spec.num_points, 3)), jnp.float32)
    ref = model.apply(variables, a, b, train=False)
    serve = build_inference_fn(spec, variables, compute_dtype=jnp.float32)
    got = serve(a, b)
    for key in ref:
        np.testing.assert_allclose(
            np.asarray(ref[key]), np.asarray(got[key]),
            rtol=5e-4, atol=5e-4, err_msg=key,
        )
