"""Int8 dynamic-quantized serving path (ops/quant.py): numerical error
bounds vs the f32 fold, and the build_inference_fn plumbing."""

import jax.numpy as jnp
import numpy as np
import pytest

from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu.ops.quant import (
    _dense_int8,
    fused_pointnet_int8,
    quantize_weights_int8,
)
from alignnet3d_tpu.serving import build_inference_fn, fused_pointnet_xla

B, N = 4, 64


def test_weight_roundtrip_error():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(128, 256)).astype(np.float32)
    (wq, scale), = quantize_weights_int8([w])
    back = np.asarray(wq, np.float32) * np.asarray(scale)
    # 8-bit symmetric with per-column max scaling of a gaussian column:
    # step = max/127 ~ 3.5 sigma/127, rms error = step/sqrt(12) -> ~0.8%
    rel = np.linalg.norm(back - w) / np.linalg.norm(w)
    assert rel < 0.01


def test_dense_int8_matches_f32():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(32, 128)), jnp.float32)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    q = quantize_weights_int8([w])[0]
    got = np.asarray(_dense_int8(x, *q))
    ref = np.asarray(x) @ w
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 0.02


def test_fused_pointnet_int8_close_to_f32():
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)
    ws = [rng.normal(size=s).astype(np.float32) * 0.2
          for s in ((3, 64), (64, 128), (128, 256))]
    bs = [rng.normal(size=s[1]).astype(np.float32) * 0.1 for s in
          ((3, 64), (64, 128), (128, 256))]
    ref = np.asarray(fused_pointnet_xla(pts, ws, bs,
                                        compute_dtype=jnp.float32))
    got = np.asarray(fused_pointnet_int8(pts, quantize_weights_int8(ws), bs))
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 0.05  # 3 chained int8 layers + max-pool


SPEC = ModelSpec(
    num_points=N, num_bins=8,
    s1_backbone=(16, 32), s1_mlp=(32,),
    s2_backbone=(16, 32), s2_mlp=(32,),
    embedding=(16, 64), remaining_mlp=(32,),
)


@pytest.mark.parametrize("scope", ["embedding", "backbones"])
def test_quantized_inference_fn(scope):
    import jax

    model = AlignNet(SPEC)
    pcs = jnp.zeros((B, N, 3))
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        pcs, pcs, train=False,
    )
    rng = np.random.default_rng(5)
    pcs1 = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)
    pcs2 = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)

    f32 = build_inference_fn(SPEC, variables, compute_dtype=jnp.float32)
    q = build_inference_fn(SPEC, variables, compute_dtype=jnp.float32,
                           quantize=scope)
    out_f = f32(pcs1, pcs2)
    out_q = q(pcs1, pcs2)
    assert set(out_q) == set(out_f)
    for key in out_f:
        a, b = np.asarray(out_f[key]), np.asarray(out_q[key])
        assert np.all(np.isfinite(b))
        denom = max(np.linalg.norm(a), 1e-3)
        assert np.linalg.norm(b - a) / denom < 0.25, key

    with pytest.raises(AssertionError):
        build_inference_fn(SPEC, variables, quantize="bogus")
