"""jax.export deployment artifacts: roundtrip parity + symbolic batch."""

import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.export import (
    OUTPUT_KEYS,
    export_alignment_model,
    export_forward,
    load_exported,
)
from alignnet3d_tpu.serving import build_inference_fn
from tests.test_serving import SPEC, _trained_variables


def test_export_roundtrip_matches_folded_serving(tmp_path):
    _, variables = _trained_variables()
    path = str(tmp_path / "model.shlo")
    blob = export_alignment_model(SPEC, variables, path,
                                  compute_dtype=jnp.float32)
    assert isinstance(blob, bytes) and len(blob) > 0
    assert open(path, "rb").read() == blob

    serve = build_inference_fn(SPEC, variables, compute_dtype=jnp.float32)
    infer = load_exported(path)
    rng = np.random.default_rng(2)
    # two different batch sizes through ONE artifact (symbolic b)
    for batch in (3, 7):
        a = rng.normal(size=(batch, SPEC.num_points, 3)).astype(np.float32)
        b = rng.normal(size=(batch, SPEC.num_points, 3)).astype(np.float32)
        ref = serve(jnp.asarray(a), jnp.asarray(b))
        got = infer(a, b)
        assert set(got) == set(OUTPUT_KEYS)
        for key in OUTPUT_KEYS:
            np.testing.assert_allclose(
                np.asarray(ref[key]), np.asarray(got[key]),
                rtol=1e-5, atol=1e-5, err_msg=key,
            )


def test_export_from_bytes_without_model_code():
    _, variables = _trained_variables()
    blob = export_alignment_model(SPEC, variables, compute_dtype=jnp.float32)
    infer = load_exported(bytearray(blob))  # bytes-like, no file
    a = np.zeros((2, SPEC.num_points, 3), np.float32)
    out = infer(a, a)
    assert out["pred_translations"].shape == (2, 3)
    assert out["pred_remaining_angle_logits"].shape == (2, 2 * SPEC.num_bins)


def test_export_forward_in_memory_matches_folded_serving():
    """The unserialized ``Exported`` (no flatbuffers needed) runs through
    ``load_exported`` like the bytes do."""
    _, variables = _trained_variables()
    infer = load_exported(export_forward(SPEC, variables,
                                         compute_dtype=jnp.float32))
    serve = build_inference_fn(SPEC, variables, compute_dtype=jnp.float32)
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, SPEC.num_points, 3)).astype(np.float32)
    b = rng.normal(size=(5, SPEC.num_points, 3)).astype(np.float32)
    ref = serve(jnp.asarray(a), jnp.asarray(b))
    got = infer(a, b)
    for key in OUTPUT_KEYS:
        np.testing.assert_allclose(np.asarray(ref[key]), np.asarray(got[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
