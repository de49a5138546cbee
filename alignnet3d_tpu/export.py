"""Ahead-of-time serialized deployment artifacts via ``jax.export``.

The reference "deploys" by restoring the TF graph + checkpoint inside
the training process (reference train.py:246-264) — the serving artifact
IS the training code. The equivalent here is an ahead-of-time
exported StableHLO module: the BN-folded serving function (serving.py)
is traced once with a *symbolic batch dimension*, its folded weights are
baked into the module as constants, and the resulting bytes can be
stored, shipped, reloaded, and executed without the model code, the
checkpoint, or even this package — anything that speaks
``jax.export`` (or raw StableHLO) can run it. ``jax.export``'s
calling-convention versioning gives the artifact a cross-release
compatibility window, which an in-process pickle of a jitted function
would not have.

    blob = export_alignment_model(spec, variables, "model.shlo")
    infer = load_exported("model.shlo")   # fn(pcs1, pcs2) -> end_points
    out = infer(pcs1, pcs2)               # any batch size, N fixed

Writing the bytes needs the ``flatbuffers`` package; ``export_forward``
returns the in-memory ``Exported``, which ``load_exported`` also takes.

Cross-platform: pass ``platforms=("cuda", "cpu")`` to emit one artifact
that lowers for both — export on a CPU host, serve on the GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import export as jax_export

from alignnet3d_tpu.models.alignnet import ModelSpec
from alignnet3d_tpu.serving import build_inference_fn

# end_points keys in a fixed order so the exported flat outputs can be
# rebuilt into the dict by a loader that never imports the model code
OUTPUT_KEYS = (
    "pred_s1_pc1centers",
    "pred_s1_pc2centers",
    "pred_s2_pc1centers",
    "pred_s2_pc2centers",
    "pred_pc1angle_logits",
    "pred_pc2angle_logits",
    "pred_translations",
    "pred_remaining_angle_logits",
)


def export_forward(spec: ModelSpec, variables, *, compute_dtype=jnp.bfloat16,
                   platforms=None) -> jax_export.Exported:
    """Trace and lower the folded serving forward (serving.py) for
    ``platforms`` (default: the current backend).

    The batch dimension is exported symbolically (``b``), so one
    artifact serves every batch size; ``num_points`` stays static (the
    data pipeline pads/resamples to it anyway, reference
    provider.py:97-98). Weights are folded (BN into dense) and embedded
    as constants.
    """
    forward = build_inference_fn(spec, variables,
                                 compute_dtype=compute_dtype)

    def flat_forward(pcs1, pcs2):
        out = forward(pcs1, pcs2)
        return tuple(out[k] for k in OUTPUT_KEYS)

    (b,) = jax_export.symbolic_shape("b")
    arg = jax.ShapeDtypeStruct((b, spec.num_points, 3), jnp.float32)
    return jax_export.export(
        jax.jit(flat_forward),
        platforms=list(platforms) if platforms else None,
    )(arg, arg)


def export_alignment_model(spec: ModelSpec, variables, path: str | None = None,
                           *, compute_dtype=jnp.bfloat16,
                           platforms=None) -> bytes:
    """Serialize ``export_forward``'s artifact; also write it to ``path``
    when given. Serialization needs the ``flatbuffers`` package."""
    blob = bytes(export_forward(spec, variables, compute_dtype=compute_dtype,
                                platforms=platforms).serialize())
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def load_exported(artifact):
    """Rehydrate an exported artifact — a path, its bytes, or an
    ``Exported`` — into ``fn(pcs1, pcs2) -> dict``.

    Needs only this function and jax — no ModelSpec, no checkpoint. The
    returned callable jit-executes the embedded module on the
    default backend (or whichever exported platform matches).
    """
    if isinstance(artifact, jax_export.Exported):
        exported = artifact
    else:
        if isinstance(artifact, (bytes, bytearray)):
            blob = bytes(artifact)
        else:
            with open(artifact, "rb") as fh:
                blob = fh.read()
        exported = jax_export.deserialize(blob)
    call = jax.jit(exported.call)

    def infer(pcs1, pcs2):
        flat = call(jnp.asarray(pcs1, jnp.float32),
                    jnp.asarray(pcs2, jnp.float32))
        return dict(zip(OUTPUT_KEYS, flat))

    return infer
