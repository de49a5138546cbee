"""Int8 quantized serving math for the folded point-MLP chains.

STATUS: EXPERIMENTAL and NOT adopted (docs/RESULTS.md "int8 ...
REJECTED"): accuracy is within ±0.3 pt of f32 at every scope, but the
dynamic quantize/dequantize passes break the conv+BN fusion chain and
cost end-to-end throughput on the accelerator it was tried on; on the
GPU it is unmeasured. The serving default and bench stay bf16; this path
remains for static-quant follow-ups (pre-calibrated scales would remove
the per-batch passes).

No reference analogue (the reference serves the full TF training graph
in f32, train.py:246-264). The motivation: an int8 matmul path runs at
twice the bf16 rate and halves the activation row traffic, and the
folded forward's narrow early layers are row-traffic-bound.

Scheme (standard dynamic quantization, chosen for zero calibration
state):
- weights: symmetric per-OUTPUT-channel int8, folded BN included
  (quantized once at build time);
- activations: symmetric per-ROW dynamic int8 — one |max| reduction per
  row per layer, fused by XLA into the preceding op;
- accumulation in int32, dequantized by (row_scale x col_scale) and
  biased/ReLU'd in f32.

Accuracy is an eval-time question, not a unit-test question: the option
ships OFF and docs/RESULTS.md carries the measured accuracy deltas per
quantization scope (see serving.build_inference_fn ``quantize``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def quantize_weights_int8(weights):
    """[(Cin, Cout) f32] -> [(int8 kernel, (Cout,) f32 scale)]."""
    out = []
    for w in weights:
        w = np.asarray(w, np.float32)
        scale = np.max(np.abs(w), axis=0) / 127.0
        scale = np.maximum(scale, 1e-12)
        wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        out.append((jnp.asarray(wq), jnp.asarray(scale)))
    return out


def _dense_int8(h, wq, w_scale):
    """Row-dynamic int8 x per-channel int8 -> f32, pre-bias."""
    ax = jnp.max(jnp.abs(h), axis=-1, keepdims=True) / 127.0
    ax = jnp.maximum(ax, 1e-12)
    hq = jnp.clip(jnp.round(h / ax), -127.0, 127.0).astype(jnp.int8)
    acc = jax.lax.dot_general(
        hq, wq,
        (((hq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return acc.astype(jnp.float32) * (ax * w_scale)


def _dense_int8_nonneg(h, wq, w_scale):
    """Unsigned 8-bit activations on a signed-int8 matmul, for KNOWN
    NONNEGATIVE rows (post-ReLU layers).

    Symmetric int8 on nonnegative data wastes the sign bit (effectively
    7-bit activations). Full unsigned precision with the same signed-int8
    matmul via the zero-point-shift identity:

        uq in [0, 255],  sq = uq - 128 in [-128, 127]
        dot(uq, wq) = dot(sq, wq) + 128 * colsum(wq)

    ``colsum`` is a per-output-channel int32 constant; with
    closure-captured weights (DESIGN.md §9) XLA folds it at compile time.
    """
    ax = jnp.max(h, axis=-1, keepdims=True) / 255.0
    ax = jnp.maximum(ax, 1e-12)
    sq = jnp.clip(jnp.round(h / ax) - 128.0, -128.0, 127.0).astype(jnp.int8)
    acc = jax.lax.dot_general(
        sq, wq,
        (((sq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    colsum = jnp.sum(wq.astype(jnp.int32), axis=0)
    return (acc + 128 * colsum).astype(jnp.float32) * (ax * w_scale)


def fused_pointnet_int8(points, qweights, biases):
    """Int8 twin of ``serving.fused_pointnet_xla``:
    relu-dense chain in dynamic int8 + f32 max over the point axis.

    The first layer sees signed inputs (raw/normalized coordinates) and
    uses symmetric int8; every later layer sees post-ReLU activations and
    uses the unsigned scheme (full 8-bit instead of 7).

    points: (B, N, C) f32; qweights: output of quantize_weights_int8;
    biases: [(Cout,) f32].
    """
    h = points.astype(jnp.float32)
    for i, ((wq, ws), b) in enumerate(zip(qweights, biases)):
        dense = _dense_int8 if i == 0 else _dense_int8_nonneg
        h = jnp.maximum(dense(h, wq, ws) + b, 0.0)
    return jnp.max(h, axis=1)
