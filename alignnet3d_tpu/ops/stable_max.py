"""Max reduction with remat-stable gradient routing.

Round-5 finding (jax 0.9.0, XLA CPU, reproduced in
tests/test_stable_max.py): ``jit(grad(...))`` of a graph that
differentiates through ``jnp.max`` can DROP gradient mass. The
``reduce_max`` VJP routes cotangents through a bitwise equality mask
``operand == broadcast(result)``; under ``jit``, XLA may rematerialize /
refuse the operand inside the fused backward with different fusion
partners and reassociation, so the recomputed values miss the stored
max bitwise and the cotangent vanishes. Measured on the DGCNN edge
stage (B4 N320 k20, C 64/128): ``jit(grad)`` disagrees with both the
eager gradient and a central finite difference by 33% max-norm while
eager matches FD — the jit gradient is simply wrong, with ZERO argmax
flips (so it is dropped mass, not tie ambiguity). The full AlignNet
training gradient differs 1.7% max-norm / 40% of elements between jit
and eager on the same version. This is the same
bitwise-equality-across-recompute failure class as the round-4 fused
kernel backward bug (docs/DESIGN.md 4b-ii item 5) — but inside XLA's
own max VJP.

``stable_max`` computes the identical forward value (the argmax element
IS the max) but routes the gradient through a ``stop_gradient``'d
argmax one-hot: a masked sum whose VJP is a broadcast multiply. There
is no equality-against-recompute anywhere, so the failure mode under
rematerialization degrades from "cotangent dropped" to "near-tie
routed to the other near-equal slot" — a valid subgradient choice with
bounded effect. Routing matches first-argmax semantics, the same
convention as eager XLA at non-tied elements.

Cost: one extra reduction pass (argmax) plus a fused select-sum in
place of the single max — memory-bound epsilon next to the matmuls the
pools sit between; the backward is a pure elementwise broadcast
(no scatter).

Wired behind ``model.options.stable_max_grad`` (ModelSpec), applied in
the training graph only — eval/serving graphs never differentiate
through the pools and keep the single-pass ``jnp.max``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def stable_max(x: jax.Array, axis: int) -> jax.Array:
    """``jnp.max(x, axis)`` with deterministic first-argmax gradient
    routing that survives XLA rematerialization (see module doc)."""
    axis = axis % x.ndim
    idx = jax.lax.stop_gradient(jnp.argmax(x, axis=axis))
    iota = jax.lax.broadcasted_iota(idx.dtype, x.shape, axis)
    sel = iota == jnp.expand_dims(idx, axis)
    return jnp.sum(jnp.where(sel, x, jnp.zeros((), x.dtype)), axis=axis)


def stable_min(x: jax.Array, axis: int) -> jax.Array:
    """``jnp.min(x, axis)`` with the same remat-stable first-argmin
    gradient routing (negation is exact for floats)."""
    return -stable_max(-x, axis)
