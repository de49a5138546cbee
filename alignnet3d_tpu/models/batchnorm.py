"""Batch normalization with the reference's EMA-with-scheduled-decay
semantics (reference utils/tf_util.py:455-492, train.py:159-174).

Differences from a textbook BatchNorm that matter for parity:

- In training, activations are normalized with the CURRENT batch statistics
  (the reference's ``mean_var_with_update``), never the running average.
- The running average uses a *scheduled* momentum ("bn_decay"):
  ``ema = m * ema + (1 - m) * batch`` with
  ``m = min(clip, 1 - init * rate^(step // decay_step))`` — m starts at 0.5
  and rises to 0.99 (train.py:172-173). The momentum is therefore a traced
  scalar passed at call time, not a module constant.
- ``eps = 1e-3`` (tf.nn.batch_normalization call, tf_util.py:491).

Deviation (documented): TF's ExponentialMovingAverage initializes shadow
variables of tensors to zero, so the reference's running variance starts at
0. We initialize running var to 1 so an eval before any training step is
well-conditioned; after a few hundred steps at momentum 0.5 the difference
is below float32 noise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from alignnet3d_tpu.models.layers import Module, Scope, ones, zeros


def batch_norm(scope: Scope, x: jax.Array, train: bool, momentum,
               dtype=None, epsilon: float = 1e-3) -> jax.Array:
    """BatchNorm over all axes but the last, with dynamic EMA momentum.
    Variables: params ``scale``/``bias``, batch_stats ``mean``/``var``."""
    features = x.shape[-1]
    scale = scope.param("scale", ones, (features,))
    bias = scope.param("bias", zeros, (features,))
    ra_mean = scope.stat("mean", lambda: jnp.zeros((features,), jnp.float32))
    ra_var = scope.stat("var", lambda: jnp.ones((features,), jnp.float32))

    if train:
        reduce_axes = tuple(range(x.ndim - 1))
        xf = x.astype(jnp.float32)
        mean = jnp.mean(xf, axis=reduce_axes)
        # tf.nn.moments: biased variance estimate
        var = jnp.mean(jnp.square(xf), axis=reduce_axes) - jnp.square(mean)
        if not scope.initializing:
            m = jnp.asarray(momentum, jnp.float32)
            scope.set_stat("mean", m * ra_mean + (1.0 - m) * mean)
            scope.set_stat("var", m * ra_var + (1.0 - m) * var)
    else:
        mean, var = ra_mean, ra_var

    y = (x.astype(jnp.float32) - mean) * jax.lax.rsqrt(var + epsilon)
    y = y * scale + bias
    return y.astype(dtype or x.dtype)


@dataclasses.dataclass(frozen=True)
class EmaBatchNorm(Module):
    """``batch_norm`` as a stand-alone module."""

    epsilon: float = 1e-3
    dtype: jnp.dtype | None = None

    def __call__(self, scope: Scope, x: jax.Array, train: bool, momentum):
        return batch_norm(scope, x, train, momentum, self.dtype, self.epsilon)
