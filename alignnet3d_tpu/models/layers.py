"""Plain-JAX layers over a nested-dict variable tree.

A model is a frozen dataclass whose ``__call__(scope, ...)`` runs the
forward pass. The ``Scope`` it receives reads (or, at init, creates) its
variables at a module path such as
``siamese/transformer1/PointNetBackbone_0/conv1``. Two trees hold them:

- ``params``: dense ``kernel``/``bias`` and batch-norm ``scale``/``bias``;
- ``batch_stats``: batch-norm running ``mean``/``var``.

``Module.init`` and ``Module.apply`` give every model the calling shape
``init(rngs, *args) -> {"params", "batch_stats"}`` and
``apply(variables, *args, mutable=["batch_stats"], rngs={"dropout": k})``.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp


def _path_key(key: jax.Array, path: str) -> jax.Array:
    """A key derived from ``key`` and a module path, stable across runs."""
    return jax.random.fold_in(key, zlib.crc32(path.encode()))


def xavier_uniform(key, shape, dtype=jnp.float32):
    # the reference's xavier_initializer (tf_util.py:24-49)
    limit = jnp.sqrt(6.0 / (shape[0] + shape[1]))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def zeros(key, shape, dtype=jnp.float32):
    del key
    return jnp.zeros(shape, dtype)


def ones(key, shape, dtype=jnp.float32):
    del key
    return jnp.ones(shape, dtype)


class Scope:
    """One forward pass's view of the variable tree at one module path.

    At init (``init_rng`` given) a missing leaf is created from its
    initializer; otherwise every leaf must already exist. Batch-stat
    updates go into a copy of the ``batch_stats`` tree, so the caller's
    variables are never changed.
    """

    def __init__(self, params: dict, stats: dict, *, init_rng=None,
                 dropout_rng=None, path: tuple = (), _counters=None):
        self.params = params
        self.stats = stats
        self.init_rng = init_rng
        self.dropout_key = dropout_rng
        self.path = path
        self._counters = {} if _counters is None else _counters

    @property
    def initializing(self) -> bool:
        return self.init_rng is not None

    def _name(self, leaf: str) -> str:
        return "/".join(self.path + (leaf,))

    def child(self, name: str) -> "Scope":
        if self.initializing:
            self.params.setdefault(name, {})
            self.stats.setdefault(name, {})
        return Scope(self.params.get(name, {}), self.stats.get(name, {}),
                     init_rng=self.init_rng, dropout_rng=self.dropout_key,
                     path=self.path + (name,), _counters=self._counters)

    def param(self, name: str, init_fn: Callable, shape) -> jax.Array:
        if name not in self.params:
            if not self.initializing:
                raise KeyError(f"no parameter {self._name(name)!r}")
            self.params[name] = init_fn(
                _path_key(self.init_rng, self._name(name)), tuple(shape))
        return self.params[name]

    def stat(self, name: str, init_value: Callable[[], jax.Array]):
        if name not in self.stats:
            if not self.initializing:
                raise KeyError(f"no batch stat {self._name(name)!r}")
            self.stats[name] = init_value()
        return self.stats[name]

    def set_stat(self, name: str, value: jax.Array) -> None:
        self.stats[name] = value

    def dropout_rng(self) -> jax.Array:
        """A fresh key per call site and per call (a module applied
        twice draws two masks)."""
        if self.dropout_key is None:
            raise ValueError("train-mode dropout needs rngs={'dropout': key}")
        path = "/".join(self.path)
        count = self._counters.get(path, 0)
        self._counters[path] = count + 1
        return jax.random.fold_in(_path_key(self.dropout_key, path), count)


def _copy_tree(tree: dict) -> dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _prune(tree: dict) -> dict:
    """Drop the empty subtrees that ``Scope.child`` made at init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


def _split_rngs(rngs) -> tuple[Any, Any]:
    if rngs is None:
        return None, None
    if isinstance(rngs, dict):
        return rngs.get("params"), rngs.get("dropout")
    return rngs, None


class Module:
    """``init``/``apply`` for a dataclass with ``__call__(scope, ...)``."""

    def __call__(self, scope: Scope, *args, **kwargs):
        raise NotImplementedError

    def init(self, rngs, *args, **kwargs) -> dict:
        params_rng, dropout_rng = _split_rngs(rngs)
        if params_rng is None:
            raise ValueError("init needs a 'params' key")
        scope = Scope({}, {}, init_rng=params_rng, dropout_rng=dropout_rng)
        self(scope, *args, **kwargs)
        return {"params": _prune(scope.params),
                "batch_stats": _prune(scope.stats)}

    def apply(self, variables: dict, *args,
              mutable: Sequence[str] = (), rngs=None, **kwargs):
        """Forward pass. With ``mutable=["batch_stats"]`` returns
        ``(out, {"batch_stats": updated})``."""
        if set(mutable or ()) - {"batch_stats"}:
            raise ValueError(f"only batch_stats is mutable, got {mutable!r}")
        _, dropout_rng = _split_rngs(rngs)
        scope = Scope(variables["params"],
                      _copy_tree(variables.get("batch_stats", {})),
                      dropout_rng=dropout_rng)
        out = self(scope, *args, **kwargs)
        if mutable:
            return out, {"batch_stats": scope.stats}
        return out


def dense(scope: Scope, x: jax.Array, features: int, dtype) -> jax.Array:
    """xavier-uniform kernel + zero bias, computed in ``dtype`` (the
    reference init, tf_util.py:24-49: xavier_initializer, constant 0)."""
    kernel = scope.param("kernel", xavier_uniform, (x.shape[-1], features))
    bias = scope.param("bias", zeros, (features,))
    y = jax.lax.dot_general(
        x.astype(dtype), kernel.astype(dtype),
        (((x.ndim - 1,), (0,)), ((), ())),
    )
    return y + bias.astype(dtype)


def dropout(scope: Scope, x: jax.Array, rate: float,
            deterministic: bool) -> jax.Array:
    if deterministic or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = jax.random.bernoulli(scope.dropout_rng(), keep_prob, x.shape)
    return jax.lax.select(keep, x / keep_prob, jnp.zeros_like(x))
