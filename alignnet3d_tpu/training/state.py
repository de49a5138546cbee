"""Training state and its checkpoint file format.

A checkpoint is one ``.npz`` file holding every leaf of a ``TrainState``
(params, BN stats, optimizer moments, step), keyed by its tree path
(``jax.tree_util.keystr``, e.g. ``.params['siamese']['remaining']
['fc1']['kernel']``). Reading needs a template of the same structure,
and only the template's keys are read, so a serving process can load
params and BN stats from a full training checkpoint without building an
optimizer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import jax
import numpy as np

CHECKPOINT_SUFFIX = ".npz"


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    step: Any
    params: Any
    batch_stats: Any
    opt_state: Any

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def save_tree(path: str, tree) -> None:
    """Write every leaf of ``tree`` to ``path`` (.npz), atomically."""
    flat = {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_tree(path: str, template):
    """Read the leaves ``template`` names from ``path``; the result has
    the template's structure, with each leaf's shape checked."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    with np.load(path) as blob:
        for p, want in paths:
            key = jax.tree_util.keystr(p)
            if key not in blob:
                raise KeyError(f"{path}: no leaf {key}")
            leaf = blob[key]
            if leaf.shape != np.shape(want):
                raise ValueError(
                    f"{path}: leaf {key} has shape {leaf.shape}, "
                    f"expected {np.shape(want)}")
            leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)
