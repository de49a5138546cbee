"""SPMD device mesh + sharding rules.

The reference has zero parallelism machinery (SURVEY.md §2: single
tf.Session on one GPU, dead ``is_dist`` BN flag). This module is the
greenfield replacement:

- a 2-axis ``Mesh`` ``('dp', 'mp')``: data parallelism over ``dp`` (the
  per-pair workload is embarrassingly parallel; one gradient all-reduce
  per step), tensor parallelism of the wide embedding layers over ``mp``;
- shape-based partition rules applied uniformly to params, optimizer
  moments, and BN statistics, so one rule tree shards the whole TrainState;
- jit with in/out shardings does the rest — XLA inserts the collectives,
  which it runs through NCCL on GPUs. The cards of one host reach each
  other at the same rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# dense outputs at least this wide get their feature axis sharded over 'mp'
TP_THRESHOLD = 512


def make_mesh(dp: int = -1, mp: int = 1, devices=None) -> Mesh:
    """Build the ('dp', 'mp') mesh. ``dp=-1`` uses all remaining devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if mp <= 0:
        mp = 1
    if dp == -1:
        dp = n // mp
    assert dp * mp <= n, f"mesh {dp}x{mp} needs {dp*mp} devices, have {n}"
    dev_array = np.asarray(devices[: dp * mp]).reshape(dp, mp)
    return Mesh(dev_array, ("dp", "mp"))


def choose_dp(dp: int, batch_size: int, num_processes: int = 1) -> int:
    """Largest dp' <= dp that divides ``batch_size`` — and, under
    multi-process SPMD, is also a multiple of ``num_processes`` so every
    process owns the same number of dp rows (the even per-process batch
    split ``multihost.global_batch`` performs). ``num_processes`` is
    always a valid floor because the Trainer asserts
    ``batch_size % num_processes == 0``."""
    if num_processes > 1:
        # the floor below is only valid when every process can take an
        # equal batch share; fail here, at the selection site, instead of
        # deep inside make_array_from_process_local_data
        assert batch_size % num_processes == 0, (
            f"batch_size {batch_size} must divide over "
            f"{num_processes} processes"
        )
        while dp > num_processes and (
            batch_size % dp != 0 or dp % num_processes != 0
        ):
            dp -= 1
    else:
        while dp > 1 and batch_size % dp != 0:
            dp -= 1
    return dp


def balanced_process_devices(devices, dp: int, mp: int,
                             num_processes: int) -> list:
    """Pick ``dp*mp`` devices with an EQUAL share from every process.

    A plain prefix of ``jax.devices()`` after dp reduction can leave
    process 0 owning more mesh rows than process 1, which breaks the even
    per-process batch split (``make_array_from_process_local_data`` then
    rejects the addressable shards). Groups devices by
    ``device.process_index`` and takes ``dp*mp/num_processes`` from each,
    in process order, so consecutive ``mp`` blocks stay within a process.
    """
    mp = max(1, mp)
    per_proc = dp * mp // num_processes
    assert per_proc % mp == 0, (
        f"mp={mp} groups must not straddle processes "
        f"(dp={dp}, processes={num_processes})"
    )
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    assert all(len(v) >= per_proc for v in by_proc.values()), (
        f"mesh {dp}x{mp} needs {per_proc} devices per process; "
        f"have {[len(v) for v in by_proc.values()]}"
    )
    return [d for p in sorted(by_proc) for d in by_proc[p][:per_proc]]


def leaf_pspec(leaf, tp_threshold: int = TP_THRESHOLD) -> P:
    """Partition rule for one array: shard wide feature axes over 'mp'.

    - 2D (in, out) dense kernels with out >= threshold -> P(None, 'mp')
    - 1D vectors (biases, BN scale/bias/stats) >= threshold -> P('mp')
    - everything else replicated.
    """
    shape = getattr(leaf, "shape", ())
    if len(shape) == 2 and shape[-1] >= tp_threshold:
        return P(None, "mp")
    if len(shape) == 1 and shape[0] >= tp_threshold:
        return P("mp")
    return P()


def state_shardings(state, mesh: Mesh, tp_threshold: int = TP_THRESHOLD):
    """NamedSharding tree mirroring any TrainState-like pytree."""
    return jax.tree_util.tree_map(
        lambda leaf: NamedSharding(mesh, leaf_pspec(leaf, tp_threshold)), state
    )


def batch_sharding(mesh: Mesh):
    """Batch arrays are sharded over 'dp' on the leading axis."""
    return NamedSharding(mesh, P("dp"))


def multi_batch_sharding(mesh: Mesh):
    """(K, B, ...) stacked-step batches: 'dp' shards the BATCH axis (1);
    the steps-per-dispatch axis (0) is a sequential lax.scan dimension and
    must stay unsharded."""
    return NamedSharding(mesh, P(None, "dp"))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
