"""Multi-host (pod-scale) SPMD wiring.

The reference is strictly single-process/single-GPU (SURVEY.md §2
parallelism inventory: no DP/TP/PP, no communication backend). This
module is the greenfield pod-scale layer SURVEY.md §2's consequence
paragraph calls for: "host data loading sharded per process over DCN
for pod-scale training".

Design (jax.distributed + the existing ('dp','mp') mesh):
- every process runs the same Trainer; ``jax.distributed.initialize``
  connects them, after which ``jax.devices()`` is the GLOBAL device set
  and the mesh spans hosts — XLA inserts the gradient all-reduce across
  them (NCCL on GPUs);
- the per-epoch shuffle derives from (seed, epoch) only, so every
  process agrees on the global batch order without communicating;
- each process loads/resamples only its own rows of each global batch
  (``PackedDataset.shard_indices`` striding) and assembles the global
  dp-sharded batch via ``jax.make_array_from_process_local_data``;
- checkpoints/eval artifacts/scalar logs are written by process 0 only;
  non-addressable (mp-sharded) state leaves are gathered with
  ``multihost_utils.process_allgather`` before serialization.

Activation: set ``ALIGNNET_COORDINATOR`` (host:port),
``ALIGNNET_NUM_PROCS`` and ``ALIGNNET_PROC_ID`` in every process's
environment (or pass explicitly), then run the normal CLI. Without the
env vars everything degrades to the single-process behavior.
``__graft_entry__.dryrun_multihost`` exercises the full path with N
local processes on the CPU backend.
"""

from __future__ import annotations

import os

import numpy as np

ENV_COORDINATOR = "ALIGNNET_COORDINATOR"
ENV_NUM_PROCS = "ALIGNNET_NUM_PROCS"
ENV_PROC_ID = "ALIGNNET_PROC_ID"

_initialized = False


def maybe_initialize(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or environment, idempotently.

    Returns True when running multi-process (after initialization),
    False for plain single-process operation. Must be called before the
    first JAX computation of the process.
    """
    global _initialized
    if _initialized:
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ[ENV_NUM_PROCS])
    if process_id is None:
        process_id = int(os.environ[ENV_PROC_ID])
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def process_index() -> int:
    import jax

    return jax.process_index()


def process_count() -> int:
    import jax

    return jax.process_count()


def is_main() -> bool:
    return process_index() == 0


def global_batch(mesh, local_arrays, global_batch_size: int):
    """Assemble per-process local batch arrays into global dp-sharded
    jax.Arrays. ``local_arrays``: tuple of numpy arrays whose leading
    axis is the LOCAL batch; the global array stacks process blocks in
    process order (the mesh's dp axis enumerates devices in process
    order, so each process's rows land on its own devices — no
    cross-host transfer)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("dp"))
    out = []
    for a in local_arrays:
        a = np.asarray(a)
        out.append(jax.make_array_from_process_local_data(
            sharding, a, (global_batch_size,) + a.shape[1:]
        ))
    return tuple(out)


def fully_replicate(tree):
    """device_get a (possibly multi-host-sharded) pytree to host numpy,
    allgathering any leaf this process cannot address alone."""
    import jax

    def leaf(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            from jax.experimental import multihost_utils

            x = multihost_utils.process_allgather(x, tiled=True)
        return np.asarray(jax.device_get(x))

    return jax.tree.map(leaf, tree)


def main_isfile(path: str) -> bool:
    """Process 0's view of ``os.path.isfile``, broadcast to every process.

    On real pods there is no shared filesystem: per-process ``isfile``
    checks can diverge (process 0 has the checkpoint, others don't),
    and a diverging resume decision deadlocks in the restore collective.
    All resume/pretraining decisions go through process 0."""
    if process_count() <= 1:
        return os.path.isfile(path)
    from jax.experimental import multihost_utils

    flag = np.int32(os.path.isfile(path) if is_main() else 0)
    return bool(multihost_utils.broadcast_one_to_all(flag))


def broadcast_tree(tree, template):
    """Broadcast a host-numpy pytree from process 0 to all processes.

    ``tree`` is process 0's payload (ignored elsewhere); ``template`` is
    a same-structure/shape/dtype pytree every process can build locally
    (e.g. ``fully_replicate(init_state())``). Used so only process 0
    needs checkpoint bytes on disk."""
    if process_count() <= 1:
        return tree
    import jax
    from jax.experimental import multihost_utils

    src = tree if is_main() else template
    src = jax.tree.map(np.asarray, src)
    return multihost_utils.broadcast_one_to_all(src)
