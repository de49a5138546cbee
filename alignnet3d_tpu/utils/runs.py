"""Run-directory helpers shared by the probe/eval scripts.

A run's saved ``config.json`` derives its logdir from the config
FILENAME stem ("config" → runs/config/), so scripts that accept "a run
dir or a config path" must restore checkpoints from the config's own
directory when the snapshot lives there (scripts/probe_tta.py originally
carried this logic inline and scripts/probe_iter_refine.py duplicated
it — round-3 simplify finding).
"""

from __future__ import annotations

import os


def resolve_run_checkpoint(cfg_path: str, epoch) -> tuple[str, str | None]:
    """(config path, checkpoint-dir-or-None) for a run dir or config.

    Returns the config.json path (resolving a directory argument to the
    config inside it) and the directory containing ``model-<epoch>``
    if the checkpoint sits next to the config — None means "derive the
    checkpoint dir from the config's logdir as usual".
    """
    if os.path.isdir(cfg_path):
        cfg_path = os.path.join(cfg_path, "config.json")
    ckpt_dir = os.path.dirname(os.path.abspath(cfg_path))
    if not os.path.exists(os.path.join(ckpt_dir, f"model-{epoch}.npz")):
        ckpt_dir = None
    return cfg_path, ckpt_dir
