"""Tests for utils/runs.py (shared run-dir checkpoint resolution)."""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from alignnet3d_tpu.utils.runs import resolve_run_checkpoint


def test_resolve_run_dir_with_checkpoint(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(json.dumps({}))
    (run / "model-5.npz").write_bytes(b"x")
    cfg, ckpt = resolve_run_checkpoint(str(run), 5)
    assert cfg == str(run / "config.json")
    assert ckpt == str(run)


def test_resolve_config_path_without_checkpoint(tmp_path):
    cfgf = tmp_path / "Exp.json"
    cfgf.write_text(json.dumps({}))
    cfg, ckpt = resolve_run_checkpoint(str(cfgf), 7)
    assert cfg == str(cfgf)
    assert ckpt is None  # caller falls back to the derived logdir
