"""evaluation.eval_every: Nth-epoch val cadence (default 1 = reference
train.py's every-epoch eval). The full val pass costs several epochs'
worth of steps, so long runs thin it out; the last epoch must always
evaluate and eval_only must be unaffected."""

import json
import os

from alignnet3d_tpu.config import load_config
from alignnet3d_tpu.data.synthetic import generate_dataset
from alignnet3d_tpu.training.trainer import Trainer


def test_eval_every_cadence(tmp_path):
    base = str(tmp_path / "SynthEC")
    generate_dataset(base, num_train=16, num_val=4, seed=17, vres=12,
                     hres=90)
    d = {
        "data": {"basepath": base},
        "logging": {"basedir": str(tmp_path / "runs")},
        "model": {
            "num_points": 32, "backbone": "pointnet",
            "options": {
                "angle_factor": 1.0, "early_stage_factor": 0.5,
                "s1transformer": [[8, 16], [[16], 0.7]],
                "s2transformer": [[8, 16], [[16], 0.7]],
                "embedding": [8, 32],
                "remaining_transform_prediction": [[16], 0.7],
            },
            "angles": {"num_bins": 4, "accept_inverted_angle": False},
        },
        "training": {"batch_size": 8, "num_epochs": 4,
                     "learning_rate": 0.005},
        "evaluation": {"save_every_epoch": True, "eval_every": 2},
    }
    cfg_path = str(tmp_path / "EC.json")
    json.dump(d, open(cfg_path, "w"))
    cfg = load_config(cfg_path)
    Trainer(cfg, seed=3).train()

    vd = os.path.join(cfg.logging.logdir, "val")
    evals = sorted(p for p in os.listdir(vd) if p.startswith("eval"))
    # epochs 0 and 2 by cadence, 3 because it is last; 1 skipped
    assert evals == ["eval000000", "eval000002", "eval000003"], evals
