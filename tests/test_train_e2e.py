"""End-to-end CLI tests on a generated fixture dataset: train -> artifacts
-> resume -> eval_only -> pretraining restore. These exercise the full
provider -> model -> loss -> metrics stack on the virtual 8-device mesh
(SURVEY.md §4c/e)."""

import json
import os

import numpy as np
import pytest

from alignnet3d_tpu.data.synthetic import generate_dataset


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    base = str(root / "SynthE2E")
    generate_dataset(base, num_train=32, num_val=8, seed=11, vres=16, hres=180)
    cfg = {
        "data": {"basepath": base},
        "logging": {"basedir": str(root / "runs")},
        "model": {
            "num_points": 64, "backbone": "pointnet",
            "options": {
                "angle_factor": 1.0, "early_stage_factor": 0.5,
                "s1transformer": [[16, 32], [[32], 0.7]],
                "s2transformer": [[16, 32], [[32], 0.7]],
                "embedding": [16, 64],
                "remaining_transform_prediction": [[32], 0.7],
            },
            "angles": {"num_bins": 8, "accept_inverted_angle": True},
        },
        "training": {"batch_size": 8, "num_epochs": 2,
                     "learning_rate": 0.005},
        "evaluation": {"save_every_epoch": True},
    }
    cfg_path = str(root / "E2E.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return root, cfg_path, base


def _run(cfg_path, *args):
    from alignnet3d_tpu.cli import main

    main([*args, "--config", cfg_path])


@pytest.mark.slow
def test_train_produces_artifacts(workspace):
    root, cfg_path, base = workspace
    _run(cfg_path, "train")
    logdir = root / "runs" / "E2E"
    assert (logdir / "model.ckpt.npz").is_file()
    assert (logdir / "model-0.npz").is_file()
    assert (logdir / "model-1.npz").is_file()
    assert (logdir / "config.json").is_file()
    assert (logdir / "out.log").is_file()
    eval_dir = logdir / "val" / "eval000001"
    for f in ("eval.json", "eval_180.json", "pred_translations.npy",
              "pred_angles.npy", "pred_s2_pc1centers.npy",
              "pred_s2_pc1angles.npy"):
        assert (eval_dir / f).is_file(), f
    ev = json.load(open(eval_dir / "eval.json"))
    assert ev["num"] == 8
    assert 0 <= ev["corr_levels"][2] <= 1
    preds = np.load(eval_dir / "pred_translations.npy")
    assert preds.shape == (8, 3) and np.all(np.isfinite(preds))
    # scalar event streams exist
    train_scalars = [
        json.loads(line)
        for line in open(logdir / "train" / "scalars.jsonl")
    ]
    assert "losses/loss" in train_scalars[-1]
    assert "hyperparameters/learning_rate" in train_scalars[-1]
    # one row per training step (reference emits per-step summaries,
    # train.py:368): 32 samples / batch 8 = 4 steps/epoch x 2 epochs
    assert [r["step"] for r in train_scalars] == list(range(1, 9))
    assert all(np.isfinite(r["losses/loss"]) for r in train_scalars)
    val_scalars = [
        json.loads(line) for line in open(logdir / "val" / "scalars.jsonl")
    ]
    assert "accuracy/o_b_1cm" in val_scalars[-1]


@pytest.mark.slow
def test_resume_continues_from_checkpoint(workspace, caplog):
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["training"]["num_epochs"] = 3
    json.dump(cfg, open(cfg_path, "w"))
    import logging

    with caplog.at_level(logging.INFO, logger="alignnet3d_tpu"):
        _run(cfg_path, "train")
    assert any("Continuing training at epoch 2" in r.message
               for r in caplog.records)
    assert (root / "runs" / "E2E" / "model-2.npz").is_file()


# depends on test_train_produces_artifacts' run dir -> same lane
@pytest.mark.slow
def test_eval_only_restores_numbered_checkpoint(workspace):
    root, cfg_path, base = workspace
    _run(cfg_path, "eval_only", "--eval_epoch", "2")
    assert (root / "runs" / "E2E" / "val" / "eval000002").is_dir()


def test_eval_only_missing_epoch_asserts(workspace):
    root, cfg_path, base = workspace
    with pytest.raises(AssertionError):
        _run(cfg_path, "eval_only", "--eval_epoch", "77")


@pytest.mark.slow
def test_pretraining_restore_runs_initial_eval(workspace, caplog):
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["training"]["pretraining"] = {
        "model": str(root / "runs" / "E2E" / "model-2")
    }
    cfg["training"]["num_epochs"] = 1
    pre_path = str(root / "Pre.json")
    json.dump(cfg, open(pre_path, "w"))
    import logging

    with caplog.at_level(logging.INFO, logger="alignnet3d_tpu"):
        _run(pre_path, "train")
    assert any("Pre-trained weights loaded" in r.message for r in caplog.records)
    # initial eval tagged 'pretr'; zfill(6) pads to '0pretr'
    # (reference train.py:292, 399)
    assert (root / "runs" / "Pre" / "val" / "eval00pretr").is_dir() or (
        root / "runs" / "Pre" / "val" / "eval0pretr"
    ).is_dir()
    assert (root / "runs" / "Pre" / "model-0.npz").is_file()


# depends on test_train_produces_artifacts' run dir -> same lane
@pytest.mark.slow
def test_refine_cascade_eval(workspace):
    """--refineICP with evaluation.refinement.cascade runs both gated
    stages (framework addition; single-stage path is the reference
    behavior, train.py:461-484) and writes finite refined artifacts."""
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["evaluation"]["refinement_gate"] = {
        "enabled": True, "max_dyaw_deg": 10.0, "max_dxy": 0.5,
    }
    cfg["evaluation"]["refinement"] = {"cascade": [
        {"radius": 0.1},
        {"radius": 0.05, "its": 4, "max_dyaw_deg": 3.0, "max_dxy": 0.15},
    ]}
    json.dump(cfg, open(cfg_path, "w"))
    try:
        _run(cfg_path, "eval_only", "--eval_epoch", "2",
             "--refineICP", "--its", "5")
        refined_dir = (root / "runs" / "E2E" / "val" / "eval000002"
                       / "refined_p2p_5")
        assert refined_dir.is_dir()
        ev = json.load(open(refined_dir / "eval_180.json"))
        assert ev["num"] == 8
        t = np.load(refined_dir / "pred_translations.npy")
        assert t.shape == (8, 3) and np.all(np.isfinite(t))
        # world-frame reset after refinement (reference train.py:483-484)
        centers = np.load(refined_dir / "pred_s2_pc1centers.npy")
        assert np.all(centers == 0.0)
    finally:
        cfg["evaluation"].pop("refinement")
        cfg["evaluation"].pop("refinement_gate")
        json.dump(cfg, open(cfg_path, "w"))


# depends on test_train_produces_artifacts' run dir -> same lane
@pytest.mark.slow
def test_checkpoint_roundtrip_preserves_predictions(workspace):
    """Restoring model-2 must reproduce eval000002's predictions exactly."""
    root, cfg_path, base = workspace
    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.training import Trainer

    cfg = load_config(cfg_path)
    trainer = Trainer(cfg, seed=0)
    state = trainer.init_state()
    state = trainer.restore_checkpoint(
        state, str(root / "runs" / "E2E" / "model-2.npz")
    )
    import jax

    assert int(jax.device_get(state.step)) == 3 * (32 // 8)
    before = np.load(
        root / "runs" / "E2E" / "val" / "eval000002" / "pred_translations.npy"
    )
    # re-run eval through the trainer and compare
    trainer.eval_one_epoch(state, "roundtrip", eval_only=True)
    after = np.load(
        root / "runs" / "E2E" / "val" / "evalroundtrip" /
        "pred_translations.npy"
    )
    np.testing.assert_allclose(before, after, atol=1e-5)


@pytest.mark.slow
def test_voxel_resample_config_wiring(workspace):
    """data.resample.mode=voxel enables the density-equalized view on the
    Trainer's dataset and trains an epoch through it (framework addition,
    PARITY.md; reference only has uniform resampling, provider.py:97-98)."""
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["data"]["resample"] = {"mode": "voxel", "voxel_size": 0.1}
    vox_cfg_path = str(root / "E2EVox.json")
    json.dump(cfg, open(vox_cfg_path, "w"))
    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.training import Trainer

    c = load_config(vox_cfg_path)
    trainer = Trainer(c, seed=0)
    assert trainer.dataset._vox is not None
    assert trainer.dataset._vox_size == 0.1
    from alignnet3d_tpu.training.trainer import ScalarWriter

    state = trainer.init_state()
    writer = ScalarWriter(str(root / "vox_train_scalars.jsonl"))
    state = trainer.train_one_epoch(state, 0, writer)
    loss = trainer.eval_one_epoch(state, 0, eval_only=True)
    assert np.isfinite(loss)


@pytest.mark.slow
def test_residual_task_config_wiring(workspace):
    """data.residual_task.enabled trains+evals an epoch on the residual-
    alignment distribution through the full Trainer path (framework
    addition, data/residual.py — the learned fine-aligner's training
    task)."""
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["data"]["residual_task"] = {
        "enabled": True, "angle_std_deg": 2.0, "xy_std": 0.1,
    }
    res_cfg_path = str(root / "E2EResidual.json")
    json.dump(cfg, open(res_cfg_path, "w"))
    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.training import Trainer

    c = load_config(res_cfg_path)
    trainer = Trainer(c, seed=0)
    assert trainer._residual_params is not None
    assert trainer._residual_params["xy_std"] == 0.1
    # the rewritten batch must be near-aligned: rel angles tiny vs the
    # uniform pose distribution of the underlying dataset
    batch = trainer._make_batch(list(trainer.val_indices)[:8],
                                rng=np.random.default_rng(0))
    assert np.abs(np.degrees(np.asarray(batch[3]))).mean() < 30.0
    from alignnet3d_tpu.training.trainer import ScalarWriter

    state = trainer.init_state()
    writer = ScalarWriter(str(root / "residual_train_scalars.jsonl"))
    state = trainer.train_one_epoch(state, 0, writer)
    loss = trainer.eval_one_epoch(state, 0, eval_only=True)
    assert np.isfinite(loss)


def test_network_refine_eval_wiring(workspace):
    """evaluation.network_refine runs a gated second forward pass and
    rewrites predictions in world frame (rotation center zero, like ICP
    refinement — framework addition, trainer._network_refine_pass)."""
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["evaluation"]["network_refine"] = {
        "enabled": True,
        "gate": {"max_dyaw_deg": 180.0, "max_dxy": 1000.0},
    }
    ref_cfg_path = str(root / "E2ENetRefine.json")
    json.dump(cfg, open(ref_cfg_path, "w"))
    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.training import Trainer

    c = load_config(ref_cfg_path)
    trainer = Trainer(c, seed=0)
    state = trainer.init_state()
    loss = trainer.eval_one_epoch(state, 0, eval_only=True)
    assert np.isfinite(loss)
    ed = str(root / "runs" / "E2ENetRefine" / "val" / "eval000000")
    centers = np.load(f"{ed}/pred_s2_pc1centers.npy")
    assert np.all(centers == 0.0)  # world-frame rewrite happened
    assert os.path.isfile(f"{ed}/eval_180.json")


def test_network_refine_rejects_residual_task(workspace):
    """data.residual_task and evaluation.network_refine in one config is
    silent-corruption territory (the refine pass would compose a second
    random pre-alignment) — the trainer must refuse (review finding)."""
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["data"]["residual_task"] = {"enabled": True}
    cfg["evaluation"]["network_refine"] = {"enabled": True}
    bad_cfg_path = str(root / "E2EBadCombo.json")
    json.dump(cfg, open(bad_cfg_path, "w"))
    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.training import Trainer

    c = load_config(bad_cfg_path)
    trainer = Trainer(c, seed=0)
    state = trainer.init_state()
    with pytest.raises(AssertionError, match="mutually exclusive"):
        trainer.eval_one_epoch(state, 0, eval_only=True)


def test_network_refine_iterations(workspace):
    """evaluation.network_refine.iterations runs N gated passes; each
    composes from the previous GATED output (frame-consistent, unlike
    the probe's raw-chain scoring) and the eval still produces valid
    world-frame artifacts."""
    root, cfg_path, base = workspace
    cfg = json.load(open(cfg_path))
    cfg["evaluation"]["network_refine"] = {
        "enabled": True, "iterations": 2,
        "gate": {"max_dyaw_deg": 180.0, "max_dxy": 1000.0},
    }
    it_cfg_path = str(root / "E2ENetRefineIter.json")
    json.dump(cfg, open(it_cfg_path, "w"))
    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.training import Trainer

    c = load_config(it_cfg_path)
    trainer = Trainer(c, seed=0)
    state = trainer.init_state()
    loss = trainer.eval_one_epoch(state, 0, eval_only=True)
    assert np.isfinite(loss)
    ed = str(root / "runs" / "E2ENetRefineIter" / "val" / "eval000000")
    assert np.all(np.load(f"{ed}/pred_s2_pc1centers.npy") == 0.0)
    assert np.all(np.isfinite(np.load(f"{ed}/pred_translations.npy")))
