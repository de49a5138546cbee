"""High-level Aligner API: checkpoint loading, alignment output contract,
ICP-refined mode."""

import json

import numpy as np
import pytest

from alignnet3d_tpu.data.synthetic import generate_dataset
from alignnet3d_tpu.geometry import transform_points


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("api")
    base = str(root / "Data")
    generate_dataset(base, num_train=16, num_val=4, seed=71, vres=16,
                     hres=180)
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
        "training": {"batch_size": 8, "num_epochs": 1,
                     "learning_rate": 0.005},
        "evaluation": {"save_every_epoch": True},
    }
    cfg_path = str(root / "Api.json")
    json.dump(cfg, open(cfg_path, "w"))
    from alignnet3d_tpu.cli import main

    main(["train", "--config", cfg_path])
    logdir = root / "runs" / "Api"
    return str(logdir / "config.json"), str(logdir / "model-0.npz"), base


def test_align_contract(trained, rng):
    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    aligner = Aligner.from_checkpoint(config_path, ckpt, batch_size=4)
    pcs1 = [np.load(f"{base}/pointcloud1/{i:08d}.npy") for i in range(6)]
    pcs2 = [np.load(f"{base}/pointcloud2/{i:08d}.npy") for i in range(6)]
    out = aligner.align(pcs1, pcs2)
    assert out["translations"].shape == (6, 3)
    assert out["angles"].shape == (6,)
    assert out["transforms"].shape == (6, 4, 4)
    assert np.all(np.isfinite(out["transforms"]))
    # the transform equals get_mat_angle(t, a, center)
    from alignnet3d_tpu.geometry import get_mat_angle

    M = get_mat_angle(out["translations"][0], out["angles"][0],
                      out["centers"][0])
    np.testing.assert_allclose(M, out["transforms"][0], atol=1e-6)


def test_align_empty_trailing_cloud(trained, rng):
    """An EMPTY cloud at the end of a mixed batch must zero-fill, not crash:
    its gather offset equals len(flat) (ADVICE r2 high finding). Also cover
    empty-first and all-empty batches."""
    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    aligner = Aligner.from_checkpoint(config_path, ckpt, batch_size=4)
    full = rng.normal(size=(5, 3)).astype(np.float32) + [6, 2, 0]
    empty = np.zeros((0, 3), np.float32)
    for pcs in ([full, empty], [empty, full], [empty, empty]):
        out = aligner.align(pcs, [full] * len(pcs))
        assert np.all(np.isfinite(out["transforms"]))
    # internal contract: empty rows come back zeroed
    res = aligner._resample([full, empty])
    assert res.shape[0] == 2
    np.testing.assert_array_equal(res[1], 0.0)


def test_align_refined_improves_or_matches(trained, rng):
    """For identical structured clouds, ICP refinement from the (barely
    trained) network init must not make alignment worse, and with a
    generous radius it should pull close to identity."""
    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    aligner = Aligner.from_checkpoint(config_path, ckpt, batch_size=4)
    # box-surface cloud (structured, so ICP correspondences are meaningful)
    pts = rng.uniform(-1, 1, (400, 3)) * np.array([2.0, 1.0, 0.8])
    axis = rng.integers(0, 3, 400)
    sign = rng.choice([-1.0, 1.0], 400)
    for k, ext in enumerate([2.0, 1.0, 0.8]):
        sel = axis == k
        pts[sel, k] = sign[sel] * ext
    pc = (pts + [6, 2, 0]).astype(np.float32)

    raw = aligner.align([pc], [pc.copy()])
    refined = aligner.align([pc], [pc.copy()], refine_icp=True,
                            icp_radius=4.0)
    err_raw = np.median(np.linalg.norm(
        transform_points(pc, raw["transforms"][0]) - pc, axis=1))
    err_ref = np.median(np.linalg.norm(
        transform_points(pc, refined["transforms"][0]) - pc, axis=1))
    assert err_ref <= err_raw * 1.05 + 1e-6
    assert err_ref < 0.3, (err_raw, err_ref)


def test_voxel_resample_serving(trained, rng):
    """voxel_resample equalizes density at serving time: a 200-point
    coincident cluster stops dominating the kept points, and empty
    clouds stay zeros."""
    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    aligner = Aligner.from_checkpoint(config_path, ckpt, batch_size=4,
                                      voxel_resample=0.1)
    dense = np.zeros((200, 3), np.float32)
    sparse = np.stack([np.arange(1, 11, dtype=np.float32) * 5.0,
                       np.zeros(10, np.float32),
                       np.zeros(10, np.float32)], axis=1)
    cloud = np.concatenate([dense, sparse])
    out = aligner._resample([cloud, np.zeros((0, 3), np.float32)])
    frac_origin = np.mean(np.all(out[0] == 0.0, axis=-1))
    assert frac_origin < 0.3  # uniform would be ~200/210
    assert np.all(out[1] == 0.0)
    # align() still runs end to end through the voxel path
    res = aligner.align([cloud], [cloud])
    assert np.all(np.isfinite(res["transforms"]))


def test_voxel_resample_config_pickup(trained):
    """from_checkpoint adopts data.resample from the run config."""
    import json as _json

    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    cfg = _json.load(open(config_path))
    cfg["data"]["resample"] = {"mode": "voxel", "voxel_size": 0.07}
    vox_cfg = config_path.replace("config.json", "config_vox.json")
    _json.dump(cfg, open(vox_cfg, "w"))
    aligner = Aligner.from_checkpoint(vox_cfg, ckpt)
    assert aligner.voxel_resample == 0.07
    # explicit kwarg wins over the config
    aligner2 = Aligner.from_checkpoint(vox_cfg, ckpt, voxel_resample=None)
    assert aligner2.voxel_resample is None


def test_denoise_serving(trained, rng):
    """data.denoise at serving: a far occluder cluster is dropped before
    resampling (same component filter the training view applies), and
    from_checkpoint adopts the config block (round-4 advisor finding:
    train/serve preprocessing skew)."""
    import json as _json

    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    aligner = Aligner.from_checkpoint(config_path, ckpt, batch_size=4,
                                      denoise=(0.5, "central"))
    target = rng.normal(size=(50, 3)).astype(np.float32) * 0.3 + [6, 2, 0]
    occluder = rng.normal(size=(30, 3)).astype(np.float32) * 0.3 + [20, 9, 0]
    cloud = np.concatenate([target, occluder])
    out = aligner._resample([cloud, np.zeros((0, 3), np.float32)])
    # every kept point comes from the central (target) component
    assert np.all(np.linalg.norm(out[0] - [6, 2, 0], axis=-1) < 3.0)
    assert np.all(out[1] == 0.0)
    res = aligner.align([cloud], [cloud])
    assert np.all(np.isfinite(res["transforms"]))

    # config pickup mirrors the voxel_resample pattern
    cfg = _json.load(open(config_path))
    cfg["data"]["denoise"] = {"cell": 0.4, "keep": "largest"}
    dn_cfg = config_path.replace("config.json", "config_denoise.json")
    _json.dump(cfg, open(dn_cfg, "w"))
    a2 = Aligner.from_checkpoint(dn_cfg, ckpt)
    assert a2.denoise == (0.4, "largest")
    a3 = Aligner.from_checkpoint(dn_cfg, ckpt, denoise=None)
    assert a3.denoise is None


def test_network_refine_gate_zero_is_identity(trained, rng):
    """With an impossible trust region nothing is accepted: the refined
    TRANSFORMS equal the plain ones (re-expressed world-frame, so t/a
    fields differ but the rigid maps must match)."""
    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    pcs1 = [np.load(f"{base}/pointcloud1/{i:08d}.npy") for i in range(5)]
    pcs2 = [np.load(f"{base}/pointcloud2/{i:08d}.npy") for i in range(5)]
    # fresh Aligner per call: the resample RNG is stateful, so pass 1
    # only reproduces from an identical seed position
    plain = Aligner.from_checkpoint(config_path, ckpt,
                                    batch_size=4).align(pcs1, pcs2)
    refined = Aligner.from_checkpoint(config_path, ckpt, batch_size=4).align(
        pcs1, pcs2, network_refine=True, refine_gate=(0.0, 0.0))
    np.testing.assert_allclose(
        refined["transforms"], plain["transforms"], atol=1e-5
    )
    assert np.all(refined["centers"] == 0.0)


def test_network_refine_composes_rigid(trained, rng):
    """Open gate: the composed second-pass transforms stay rigid
    (orthonormal yaw-only rotations) and finite."""
    from alignnet3d_tpu.api import Aligner

    config_path, ckpt, base = trained
    aligner = Aligner.from_checkpoint(config_path, ckpt, batch_size=4)
    pcs1 = [np.load(f"{base}/pointcloud1/{i:08d}.npy") for i in range(5)]
    pcs2 = [np.load(f"{base}/pointcloud2/{i:08d}.npy") for i in range(5)]
    out = aligner.align(pcs1, pcs2, network_refine=True,
                        refine_gate=(180.0, 1e9))
    M = out["transforms"]
    assert np.all(np.isfinite(M))
    R = M[:, :3, :3]
    eye = np.einsum("nij,nkj->nik", R, R)
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (len(M), 1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    # z-axis preserved (yaw-only constraint survives composition)
    np.testing.assert_allclose(R[:, 2, 2], 1.0, atol=1e-6)
