"""The variable tree, checkpoint format, optional packages, compile cache
and the GPU-only entry points."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "variable_tree.json")


def _run(code_or_args, env=None, cwd=REPO, timeout=300):
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable, *code_or_args])
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    full_env.update(env or {})
    full_env = {k: v for k, v in full_env.items() if v is not None}
    return subprocess.run(args, cwd=cwd, env=full_env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("name,config", [
    ("pointnet", "configs/SynthCars80kCenterSupScratch.json"),
    ("dgcnn", "configs/SynthCars40kDGCNN.json"),
])
def test_variable_tree_matches_golden(name, config):
    """Every variable path and shape is the one checkpoints, the serving
    fold and the sharding rules were written against (recorded from the
    original model definition)."""
    from alignnet3d_tpu.config import config_from_dict
    from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec

    with open(os.path.join(REPO, config)) as f:
        cfg = config_from_dict(json.load(f))
    spec = ModelSpec.from_config(cfg)
    model = AlignNet(spec)
    x = jnp.zeros((2, spec.num_points, 3))
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, x, x,
                           train=False))
    got = {
        col: {"/".join(k.key for k in path): list(leaf.shape)
              for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
        for col, tree in shapes.items()
    }
    with open(GOLDEN) as f:
        assert got == json.load(f)[name]


def _small_state():
    from alignnet3d_tpu.training.state import TrainState

    params = {"a": {"kernel": jnp.arange(6.0).reshape(2, 3)},
              "b": jnp.ones((4,))}
    tx = optax.adam(1e-3)
    return TrainState(step=jnp.asarray(7, jnp.int32), params=params,
                      batch_stats={"bn": {"mean": jnp.zeros((3,))}},
                      opt_state=tx.init(params))


def test_npz_checkpoint_round_trip(tmp_path):
    from alignnet3d_tpu.training.state import TrainState, load_tree, save_tree

    state = _small_state()
    state = state.replace(params=jax.tree.map(lambda x: x + 0.5,
                                              state.params))
    path = str(tmp_path / "model-0.npz")
    save_tree(path, state)
    assert sorted(os.listdir(tmp_path)) == ["model-0.npz"]
    template = jax.tree.map(jnp.zeros_like, state)
    restored = load_tree(path, template)
    assert isinstance(restored, TrainState)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a template without optimizer moments reads params alone
    part = load_tree(path, TrainState(step=None, params=state.params,
                                      batch_stats=None, opt_state=None))
    np.testing.assert_array_equal(part.params["b"], 1.5)
    bad = state.replace(params={**state.params, "b": jnp.ones((5,))})
    with pytest.raises(ValueError, match="shape"):
        load_tree(path, bad)


def test_train_state_is_a_pytree():
    state = _small_state()
    leaves = jax.tree.leaves(state)
    # step + 2 params + 1 stat + adam (count, mu x2, nu x2)
    assert len(leaves) == 1 + 2 + 1 + 5
    doubled = jax.jit(lambda s: jax.tree.map(lambda x: x * 2, s))(state)
    assert type(doubled) is type(state)
    assert int(doubled.step) == 14
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(state)]
    assert ".params['a']['kernel']" in paths


def test_main_path_runs_without_flax_msgpack_tqdm(tmp_path):
    """Blocked optional packages: the entry modules import and one CLI
    training epoch with its eval runs."""
    code = f"""
import json, os, sys
for name in ("flax", "msgpack", "tqdm"):
    sys.modules[name] = None
import alignnet3d_tpu.api, alignnet3d_tpu.cli, alignnet3d_tpu.export
import alignnet3d_tpu.serving, alignnet3d_tpu.training
from alignnet3d_tpu.data.synthetic import generate_dataset
root = {str(tmp_path)!r}
base = os.path.join(root, "data")
generate_dataset(base, num_train=16, num_val=8, seed=5, vres=16, hres=180)
cfg = {{
    "data": {{"basepath": base}},
    "logging": {{"basedir": os.path.join(root, "runs")}},
    "model": {{"num_points": 32, "options": {{
        "s1transformer": [[16, 32], [[32], 0.7]],
        "s2transformer": [[16, 32], [[32], 0.7]],
        "embedding": [16, 64],
        "remaining_transform_prediction": [[32], 0.7]}},
        "angles": {{"num_bins": 8}}}},
    "training": {{"batch_size": 8, "num_epochs": 1}},
}}
path = os.path.join(root, "cfg.json")
json.dump(cfg, open(path, "w"))
alignnet3d_tpu.cli.main(["train", "--config", path])
assert not any(m in sys.modules and sys.modules[m] is not None
               for m in ("flax", "msgpack", "tqdm"))
print("trained")
"""
    proc = _run(code, env={"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("trained")
    assert os.path.isfile(tmp_path / "runs" / "cfg" / "model-0.npz")


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise <repo>/.jax_cache,
    a fixed path (the path is part of the cache key)."""
    want = str(tmp_path / "cache") if env_dir else os.path.join(
        REPO, ".jax_cache")
    code = ("import jax\n"
            "from alignnet3d_tpu.utils import setup_compile_cache\n"
            "print(setup_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    proc = _run(code, env={"JAX_COMPILATION_CACHE_DIR":
                           want if env_dir else None})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == [want, want]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """No GPU, or no repo beside the script: non-zero exit, no ok line."""
    cwd = REPO
    if alone:
        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        cwd = str(tmp_path)
    proc = _run(["chip_smoke.py"], cwd=cwd,
                env={"PYTHONPATH": None} if alone else None)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_bench_refuses_cpu():
    proc = _run(["bench.py"])
    assert proc.returncode == 1
    assert proc.stdout.strip() == ""
    assert "needs a GPU" in proc.stderr
