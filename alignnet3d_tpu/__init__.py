"""AlignNet-3D in JAX: fast point-cloud registration on a GPU.

A ground-up rebuild of the capabilities of grossjohannes/AlignNet-3D
(3DV 2019, arXiv:1910.04668):

- jax/XLA compute path: the Siamese PointNet encoder is expressed as large
  batched matmuls; per-sample rotations are batched einsums; everything is
  jit-compiled with static shapes. No hand-written kernels: XLA's own
  fusions and library matmuls run every op.
- SPMD parallelism via ``jax.sharding.Mesh`` + jit shardings
  (``alignnet3d_tpu.parallel``): data parallelism over a ``dp`` axis and
  tensor parallelism of the wide embedding layers over ``mp``. The reference
  has no parallelism machinery at all (single tf.Session on one GPU,
  reference train.py:189).
- On-device batched constrained ICP (``alignnet3d_tpu.icp``) replacing the
  per-sample CPU calls into the forked Open3D C++ library
  (reference icp.py:69-143).

The public API mirrors the reference's layer map (SURVEY.md §1): config,
data provider, model, train/eval driver, metrics, ICP baselines.
"""

__version__ = "0.1.0"

from alignnet3d_tpu.config import load_config, configGlobal, save_config  # noqa: F401
