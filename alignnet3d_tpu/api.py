"""High-level alignment API.

The reference exposes registration only through the train.py CLI; this
module provides the programmatic serving surface:

    from alignnet3d_tpu.api import Aligner

    aligner = Aligner.from_checkpoint("runs/SynthCars/config.json",
                                      "runs/SynthCars/model-199.npz")
    result = aligner.align(list_of_pc1, list_of_pc2, refine_icp=True)
    result["translations"], result["angles"], result["centers"]

Semantics match the eval path exactly: clouds are resampled with
replacement to the model's point count, the yaw is composed as
``decode(pc2) - decode(pc1) + decode(remaining)``, and the returned
translation acts about the returned rotation center
(``geometry.get_mat_angle(t, a, center)`` maps cloud1 onto cloud2).
Optional on-device ICP refinement polishes each pair (world-frame output,
center = origin), like the CLI's ``--refineICP``.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from alignnet3d_tpu.config import config_from_dict
from alignnet3d_tpu.geometry import get_mat_angle
from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu.evaluation.decode import decode_pair_outputs


class Aligner:
    def __init__(self, spec: ModelSpec, variables, batch_size: int = 128,
                 scale_residuals: bool = False, seed: int = 0,
                 voxel_resample: float | None = None,
                 denoise: tuple[float, str] | None = None):
        self.spec = spec
        # frozen at construction: the compiled forward closure-captures
        # this pytree (DESIGN.md §9), so mutating ``aligner.variables``
        # later has NO effect — build a new Aligner to swap weights.
        # Kept as an attribute for introspection only.
        self.variables = variables
        self.batch_size = batch_size
        self.residual_scale = (
            np.pi / spec.num_bins if scale_residuals else 1.0
        )
        # density-equalized serving input (matches training
        # data.resample.mode=voxel; see provider.enable_voxel_resample)
        self.voxel_resample = voxel_resample
        # clutter rejection (cell_m, 'central'|'largest') matching
        # training data.denoise (provider.enable_component_filter) — a
        # model trained on filtered clouds must serve on filtered clouds
        self.denoise = denoise
        self._rng = np.random.default_rng(seed)
        model = AlignNet(spec)
        self._model = model
        # weights are CLOSURE-CAPTURED compile-time constants: XLA folds
        # BN into the convs and bakes layouts — argument-passed weights
        # cost 38% at large batch (DESIGN.md §9)
        self._forward = jax.jit(
            lambda a, b: model.apply(variables, a, b, train=False)
        )
        self._alt_forwards: dict = {}

    def _forward_for(self, variables):
        """Compiled forward for an alternate weight set (e.g. a residual
        refiner), cached per OBJECT IDENTITY — each gets its own
        closure-captured executable (DESIGN.md §9). Pass the SAME pytree
        object across calls: a fresh object with identical contents
        recompiles. The cache is bounded (FIFO, 4 entries) so a caller
        that does churn weight objects leaks recompiles, not memory."""
        if variables is None:
            return self._forward
        key = id(variables)
        if key not in self._alt_forwards:
            while len(self._alt_forwards) >= 4:
                self._alt_forwards.pop(next(iter(self._alt_forwards)))
            model = self._model
            self._alt_forwards[key] = jax.jit(
                lambda a, b: model.apply(variables, a, b, train=False)
            )
        return self._alt_forwards[key]

    @classmethod
    def from_checkpoint(cls, config_path: str, checkpoint_path: str,
                        **kwargs) -> "Aligner":
        """Load from a run's config.json + a model-*.npz snapshot."""
        from alignnet3d_tpu.training.state import TrainState, load_tree

        with open(config_path) as f:
            cfg = config_from_dict(json.load(f))
        spec = ModelSpec.from_config(cfg)
        model = AlignNet(spec)
        dummy = jnp.zeros((2, spec.num_points, 3), jnp.float32)
        variables = model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            dummy, dummy, train=False,
        )
        # checkpoints store the full TrainState; read only what serving
        # needs (no optimizer moments)
        state = load_tree(checkpoint_path, TrainState(
            step=None, params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=None))
        variables = {"params": state.params,
                     "batch_stats": state.batch_stats}
        scale = bool(
            cfg.evaluation.has("scale_residuals")
            and cfg.evaluation.scale_residuals
        )
        # a model trained with density-equalized inputs serves with them
        if ("voxel_resample" not in kwargs
                and cfg.data.has("resample")
                and cfg.data.resample.mode == "voxel"):
            kwargs["voxel_resample"] = (
                cfg.data.resample.voxel_size
                if cfg.data.resample.has("voxel_size") else 0.05
            )
        # likewise a model trained with data.denoise clutter filtering
        # (trainer.py enable_component_filter) serves with the same filter
        if "denoise" not in kwargs and cfg.data.has("denoise"):
            kwargs["denoise"] = (
                cfg.data.denoise.cell
                if cfg.data.denoise.has("cell") else 0.5,
                cfg.data.denoise.keep
                if cfg.data.denoise.has("keep") else "central",
            )
        return cls(spec, variables, scale_residuals=scale, **kwargs)

    def _resample(self, clouds: Sequence[np.ndarray]) -> np.ndarray:
        """Uniform resample-with-replacement to the model point count,
        vectorized over the batch: one RNG draw + one gather instead of a
        per-cloud loop (the loop dominated large-batch serving latency,
        docs/RESULTS.md p50 table)."""
        n = self.spec.num_points
        m = len(clouds)
        arrs = [np.asarray(c, np.float32).reshape(-1, np.shape(c)[-1]
                                                  if np.ndim(c) > 1 else 3)
                for c in clouds]
        lens = np.fromiter((len(a) for a in arrs), np.int64, m)
        total = int(lens.sum())
        if total == 0:
            return np.zeros((m, n, 3), np.float32)
        flat = np.concatenate([a[:, :3] for a in arrs if len(a)])
        if self.denoise is not None:
            # same per-cloud component filter the training view applies
            # (data/denoise.py) — train/serve preprocessing must match
            from alignnet3d_tpu.data.denoise import component_filter_indices

            cid = np.repeat(np.arange(m, dtype=np.int64), lens)
            kept = component_filter_indices(flat, cid, *self.denoise)
            flat = flat[kept]
            lens = np.bincount(cid[kept], minlength=m).astype(np.int64)
            total = int(lens.sum())
            if total == 0:
                return np.zeros((m, n, 3), np.float32)
        if self.voxel_resample:
            # one representative per occupied voxel per cloud, so dense
            # near-range panels stop dominating the kept points (the SAME
            # dedup implementation the training-side view uses —
            # provider.voxel_dedup_indices — computed per call since
            # serving inputs are not cacheable)
            from alignnet3d_tpu.data.provider import voxel_dedup_indices

            cid = np.repeat(np.arange(m, dtype=np.int64), lens)
            first = voxel_dedup_indices(flat, cid, self.voxel_resample)
            flat = flat[first]
            lens = np.bincount(cid[first], minlength=m).astype(np.int64)
            total = int(lens.sum())
        offs = np.zeros(m, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        # scale one uniform block by per-cloud lengths (empty -> index 0,
        # zeroed below — reference provider.py:95-96 empty-cloud behavior)
        idx = (self._rng.random((m, n)) * lens[:, None]).astype(np.int64)
        idx = np.minimum(idx, np.maximum(lens - 1, 0)[:, None])
        # clamp gathered indices: an EMPTY cloud that is not the first has
        # offs == its successor's start (== len(flat) when it is last),
        # which would index out of bounds; its rows are zeroed below anyway
        gather = np.minimum((idx + offs[:, None]).ravel(), total - 1)
        out = flat[gather].reshape(m, n, 3)
        if (lens == 0).any():
            out[lens == 0] = 0.0
        return np.ascontiguousarray(out, np.float32)

    def _predict(self, pcs1, pcs2, resolve_flips: bool,
                 variables=None):
        """One forward sweep over all pairs: resample, batch, decode.
        Returns (translations (N,3), angles (N,), centers (N,3))."""
        n = len(pcs1)
        nb = self.spec.num_bins
        bs = self.batch_size
        forward = self._forward_for(variables)
        translations = np.empty((n, 3), np.float32)
        angles = np.empty(n, np.float32)
        centers = np.empty((n, 3), np.float32)

        for s in range(0, n, bs):
            e = min(s + bs, n)
            a = self._resample(pcs1[s:e])
            b = self._resample(pcs2[s:e])
            pad = bs - (e - s)
            if pad:
                a = np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                b = np.concatenate([b, np.repeat(b[-1:], pad, 0)])
            out = jax.device_get(
                forward(jnp.asarray(a), jnp.asarray(b))
            )
            k = e - s
            dec = decode_pair_outputs(
                out, a, b, nb, self.residual_scale,
                resolve_flips=resolve_flips, n=k)
            translations[s:e] = dec.translations
            angles[s:e] = dec.angles
            centers[s:e] = dec.s2_pc1centers
        return translations, angles, centers

    def align(self, pcs1: Sequence[np.ndarray], pcs2: Sequence[np.ndarray],
              refine_icp: bool = False, icp_its: int = 30,
              icp_radius: float = 0.1, resolve_flips: bool = False,
              network_refine: bool = False,
              refine_gate: tuple = (2.0, 0.15),
              refine_variables=None):
        """Align pairs of raw clouds. Returns dict with ``translations``
        (N, 3), ``angles`` (N,), ``centers`` (N, 3) and ``transforms``
        (N, 4, 4). ``resolve_flips`` settles the 180-degree yaw ambiguity
        of accept_inverted_angle models by on-device chamfer comparison.

        ``network_refine`` runs a SECOND forward pass on the coarsely
        aligned pair and composes the correction, accepted per pair only
        inside the ``refine_gate`` trust region (max |dyaw| deg,
        max |dxy| m) — strictly better than one pass on every accuracy
        bucket (docs/RESULTS.md "Iterative network refinement"; mirrors
        the eval path's evaluation.network_refine).
        ``refine_variables`` optionally swaps in a residual-task
        fine-aligner's weights (data/residual.py) for the second pass.
        ICP refinement stacks on top when both are requested."""
        assert len(pcs1) == len(pcs2)
        n = len(pcs1)
        translations, angles, centers = self._predict(
            pcs1, pcs2, resolve_flips
        )

        if network_refine and n:
            from alignnet3d_tpu.geometry import (
                compose_gated_refinement,
                get_mat_angle_batch,
                transform_points,
            )

            M1 = get_mat_angle_batch(translations, angles, centers)
            pcs1_t = [
                transform_points(np.asarray(p, np.float32)[:, :3], M1[i])
                if len(p) else p
                for i, p in enumerate(pcs1)
            ]
            t2, a2, c2 = self._predict(
                pcs1_t, pcs2, resolve_flips, variables=refine_variables
            )
            M, _ = compose_gated_refinement(
                M1, t2, a2, c2, refine_gate[0], refine_gate[1]
            )
            translations = M[:, :3, 3].astype(np.float32)
            angles = np.arctan2(M[:, 1, 0], M[:, 0, 0]).astype(np.float32)
            centers = np.zeros_like(centers)

        if refine_icp:
            from alignnet3d_tpu.icp.p2point import icp_p2point_batch

            n_max = max(max((len(p) for p in pcs1), default=1),
                        max((len(p) for p in pcs2), default=1))
            n_max = min(n_max, 4096)

            def pad_set(clouds):
                arr = np.zeros((n, n_max, 3), np.float32)
                msk = np.zeros((n, n_max), bool)
                for i, pc in enumerate(clouds):
                    pc = np.asarray(pc, np.float32)[:, :3]
                    if len(pc) > n_max:
                        pick = self._rng.choice(len(pc), n_max, replace=False)
                        pc = pc[pick]
                    arr[i, : len(pc)] = pc
                    msk[i, : len(pc)] = True
                return arr, msk

            src, sm = pad_set(pcs1)
            dst, dm = pad_set(pcs2)
            init = np.stack([
                get_mat_angle(translations[i], angles[i],
                              rotation_center=centers[i])
                for i in range(n)
            ])
            tf, _, _ = icp_p2point_batch(
                src, sm, dst, dm, init, radius=icp_radius, its=icp_its
            )
            translations = tf[:, :3, 3].astype(np.float32)
            angles = np.arctan2(tf[:, 1, 0], tf[:, 0, 0]).astype(np.float32)
            centers = np.zeros_like(centers)

        transforms = np.stack([
            get_mat_angle(translations[i], angles[i],
                          rotation_center=centers[i])
            for i in range(n)
        ])
        return {
            "translations": translations,
            "angles": angles,
            "centers": centers,
            "transforms": transforms,
        }
