"""Train/eval driver — the equivalent of reference train.py.

Semantics preserved from the reference (train.py:187-545):
- staircase LR decay with 1e-5 floor, Adam/Momentum optimizers;
- scheduled BN momentum fed into the EMA BatchNorm each step;
- per-epoch: shuffled drop-remainder training epoch, then a FULL val-set
  eval producing eval.json + eval_180.json and the 8 pred_*.npy artifacts;
- checkpoint cadence: rolling ``model.ckpt`` every 2 epochs, numbered
  ``model-<E>`` every 5 / every epoch if evaluation.save_every_epoch / last;
- auto-resume from the rolling checkpoint with epoch-alignment assertion;
- transfer learning: restore everything except the step counter from
  ``training.pretraining.model``, then an initial eval tagged 'pretr';
- eval-time prediction composition: angle = decode(pc2) - decode(pc1) +
  decode(remaining) with the reference's unscaled-residual decoder;
- timing mode: 10 repeats at batch size 32 reporting per-sample latency.

Changes from the reference:
- ONE jit-compiled train step with donated state; input jitter runs on
  device (jax.random) instead of host numpy;
- batches come from the PackedDataset + background prefetch (the reference
  does per-sample file IO inside the step loop, SURVEY.md §3.1);
- eval pads the final partial batch to keep XLA shapes static and trims
  on host (the reference feeds a stale-tail batch, train.py:432-451);
- SPMD via the ('dp','mp') mesh: batch sharded over dp, wide layers over
  mp; XLA inserts gradient psums (parallel/mesh.py);
- checkpoints are .npz snapshots of the full TrainState (params, BN
  stats, optimizer moments, step; training/state.py) — same dual-cadence
  scheme.
- scalar metrics go to JSONL event files (train/val/val_180) instead of
  TensorBoard protobufs; same tags, greppable.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import time
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from alignnet3d_tpu.data import provider
from alignnet3d_tpu.evaluation import metrics as evaluation
from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu.models.losses import LossSpec, get_loss
from alignnet3d_tpu.evaluation.decode import decode_pair_outputs
from alignnet3d_tpu.parallel import mesh as meshlib
from alignnet3d_tpu.parallel import multihost
from alignnet3d_tpu.training import schedules
from alignnet3d_tpu.training.state import (
    CHECKPOINT_SUFFIX,
    TrainState,
    load_tree,
    save_tree,
)

logger = logging.getLogger("alignnet3d_tpu")


def setup_logging(logdir: str):
    """stdout + DEBUG file log with timestamp-suffixed rollover
    (reference train.py:84-111)."""
    os.makedirs(logdir, exist_ok=True)
    root = logging.getLogger("alignnet3d_tpu")
    root.setLevel(logging.DEBUG)
    root.handlers = [h for h in root.handlers if not isinstance(
        h, (logging.StreamHandler, logging.FileHandler))]
    fmt = logging.Formatter(
        "%(asctime)s %(name)-12s %(levelname)-8s %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    logfile = f"{logdir}/out.log"
    if os.path.exists(logfile):
        datestr = datetime.datetime.today().strftime("%Y-%m-%d_%H-%M-%S")
        logfile = f"{logfile[:-4]}_{datestr}.log"
    fh = logging.FileHandler(logfile)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(fmt)
    root.addHandler(fh)


class progress:
    """Iterate ``iterable``, logging ``done/total`` with the rate every
    ``interval`` seconds at INFO, and once more at DEBUG when the loop
    ends or ``close()`` is called, so the final throughput lands in
    out.log (reference train.py:114-126 logged its progress bar's final
    stats)."""

    def __init__(self, iterable, desc: str = "", total=None,
                 interval: float = 60.0):
        self.iterable = iterable
        self.desc = desc
        self.total = total
        self.interval = interval
        self.n = 0
        self._start = time.time()
        self._closed = False

    def _line(self) -> str:
        elapsed = time.time() - self._start
        rate = self.n / elapsed if elapsed > 0 else 0.0
        total = "?" if self.total is None else self.total
        return (f"{self.desc}: {self.n}/{total} "
                f"[{elapsed:.1f}s, {rate:.2f} it/s]")

    def __iter__(self):
        last = self._start
        try:
            for item in self.iterable:
                yield item
                self.n += 1
                now = time.time()
                if now - last >= self.interval:
                    last = now
                    logger.info("progress %s", self._line())
        finally:
            self.close()

    def close(self):
        if not self._closed:
            self._closed = True
            logger.debug("progress %s", self._line())


class ScalarWriter:
    """JSONL scalar event writer — the TB-summary equivalent
    (tags match reference train.py:517-531)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path

    def write(self, step: int, scalars: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), **{
                k: float(v) for k, v in scalars.items()
            }}) + "\n")

    def write_rows(self, steps, stacked: dict):
        """One JSONL row per step from a dict of equal-length arrays.

        Matches the reference's per-step train summaries (train.py:368)
        without per-step host syncs: the caller stacks device scalars for
        the whole epoch and flushes them here in one readback.
        """
        keys = list(stacked)
        with open(self.path, "a") as f:
            for i, step in enumerate(steps):
                f.write(json.dumps({"step": int(step), **{
                    k: float(stacked[k][i]) for k in keys
                }}) + "\n")


def cascade_stage_kwargs(base_kwargs: dict, stage: dict) -> dict:
    """Per-stage refine_predictions kwargs for one cascade stage dict
    ({radius?, max_dyaw_deg?, max_dxy?}). A stage that sets its own trust
    region implies gating for that stage — otherwise stage-level
    max_dyaw_deg / max_dxy would be silently dead whenever the global
    evaluation.refinement_gate is disabled."""
    kwargs = dict(base_kwargs)
    if "radius" in stage:
        kwargs["radius"] = stage["radius"]
    if "method" in stage:
        kwargs["method"] = stage["method"]
    for src, dst in (("max_dyaw_deg", "gate_max_dyaw_deg"),
                     ("max_dxy", "gate_max_dxy")):
        if src in stage:
            kwargs[dst] = stage[src]
            kwargs["gate"] = True
    return kwargs


@dataclasses.dataclass
class Trainer:
    cfg: Any
    seed: int = 0
    use_mesh: bool | None = None  # None = auto (mesh if >1 device configured)

    def __post_init__(self):
        cfg = self.cfg
        self.spec = ModelSpec.from_config(cfg)
        self.loss_spec = LossSpec.from_config(cfg)
        self.model = AlignNet(self.spec)
        self.logdir = cfg.logging.logdir
        self.batch_size = cfg.training.batch_size

        self.train_indices = provider.getDataFiles(
            f"{cfg.data.basepath}/split/train.txt"
        )
        self.val_indices = provider.getDataFiles(
            f"{cfg.data.basepath}/split/val.txt"
        )
        self.num_batches_per_epoch = len(self.train_indices) // self.batch_size
        self.dataset = provider.PackedDataset(cfg.data.basepath)
        # framework addition: clutter rejection (data.denoise = {"cell":
        # 0.5, "keep": "central"|"largest"}, data/denoise.py) — must
        # precede the voxel view (provider.enable_component_filter)
        if cfg.data.has("denoise"):
            self.dataset.enable_component_filter(
                cfg.data.denoise.cell
                if cfg.data.denoise.has("cell") else 0.5,
                cfg.data.denoise.keep
                if cfg.data.denoise.has("keep") else "central",
            )
        # framework addition: density-equalized resampling (data.resample
        # = {"mode": "voxel", "voxel_size": 0.05}); default is the
        # reference's uniform resample-with-replacement (provider.py:97-98)
        if cfg.data.has("resample") and cfg.data.resample.mode == "voxel":
            self.dataset.enable_voxel_resample(
                cfg.data.resample.voxel_size
                if cfg.data.resample.has("voxel_size") else 0.05
            )

        # pod-scale: if jax.distributed was initialized (parallel/multihost),
        # this process owns 1/num_processes of every batch; the mesh below
        # spans ALL hosts' devices (jax.devices() is global after init)
        self.num_processes = jax.process_count()
        self.process_index = jax.process_index()
        self.is_main_process = self.process_index == 0
        if self.num_processes > 1:
            assert self.batch_size % self.num_processes == 0, (
                f"batch_size {self.batch_size} must divide over "
                f"{self.num_processes} processes"
            )
        self.local_batch_size = self.batch_size // self.num_processes

        mesh_cfg = cfg.tpu.mesh if cfg.has("tpu") else None
        dp = mesh_cfg.dp if mesh_cfg else -1
        mp = mesh_cfg.mp if mesh_cfg else 1
        if dp == -1:
            dp = max(1, len(jax.devices()) // max(1, mp))
        dp = meshlib.choose_dp(dp, self.batch_size, self.num_processes)
        if self.num_processes > 1:
            mesh_devices = meshlib.balanced_process_devices(
                jax.devices(), dp, mp, self.num_processes
            )
            self.mesh = meshlib.make_mesh(dp=dp, mp=mp,
                                          devices=mesh_devices)
        else:
            self.mesh = meshlib.make_mesh(dp=dp, mp=mp)
        if self.use_mesh is None:
            self.use_mesh = self.mesh.devices.size > 1
        if self.num_processes > 1:
            assert self.use_mesh, "multi-process training requires the mesh"
            assert dp % self.num_processes == 0, (
                f"dp={dp} must distribute over {self.num_processes} processes"
            )

        self.tx = self._make_optimizer()
        self._jit_cache: dict = {}
        self._data_rng = np.random.default_rng(self.seed + 1)
        self._jit_rng = jax.random.PRNGKey(self.seed + 2)
        from alignnet3d_tpu.data.residual import params_from_config

        self._residual_params = params_from_config(cfg)

    # ------------------------------------------------------------- building

    def _make_optimizer(self):
        cfg = self.cfg
        nbpe = max(1, self.num_batches_per_epoch)
        lr_fn = lambda count: schedules.learning_rate(  # noqa: E731
            jnp.asarray(count), cfg, nbpe
        )
        name = cfg.training.optimizer.optimizer
        if name == "adam":
            return optax.adam(learning_rate=lr_fn)
        if name == "momentum":
            return optax.sgd(learning_rate=lr_fn,
                             momentum=cfg.training.optimizer.momentum)
        raise ValueError(f"Invalid optimizer {name!r}")

    def init_state(self) -> TrainState:
        rng = jax.random.PRNGKey(self.seed)
        pcs = jnp.zeros((2, self.spec.num_points, 3), jnp.float32)
        variables = self.model.init(
            {"params": rng, "dropout": jax.random.PRNGKey(self.seed + 7)},
            pcs, pcs, train=False,
        )
        params = variables["params"]
        state = TrainState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=variables["batch_stats"],
            opt_state=self.tx.init(params),
        )
        return self._place_state(state)

    def _place_state(self, state: TrainState) -> TrainState:
        """Multi-process: host-local state must be explicitly placed onto
        the global mesh shardings before jit can consume it (single-process
        jit reshards addressable inputs automatically)."""
        if self.num_processes > 1:
            state = jax.device_put(
                state, meshlib.state_shardings(state, self.mesh)
            )
        return state

    # ------------------------------------------------------------ jitted fns

    def _train_step_fn(self, state: TrainState, batch, rng):
        cfg = self.cfg
        nbpe = max(1, self.num_batches_per_epoch)
        pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2 = batch
        bn_m = schedules.bn_decay(state.step, cfg, nbpe)
        lr = schedules.learning_rate(state.step, cfg, nbpe)

        j1, j2, drop = jax.random.split(rng, 3)
        # device-side jitter, distribution of reference provider.py:60-71
        pcs1 = pcs1 + jnp.clip(
            0.01 * jax.random.normal(j1, pcs1.shape), -0.05, 0.05
        )
        pcs2 = pcs2 + jnp.clip(
            0.01 * jax.random.normal(j2, pcs2.shape), -0.05, 0.05
        )

        def loss_fn(params):
            out, mutated = self.model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                pcs1, pcs2, train=True, momentum=bn_m,
                mutable=["batch_stats"], rngs={"dropout": drop},
            )
            loss, aux = get_loss(
                pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2, out,
                spec=self.loss_spec,
            )
            return loss, (aux, mutated["batch_stats"])

        (loss, (aux, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        updates, new_opt_state = self.tx.update(
            grads, state.opt_state, state.params
        )
        new_params = optax.apply_updates(state.params, updates)
        new_state = state.replace(
            step=state.step + 1,
            params=new_params,
            batch_stats=new_stats,
            opt_state=new_opt_state,
        )
        metrics = {
            "losses/loss": loss,
            "hyperparameters/learning_rate": lr,
            "hyperparameters/bn_decay": bn_m,
            **aux,
        }
        return new_state, metrics

    def _train_multi_step_fn(self, state: TrainState, batches, rngs):
        """K sequential optimizer steps in ONE device dispatch.

        ``batches`` is the usual 8-tuple with a leading steps axis
        (K, B, ...) and ``rngs`` a (K,)-stacked key array; a lax.scan
        over the K slices reproduces the single-step path's semantics
        exactly (per-step schedules read state.step inside, the rng
        stream is the same keys the K=1 loop would have drawn). It
        amortizes the fixed per-dispatch host cost over K steps; whether
        that pays on a given device is unmeasured, so it stays off.
        Enabled via ``tpu.steps_per_dispatch`` > 1."""
        def body(st, xs):
            batch, rng = xs
            return self._train_step_fn(st, batch, rng)

        return jax.lax.scan(body, state, (batches, rngs))

    def _eval_step_fn(self, state: TrainState, batch):
        pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2 = batch
        out = self.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            pcs1, pcs2, train=False,
        )
        loss, _ = get_loss(
            pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2, out,
            spec=self.loss_spec,
        )
        return loss, out

    def _get_jitted(self, name: str):
        if name in self._jit_cache:
            return self._jit_cache[name]
        if self.use_mesh:
            if "state_shardings" not in self._jit_cache:
                dummy = self.init_state()
                self._jit_cache["state_shardings"] = meshlib.state_shardings(
                    dummy, self.mesh
                )
                del dummy
            st_shard = self._jit_cache["state_shardings"]
            b_shard = meshlib.batch_sharding(self.mesh)
            rep = meshlib.replicated(self.mesh)
            batch_shards = (b_shard,) * 8
            if name == "train_multi":
                # built lazily: only tpu.steps_per_dispatch>1 runs pay
                # its compile
                mb_shards = (meshlib.multi_batch_sharding(self.mesh),) * 8
                self._jit_cache["train_multi"] = jax.jit(
                    self._train_multi_step_fn,
                    in_shardings=(st_shard, mb_shards, rep),
                    out_shardings=(st_shard, rep),
                    donate_argnums=(0,),
                )
                return self._jit_cache["train_multi"]
            train = jax.jit(
                self._train_step_fn,
                in_shardings=(st_shard, batch_shards, rep),
                out_shardings=(st_shard, rep),
                donate_argnums=(0,),
            )
            evalf = jax.jit(
                self._eval_step_fn,
                in_shardings=(st_shard, batch_shards),
                out_shardings=(rep, rep),
            )
        else:
            if name == "train_multi":
                self._jit_cache["train_multi"] = jax.jit(
                    self._train_multi_step_fn, donate_argnums=(0,)
                )
                return self._jit_cache["train_multi"]
            train = jax.jit(self._train_step_fn, donate_argnums=(0,))
            evalf = jax.jit(self._eval_step_fn)
        self._jit_cache["train"] = train
        self._jit_cache["eval"] = evalf
        return self._jit_cache[name]

    # ---------------------------------------------------------- checkpoints

    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.logdir, f"{name}{CHECKPOINT_SUFFIX}")

    def save_checkpoint(self, state: TrainState, name: str):
        # allgather is a collective: every process participates, only
        # process 0 touches the filesystem
        state = multihost.fully_replicate(state)
        path = self._ckpt_path(name)
        if not self.is_main_process:
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_tree(path, state)
        logger.info(f"Model saved in file: {path}")
        return path

    def restore_checkpoint(self, state: TrainState, path: str,
                           except_step: bool = False) -> TrainState:
        # collective: every process participates. Only process 0 needs the
        # checkpoint bytes on disk (no shared-FS assumption on real pods);
        # the restored host tree is broadcast from process 0.
        template = multihost.fully_replicate(state)
        if self.num_processes <= 1 or self.is_main_process:
            restored = load_tree(path, template)
        else:
            restored = template
        if self.num_processes > 1:
            restored = multihost.broadcast_tree(restored, template)
        if except_step:
            restored = restored.replace(step=template.step)
        if self.num_processes > 1:
            return self._place_state(restored)
        return jax.device_put(restored)

    # ------------------------------------------------------------- epochs

    def _make_batch(self, indices, rng: np.random.Generator | None = None):
        rng = self._data_rng if rng is None else rng
        batch = self.dataset.sample_batch(
            indices, self.spec.num_points, rng,
        )
        if self._residual_params is not None:
            # residual-alignment task (data.residual_task): pre-align pc1
            # by gt composed with a small sampled residual — trains a
            # learned fine-aligner (data/residual.py)
            from alignnet3d_tpu.data.residual import apply_residual_task

            batch = apply_residual_task(batch, rng, **self._residual_params)
        return batch

    def _epoch_rng(self, *tags) -> np.random.Generator:
        """Fresh child generator per epoch: (a) the prefetch worker thread
        owns it exclusively, so an aborted epoch (NaN guard) can't leave a
        shared generator mid-stream (VERDICT r2 weak #6); (b) every process
        derives the same stream from (seed, tags), so multi-host shuffles
        agree without communication."""
        ints = [self.seed]
        for t in tags:
            try:
                ints.append(int(t))
            except (TypeError, ValueError):  # string epoch tags ('pretr', ...)
                ints.extend(str(t).encode("utf8"))
        return np.random.default_rng(np.random.SeedSequence(ints))

    def _next_rng(self):
        self._jit_rng, sub = jax.random.split(self._jit_rng)
        return sub

    def _network_refine_pass(self, state, eval_fn, P, val_idxs,
                             batch_size, residual_scale, net_ref,
                             resolve_flips: bool = True,
                             iteration: int = 0):
        """Second forward pass on the coarsely aligned pair
        (evaluation.network_refine): transform pc1 by the first pass's
        composed transform, re-predict, compose dM @ M1, and accept the
        update per pair only inside a trust region (|da| <= gate
        max_dyaw_deg, |dxy| <= max_dxy) — an out-of-basin second pass
        must not throw away a good init (same rationale as the ICP
        gate, icp/p2point.py:248-261).

        Rewrites P's final transform in world frame (rotation center
        zero, like ICP refinement — reference train.py:483-484); the
        s1/s2 diagnostic arrays keep the FIRST pass's values. Optional
        ``weights`` key: a checkpoint path (no .npz suffix, like
        training.pretraining.model) of a residual-task fine-aligner
        (data/residual.py) to use for the second pass.
        """
        from alignnet3d_tpu.geometry import (
            compose_gated_refinement,
            get_mat_angle_batch,
        )

        n = len(val_idxs)
        nb = self.spec.num_bins
        gate = net_ref.gate if net_ref.has("gate") else None
        gate_deg = (gate.max_dyaw_deg
                    if gate is not None and gate.has("max_dyaw_deg")
                    else 2.0)
        gate_xy = (gate.max_dxy
                   if gate is not None and gate.has("max_dxy") else 0.15)
        # the residual-task rewrite must not be re-applied to the refine
        # batches (it would compose a SECOND random pre-alignment on top
        # of M1); network_refine composes its own
        assert self._residual_params is None, (
            "evaluation.network_refine and data.residual_task are "
            "mutually exclusive in one config — point network_refine at "
            "the residual-trained weights instead (weights key)"
        )
        refine_state = state
        if net_ref.has("weights") and net_ref.weights:
            # cache: during training this pass runs every eval epoch
            cached = getattr(self, "_refine_state_cache", None)
            if cached is not None and cached[0] == net_ref.weights:
                refine_state = cached[1]
            else:
                refine_state = self.restore_checkpoint(
                    self.init_state(), net_ref.weights + CHECKPOINT_SUFFIX
                )
                self._refine_state_cache = (net_ref.weights, refine_state)
        M1 = get_mat_angle_batch(
            P["pred_translations"], P["pred_angles"][:, 0],
            P["pred_s2_pc1centers"],
        )
        # distinct fixed stream per pass (pass 1 of the eval loop is (2))
        rng = self._epoch_rng(2, 1 + iteration)
        t2 = np.empty((n, 3), np.float32)
        a2 = np.empty(n, np.float64)
        c2 = np.empty((n, 3), np.float32)
        num_batches = int(np.ceil(n / batch_size))
        for bi in range(num_batches):
            s, e = bi * batch_size, min((bi + 1) * batch_size, n)
            take = val_idxs[s:e] + [val_idxs[0]] * (batch_size - (e - s))
            batch = self._make_batch(take, rng=rng)
            pc1 = np.asarray(batch[0])
            Mb = M1[s:e]
            if len(pc1) > e - s:
                Mb = np.concatenate(
                    [Mb, np.tile(np.eye(4), (len(pc1) - (e - s), 1, 1))]
                )
            pc1 = (np.einsum("bij,bnj->bni",
                             Mb[:, :3, :3].astype(np.float32), pc1)
                   + Mb[:, None, :3, 3].astype(np.float32))
            # empty clouds stay zero (reference provider.py:95-96)
            empty = ~np.any(np.asarray(batch[0]) != 0.0, axis=(1, 2))
            pc1[empty] = 0.0
            _, out = eval_fn(refine_state,
                             (pc1.astype(np.float32),) + tuple(batch[1:]))
            out = jax.device_get(out)
            # same decode policy as pass 1 (cfg.evaluation.resolve_flips)
            # — mixing policies would let the mod-pi gate accept pi-sized
            # "corrections"
            dec = decode_pair_outputs(
                out, pc1, batch[1], nb, residual_scale,
                resolve_flips=resolve_flips, n=e - s)
            t2[s:e] = dec.translations
            a2[s:e] = dec.angles
            c2[s:e] = dec.s2_pc1centers
        M, ok = compose_gated_refinement(M1, t2, a2, c2, gate_deg, gate_xy)
        logger.info(
            f"network refine: accepted {int(ok.sum())}/{n} "
            f"(gate {gate_deg} deg / {gate_xy} m)"
        )
        P["pred_translations"] = M[:, :3, 3].astype(np.float32)
        P["pred_angles"] = np.arctan2(
            M[:, 1, 0], M[:, 0, 0]
        ).astype(np.float32).reshape(n, 1)
        P["pred_s2_pc1centers"] = np.zeros((n, 3), np.float32)
        return P

    def train_one_epoch(self, state: TrainState, epoch: int,
                        writer: ScalarWriter):
        """Shuffled drop-remainder epoch (reference train.py:335-383).

        Aux subsystems beyond the reference (SURVEY.md §5):
        - ``tpu.profile.dir`` captures a jax.profiler trace of the first
          ``tpu.profile.steps`` steps of epoch 0;
        - a NaN guard aborts the run with a clear message instead of
          silently training on garbage (the last checkpoint remains on
          disk for recovery).
        """
        train_fn = self._get_jitted("train")
        epoch_rng = self._epoch_rng(1, epoch)
        idxs = np.asarray(self.train_indices).copy()
        epoch_rng.shuffle(idxs)
        num_batches = len(idxs) // self.batch_size
        if self.num_processes > 1:
            # per-process shard of the (identically shuffled) epoch order;
            # each process assembles only its own rows of each global batch
            idxs = np.asarray(provider.PackedDataset.shard_indices(
                idxs, self.process_index, self.num_processes
            ))
        step_bs = self.local_batch_size
        prefetch = self.cfg.tpu.prefetch_batches if self.cfg.has("tpu") else 2

        profile_cfg = (
            self.cfg.tpu.profile
            if self.cfg.has("tpu") and self.cfg.tpu.has("profile") else None
        )
        profile_steps = (
            profile_cfg.steps if profile_cfg and epoch == 0 else 0
        )

        def make(i):
            batch = self._make_batch(
                idxs[i * step_bs:(i + 1) * step_bs], rng=epoch_rng
            )
            if self.num_processes > 1:
                batch = multihost.global_batch(
                    self.mesh, batch, self.batch_size
                )
            return batch

        # steps-per-dispatch: amortize the per-dispatch host cost over K
        # optimizer steps (lax.scan inside one jit — _train_multi_step_fn).
        # Single-process only: the stacked (K, B, ...) host assembly does
        # not compose with multihost.global_batch's per-process shards.
        k_steps = (
            self.cfg.tpu.steps_per_dispatch
            if self.cfg.has("tpu") and self.cfg.tpu.has("steps_per_dispatch")
            else 1
        )
        if self.num_processes > 1 and k_steps > 1:
            logger.info("tpu.steps_per_dispatch ignored under multi-process")
            k_steps = 1
        k_steps = max(1, min(int(k_steps), max(num_batches, 1)))

        if k_steps > 1:
            train_fn = self._get_jitted("train_multi")
            # full-K chunks plus at most one remainder chunk: the two
            # shapes each compile once per process, every epoch reuses
            chunk_sizes = [
                min(k_steps, num_batches - s)
                for s in range(0, num_batches, k_steps)
            ]
            chunk_offsets = np.cumsum([0] + chunk_sizes[:-1])

            def make_dispatch(j):
                rows = [make(int(chunk_offsets[j]) + t)
                        for t in range(chunk_sizes[j])]
                return tuple(
                    np.stack([r[a] for r in rows]) for a in range(8)
                )

            num_dispatches = len(chunk_sizes)
        else:
            make_dispatch = make
            num_dispatches = num_batches

        step_metrics = []  # dicts of device scalars — no per-step host sync
        profiling = False
        for batch_idx, batch in enumerate(progress(
            provider.PrefetchIterator(make_dispatch, num_dispatches, prefetch),
            desc=f"train epoch {epoch}", total=num_dispatches,
        )):
            if profile_steps and batch_idx == 1:  # skip compile step
                jax.profiler.start_trace(profile_cfg.dir)
                profiling = True
            if k_steps > 1:
                rngs = jnp.stack(
                    [self._next_rng() for _ in range(batch[0].shape[0])]
                )
                state, metrics = train_fn(state, batch, rngs)
            else:
                state, metrics = train_fn(state, batch, self._next_rng())
            step_metrics.append(metrics)
            if profiling and batch_idx + 1 >= 1 + profile_steps:
                jax.profiler.stop_trace()
                profiling = False
                logger.info(f"profiler trace written to {profile_cfg.dir}")
        if profiling:
            jax.profiler.stop_trace()
        # single readback per epoch: a per-step float() would make the
        # host wait for the device every step
        if step_metrics:
            stacked = jax.device_get(jax.tree.map(
                (lambda *xs: jnp.concatenate(xs)) if k_steps > 1
                else (lambda *xs: jnp.stack(xs)),
                *step_metrics,
            ))
            loss_vals = np.asarray(stacked["losses/loss"])
            bad = ~np.isfinite(loss_vals)
            if bad.any():
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} step "
                    f"{int(np.argmax(bad))} (value "
                    f"{loss_vals[np.argmax(bad)]}); last good checkpoint is "
                    f"in {self.logdir}"
                )
            # per-step scalar rows, like the reference's per-step train
            # summaries (train.py:368, tp8.py:336-353)
            final_step = int(jax.device_get(state.step))
            base = final_step - num_batches
            if self.is_main_process:
                writer.write_rows(range(base + 1, final_step + 1), stacked)
            logger.info(
                "train mean loss: %f" % (float(loss_vals.sum()) / num_batches)
            )
        return state

    def eval_one_epoch(self, state: TrainState, epoch, eval_only: bool,
                       do_timings: bool = False, override_batch_size=None,
                       refine_icp: bool = False, icp_its: int = 30,
                       icp_method: str = "p2p",
                       use_old_results: bool = False,
                       val_writer: ScalarWriter | None = None,
                       val_writer_180: ScalarWriter | None = None):
        """Full val-set eval + artifacts (reference train.py:386-545)."""
        cfg = self.cfg
        batch_size = override_batch_size or self.batch_size
        if override_batch_size is None:
            eval_fn = self._get_jitted("eval")
        else:
            key = f"eval_bs{override_batch_size}"
            if key not in self._jit_cache:
                if self.use_mesh:
                    # mirror the main eval jit's shardings: without
                    # replicated out_shardings the output follows the
                    # dp-sharded input and device_get on it raises under
                    # multi-process (non-addressable shards)
                    self._get_jitted("eval")  # populate state_shardings
                    st_shard = self._jit_cache["state_shardings"]
                    b_shard = meshlib.batch_sharding(self.mesh)
                    rep = meshlib.replicated(self.mesh)
                    self._jit_cache[key] = jax.jit(
                        self._eval_step_fn,
                        in_shardings=(st_shard, (b_shard,) * 8),
                        out_shardings=(rep, rep),
                    )
                else:
                    self._jit_cache[key] = jax.jit(self._eval_step_fn)
            eval_fn = self._jit_cache[key]
        val_idxs = list(self.val_indices)
        n_val = len(val_idxs)
        num_batches = int(np.ceil(n_val / batch_size))
        num_full_batches = n_val // batch_size

        if self.num_processes > 1:
            assert batch_size % self.num_processes == 0, (
                f"eval batch size {batch_size} must divide over "
                f"{self.num_processes} processes"
            )
        local_bs = batch_size // self.num_processes
        lo = self.process_index * local_bs
        # one FIXED eval stream (not epoch-tagged): the same checkpoint
        # reproduces identical predictions under any eval invocation, and
        # epoch-to-epoch val curves carry no resampling noise — the
        # determinism the reference probes for by hand (provider.py:99-100)
        eval_rng = self._epoch_rng(2)

        # effective refinement method: CLI --refineICPmethod, overridable
        # by config (evaluation.refinement.method)
        if (cfg.evaluation.has("refinement")
                and cfg.evaluation.refinement.has("method")):
            icp_method = cfg.evaluation.refinement.method

        eval_dir = f"{self.logdir}/val/eval{str(epoch).zfill(6)}"
        base_eval_dir = eval_dir
        if refine_icp:
            suffix = f"_{icp_its}" if icp_its != 30 else ""
            eval_dir = f"{eval_dir}/refined_{icp_method}{suffix}"
        if self.is_main_process and os.path.isdir(eval_dir):
            # reference uses int(time.time()) alone (train.py:405); sub-second
            # re-evals (e.g. timings mode) need a uniquifier
            backup = f"{eval_dir}_backup_{int(time.time())}"
            k = 0
            while os.path.exists(backup):
                k += 1
                backup = f"{eval_dir}_backup_{int(time.time())}_{k}"
            os.rename(eval_dir, backup)
        if self.is_main_process:
            os.makedirs(eval_dir, exist_ok=True)

        P = {
            k: np.empty((n_val, d), dtype=np.float32)
            for k, d in [
                ("pred_translations", 3), ("pred_angles", 1),
                ("pred_s1_pc1centers", 3), ("pred_s1_pc2centers", 3),
                ("pred_s2_pc1centers", 3), ("pred_s2_pc2centers", 3),
                ("pred_s2_pc1angles", 1), ("pred_s2_pc2angles", 1),
            ]
        }
        G = {
            "gt_translations": np.empty((n_val, 3), np.float32),
            "gt_angles": np.empty((n_val, 1), np.float32),
            "gt_pc1centers": np.empty((n_val, 3), np.float32),
        }

        if use_old_results:
            P["pred_translations"] = np.load(
                f"{base_eval_dir}/pred_translations.npy"
            )
            P["pred_angles"] = np.load(f"{base_eval_dir}/pred_angles.npy")
            P["pred_s2_pc1centers"] = np.load(
                f"{base_eval_dir}/pred_s2_pc1centers.npy"
            )

        nb = self.spec.num_bins
        # Reference eval decodes angle residuals UNSCALED (classLogits2angle,
        # tp8.py:241-244) although the head is trained to predict residuals
        # normalized by pi/num_bins (tp8.py:278). evaluation.scale_residuals
        # opts into the consistent decode.
        residual_scale = (
            np.pi / nb
            if cfg.evaluation.has("scale_residuals")
            and cfg.evaluation.scale_residuals else 1.0
        )
        do_resolve_flips = (
            cfg.evaluation.has("resolve_flips")
            and cfg.evaluation.resolve_flips
            # host-side prediction post-processing feeds process-0-only
            # artifacts; skip the redundant compute on other processes
            and self.is_main_process
        )
        loss_sum, cumulated_times = 0.0, 0.0
        for batch_idx in progress(range(num_batches),
                                  desc=f"eval epoch {epoch}",
                                  total=num_batches):
            start = batch_idx * batch_size
            end = min(start + batch_size, n_val)
            actual = end - start
            take = val_idxs[start:end]
            # pad to full batch to keep shapes static (reference feeds a
            # stale tail instead, train.py:432-451)
            padded = take + [val_idxs[0]] * (batch_size - actual)
            # every process assembles the FULL host batch (labels + clouds
            # for host-side decode are needed everywhere); the device call
            # gets only this process's rows, assembled into the global
            # dp-sharded batch
            batch = self._make_batch(padded, rng=eval_rng)
            if self.num_processes > 1:
                dev_batch = multihost.global_batch(
                    self.mesh,
                    tuple(a[lo:lo + local_bs] for a in batch),
                    batch_size,
                )
            else:
                dev_batch = batch
            if not use_old_results:
                t0 = time.time()
                loss_val, out = eval_fn(state, dev_batch)
                out = jax.device_get(out)
                loss_val = float(loss_val)
                cumulated_times += time.time() - t0

                if actual == batch_size:
                    loss_sum += loss_val
                t0 = time.time()
                dec = decode_pair_outputs(
                    out, batch[0], batch[1], nb, residual_scale,
                    resolve_flips=do_resolve_flips, n=actual)
                if do_resolve_flips:
                    cumulated_times += time.time() - t0
                ang1, ang2 = dec.ang1, dec.ang2
                P["pred_translations"][start:end] = dec.translations
                P["pred_angles"][start:end, 0] = dec.angles
                P["pred_s1_pc1centers"][start:end] = out["pred_s1_pc1centers"][:actual]
                P["pred_s1_pc2centers"][start:end] = out["pred_s1_pc2centers"][:actual]
                P["pred_s2_pc1centers"][start:end] = out["pred_s2_pc1centers"][:actual]
                P["pred_s2_pc2centers"][start:end] = out["pred_s2_pc2centers"][:actual]
                P["pred_s2_pc1angles"][start:end, 0] = ang1
                P["pred_s2_pc2angles"][start:end, 0] = ang2
            G["gt_translations"][start:end] = batch[2][:actual]
            G["gt_angles"][start:end] = batch[3][:actual]
            G["gt_pc1centers"][start:end] = batch[4][:actual]

        if not self.is_main_process:
            # artifacts, metrics files, ICP refinement and scalar rows are
            # process-0-only; the collective (jitted eval) work above
            # already happened on every process
            return loss_sum / num_full_batches if num_full_batches else 0.0

        net_ref = (cfg.evaluation.network_refine
                   if cfg.evaluation.has("network_refine") else None)
        if (net_ref is not None and net_ref.enabled and not use_old_results
                and not do_timings):
            # framework addition: second network pass on the coarsely
            # aligned pair (evaluation.network_refine; no reference
            # analogue — its only refinement is ICP, train.py:461-484).
            # Measured strictly better than one pass on every bucket
            # (docs/RESULTS.md "Iterative network refinement").
            # Single-process only: the pass is a collective forward, but
            # it consumes main-process-only flip-resolved predictions.
            assert self.num_processes == 1, (
                "evaluation.network_refine is single-process (pod eval "
                "runs the coarse pass everywhere; refine after gather)"
            )
            t0 = time.time()
            # iterations > 1 compose from the GATED chain each pass
            # (P is rewritten in place), so deeper iterations stay
            # frame-consistent — unlike the probe's raw-chain scoring
            # (scripts/probe_iter_refine.py note). Measured: a residual-
            # trained refiner keeps improving through 3 passes
            # (docs/RESULTS.md "Residual-task refiner").
            for itn in range(int(net_ref.iterations)
                             if net_ref.has("iterations") else 1):
                P = self._network_refine_pass(
                    state, eval_fn, P, val_idxs, batch_size,
                    residual_scale, net_ref,
                    resolve_flips=do_resolve_flips, iteration=itn,
                )
            cumulated_times += time.time() - t0

        if refine_icp:
            from alignnet3d_tpu.icp import refine_predictions

            # framework addition: fitness/trust-region acceptance gate
            # (cfg evaluation.refinement_gate; see icp/p2point.py)
            gate_cfg = (
                cfg.evaluation.refinement_gate
                if cfg.evaluation.has("refinement_gate") else None
            )
            gate_kwargs = {}
            if gate_cfg is not None and gate_cfg.enabled:
                gate_kwargs["gate"] = True
                if gate_cfg.has("max_dyaw_deg"):
                    gate_kwargs["gate_max_dyaw_deg"] = gate_cfg.max_dyaw_deg
                if gate_cfg.has("max_dxy"):
                    gate_kwargs["gate_max_dxy"] = gate_cfg.max_dxy
            # framework additions: correspondence radius override (the
            # reference hardwires radius=0.1, train.py:469) and a
            # coarse->fine refinement cascade (evaluation.refinement.cascade:
            # list of {radius, its?, max_dyaw_deg?, max_dxy?} stage dicts;
            # each stage starts from the previous stage's world-frame
            # output with its own trust region, so the fine radius may
            # only polish, never re-basin)
            ref_cfg = (cfg.evaluation.refinement
                       if cfg.evaluation.has("refinement") else None)
            if ref_cfg is not None and ref_cfg.has("radius"):
                gate_kwargs["radius"] = ref_cfg.radius
            # effective method resolved above (CLI/config); cascade
            # stages may override per stage
            gate_kwargs["method"] = icp_method
            stages = (ref_cfg.cascade
                      if ref_cfg is not None and ref_cfg.has("cascade")
                      else None)
            if not stages:
                stages = [{}]  # single stage with the global defaults
            cur_t = P["pred_translations"]
            cur_a = P["pred_angles"]
            cur_c = P["pred_s2_pc1centers"]
            icp_time = 0.0
            for stage in stages:
                stage_kwargs = cascade_stage_kwargs(gate_kwargs, stage)
                refined, elapsed = refine_predictions(
                    cfg, val_idxs, cur_t, cur_a, cur_c,
                    its=int(stage.get("its", icp_its)),
                    dataset=self.dataset, **stage_kwargs,
                )
                cur_t = refined["translations"]
                cur_a = refined["angles"]
                # ICP transforms are world-frame: rotation center resets
                # to the origin (reference train.py:483-484)
                cur_c = np.zeros_like(cur_c)
                icp_time += elapsed
            P["pred_translations"] = cur_t
            P["pred_angles"] = cur_a
            P["pred_s2_pc1centers"] = cur_c
            cumulated_times += icp_time

        mean_loss = loss_sum / num_full_batches if num_full_batches else 0.0
        mean_time = cumulated_times / float(n_val)

        if do_timings:
            print(f"Timing bs={batch_size}: {mean_time}")
        elif cfg.evaluation.has("special") and cfg.evaluation.special.mode == "held":
            evaluation.evaluate_held(
                cfg, val_idxs, P["pred_translations"], P["pred_angles"],
                G["gt_translations"], G["gt_angles"], eval_dir=eval_dir,
                mean_time=mean_time, metas=self.dataset.metas(val_idxs),
            )
        else:
            metas = self.dataset.metas(val_idxs)
            global_step = int(jax.device_get(state.step))
            for accept_inverted, writer in (
                (False, val_writer), (True, val_writer_180)
            ):
                eval_dict = evaluation.evaluate(
                    cfg, val_idxs, P["pred_translations"], P["pred_angles"],
                    G["gt_translations"], G["gt_angles"],
                    P["pred_s2_pc1centers"], G["gt_pc1centers"],
                    eval_dir=eval_dir, accept_inverted_angle=accept_inverted,
                    mean_time=mean_time, metas=metas,
                )
                lv = " ".join(f"{a * 100.0:.2f}%" for a in eval_dict.corr_levels)
                lt = " ".join(
                    f"{a * 100.0:.2f}%" for a in eval_dict.corr_levels_translation
                )
                la = " ".join(
                    f"{a * 100.0:.2f}%" for a in eval_dict.corr_levels_angles
                )
                logger.info(
                    f"Mean translation distance: {eval_dict.mean_dist_translation},"
                    f" Mean angle distance: {eval_dict.mean_dist_angle},"
                    f" Levels: {lv}, Translation levels: {lt},"
                    f" Angle levels: {la}, Mean ex. time: {mean_time:.5f}"
                )
                if not eval_only and writer is not None:
                    writer.write(global_step, {
                        "losses/loss": mean_loss,
                        "accuracy/t_a_mean_dist": eval_dict.mean_dist_translation,
                        "accuracy/t_b_1cm": eval_dict.corr_levels_translation[0],
                        "accuracy/t_c_10cm": eval_dict.corr_levels_translation[1],
                        "accuracy/t_d_1m": eval_dict.corr_levels_translation[2],
                        "accuracy/a_a_mean_dist": eval_dict.mean_dist_angle,
                        "accuracy/a_b_1d": eval_dict.corr_levels_angles[0],
                        "accuracy/a_c_5d": eval_dict.corr_levels_angles[1],
                        "accuracy/a_d_10d": eval_dict.corr_levels_angles[2],
                        "accuracy/o_b_1cm": eval_dict.corr_levels[0],
                        "accuracy/o_c_10cm": eval_dict.corr_levels[1],
                        "accuracy/o_d_1m": eval_dict.corr_levels[2],
                        "accuracy/fitness": eval_dict.reg_eval.fitness,
                        "accuracy/inlier_rmse": eval_dict.reg_eval.inlier_rmse,
                    })

        for name, arr in P.items():
            np.save(f"{eval_dir}/{name}.npy", arr)
        logger.info("val mean loss: %f" % mean_loss)
        return mean_loss

    # --------------------------------------------------------------- driver

    def train(self, eval_only: bool = False, eval_epoch=None,
              refine_icp: bool = False, icp_its: int = 30,
              icp_method: str = "p2p",
              use_old_results: bool = False, do_timings: bool = False,
              override_batch_size=None, eval_only_model_to_load=None):
        """Main entry (reference train.py:187-332)."""
        cfg = self.cfg
        setup_logging(
            self.logdir if self.is_main_process
            else f"{self.logdir}/proc{self.process_index}"
        )
        # verbatim copy of the effective config into the logdir
        # (reference train.py:46-50); process 0 only
        if self.is_main_process:
            from alignnet3d_tpu.config import save_config

            configcopy = f"{self.logdir}/config.json"
            if os.path.exists(configcopy):
                datestr = datetime.datetime.today().strftime(
                    "%Y-%m-%d_%H-%M-%S"
                )
                configcopy = f"{configcopy[:-5]}_{datestr}.json"
            try:
                save_config(configcopy)
            except Exception:
                pass

        train_writer = ScalarWriter(f"{self.logdir}/train/scalars.jsonl")
        val_writer = ScalarWriter(f"{self.logdir}/val/scalars.jsonl")
        val_writer_180 = ScalarWriter(f"{self.logdir}/val_180/scalars.jsonl")

        state = self.init_state()
        start_epoch = 0

        if eval_only:
            model_dir = eval_only_model_to_load or self.logdir
            if not use_old_results and not do_timings:
                path = os.path.join(
                    model_dir, f"model-{eval_epoch}{CHECKPOINT_SUFFIX}")
                assert multihost.main_isfile(path), path
                state = self.restore_checkpoint(state, path)
                restored = int(jax.device_get(state.step))
                if eval_only_model_to_load is None and self.num_batches_per_epoch:
                    assert restored % self.num_batches_per_epoch == 0
                    assert restored // self.num_batches_per_epoch - 1 == int(
                        eval_epoch
                    ), (restored, eval_epoch)
            start_epoch = int(eval_epoch)
            logger.info(f"Evaluating at epoch {start_epoch}")
        else:
            rolling = self._ckpt_path("model.ckpt")
            if multihost.main_isfile(rolling):
                state = self.restore_checkpoint(state, rolling)
                restored = int(jax.device_get(state.step))
                assert restored % self.num_batches_per_epoch == 0
                start_epoch = restored // self.num_batches_per_epoch
                logger.info(f"Continuing training at epoch {start_epoch}")
            elif cfg.training.pretraining.model != "":
                pre = cfg.training.pretraining.model
                if not pre.endswith(CHECKPOINT_SUFFIX):
                    pre = pre + CHECKPOINT_SUFFIX
                assert multihost.main_isfile(pre), pre
                state = self.restore_checkpoint(state, pre, except_step=True)
                assert int(jax.device_get(state.step)) == 0
                logger.info(
                    f"Pre-trained weights loaded from {pre},"
                    " starting initial evaluation"
                )
                self.eval_one_epoch(
                    state, "pretr", eval_only=False,
                    val_writer=val_writer, val_writer_180=val_writer_180,
                )
                logger.info("Initial evaluation finished")

        # evaluation.eval_every (default 1 = reference semantics,
        # train.py evals every epoch): at N>1 the full val pass (dual
        # eval + artifact writes) runs every Nth epoch and always on the
        # last — a
        # wall-clock lever for long runs; eval_only is never skipped
        eval_every = (
            cfg.evaluation.eval_every
            if cfg.evaluation.has("eval_every") else 1
        )
        try:
            start = time.time()
            for epoch in range(start_epoch, cfg.training.num_epochs):
                logger.info("**** EPOCH %03d ****" % epoch)
                if not eval_only:
                    state = self.train_one_epoch(state, epoch, train_writer)
                was_last = epoch == cfg.training.num_epochs - 1
                if do_timings:
                    for _ in range(10):
                        self.eval_one_epoch(
                            state, epoch, eval_only=eval_only,
                            do_timings=True,
                            override_batch_size=override_batch_size,
                        )
                elif eval_only or was_last or epoch % eval_every == 0:
                    self.eval_one_epoch(
                        state, epoch, eval_only=eval_only,
                        refine_icp=refine_icp, icp_its=icp_its,
                        icp_method=icp_method,
                        use_old_results=use_old_results,
                        val_writer=val_writer, val_writer_180=val_writer_180,
                    )
                if eval_only:
                    break

                if epoch % 2 == 0 or was_last:
                    self.save_checkpoint(state, "model.ckpt")
                if (epoch % 5 == 0 or was_last
                        or cfg.evaluation.save_every_epoch):
                    self.save_checkpoint(state, f"model-{epoch}")

                elapsed = time.time() - start
                remaining = elapsed / (epoch - start_epoch + 1) * (
                    cfg.training.num_epochs - epoch - 1
                )
                logger.info(
                    f"Finished epoch {epoch}."
                    f" Time elapsed: {datetime.timedelta(seconds=elapsed)},"
                    f" Time remaining: {datetime.timedelta(seconds=remaining)}"
                )
            logger.info("Finished Training")
        except KeyboardInterrupt:
            logger.info("Interrupted")
        return state
