"""Accuracy + throughput of the int8 quantized serving paths.

Runs the val split through ``serving.build_inference_fn`` at each
quantization scope {none, embedding, backbones} with the SAME decode as
the trainer's eval (scale_residuals, flip resolution), scores the
<2/10/20 cm success table per scope, and times each path at a large
batch (chained-scan protocol, pairs/s). The deltas decide whether int8
is adoptable for the headline bench (docs/RESULTS.md).

Usage: python scripts/eval_quant.py <config.json> <epoch> [bench_batch]
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from alignnet3d_tpu.utils.runs import resolve_run_checkpoint as _resolve


def main():
    cfg_path, epoch = sys.argv[1], int(sys.argv[2])
    bench_b = int(sys.argv[3]) if len(sys.argv) > 3 else 8192

    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.evaluation.decode import decode_pair_outputs
    from alignnet3d_tpu.evaluation.quickscore import (
        format_table,
        success_table,
    )
    from alignnet3d_tpu.serving import build_inference_fn
    from alignnet3d_tpu.training.trainer import Trainer

    cfg_path, ckpt_dir = _resolve(cfg_path, epoch)
    cfg = load_config(cfg_path)
    trainer = Trainer(cfg, seed=0, use_mesh=False)
    state = trainer.restore_checkpoint(
        trainer.init_state(),
        os.path.join(ckpt_dir or trainer.logdir, f"model-{epoch}.npz"),
    )
    variables = {"params": state.params, "batch_stats": state.batch_stats}

    val_idxs = list(trainer.val_indices)
    n = len(val_idxs)
    bs = trainer.batch_size
    nb = trainer.spec.num_bins
    residual_scale = (
        np.pi / nb
        if cfg.evaluation.has("scale_residuals")
        and cfg.evaluation.scale_residuals else 1.0
    )
    ds = trainer.dataset
    rows = ds.rows(val_idxs)
    gt_t = ds.translations[rows].reshape(-1, 3)
    gt_a = ds.rel_angles[rows].reshape(-1)
    gt_c = ds.pc1centers[rows].reshape(-1, 3)
    num_batches = int(np.ceil(n / bs))

    for scope in (None, "embedding", "backbones"):
        fn = jax.jit(build_inference_fn(
            trainer.spec, variables, quantize=scope
        ))
        rng = trainer._epoch_rng(2)  # the run's own eval stream
        t_all = np.empty((n, 3), np.float32)
        a_all = np.empty(n, np.float64)
        c_all = np.empty((n, 3), np.float32)
        for bi in range(num_batches):
            s, e = bi * bs, min((bi + 1) * bs, n)
            take = val_idxs[s:e] + [val_idxs[0]] * (bs - (e - s))
            batch = trainer._make_batch(take, rng=rng)
            out = jax.device_get(fn(batch[0], batch[1]))
            # the trainer's exact decode (evaluation/decode.py) — keeps
            # the quantization deltas valid under future decode changes
            dec = decode_pair_outputs(
                out, batch[0], batch[1], nb, residual_scale,
                resolve_flips=True, n=e - s)
            t_all[s:e] = dec.translations
            a_all[s:e] = dec.angles
            c_all[s:e] = dec.s2_pc1centers
        tab = success_table(t_all, a_all, c_all, gt_t, gt_a, gt_c)
        print(f"{scope or 'f32-fold':12s} "
              f"{format_table(tab, ('all', 'val', 'test'))}", flush=True)

    # throughput at bench batch (network-only forward, bf16 inputs)
    rng = np.random.default_rng(0)
    a0 = jnp.asarray(rng.normal(
        size=(bench_b, trainer.spec.num_points, 3)), jnp.float32)
    b0 = -a0
    for scope in (None, "embedding", "backbones"):
        fwd = build_inference_fn(trainer.spec, variables, quantize=scope)

        @partial(jax.jit, static_argnums=(2,))
        def chained(a, b, iters, fwd=fwd):
            def body(carry, _):
                aa, bb = carry
                out = fwd(aa, bb)
                d = out["pred_translations"][:, None, :] * 1e-6
                return (aa + d, bb - d), out["pred_translations"][0, 0]
            _, probes = jax.lax.scan(body, (a, b), None, length=iters)
            return probes

        iters = 20
        np.asarray(chained(a0, b0, iters))
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(chained(a0, b0, iters))
            best = min(best, time.perf_counter() - t0)
        print(f"{scope or 'f32-fold':12s} B={bench_b}: "
              f"{bench_b * iters / best:,.0f} pairs/s", flush=True)


if __name__ == "__main__":
    main()
