"""Test-time augmentation probe: multi-resample prediction averaging.

Each eval forward sees ONE random N-point resample of each cloud; on
sparse far-range scans that injects resample noise into the predicted
centers/translations. This probes whether averaging predictions over K
independent resamples buys accuracy (angles are aggregated as a
circular mean mod pi after flip-alignment to the first sample's
hypothesis; translations/centers average linearly).

Usage: python scripts/probe_tta.py <run_dir_or_config.json> <epoch> [K ...]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    cfg_path, epoch = sys.argv[1], int(sys.argv[2])
    ks = [int(a) for a in sys.argv[3:]] or [1, 2, 4, 8]

    import jax

    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.data import provider
    from alignnet3d_tpu.evaluation.decode import decode_pair_outputs
    from alignnet3d_tpu.training.trainer import Trainer

    from alignnet3d_tpu.utils.runs import resolve_run_checkpoint

    cfg_path, ckpt_dir = resolve_run_checkpoint(cfg_path, epoch)
    cfg = load_config(cfg_path)
    trainer = Trainer(cfg, seed=0, use_mesh=False)
    state = trainer.init_state()
    state = trainer.restore_checkpoint(
        state,
        os.path.join(ckpt_dir or trainer.logdir, f"model-{epoch}.npz"),
    )
    eval_fn = trainer._get_jitted("eval")

    val_idxs = list(trainer.val_indices)
    n = len(val_idxs)
    bs = trainer.batch_size
    nb = trainer.spec.num_bins
    scale = np.pi / nb
    ds = trainer.dataset
    rows = ds.rows(val_idxs)
    gt_t = ds.translations[rows].reshape(-1, 3)
    gt_a = ds.rel_angles[rows].reshape(-1)
    gt_c = ds.pc1centers[rows].reshape(-1, 3)

    kmax = max(ks)
    # per-replica predictions
    T = np.zeros((kmax, n, 3), np.float32)
    A = np.zeros((kmax, n), np.float64)
    C = np.zeros((kmax, n, 3), np.float32)
    num_batches = int(np.ceil(n / bs))
    for rep in range(kmax):
        rng = trainer._epoch_rng(500 + rep)
        for bi in range(num_batches):
            s, e = bi * bs, min((bi + 1) * bs, n)
            take = val_idxs[s:e] + [val_idxs[0]] * (bs - (e - s))
            batch = trainer._make_batch(take, rng=rng)
            _, out = eval_fn(state, batch)
            out = jax.device_get(out)
            dec = decode_pair_outputs(
                out, batch[0], batch[1], nb, scale,
                resolve_flips=True, n=e - s)
            T[rep, s:e] = dec.translations
            A[rep, s:e] = dec.angles
            C[rep, s:e] = dec.s2_pc1centers
        print(f"replica {rep} done", flush=True)

    from alignnet3d_tpu.evaluation.quickscore import format_table, success_table

    def score(label, t, a, c):
        # is_test defaults to quickscore.positional_is_test(n)
        tab = success_table(t, a, c, gt_t, gt_a, gt_c)
        print(f"{label:10s} {format_table(tab, ('all', 'val', 'test'))}",
              flush=True)

    for k in ks:
        # align each replica's angle to replica 0's hypothesis (mod pi
        # branch nearest), then circular-mean; average t and c linearly
        a0 = A[0]
        aligned = np.empty((k, n))
        for r in range(k):
            d = A[r] - a0
            d = (d + np.pi / 2) % np.pi - np.pi / 2  # nearest mod-pi branch
            aligned[r] = a0 + d
        a_mean = np.arctan2(
            np.mean(np.sin(aligned), axis=0), np.mean(np.cos(aligned), axis=0)
        )
        score(f"K={k}", T[:k].mean(0), a_mean, C[:k].mean(0))


if __name__ == "__main__":
    main()
