"""Iterative network refinement probe: re-apply the model to its own
coarsely-aligned output and compose transforms.

Pass 1 predicts T1 for (pc1, pc2); pass k re-runs the network on
(T_{k-1} pc1, pc2) — a nearly-aligned pair — and composes
T_k = dT_k @ T_{k-1}. The hypothesis: at near-identity relative pose the
prediction task is far easier (no flip ambiguity, small residual bins),
so iteration should lift the fine buckets (<2 cm / <10 cm) the way ICP
does but with learned correspondences instead of nearest-point — the
reference has no analogue (its only refinement is Open3D ICP,
train.py:461-484).

Each iteration is also scored with a trust-region gate (accept the
incremental update only when |da| <= gate_deg and |dt_xy| <= gate_xy):
an out-of-basin second pass can throw away a good init, exactly the
failure mode the ICP gate exists for (icp/p2point.py:248-261). The
incremental world displacement at the object equals the raw predicted
translation of the pass (M2 @ c2 = c2 + t2), so the gate needs no
re-basing.

With ``--refiner <run_dir_or_config.json> <epoch>``, iterations >= 2 use
THAT checkpoint instead of the coarse model — the learned fine-aligner
trained on the residual task (data/residual.py). The refiner must share
the coarse model's architecture spec (same tp8 options) since only the
weights are swapped.

Usage: python scripts/probe_iter_refine.py <run_dir_or_config.json> <epoch>
           [n_iters] [gate_deg] [gate_xy]
           [--refiner <run_dir_or_config.json> <epoch>]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from alignnet3d_tpu.geometry import (
    compose_gated_refinement,
    get_mat_angle_batch as _mats_from,
)
from alignnet3d_tpu.utils.runs import resolve_run_checkpoint as _resolve


def main():
    argv = list(sys.argv[1:])
    refiner = None
    if "--refiner" in argv:
        i = argv.index("--refiner")
        refiner = (argv[i + 1], int(argv[i + 2]))
        argv = argv[:i] + argv[i + 3:]
    cfg_path, epoch = argv[0], int(argv[1])
    n_iters = int(argv[2]) if len(argv) > 2 else 3
    gate_deg = float(argv[3]) if len(argv) > 3 else 2.0
    gate_xy = float(argv[4]) if len(argv) > 4 else 0.15

    import jax

    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.evaluation.decode import decode_pair_outputs
    from alignnet3d_tpu.training.trainer import Trainer

    cfg_path, ckpt_dir = _resolve(cfg_path, epoch)
    cfg = load_config(cfg_path)
    trainer = Trainer(cfg, seed=0, use_mesh=False)
    state = trainer.init_state()
    state = trainer.restore_checkpoint(
        state,
        os.path.join(ckpt_dir or trainer.logdir, f"model-{epoch}.npz"),
    )
    eval_fn = trainer._get_jitted("eval")
    refine_state = state
    if refiner is not None:
        rpath, rdir = _resolve(*refiner)
        assert rdir is not None, f"no model-{refiner[1]} next to {rpath}"
        refine_state = trainer.restore_checkpoint(
            trainer.init_state(),
            os.path.join(rdir, f"model-{refiner[1]}.npz"),
        )
        print(f"refiner: {rdir} epoch {refiner[1]}", flush=True)

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

    from alignnet3d_tpu.evaluation.quickscore import (
        format_table,
        success_table,
    )

    def score(label, M):
        yaw = np.arctan2(M[:, 1, 0], M[:, 0, 0])
        tab = success_table(M[:, :3, 3].astype(np.float32), yaw,
                            np.zeros((n, 3), np.float32), gt_t, gt_a, gt_c)
        print(f"{label:16s} {format_table(tab, ('all', 'val', 'test'))}",
              flush=True)

    num_batches = int(np.ceil(n / bs))
    M = None  # composed transform so far, (n,4,4)
    for it in range(n_iters):
        # FIXED eval stream per pass; pass 1 uses trainer._eval_epoch's
        # exact stream (_epoch_rng(2)) so the baseline row is
        # bit-comparable to the run's own eval artifacts
        rng = trainer._epoch_rng(2) if it == 0 else trainer._epoch_rng(2, it)
        t_all = np.empty((n, 3), np.float32)
        a_all = np.empty(n, np.float64)
        c_all = np.empty((n, 3), np.float32)
        for bi in range(num_batches):
            s, e = bi * bs, min((bi + 1) * bs, n)
            take = val_idxs[s:e] + [val_idxs[0]] * (bs - (e - s))
            batch = trainer._make_batch(take, rng=rng)
            pc1 = np.asarray(batch[0])
            if it > 0:
                Mb = M[s:e]
                pad = np.tile(np.eye(4), (len(pc1) - (e - s), 1, 1))
                Mb = np.concatenate([Mb, pad]) if len(pad) else Mb
                raw = pc1
                pc1 = np.einsum(
                    "bij,bnj->bni", Mb[:, :3, :3].astype(np.float32), pc1
                ) + Mb[:, None, :3, 3].astype(np.float32)
                # empty clouds stay zero (reference provider.py:95-96 —
                # parity with trainer._network_refine_pass)
                pc1[~np.any(raw != 0.0, axis=(1, 2))] = 0.0
                batch = (pc1,) + tuple(batch[1:])
            _, out = eval_fn(state if it == 0 else refine_state, batch)
            out = jax.device_get(out)
            dec = decode_pair_outputs(
                out, pc1, batch[1], nb, residual_scale,
                resolve_flips=True, n=e - s)
            t_all[s:e] = dec.translations
            a_all[s:e] = dec.angles
            c_all[s:e] = dec.s2_pc1centers
        if it == 0:
            M = _mats_from(t_all, a_all, c_all)
            score("iter 1", M)
        else:
            prev = M
            # gated composition shared with the eval/serving paths
            # (geometry.compose_gated_refinement). The gated score is
            # only valid at iter 2: deeper iterations' increments are
            # measured in the RAW chain's frame, so a gated chain would
            # compose from a mismatched frame once any pair rejects
            # (round-3 review finding).
            M_gated, ok = compose_gated_refinement(
                prev, t_all, a_all, c_all, gate_deg, gate_xy
            )
            M = np.einsum(
                "nij,njk->nik", _mats_from(t_all, a_all, c_all), prev
            )
            score(f"iter {it + 1} raw", M)
            if it == 1:
                score(f"iter {it + 1} gated", M_gated)
            print(f"  gate accepted {int(ok.sum())}/{n} "
                  f"(|da|<={gate_deg}deg, |dxy|<={gate_xy}m)", flush=True)


if __name__ == "__main__":
    main()
