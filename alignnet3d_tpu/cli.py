"""CLI entry point — flag-compatible with reference train.py:32-40.

    python train.py {train,eval_only} --config configs/X.json
        [--refineICP] [--its N] [--use_old_results]
        [--refineICPmethod p2p] [--eval_epoch E]

Special evaluation modes (reference train.py:548-561) dispatch on
``evaluation.special.mode``: 'icp' (standalone ICP baselines), 'held'
(velocity-only eval with an external model), 'timings' (10x bs=32 latency).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("operation", choices=["train", "eval_only"],
                        help="Operation to run")
    parser.add_argument("--config", required=True, help="Config file")
    parser.add_argument("--refineICP", action="store_true",
                        help="Refine results with ICP")
    parser.add_argument("--its", required=False, default=30,
                        help="ICP refinement iterations")
    parser.add_argument("--use_old_results", action="store_true",
                        help="Reuse stored predictions instead of inference")
    parser.add_argument("--refineICPmethod", required=False, default="p2p",
                        choices=["p2p", "p2plane"],
                        help="ICP method for refinement (p2plane fills the "
                        "reference's asserted-out variant, icp.py:81-83)")
    parser.add_argument("--eval_epoch", required=False, default="199",
                        help="Epoch to eval in eval_only mode")
    parser.add_argument("--seed", required=False, default=0, type=int)
    return parser


def main(argv=None):
    flags = build_parser().parse_args(argv)

    # pod-scale: connect this process to its peers when the ALIGNNET_*
    # distributed env vars are present (no-op otherwise); must precede
    # any JAX use (parallel/multihost.py)
    from alignnet3d_tpu.parallel import multihost

    multihost.maybe_initialize()

    from alignnet3d_tpu.utils import setup_compile_cache

    setup_compile_cache()

    from alignnet3d_tpu.config import load_config

    cfg = load_config(flags.config)

    if cfg.evaluation.has("special"):
        mode = cfg.evaluation.special.mode
        if mode == "icp":
            print(flags.config)
            from alignnet3d_tpu import icp

            icp.evaluate(cfg, flags.use_old_results)
            return
        if mode == "held":
            from alignnet3d_tpu.training import Trainer

            Trainer(cfg, seed=flags.seed).train(
                eval_only=True, eval_epoch=flags.eval_epoch,
                eval_only_model_to_load=cfg.evaluation.special.held.model,
            )
            return
        if mode == "timings":
            from alignnet3d_tpu.training import Trainer

            for bs in [32]:
                cfg.training.__dict__["batch_size"] = bs
                Trainer(cfg, seed=flags.seed).train(
                    eval_only=True, eval_epoch=flags.eval_epoch,
                    do_timings=True, override_batch_size=bs,
                )
            return
        raise AssertionError(f"unknown special mode {mode!r}")

    from alignnet3d_tpu.training import Trainer

    trainer = Trainer(cfg, seed=flags.seed)
    if flags.operation == "train":
        trainer.train()
    else:
        trainer.train(
            eval_only=True, eval_epoch=flags.eval_epoch,
            refine_icp=flags.refineICP, icp_its=int(flags.its),
            icp_method=flags.refineICPmethod,
            use_old_results=flags.use_old_results,
        )


if __name__ == "__main__":
    main()
