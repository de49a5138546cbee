"""Serving-latency benchmark: p50/p95 end-to-end Aligner.align latency.

Measures the BASELINE.md third target ("p50 align latency — report; no
reference value exists to beat"): wall-clock of the public API
(alignnet3d_tpu.api.Aligner.align) per batch at serving batch sizes,
including host resample, device dispatch, and readback — the number a
serving user actually sees.

The fixed per-call host cost floors small-batch latency; per-pair cost
at large batches is the device-bound figure. Both are reported.

Run on the GPU: python scripts/bench_latency.py [--json]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.config import config_from_dict
    from alignnet3d_tpu.api import Aligner
    from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec

    cfg = config_from_dict({
        "model": {
            "num_points": 512,
            "options": {
                "angle_factor": 1.0,
                "early_stage_factor": 0.5,
                "s1transformer": [[64, 128, 256], [[512, 256], 0.7]],
                "s2transformer": [[64, 128, 512], [[512, 256], 0.7]],
                "embedding": [64, 128, 1024],
                "remaining_transform_prediction": [[512, 256], 0.7],
            },
            "angles": {"num_bins": 50, "accept_inverted_angle": True},
        },
    })
    spec = ModelSpec.from_config(cfg)
    model = AlignNet(spec)
    dummy = jnp.zeros((2, spec.num_points, 3), jnp.float32)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        dummy, dummy, train=False,
    )

    rng = np.random.default_rng(0)
    rows = []
    for bs in (1, 8, 32, 128, 1024):
        aligner = Aligner(spec, variables, batch_size=bs)
        clouds1 = [rng.normal(size=(300, 3)).astype(np.float32)
                   for _ in range(bs)]
        clouds2 = [rng.normal(size=(300, 3)).astype(np.float32)
                   for _ in range(bs)]
        aligner.align(clouds1, clouds2)  # compile + warmup
        times = []
        reps = 30 if bs <= 128 else 10
        for _ in range(reps):
            t0 = time.perf_counter()
            aligner.align(clouds1, clouds2)
            times.append(time.perf_counter() - t0)
        t = np.asarray(times) * 1e3
        rows.append({
            "batch_size": bs,
            "p50_ms": round(float(np.percentile(t, 50)), 2),
            "p95_ms": round(float(np.percentile(t, 95)), 2),
            "p50_ms_per_pair": round(float(np.percentile(t, 50)) / bs, 4),
        })
        print(f"bs={bs:5d}: p50 {rows[-1]['p50_ms']:8.2f} ms  "
              f"p95 {rows[-1]['p95_ms']:8.2f} ms  "
              f"({rows[-1]['p50_ms_per_pair']:.3f} ms/pair)")
    if "--json" in sys.argv:
        print(json.dumps(rows))


if __name__ == "__main__":
    main()
