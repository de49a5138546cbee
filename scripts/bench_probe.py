#!/usr/bin/env python
"""Throughput probe: which inference configuration maximizes pairs/s?

Measures the flagship forward (bench.py model geometry: N=512, 50 bins,
bf16 compute) under the same chained-``lax.scan`` protocol as bench.py,
across {model.apply, BN-folded serving path (serving.py)} x batch
sizes. The winner informs bench.py's shipped default —
the driver's round-end number should reflect the fastest *correct* path
(the serving fold is parity-tested vs model.apply in
tests/test_serving.py, so all rows compute the same function).

Needs a GPU; exits with status 1 without one.
Usage: python scripts/bench_probe.py [batch ...]   (default 1024 2048 4096)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_ITERS = 50


def main(argv):
    batches = [int(a) for a in argv] or [1024, 2048, 4096]

    import jax
    import jax.numpy as jnp
    from functools import partial

    from alignnet3d_tpu.config import config_from_dict
    from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
    from alignnet3d_tpu.serving import build_inference_fn

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
        "tpu": {"compute_dtype": "bfloat16"},
    })
    spec = ModelSpec.from_config(cfg)
    model = AlignNet(spec)

    n_iters = N_ITERS
    if jax.devices()[0].platform != "gpu":
        print("bench_probe.py needs a GPU", file=sys.stderr)
        return 1

    rng = np.random.default_rng(0)
    big = max(batches)
    pcs1_all = rng.normal(size=(big, spec.num_points, 3)).astype(np.float32)
    pcs2_all = rng.normal(size=(big, spec.num_points, 3)).astype(np.float32)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(pcs1_all[:2]), jnp.asarray(pcs2_all[:2]), train=False,
    )

    def timed(forward, b):
        a0 = jnp.asarray(pcs1_all[:b])
        b0 = jnp.asarray(pcs2_all[:b])

        @partial(jax.jit, static_argnums=(2,))
        def chained(a, bb, n):
            def body(carry, _):
                a, bb = carry
                out = forward(a, bb)
                delta = out["pred_translations"][:, None, :] * 1e-6
                return (a + delta, bb - delta), out["pred_translations"][0, 0]

            _, probes = jax.lax.scan(body, (a, bb), None, length=n)
            return probes

        np.asarray(chained(a0, b0, n_iters))  # compile + warm
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(chained(a0, b0, n_iters))
            best = min(best, time.perf_counter() - t0)
        return b * n_iters / best

    paths = [("model.apply", lambda a, b: model.apply(variables, a, b,
                                                      train=False))]
    paths.append(("serving-fold", build_inference_fn(spec, variables)))

    print(f"{'path':<22}" + "".join(f"B={b:<10}" for b in batches))
    results = {}
    for name, fn in paths:
        row = []
        for b in batches:
            pps = timed(fn, b)
            results[(name, b)] = pps
            row.append(f"{pps:>9,.0f}  ")
        print(f"{name:<22}" + "".join(row))

    best_key = max(results, key=results.get)
    print(f"\nbest: {best_key[0]} @ B={best_key[1]} -> "
          f"{results[best_key]:,.0f} pairs/s "
          f"({results[best_key] / results[('model.apply', batches[0])]:.3f}x "
          f"current bench.py config)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
