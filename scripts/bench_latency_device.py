"""Device-bound single-pair (bs=1) forward latency.

The end-to-end p50 at bs=1 (scripts/bench_latency.py) is floored by the
per-call host dispatch cost; this measures what the device needs per
single-pair forward by chaining many bs=1 forwards inside one jitted
lax.scan (each iteration consumes the previous output, so nothing can
be elided) and amortizing the one dispatch+readback over the chain.

    python scripts/bench_latency_device.py [chain_len]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    chain = int(sys.argv[1]) if len(sys.argv) > 1 else 512

    import jax
    import jax.numpy as jnp
    from functools import partial

    from alignnet3d_tpu.config import config_from_dict
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
        "tpu": {"compute_dtype": "bfloat16"},
    })
    spec = ModelSpec.from_config(cfg)
    model = AlignNet(spec)

    rng = np.random.default_rng(0)
    pcs1 = jnp.asarray(rng.normal(size=(1, spec.num_points, 3)), jnp.float32)
    pcs2 = jnp.asarray(rng.normal(size=(1, spec.num_points, 3)), jnp.float32)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        pcs1, pcs2, train=False,
    )

    @partial(jax.jit, static_argnums=(3,))
    def chained(v, a, b, n):
        def body(carry, _):
            a, b = carry
            out = model.apply(v, a, b, train=False)
            delta = out["pred_translations"][:, None, :] * 1e-6
            return (a + delta, b - delta), out["pred_translations"][0, 0]

        _, probes = jax.lax.scan(body, (a, b), None, length=n)
        return probes

    np.asarray(chained(variables, pcs1, pcs2, chain))  # compile + warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.asarray(chained(variables, pcs1, pcs2, chain))
        times.append((time.perf_counter() - t0) / chain)
    times.sort()
    print(json.dumps({
        "metric": "bs1_device_forward_latency_p50",
        "value": round(times[len(times) // 2] * 1e3, 4),
        "unit": "ms",
        "chain_len": chain,
        "best_ms": round(times[0] * 1e3, 4),
    }))


if __name__ == "__main__":
    main()
