#!/usr/bin/env python
"""Headline benchmark: aligned point-cloud pairs / sec / GPU.

Batched inference of the flagship AlignNet model (SynthCars-scale: N=512
points, 50 angle bins, bfloat16 compute) on the available GPU. Prints
ONE JSON line that names the device it ran on. Without a GPU it exits
with status 1 and prints no result.

Measurement: N_ITERS forwards run CHAINED inside one jitted ``lax.scan``
(each iteration's input is perturbed by the previous output, so nothing
can be elided), and one host readback ends each timed call.

``--mesh`` additionally data-parallelizes the batch over ALL local
devices via a 1-D ``jax.sharding.Mesh`` (params replicated, batch axis
sharded) and reports the device count.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N_ITERS = 50
BATCH = 8192


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    unknown = [a for a in argv if a != "--mesh"]
    if unknown:
        print("usage: bench.py [--mesh]", file=sys.stderr)
        return 2
    use_mesh = "--mesh" in argv

    import jax
    import jax.numpy as jnp
    from functools import partial

    from alignnet3d_tpu.utils import setup_compile_cache

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {device.platform}",
              file=sys.stderr)
        return 1
    setup_compile_cache()

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

    n_dev = len(jax.devices()) if use_mesh else 1
    B, N = BATCH * n_dev, spec.num_points
    rng = np.random.default_rng(0)
    pcs1 = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)
    pcs2 = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        pcs1[:2], pcs2[:2], train=False,
    )

    if use_mesh:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(jax.devices()), ("dp",))
        batch_sharding = NamedSharding(mesh, P("dp"))
        replicated = NamedSharding(mesh, P())
        pcs1 = jax.device_put(pcs1, batch_sharding)
        pcs2 = jax.device_put(pcs2, batch_sharding)
        variables = jax.device_put(variables, replicated)

    # Weights are CLOSURE-CAPTURED (compile-time constants), the
    # deployment semantics of a serving engine (jax.export/AOT does the
    # same): XLA can then fold BN scales into the convs and fix weight
    # layouts at compile time.
    @partial(jax.jit, static_argnums=(2,))
    def chained(a, b, n):
        def body(carry, _):
            a, b = carry
            out = model.apply(variables, a, b, train=False)
            delta = out["pred_translations"][:, None, :] * 1e-6
            return (a + delta, b - delta), out["pred_translations"][0, 0]

        _, probes = jax.lax.scan(body, (a, b), None, length=n)
        return probes

    # warmup + compile (host readback forces completion)
    np.asarray(chained(pcs1, pcs2, N_ITERS))

    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(chained(pcs1, pcs2, N_ITERS))
        best = min(best, time.perf_counter() - t0)

    pairs_per_sec = B * N_ITERS / best
    record = {
        "metric": "align_pairs_per_sec",
        "value": pairs_per_sec,
        "unit": "pairs/s",
        "device": {"platform": device.platform,
                   "kind": device.device_kind, "count": n_dev},
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
