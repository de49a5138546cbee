#!/usr/bin/env python
"""Run the main path once on one GPU and check every result.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: the sharded training
                                        # step against the one-card step

Phases, each printing one JSON line:

- device: platform, device kind and count, ``nvidia-smi`` name and power
  limit, jax/jaxlib versions, XLA_FLAGS, the compile-cache directory;
- data: a synthetic LiDAR dataset generated from ``--seed`` (set-up);
- serve_pointnet: the flagship PointNet AlignNet
  (configs/SynthCars80kCenterSupScratch.json, random weights from the
  seed) through ``build_inference_fn`` in float32 and bfloat16 against
  ``model.apply`` at HIGHEST precision, ``Aligner.align`` with network
  and ICP refinement on ragged clouds, and a ``"cuda"`` export round trip
  (in memory);
- serve_dgcnn: the DGCNN widths of configs/SynthCars40kDGCNN.json, the
  folded edge stage against ``model.apply`` and the kNN graph against a
  float64 brute force;
- icp: point-to-point and point-to-plane ICP and flip resolution on
  padded clouds of up to 4,096 points, correspondences against float64,
  transforms against the same functions on the CPU device;
- baselines: device times of the plain-XLA ops on the hot paths;
- train: ``cli.main(["train", ...])`` on the flagship config, its
  eval, and ``Aligner.from_checkpoint`` on the saved ``.npz``;
- grads: one training-step gradient with plain and ``stable_max``
  max-pool gradients, for PointNet and DGCNN, and the step's loss on
  the GPU against the CPU device.

A failed check raises, and the script exits non-zero. Nothing falls back
to the CPU. The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU, or without the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(HERE, "configs", "SynthCars80kCenterSupScratch.json")
DGCNN = os.path.join(HERE, "configs", "SynthCars40kDGCNN.json")
# gitignored work directories inside the checkout, emptied on every run
DATA_DIR = os.path.join(HERE, "data", "chip_smoke")
RUNS_DIR = os.path.join(HERE, "runs", "chip_smoke")
# problem sizes (pairs per batch, scenes generated)
SERVE_PAIRS = 1024
DGCNN_PAIRS = 128
ICP_PAIRS = 64
GRAD_PAIRS = 128
TRAIN_SCENES, VAL_SCENES = 512, 128


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=_jsonable),
          flush=True)


def _jsonable(x):
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def assert_close(got, want, rtol: float, atol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return
    the largest absolute deviation."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    check(np.all(np.isfinite(got)), f"{what}: non-finite values")
    dev = np.abs(got - want)
    bad = dev > atol + rtol * np.abs(want)
    check(not bad.any(), f"{what}: {int(bad.sum())} values beyond "
          f"rtol={rtol} atol={atol}, max deviation {dev.max():.3g}")
    return float(dev.max())


def median_ms(fn, *args, reps: int = 10) -> float:
    """Median device time of ``fn(*args)`` in ms (compiled and warm)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def rel_l2(tree, ref) -> float:
    """Relative L2 distance of two pytrees of arrays, over all leaves."""
    import jax

    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2))
              for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2))
              for y in jax.tree.leaves(ref))
    return (num / den) ** 0.5


def load_cfg(path: str):
    from alignnet3d_tpu.config import config_from_dict

    with open(path) as f:
        return config_from_dict(json.load(f))


def warm_variables(spec, seed: int, batch):
    """Seeded init, then two train-mode passes so the BN running stats
    (which serving folds into the weights) are not the identity."""
    import jax

    from alignnet3d_tpu.models.alignnet import AlignNet

    model = AlignNet(spec)
    a, b = batch
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           a[:2], b[:2], train=False)
    step = jax.jit(lambda v, x, y, k: model.apply(
        v, x, y, train=True, momentum=0.5, mutable=["batch_stats"],
        rngs={"dropout": k})[1])
    for i in range(2):
        stats = step(variables, a, b, jax.random.PRNGKey(seed + i))
        variables = {"params": variables["params"], **stats}
    return model, variables


def knn_mismatch_gap(points, idx, k):
    """Largest squared-distance gap, over the row's distance scale,
    between the chosen neighbour and the float64 brute force's at the
    same rank (0 where they agree)."""
    p = np.asarray(points, np.float64)
    got = np.asarray(idx)
    worst, n_off = 0.0, 0
    for bi in range(p.shape[0]):
        d = np.sum((p[bi, :, None, :] - p[bi, None, :, :]) ** 2, axis=-1)
        ref = np.argsort(d, axis=-1, kind="stable")[:, :k]
        off = got[bi] != ref
        if off.any():
            scale = 1.0 + np.sum(p[bi] ** 2, axis=-1).max()
            gap = np.abs(np.take_along_axis(d, got[bi], -1)
                         - np.take_along_axis(d, ref, -1)) / scale
            worst = max(worst, float(gap[off].max()))
            n_off += int(off.sum())
    return worst, n_off


def nn_mismatch_gap(src, dst, mask, idx):
    """``knn_mismatch_gap`` for masked nearest neighbours (k = 1)."""
    s = np.asarray(src, np.float64)
    d = np.asarray(dst, np.float64)
    d2 = np.sum((s[:, None, :] - d[None, :, :]) ** 2, axis=-1)
    d2[:, ~np.asarray(mask)] = np.inf
    ref = np.argmin(d2, axis=1)
    idx = np.asarray(idx)
    off = idx != ref
    if not off.any():
        return 0.0, 0
    rows = np.arange(len(idx))
    scale = 1.0 + np.max(np.sum(d[np.asarray(mask)] ** 2, axis=-1))
    gap = np.abs(d2[rows, idx] - d2[rows, ref]) / scale
    return float(gap[off].max()), int(off.sum())


# a float32 distance |a|^2 - 2ab + |b|^2 carries a rounding error of a few
# ulp of the squared norms; two candidates closer than this are a tie
TIE_EPS = 1e-5


# ------------------------------------------------------------------ phases


def phase_device(count_wanted: int):
    import jax
    import jaxlib

    from alignnet3d_tpu.utils import setup_compile_cache

    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {device.platform}")
    if len(jax.devices()) < count_wanted:
        sys.exit(f"needs {count_wanted} GPUs; JAX found {len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    cache_dir = setup_compile_cache()
    for line in smi.splitlines():
        print(line, flush=True)
    emit("device", platform=device.platform, kind=device.device_kind,
         count=len(jax.devices()), nvidia_smi=smi.splitlines(),
         jax=jax.__version__, jaxlib=jaxlib.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache_dir)
    return device


def phase_data(seed: int, num_train: int, num_val: int):
    from alignnet3d_tpu.data import native_loader
    from alignnet3d_tpu.data.provider import PackedDataset
    from alignnet3d_tpu.data.synthetic import generate_dataset

    t0 = time.perf_counter()
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    generate_dataset(DATA_DIR, num_train=num_train, num_val=num_val,
                     seed=seed)
    dataset = PackedDataset(DATA_DIR)
    loader = "native" if native_loader.get_lib() is not None else "numpy"
    emit("data", scenes=len(dataset), loader=loader,
         points_per_cloud_median=float(np.median(dataset.counts1)),
         points_per_cloud_max=int(dataset.counts1.max()),
         seconds=time.perf_counter() - t0)
    return dataset, loader


def sample(dataset, n_pairs: int, num_points: int, seed: int):
    idx = np.arange(n_pairs) % len(dataset)
    rng = np.random.default_rng(seed)
    return dataset.sample_batch(list(dataset.indices[idx]), num_points, rng)


def raw_clouds(dataset, rows):
    out = ([], [])
    for k, acc in zip((1, 2), out):
        pts = getattr(dataset, f"points{k}")
        offs = getattr(dataset, f"offsets{k}")
        counts = getattr(dataset, f"counts{k}")
        for r in rows:
            acc.append(np.asarray(pts[offs[r]:offs[r] + counts[r]],
                                  np.float32))
    return out


def phase_serve_pointnet(dataset, seed: int):
    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.api import Aligner
    from alignnet3d_tpu.export import export_forward, load_exported
    from alignnet3d_tpu.models.alignnet import ModelSpec
    from alignnet3d_tpu.serving import build_inference_fn

    t_phase = time.perf_counter()
    spec = ModelSpec.from_config(load_cfg(FLAGSHIP))
    B = SERVE_PAIRS
    batch = sample(dataset, B, spec.num_points, seed)
    a, b = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    model, variables = warm_variables(spec, seed, (a[:128], b[:128]))

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda x, y: model.apply(variables, x, y,
                                               train=False))(a, b)
        f32 = jax.jit(build_inference_fn(spec, variables,
                                         compute_dtype=jnp.float32))(a, b)
    # float32 at HIGHEST: folding BN into the weights reassociates float32
    # sums (tests/test_serving.py tolerance)
    dev_f32 = {k: assert_close(f32[k], ref[k], 2e-4, 2e-4, f"f32 {k}")
               for k in ref}
    tf32 = jax.jit(build_inference_fn(spec, variables,
                                      compute_dtype=jnp.float32))(a, b)
    dev_tf32 = {k: float(np.max(np.abs(np.asarray(tf32[k], np.float64)
                                       - np.asarray(ref[k], np.float64))))
                for k in ref}
    serve = jax.jit(build_inference_fn(spec, variables))
    bf16 = serve(a, b)
    # bfloat16 operands through three stacked stages cost centimetres on
    # an untrained net (tests/test_serving.py tolerance)
    dev_bf16 = assert_close(bf16["pred_s2_pc1centers"],
                            ref["pred_s2_pc1centers"], 0.0, 0.15,
                            "bf16 pred_s2_pc1centers")
    compiled = serve.lower(a, b).compile()
    mem = compiled.memory_analysis()
    memory = {f: int(getattr(mem, f)) for f in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, f)}
    forward_ms = median_ms(compiled, a, b, reps=20)

    # served requests: ragged raw clouds of 200 to 4,400 points
    rows = [r for r in range(len(dataset))
            if 200 <= dataset.counts1[r] <= 4400
            and 200 <= dataset.counts2[r] <= 4400]
    check(len(rows) >= 48, f"only {len(rows)} clouds in 200..4400 points")
    aligner = Aligner(spec, variables, seed=seed)
    sizes = []
    t0 = time.perf_counter()
    for req, n in enumerate((16, 32)):
        pcs1, pcs2 = raw_clouds(dataset, rows[req * 16:req * 16 + n])
        sizes += [len(p) for p in pcs1 + pcs2]
        res = aligner.align(pcs1, pcs2, refine_icp=True, network_refine=True)
        for key, shape in (("translations", (n, 3)), ("angles", (n,)),
                           ("centers", (n, 3)), ("transforms", (n, 4, 4))):
            check(res[key].shape == shape, f"align {key} {res[key].shape}")
            check(np.all(np.isfinite(res[key])), f"align {key} non-finite")
    align_s = time.perf_counter() - t0

    # the in-memory artifact: writing its bytes needs the flatbuffers
    # package, which the GPU machine need not have
    exported = export_forward(spec, variables, platforms=("cuda",))
    infer = load_exported(exported)
    got = infer(a[:B // 4], b[:B // 4])
    want = serve(a[:B // 4], b[:B // 4])
    # the same bfloat16 StableHLO compiled twice: autotuning may pick
    # another matmul algorithm, which moves bfloat16 rounding
    dev_export = {k: assert_close(got[k], want[k], 1e-2, 1e-2, f"export {k}")
                  for k in want}
    emit("serve_pointnet", batch=B, num_points=spec.num_points,
         max_dev_f32_highest=dev_f32, max_dev_f32_default_tf32=dev_tf32,
         max_dev_bf16_s2_center_m=dev_bf16, max_dev_export=dev_export,
         export_stablehlo_bytes=len(exported.mlir_module_serialized),
         memory=memory,
         bf16_forward_median_ms=forward_ms,
         align_requests=2, align_cloud_sizes=[min(sizes), max(sizes)],
         align_seconds_incl_compile=align_s,
         seconds=time.perf_counter() - t_phase)
    return spec, variables, compiled, a, b


def phase_serve_dgcnn(dataset, seed: int):
    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.models.alignnet import ModelSpec
    from alignnet3d_tpu.models.backbones import DGCNNBackbone
    from alignnet3d_tpu.ops.knn import knn, pairwise_distance
    from alignnet3d_tpu.serving import _FoldedDGCNN, build_inference_fn

    t_phase = time.perf_counter()
    spec = ModelSpec.from_config(load_cfg(DGCNN))
    B, k = DGCNN_PAIRS, 20
    batch = sample(dataset, B, spec.num_points, seed + 1)
    a, b = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    model, variables = warm_variables(spec, seed, (a, b))
    params, stats = variables["params"], variables["batch_stats"]
    stacked = jnp.concatenate([a, b])
    x = stacked - jnp.mean(stacked, axis=1, keepdims=True)

    # each backbone's folded edge stage against the model's own backbone
    # on the same points (so the same kNN graph), float32 at HIGHEST
    dev_backbone = {}
    for name, sizes in (("transformer1", spec.s1_backbone),
                        ("transformer2", spec.s2_backbone),
                        ("embedding", spec.embedding)):
        tree = (lambda t: t["siamese"]["DGCNNBackbone_0"]
                if name == "embedding"
                else t["siamese"][name]["DGCNNBackbone_0"])
        p, s = tree(params), tree(stats)
        with jax.default_matmul_precision("highest"):
            want = jax.jit(lambda v: DGCNNBackbone(tuple(sizes), k=k).apply(
                {"params": p, "batch_stats": s}, v, train=False,
                momentum=0.9))(x)
            got = jax.jit(lambda v: _FoldedDGCNN(p, s, len(sizes), k=k)(
                v, jnp.float32))(x)
        # BN folding reassociates float32 sums over C1 x k edge terms
        # (tests/test_serving.py DGCNN tolerance)
        dev_backbone[name] = assert_close(got, want, 5e-4, 5e-4,
                                          f"dgcnn {name} backbone")

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda u, v: model.apply(variables, u, v,
                                               train=False))(a, b)
        f32 = jax.jit(build_inference_fn(spec, variables,
                                         compute_dtype=jnp.float32))(a, b)
    dev_model = {kk: float(np.max(np.abs(np.asarray(f32[kk], np.float64)
                                          - np.asarray(ref[kk], np.float64))))
                 for kk in ref}
    for kk in ref:
        check(np.all(np.isfinite(np.asarray(f32[kk]))), f"dgcnn {kk}")

    # kNN graph at the default (TF32) matmul precision: the distance
    # product pins HIGHEST, so only float32 near ties may differ
    idx = jax.jit(lambda v: knn(pairwise_distance(v), k))(x)
    gap, n_off = knn_mismatch_gap(x, idx, k)
    check(gap <= TIE_EPS, f"kNN differs from float64 beyond ties: {gap:.3g}")
    emit("serve_dgcnn", batch=B, num_points=spec.num_points, k=k,
         max_dev_backbone_f32_highest=dev_backbone,
         max_dev_model_f32_highest=dev_model,
         knn_rows=int(x.shape[0] * x.shape[1]), knn_tie_swaps=n_off,
         knn_max_tie_gap=gap, seconds=time.perf_counter() - t_phase)
    return spec, variables, x


def phase_icp(dataset, seed: int):
    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.geometry import get_mat_angle
    from alignnet3d_tpu.icp.p2plane import icp_p2plane_batch
    from alignnet3d_tpu.icp.p2point import (
        _nn_correspondences,
        icp_p2point_batch,
        pad_full_clouds,
    )
    from alignnet3d_tpu.ops.flip_resolve import resolve_flips

    t_phase = time.perf_counter()
    B = ICP_PAIRS
    rng = np.random.default_rng(seed + 2)
    # the 64 scenes with the most points, so the padding reaches 4,096
    order = np.argsort(-np.maximum(dataset.counts1, dataset.counts2))
    file_idx = list(dataset.indices[np.sort(order[:B])])
    (src, sm), (dst, dm) = pad_full_clouds(dataset, file_idx,
                                           max_points=4096)
    labels = dataset.sample_batch(file_idx, 1024, rng)
    t_gt, a_gt, c1 = labels[2], labels[3].reshape(-1), labels[4]
    init = np.stack([
        get_mat_angle(t_gt[i] + rng.normal(0, 0.1, 3) * [1, 1, 0],
                      a_gt[i] + rng.normal(0, 0.03), rotation_center=c1[i])
        for i in range(B)])

    t0 = time.perf_counter()
    tf_pp, fit_pp, _ = icp_p2point_batch(src, sm, dst, dm, init,
                                         radius=0.1, its=30)
    tf_pl, fit_pl, _ = icp_p2plane_batch(src, sm, dst, dm, init,
                                         radius=0.1, its=30)
    icp_s = time.perf_counter() - t0
    for name, tf in (("p2point", tf_pp), ("p2plane", tf_pl)):
        check(np.all(np.isfinite(tf)), f"{name} non-finite")

    # correspondences of the initial pose against float64
    moved = np.einsum("bij,bnj->bni", init[:, :3, :3], src) \
        + init[:, None, :3, 3]
    moved = moved.astype(np.float32)
    nn_idx, _ = jax.jit(jax.vmap(_nn_correspondences))(
        jnp.asarray(moved), jnp.asarray(dst), jnp.asarray(dm))
    nn_gap, nn_off = 0.0, 0
    for i in range(4):
        g, o = nn_mismatch_gap(moved[i], dst[i], dm[i], np.asarray(nn_idx[i]))
        nn_gap, nn_off = max(nn_gap, g), nn_off + o
    check(nn_gap <= TIE_EPS, f"NN differs from float64 beyond ties: {nn_gap}")

    def yaw(tf):
        return np.arctan2(tf[:, 1, 0], tf[:, 0, 0])

    def deviation(x, y):
        return (float(np.abs(x[:, :3, 3] - y[:, :3, 3]).max()),
                float(np.abs((yaw(x) - yaw(y) + np.pi) % (2 * np.pi)
                             - np.pi).max()))

    # Final transforms against the same jitted functions on the CPU.
    # Partial-overlap pairs are not a fair test: after 30 iterations
    # their result moves by millimetres when an input moves by one ulp
    # (the order of float32 sums differs between backends). Full-overlap
    # pairs with a known answer converge, so there the backends must
    # agree: each real cloud against a rigidly moved copy of itself.
    n_cpu = 8
    gt = np.stack([get_mat_angle(rng.normal(0, 0.5, 3) * [1, 1, 0.1],
                                 rng.normal(0, 0.2)) for _ in range(n_cpu)])
    s8, m8 = src[:n_cpu], sm[:n_cpu]
    copy = (np.einsum("bij,bnj->bni", gt[:, :3, :3], s8)
            + gt[:, None, :3, 3]).astype(np.float32)
    copy[~m8] = 0.0
    start = np.einsum("bij,bjk->bik", np.stack([
        get_mat_angle(rng.normal(0, 0.05, 3) * [1, 1, 0],
                      rng.normal(0, 0.02)) for _ in range(n_cpu)]), gt)
    runs = {}
    for dev_name, ctx in (("gpu", None), ("cpu", jax.devices("cpu")[0])):
        for name, fn in (("p2point", icp_p2point_batch),
                         ("p2plane", icp_p2plane_batch)):
            with jax.default_device(ctx):
                runs[name, dev_name] = fn(s8, m8, copy, m8, start,
                                          radius=0.1, its=30)[0]
        # real pairs too, for the record
        with jax.default_device(ctx):
            runs["real", dev_name] = icp_p2point_batch(
                src[:n_cpu], sm[:n_cpu], dst[:n_cpu], dm[:n_cpu],
                init[:n_cpu], radius=0.1, its=30)[0]
    # every product in ICP pins its precision, so a HIGHEST default
    # changes nothing on the GPU
    with jax.default_matmul_precision("highest"):
        runs["p2plane", "gpu_highest"] = icp_p2plane_batch(
            s8, m8, copy, m8, start, radius=0.1, its=30)[0]
    dev = {}
    for name in ("p2point", "p2plane"):
        dt, da = deviation(runs[name, "gpu"], runs[name, "cpu"])
        check(dt <= 1e-4 and da <= 1e-4,
              f"{name} GPU vs CPU: {dt:.3g} m, {da:.3g} rad")
        dev[name] = {"m": dt, "rad": da}
    dt, da = deviation(runs["p2plane", "gpu"], gt)
    check(dt <= 1e-4 and da <= 1e-4, f"p2plane misses a full-overlap "
          f"pair's known motion by {dt:.3g} m, {da:.3g} rad")
    dev["p2plane_vs_known_motion"] = {"m": dt, "rad": da}
    dt, da = deviation(runs["p2plane", "gpu"], runs["p2plane", "gpu_highest"])
    check(dt <= 1e-5 and da <= 1e-5,
          f"GPU ICP changes with the default precision: {dt:.3g} m")
    dev["p2plane_default_vs_highest"] = {"m": dt, "rad": da}
    dt, da = deviation(runs["real", "gpu"], runs["real", "cpu"])
    dev["p2point_partial_overlap_info"] = {"m": dt, "rad": da}

    # flip resolution against float64 chamfer scores
    pcs1, pcs2 = labels[0], labels[1]
    ang = a_gt + rng.normal(0, 0.05, B)
    flip, d, d_flip = resolve_flips(
        jnp.asarray(pcs1), jnp.asarray(pcs2), jnp.asarray(t_gt),
        jnp.asarray(ang, jnp.float32), jnp.asarray(c1))

    def chamfer(p, q):
        return np.array([
            np.mean(np.sqrt(np.min(np.sum(
                (pi[:, None, :] - qi[None, :, :]) ** 2, -1), axis=1)))
            for pi, qi in zip(p, q)])

    def rigid(p, t, a, c):
        cs, sn = np.cos(a), np.sin(a)
        r = np.stack([np.stack([cs, -sn, 0 * a], -1),
                      np.stack([sn, cs, 0 * a], -1),
                      np.stack([0 * a, 0 * a, 1 + 0 * a], -1)], -2)
        return np.einsum("bij,bnj->bni", r, p - c[:, None]) \
            + (c + t)[:, None]

    p1 = pcs1.astype(np.float64)
    p2 = pcs2.astype(np.float64)
    args = (t_gt.astype(np.float64), ang, c1.astype(np.float64))
    d64 = chamfer(rigid(p1, *args), p2)
    df64 = chamfer(rigid(p1, args[0], ang + np.pi, args[2]), p2)
    decided = np.abs(d64 - df64) > 1e-4 * np.maximum(d64, df64)
    check(np.all(np.asarray(flip)[decided] == (df64 < d64)[decided]),
          "resolve_flips disagrees with float64")
    assert_close(d, d64, 1e-4, 1e-5, "chamfer score")
    emit("icp", pairs=B, padded_points=int(src.shape[1]),
         p2point_mean_fitness=float(np.mean(fit_pp)),
         p2plane_mean_fitness=float(np.mean(fit_pl)),
         icp_seconds_incl_compile=icp_s, nn_tie_swaps=nn_off,
         nn_max_tie_gap=nn_gap, max_dev_gpu_vs_cpu=dev,
         flips=int(np.sum(flip)), flip_pairs_decided=int(decided.sum()),
         seconds=time.perf_counter() - t_phase)
    return src, sm, dst, dm


def phase_baselines(pn, dg, icp_clouds):
    """Device time of the plain-XLA op behind each hot path, at the
    widths the phases above ran."""
    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.icp.p2point import _nn_correspondences
    from alignnet3d_tpu.models.backbones import DGCNNBackbone
    from alignnet3d_tpu.ops.knn import gather_rows, knn, pairwise_distance
    from alignnet3d_tpu.serving import (
        _fold_chain,
        folded_edge_stage,
        fused_pointnet_xla,
    )

    pn_spec, pn_vars, _, a, b = pn
    dg_spec, _, x = dg
    src, sm, dst, dm = icp_clouds
    out = {}

    enc = pn_vars["params"]["siamese"]["PointNetBackbone_0"]
    enc_s = pn_vars["batch_stats"]["siamese"]["PointNetBackbone_0"]
    w, bias = _fold_chain(enc, enc_s, "conv", len(pn_spec.embedding))
    pts = jnp.concatenate([a, b])
    chain = jax.jit(lambda p: fused_pointnet_xla(p, w, bias))
    out["pointnet_embedding_chain_bf16"] = {
        "shape": list(pts.shape), "ms": median_ms(chain, pts)}

    k = 20
    knn_fn = jax.jit(lambda v: knn(pairwise_distance(v), k))
    out["knn_top_k"] = {"shape": list(x.shape), "k": k,
                        "ms": median_ms(knn_fn, x)}
    idx = knn_fn(x)
    gather = jax.jit(lambda v, i: gather_rows(v, i))
    v64 = jnp.ones(x.shape[:2] + (64,), jnp.float32)
    out["neighbour_gather_c64"] = {"ms": median_ms(gather, v64, idx)}

    rng = np.random.default_rng(0)
    w1 = jnp.asarray(rng.normal(size=(6, 64)) / 2, jnp.float32)
    w2 = jnp.asarray(rng.normal(size=(64, 128)) / 8, jnp.float32)
    b1 = jnp.zeros((64,), jnp.float32)
    b2 = jnp.zeros((128,), jnp.float32)
    edge = jax.jit(lambda v, i: folded_edge_stage(v, i, w1, b1, w2, b2))
    out["folded_edge_stage_bf16_64_128"] = {"ms": median_ms(edge, x, idx)}

    layers = tuple(dg_spec.embedding)
    bb = DGCNNBackbone(layers, k=k)
    bb_vars = bb.init({"params": jax.random.PRNGKey(0)}, x[:2], train=False,
                      momentum=0.9)

    def train_loss(p, v):
        out_, _ = bb.apply({"params": p, "batch_stats":
                            bb_vars["batch_stats"]}, v, train=True,
                           momentum=0.9, mutable=["batch_stats"])
        return jnp.sum(out_)

    grad = jax.jit(jax.grad(train_loss))
    out["dgcnn_backbone_train_fwd_bwd_f32"] = {
        "layers": list(layers), "ms": median_ms(grad, bb_vars["params"], x)}

    nn = jax.jit(jax.vmap(_nn_correspondences))
    s, d_, m = jnp.asarray(src), jnp.asarray(dst), jnp.asarray(dm)
    out["icp_nn_argmin"] = {"shape": list(src.shape),
                            "ms": median_ms(nn, s, d_, m)}
    emit("baselines", ops=out)


def phase_train(seed: int, loader: str):
    from alignnet3d_tpu.api import Aligner
    from alignnet3d_tpu.cli import main as cli_main

    t_phase = time.perf_counter()
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    os.makedirs(RUNS_DIR)
    with open(FLAGSHIP) as f:
        cfg = json.load(f)
    cfg["data"]["basepath"] = DATA_DIR
    cfg["logging"]["basedir"] = RUNS_DIR
    cfg["training"]["num_epochs"] = 1
    cfg_path = os.path.join(RUNS_DIR, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    cli_main(["train", "--config", cfg_path, "--seed", str(seed)])
    train_s = time.perf_counter() - t0

    logdir = os.path.join(RUNS_DIR, "flagship")
    with open(os.path.join(logdir, "train", "scalars.jsonl")) as f:
        losses = [json.loads(line)["losses/loss"] for line in f]
    check(len(losses) > 0 and np.all(np.isfinite(losses)),
          f"train losses {losses}")
    with open(os.path.join(logdir, "val", "eval000000", "eval.json")) as f:
        ev = json.load(f)
    with open(os.path.join(logdir, "out.log")) as f:
        progress = re.findall(r"progress (train epoch 0: .*)", f.read())
    ckpt = os.path.join(logdir, "model-0.npz")
    aligner = Aligner.from_checkpoint(os.path.join(logdir, "config.json"),
                                      ckpt)
    from alignnet3d_tpu.data.provider import PackedDataset

    ds = PackedDataset(DATA_DIR)
    pcs1, pcs2 = raw_clouds(ds, range(8))
    res = aligner.align(pcs1, pcs2)
    check(np.all(np.isfinite(res["transforms"])), "reloaded align")
    emit("train", steps=len(losses), batch=cfg["training"]["batch_size"],
         losses=losses, eval_pairs=ev["num"],
         eval_corr_levels=ev["corr_levels"], loader=loader,
         epoch_progress_incl_compile=progress,
         train_and_eval_seconds_incl_compile=train_s,
         checkpoint_bytes=os.path.getsize(ckpt),
         seconds=time.perf_counter() - t_phase)


def phase_grads(dataset, seed: int):
    import jax
    import jax.numpy as jnp

    from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
    from alignnet3d_tpu.models.losses import LossSpec, get_loss

    t_phase = time.perf_counter()
    result = {}
    for name, path in (("pointnet", FLAGSHIP), ("dgcnn", DGCNN)):
        cfg = load_cfg(path)
        spec = ModelSpec.from_config(cfg)
        loss_spec = LossSpec.from_config(cfg)
        batch = tuple(jnp.asarray(x) for x in sample(
            dataset, GRAD_PAIRS, spec.num_points, seed + 3))
        model, variables = warm_variables(spec, seed, batch[:2])
        key = jax.random.PRNGKey(seed + 4)

        def make(spec_):
            m = AlignNet(spec_)

            def loss_fn(params, stats, batch_):
                out, _ = m.apply({"params": params, "batch_stats": stats},
                                 batch_[0], batch_[1], train=True,
                                 momentum=0.5, mutable=["batch_stats"],
                                 rngs={"dropout": key})
                return get_loss(*batch_, out, spec=loss_spec)[0]

            return loss_fn

        plain = make(dataclasses.replace(spec, stable_max_grad=False))
        stable = make(dataclasses.replace(spec, stable_max_grad=True))
        args = (variables["params"], variables["batch_stats"], batch)
        with jax.default_matmul_precision("highest"):
            loss_p, g_p = jax.jit(jax.value_and_grad(plain))(*args)
            loss_s, g_s = jax.jit(jax.value_and_grad(stable))(*args)
            rel = rel_l2(*jax.device_get((g_p, g_s)))
            cpu = jax.devices("cpu")[0]
            cpu_args = jax.device_put(args, cpu)
            loss_cpu = float(jax.jit(plain)(*cpu_args))
        step_ms = median_ms(jax.jit(jax.value_and_grad(plain)), *args,
                            reps=5)
        # the same float32 step on two backends sums 2 x 128 x N points
        # in another order
        check(abs(float(loss_p) - loss_cpu) <= 1e-4 * abs(loss_cpu),
              f"{name} loss GPU {float(loss_p)} vs CPU {loss_cpu}")
        check(np.isfinite(rel), f"{name} gradient non-finite")
        if name == "pointnet":
            check(rel <= 1e-3, f"pointnet plain-max gradient drops mass: "
                  f"relative L2 {rel:.3g} vs stable_max")
        result[name] = {"grad_rel_l2_plain_vs_stable": rel,
                        "loss_gpu_highest": float(loss_p),
                        "loss_cpu": loss_cpu,
                        "loss_stable": float(loss_s),
                        "value_and_grad_default_precision_ms": step_ms}
    emit("grads", batch=GRAD_PAIRS, **result,
         seconds=time.perf_counter() - t_phase)


def phase_four_cards(seed: int):
    """One Trainer step on the same global batch at dp=4 x mp=1 and
    dp=2 x mp=2 against the one-card step, all at HIGHEST precision,
    with the plain max-pool gradient and with ``stable_max``."""
    import jax

    from alignnet3d_tpu.config import load_config
    from alignnet3d_tpu.training import Trainer

    t_phase = time.perf_counter()
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    os.makedirs(RUNS_DIR)
    with open(FLAGSHIP) as f:
        base = json.load(f)
    base["data"]["basepath"] = DATA_DIR
    base["logging"]["basedir"] = RUNS_DIR
    lr = base["training"]["learning_rate"]
    meshes = ((1, 1), (4, 1), (2, 2))
    results = {}
    for stable in (False, True):
        for dp, mp in meshes:
            cfg = json.loads(json.dumps(base))
            cfg.setdefault("tpu", {})["mesh"] = {"dp": dp, "mp": mp}
            cfg["model"]["options"]["stable_max_grad"] = stable
            path = os.path.join(RUNS_DIR, f"mesh_{dp}x{mp}_{int(stable)}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            trainer = Trainer(load_config(path), seed=seed)
            check(trainer.mesh.devices.size == dp * mp,
                  f"mesh {trainer.mesh.devices.shape}")
            rng = np.random.default_rng(seed)
            batch = trainer._make_batch(
                trainer.train_indices[:trainer.batch_size], rng=rng)
            with jax.default_matmul_precision("highest"):
                state = trainer.init_state()
                step = trainer._get_jitted("train")
                new, metrics = step(state, batch, jax.random.PRNGKey(seed))
                results[stable, dp, mp] = (
                    float(metrics["losses/loss"]),
                    jax.device_get(new.params),
                    jax.device_get(new.opt_state[0].mu))
    report = {}
    for stable in (False, True):
        loss1, params1, mu1 = results[stable, 1, 1]
        name = "stable_max" if stable else "plain_max"
        report[name] = {"loss_one_card": loss1}
        for dp, mp in meshes[1:]:
            loss, params, mu = results[stable, dp, mp]
            # float32 sums over 2 x 128 x 1,024 points in another order
            check(abs(loss - loss1) <= 1e-5 * abs(loss1),
                  f"{name} dp={dp} mp={mp} loss {loss} vs {loss1}")
            # Adam's first moment after one step is 0.1 x the gradient
            grad_rel = rel_l2(mu, mu1)
            row = {"loss": loss, "grad_rel_l2": grad_rel}
            report[name][f"dp{dp}_mp{mp}"] = row
            # The loss (the forward) agrees to 1e-5, but this model's
            # float32 gradient moves by 5e-4 to 5e-3 in relative L2 when
            # only the order of its sums changes (reversing a batch of 8
            # on the CPU: 5.4e-4; two meshes on the GPU: about 5e-3), so
            # agreement is checked at 1e-2
            check(grad_rel <= 1e-2,
                  f"{name} dp={dp} mp={mp} gradient rel L2 {grad_rel}")
            # Adam's first step moves each weight by lr * g / (|g| + 1e-8)
            # (mu = 0.1 g). Where |g| exceeds the two meshes' gradient
            # difference tenfold and 1e-6, that is lr * sign(g) to within
            # 5e-6, so the weights agree; elsewhere they may differ by up
            # to 2 lr
            moved, n_unsettled = 0.0, 0
            for x, y, g4, g1 in zip(jax.tree.leaves(params),
                                    jax.tree.leaves(params1),
                                    jax.tree.leaves(mu), jax.tree.leaves(mu1)):
                x, y, g4, g1 = (np.asarray(v, np.float64)
                                for v in (x, y, g4, g1))
                settled = ((np.abs(g1) > 10 * np.abs(g4 - g1))
                           & (np.abs(g1) > 1e-7))
                diff = np.abs(x - y)
                n_unsettled += int((~settled).sum())
                check(np.all(diff <= 2 * lr * (1 + 1e-3)),
                      "weights moved apart by more than Adam allows")
                moved = max(moved, float(diff[settled].max(initial=0.0)))
            check(moved <= 1e-5, f"{name} dp={dp} mp={mp} params differ "
                  f"by {moved}")
            row.update(max_param_dev_settled=moved,
                       unsettled_weights=n_unsettled)
    emit("four_cards", batch=base["training"]["batch_size"], **report,
         seconds=time.perf_counter() - t_phase)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded training step on 4 GPUs")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax

    count = 4 if args.four_cards else 1
    device = phase_device(count)
    if args.four_cards:
        with open(FLAGSHIP) as f:
            batch_size = json.load(f)["training"]["batch_size"]
        phase_data(args.seed, num_train=batch_size, num_val=16)
        phase_four_cards(args.seed)
    else:
        dataset, loader = phase_data(args.seed, TRAIN_SCENES, VAL_SCENES)
        pn = phase_serve_pointnet(dataset, args.seed)
        dg = phase_serve_dgcnn(dataset, args.seed)
        icp_clouds = phase_icp(dataset, args.seed)
        phase_baselines(pn, dg, icp_clouds)
        del pn, dg, icp_clouds
        phase_train(args.seed, loader)
        phase_grads(dataset, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    # the package is imported before any output, so a copy of this script
    # without the repository beside it fails with no result printed
    import alignnet3d_tpu  # noqa: F401

    sys.exit(main())
