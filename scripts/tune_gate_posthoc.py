"""Post-hoc refinement-gate threshold sweep on cached artifacts (no device).

Because the in-loop gate (icp/p2point.py:291-309) falls back to the
NETWORK prediction for rejected pairs, any TIGHTER (max_dyaw_deg,
max_dxy) threshold pair can be evaluated exactly from a refined eval
that RAN WITH THE GATE ENABLED: pairs the looser in-loop gate rejected
(fitness not better, or outside the loose region) are already identical
to the network output, so post-hoc tightening reproduces in-loop
behavior bit-for-bit. This sweeps the thresholds on the val subset and
reports the untouched test subset (positions >= 1000) alongside, zero
ICP re-runs.

NOT exact for gate-DISABLED artifacts: the in-loop gate additionally
requires the fitness/rmse 'better' condition, which is not recoverable
from the cached arrays; on ungated artifacts this script over-accepts
relative to a real in-loop run at the same thresholds.

Round-3 motivation: the round-2 gate (10 deg / 0.5 m), tuned when the
network was at 79% <20 cm, accepts ~100% of refinements from the 88%
80k model and turns refinement into a net loss on the 10/20 cm buckets;
tightening dxy to ~0.15 m restores strictly-better behavior
(<2 cm +3.2 val / +2.4 test, <10/<20 cm within noise).

Usage: python scripts/tune_gate_posthoc.py <dataset_basepath> <eval_dir>
e.g.   python scripts/tune_gate_posthoc.py /root/data/SynthCars80k \
           /root/data/runs/SynthCars80k/val/eval000209
(expects <eval_dir>/refined_p2p* as produced by eval_only --refineICP)
"""

import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    base, ed = sys.argv[1], sys.argv[2]
    ref_dir = sorted(glob.glob(f"{ed}/refined_p2p*"))[0]

    from alignnet3d_tpu.data import provider
    from alignnet3d_tpu.evaluation.quickscore import (
        positional_is_test,
        success_table,
    )
    from alignnet3d_tpu.geometry import (
        angle_diff,
        translate_transform_to_new_center_of_rotation,
    )

    val = provider.getDataFiles(f"{base}/split/val.txt")
    ds = provider.PackedDataset(base)
    rows = np.asarray(ds.rows(val)).reshape(-1)
    gt_t = ds.translations[rows].reshape(-1, 3)
    gt_a = ds.rel_angles[rows].reshape(-1)
    gt_c = ds.pc1centers[rows].reshape(-1, 3)

    def load(d):
        return {k: np.load(f"{d}/pred_{k}.npy")
                for k in ("translations", "angles", "s2_pc1centers")}

    net, ref = load(ed), load(ref_dir)
    net_a = net["angles"].reshape(-1)
    ref_a = ref["angles"].reshape(-1)
    # refined outputs are world-frame; compare against the net prediction
    # re-based to the origin center
    net_t0 = translate_transform_to_new_center_of_rotation(
        net["translations"], net_a, net["s2_pc1centers"],
        np.zeros_like(gt_c),
    )
    # in-loop gate semantics: wrapped to (-180, 180], NOT folded at 180
    # (a 179-degree ICP flip must read as a huge delta, p2point.py:299-301)
    dyaw = np.abs(np.degrees(angle_diff(ref_a, net_a)))
    dxy = np.linalg.norm(ref["translations"][:, :2] - net_t0[:, :2], axis=1)
    is_test = positional_is_test(len(val))

    def score(accept):
        t = np.where(accept[:, None], ref["translations"],
                     net["translations"])
        a = np.where(accept, ref_a, net_a)
        c = np.where(accept[:, None], ref["s2_pc1centers"],
                     net["s2_pc1centers"])
        return success_table(t, a, c, gt_t, gt_a, gt_c, is_test)

    def row(name, tab, extra=""):
        f = lambda s: "/".join(f"{100*v:4.1f}" for v in tab[s])  # noqa
        print(f"{name:28s} all {f('all')}  val {f('val')}  "
              f"test {f('test')}{extra}")

    row("network only", score(np.zeros(len(val), bool)))
    row("refined, no extra gate", score(np.ones(len(val), bool)))
    best = None
    for mdy in (1.0, 2.0, 5.0, 10.0):
        for mdx in (0.05, 0.08, 0.10, 0.12, 0.15, 0.20, 0.30, 0.50):
            accept = (dyaw <= mdy) & (dxy <= mdx)
            tab = score(accept)
            row(f"dyaw<={mdy:4.1f} dxy<={mdx:.2f}", tab,
                f"  accept {accept.mean():.2f}")
            key = sum(tab["val"])  # picked on val only
            if best is None or key > best[0]:
                best = (key, mdy, mdx, tab)
    _, mdy, mdx, tab = best
    print(f"\npicked on val: dyaw<={mdy} dxy<={mdx}")
    row("PICKED", tab)


if __name__ == "__main__":
    main()
