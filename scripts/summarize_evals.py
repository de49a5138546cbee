#!/usr/bin/env python
"""Summarize eval artifacts into markdown rows for docs/RESULTS.md.

Scans /root/data/runs/<run>/val/eval*/ (and refined_* subdirs) for
eval_180.json and prints one row per eval dir: run, epoch, variant,
corr_levels (<2/<10/<20 cm), mean translation / yaw. Pure host-side
file reading — safe to run any time (no device client).

Usage: python scripts/summarize_evals.py [run-name-substring ...]
"""

from __future__ import annotations

import glob
import json
import os
import sys


def rows_for(run_dir: str):
    run = os.path.basename(run_dir)
    for ed in sorted(glob.glob(f"{run_dir}/val/eval*")):
        epoch = os.path.basename(ed).replace("eval", "").lstrip("0") or "0"
        for sub, variant in [(ed, "network")] + [
            (d, os.path.basename(d))
            for d in sorted(glob.glob(f"{ed}/refined_*"))
        ]:
            p = f"{sub}/eval_180.json"
            if not os.path.isfile(p):
                continue
            try:
                ev = json.load(open(p))
            except Exception:
                continue
            lv = ev.get("corr_levels", [None] * 3)
            yield (run, epoch, variant,
                   [round(100 * float(x), 2) if x is not None else None
                    for x in lv],
                   round(float(ev.get("mean_dist_translation", -1)), 4),
                   round(float(ev.get("mean_dist_angle", -1)), 3))


def main():
    args = sys.argv[1:]
    last_only = "--last" in args
    pats = [p.lower() for p in args if p != "--last"]
    base = "/root/data/runs"
    print("| run | epoch | variant | <2cm | <10cm | <20cm | mean_t | mean_yaw |")
    print("|---|---|---|---|---|---|---|---|")
    for run_dir in sorted(glob.glob(f"{base}/*")):
        if pats and not any(p in run_dir.lower() for p in pats):
            continue
        rows = list(rows_for(run_dir))
        if last_only and rows:
            emax = max(int(r[1]) for r in rows)
            rows = [r for r in rows if int(r[1]) == emax]
        for run, epoch, variant, lv, mt, ma in rows:
            lvs = " | ".join("-" if x is None else f"{x:.2f}" for x in lv)
            print(f"| {run} | {epoch} | {variant} | {lvs} | {mt} | {ma} |")


if __name__ == "__main__":
    main()
