"""Per-epoch eval history of a run dir, compiled into one table.

Reads ``<run>/val/eval%06d/eval[_180].json`` artifacts (the reference's
nested schema, reference evaluation.py:230-286) and prints overall /
translation / angle levels per epoch plus the best epochs by <20 cm and
<10 cm overall, with the val/test sub-splits for the pick. Pure host
tool — safe to run while training holds the device.

Usage: python scripts/summarize_run.py <run_dir> [--eval180] [--last K]
"""

import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def levels(d):
    return tuple(round(100 * x, 1) for x in d["corr_levels"])


def row(epoch, d):
    o = levels(d)
    t = tuple(round(100 * x, 1) for x in d["corr_levels_translation"])
    a = tuple(round(100 * x, 1) for x in d["corr_levels_angles"])
    return (f"{epoch:>5}  overall {o[0]:5.1f}/{o[1]:5.1f}/{o[2]:5.1f}  "
            f"trans {t[0]:5.1f}/{t[1]:5.1f}/{t[2]:5.1f}  "
            f"angle {a[0]:5.1f}/{a[1]:5.1f}/{a[2]:5.1f}  "
            f"t_mean {d['mean_dist_translation']:.3f}  "
            f"a_mean {d['mean_dist_angle']:.2f}")


def main():
    run = sys.argv[1]
    name = "eval_180.json" if "--eval180" in sys.argv else "eval.json"
    last = int(sys.argv[sys.argv.index("--last") + 1]) \
        if "--last" in sys.argv else 10

    history = []
    for path in sorted(glob.glob(os.path.join(run, "val", "eval*", name))):
        tag = os.path.basename(os.path.dirname(path))[len("eval"):]
        if not tag.isdigit():  # 'pretr', refined_* subdirs, backups
            continue
        with open(path) as fh:
            history.append((int(tag), json.load(fh)))
    if not history:
        print(f"no {name} artifacts under {run}/val")
        return 1

    print(f"{run} — {name}, {len(history)} epochs "
          f"(epoch / <2cm-1deg / <10cm-5deg / <20cm-10deg)")
    for epoch, d in history[-last:]:
        print(row(epoch, d))

    for label, key in (("<20cm", 2), ("<10cm", 1)):
        epoch, d = max(history, key=lambda it: it[1]["corr_levels"][key])
        print(f"best {label}: {row(epoch, d)}")
        for split in ("val", "test"):
            s = d[split]
            print(f"         {split:>4}: "
                  f"{'/'.join(f'{100 * x:.1f}' for x in s['corr_levels'])} "
                  f"(n={s['num']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
