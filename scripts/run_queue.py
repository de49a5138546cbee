"""Replayable serialized experiment queue.

A killed run loses no finished step: this runner replaces ad-hoc chain
shell scripts with a replayable manifest:

  /root/data/queue.json   [{"id": ..., "cmd": ..., "wait_for": path?},...]
  /root/data/markers/     <id>.done written on rc==0 (skipped on replay)
  /root/data/queue.log    timestamped step log

Steps run SERIALLY (one process on the device at a time)
with cwd=/root/repo. A killed queue is resumed by simply re-running this
script (scripts/resume_queue.sh): finished steps skip via markers,
training steps auto-resume from their rolling checkpoint.

Usage: python scripts/run_queue.py [manifest.json]
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKERS = "/root/data/markers"


def log(msg):
    line = f"[queue {time.strftime('%H:%M:%S')}] {msg}"
    print(line, flush=True)


def main():
    manifest = sys.argv[1] if len(sys.argv) > 1 else "/root/data/queue.json"
    steps = json.load(open(manifest))
    os.makedirs(MARKERS, exist_ok=True)
    with open("/tmp/queue.pid", "w") as f:
        f.write(str(os.getpid()))
    log(f"manifest {manifest}: {len(steps)} steps")
    for step in steps:
        sid, cmd = step["id"], step["cmd"]
        marker = os.path.join(MARKERS, f"{sid}.done")
        if os.path.exists(marker):
            log(f"skip {sid} (done)")
            continue
        wait_for = step.get("wait_for")
        if wait_for:
            log(f"{sid}: waiting for {wait_for}")
            while not os.path.exists(wait_for):
                time.sleep(60)
        log(f"run {sid}: {cmd}")
        t0 = time.time()
        rc = subprocess.call(cmd, shell=True, cwd=REPO)
        dt = time.time() - t0
        if rc == 0:
            with open(marker, "w") as f:
                f.write(f"{dt:.0f}s\n")
            log(f"{sid} done in {dt:.0f}s")
        else:
            log(f"{sid} FAILED rc={rc} after {dt:.0f}s — continuing")
            # no marker: a replay retries the step (training steps resume
            # from their rolling ckpt, so retry-after-kill loses nothing)
    log("queue drained")


if __name__ == "__main__":
    main()
