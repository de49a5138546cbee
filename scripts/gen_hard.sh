#!/bin/bash
# Generate SynthCarsHard (8k train + 2k val, hard=True: occlusion /
# truncation / clutter) once the main regen finishes — runs OUTSIDE the
# serialized queue because it is pure-CPU work; the queue's
# eval_variants step waits on the marker this writes.
set -u
cd "$(dirname "$0")/.."
while [ ! -f /root/data/SynthCars80k.done ]; do sleep 30; done
if [ -f /root/data/SynthCarsHard.done ]; then
    echo "[gen_hard] already done"; exit 0
fi
python - <<'EOF'
import sys, time
sys.path.insert(0, ".")
from alignnet3d_tpu.data.synthetic import generate_dataset
t0 = time.time()
generate_dataset("/root/data/SynthCarsHard", 8000, 2000, seed=31, hard=True)
open("/root/data/SynthCarsHard.done", "w").write(f"{time.time()-t0:.1f}s\n")
print(f"[gen_hard] done in {time.time()-t0:.1f}s", flush=True)
EOF
