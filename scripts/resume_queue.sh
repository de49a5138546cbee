#!/bin/bash
# Replay the serialized experiment queue after a kill or reboot.
# Safe to run at every session start: completed steps skip via markers.
set -u
cd "$(dirname "$0")/.."
if [ -f /tmp/queue.pid ] && kill -0 "$(cat /tmp/queue.pid)" 2>/dev/null; then
    echo "queue already running (pid $(cat /tmp/queue.pid))"
    exit 0
fi
nohup python scripts/run_queue.py "${1:-/root/data/queue.json}" \
    >> /root/data/queue.log 2>&1 &
echo "queue launched, pid $! (log: /root/data/queue.log)"
