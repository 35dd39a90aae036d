#!/bin/sh
# Benchmark sweep — parity with /root/reference/test/benchmark.sh (workers x
# min-frame-size grid, 2 reps) using a synthetic in-RAM corpus.  Workers map
# to devices (SURVEY.md §2).  Render with tools/report.py.
#
# Runs ONE benchmark process at a time, by design: a JAX process reserves
# most of an accelerator's memory when it starts, so processes must never
# overlap on one card.  Do not background or parallelize the loop.
#
# Usage: sh tools/sweep.sh [--zstd|--lz4] [MB] > results.txt
set -e
CODEC=${1:---zstd}
MB=${2:-64}
REPS=2
cd "$(dirname "$0")/.."
# full reference grid (/root/reference/test/benchmark.sh:16): f up to
# 1024 MiB.  Points with f > MB degenerate to one frame; pass MB >= 1024
# to make the top rows meaningful.
for w in 1 2 4 8 16; do
  for f in 1 4 16 64 256 1024; do
    [ "$f" -gt "$MB" ] && continue
    for _ in $(seq $REPS); do
      python tools/benchmark.py "$CODEC" --synthetic "$MB" "$w" "$f" -t
    done
  done
done
