"""Headline benchmark: end-to-end zstd level-3 seekable compression
throughput on one GPU, through the public Writer API with a counting sink
(mirrors the reference harness /root/reference/test/benchmark.c:139-151,
324 which writes to /dev/null through a byte-counting callback).

Baseline: the reference's 16-worker CPU peak, ~1699 MiB/s (BASELINE.md,
test/results/report1m.txt:17).

Prints the device (JAX platform, device kind, device count, and the card's
name and power limit from nvidia-smi), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}.  Exits non-zero without a
GPU: a CPU number is never reported under this metric.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from libzseek_jax.utils.compile_cache import enable_compile_cache

import numpy as np

BASELINE_MIBS = 1699.0  # reference zstd L3, 16 workers, f=1024 MiB


class CountingSink:
    def __init__(self):
        self.n = 0

    def write(self, b):
        self.n += len(b)


def run(total_mb: int, chunk: int = 1 << 20, min_frame: int = 1 << 20,
        batch_frames: int = 16):
    from libzseek_jax.runtime.writer import Writer
    from libzseek_jax.testing.corpus import mixed_corpus

    rng = np.random.default_rng(11)
    data = mixed_corpus(rng, total_mb << 20).tobytes()
    sink = CountingSink()
    w = Writer(sink, codec="zstd", min_frame_size=min_frame,
               batch_frames=batch_frames)
    t0 = time.time()
    for pos in range(0, len(data), chunk):
        w.write(data[pos: pos + chunk])
    st = w.close()
    dt = time.time() - t0
    return (total_mb / dt), sink.n / len(data), st.frames, dt


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    print(f"nvidia-smi: {smi}")
    print(f"compile cache: {enable_compile_cache()}")
    total_mb = int(os.environ.get("BENCH_MB", "64"))
    # warm-up at the same size: shape buckets (literal/sequence/payload
    # capacities) depend on batch content, and each distinct bucket
    # compiles on first use
    warm_mb = int(os.environ.get("BENCH_WARMUP_MB", str(total_mb)))
    reps = int(os.environ.get("BENCH_REPS", "4"))
    run(warm_mb)
    runs = []
    for _ in range(max(1, reps)):
        m, ratio, frames, dt = run(total_mb)
        runs.append(m)
    mibs = sum(runs) / len(runs)
    print(json.dumps({
        "metric": "zstd_l3_compress_throughput",
        "value": mibs,
        "unit": "MiB/s",
        "vs_baseline": mibs / BASELINE_MIBS,
        "best": max(runs),
        "reps": runs,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
