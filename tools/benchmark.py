"""Benchmark harness — parity with the reference CLI
(/root/reference/test/benchmark.c) plus read-side workloads it lacks.

Compression (reference parity, :156-302):
  * loads the input fully into RAM first to remove I/O noise (:161-192)
  * writes CHUNK_SIZE pieces through the public API to a byte-counting
    sink (:139-151, 324)
  * reports wall/user/sys time, CPU %, MiB/s (total and per worker),
    max RSS, per-write latency min/mean/std/max, compression ratio
    (report(), :67-134); terse mode (-t) emits one machine-readable line
    (:120-122)

Read side (new; BASELINE.json configs — the reference never benchmarks
decompression): sequential full-file decode, strided preads, and a zipfian
random-pread workload with hot-cache p50/p99 latencies.

Usage:
  python tools/benchmark.py --zstd|--lz4 (FILE | --synthetic MB)
      [workers] [frame_size_MiB] [-t] [--pread] [--chunk BYTES]
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libzseek_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

CHUNK_SIZE = 1 << 20  # reference benchmark.c:18


class CountingSink:
    def __init__(self):
        self.n = 0

    def write(self, b):
        self.n += len(b)


def load_input(args) -> bytes:
    if args.synthetic:
        from libzseek_jax.testing.corpus import mixed_corpus
        rng = np.random.default_rng(11)
        return mixed_corpus(rng, args.synthetic << 20).tobytes()
    with open(args.file, "rb") as f:
        return f.read()


def bench_compress(data: bytes, codec: str, workers: int, frame_mib: int,
                   chunk: int, terse: bool):
    from libzseek_jax.runtime.writer import Writer

    # compile warm-up: run the same shapes once so the measurement sees
    # steady state, not executable builds (bench.py does the same; the
    # reference's analog is loading the input to RAM first, :161-192)
    warm = Writer(CountingSink(), codec=codec,
                  min_frame_size=frame_mib << 20,
                  batch_frames=max(1, workers), workers=workers)
    for pos in range(0, len(data), chunk):
        warm.write(data[pos: pos + chunk])
    warm.close()

    sink = CountingSink()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.monotonic()
    w = Writer(sink, codec=codec, min_frame_size=frame_mib << 20,
               batch_frames=max(1, workers), workers=workers)
    lat = []
    for pos in range(0, len(data), chunk):
        t = time.monotonic()
        w.write(data[pos: pos + chunk])
        lat.append(time.monotonic() - t)
    t = time.monotonic()
    st = w.close()
    lat.append(time.monotonic() - t)
    wall = time.monotonic() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    usr = ru1.ru_utime - ru0.ru_utime
    sys_t = ru1.ru_stime - ru0.ru_stime
    cpu_pct = 100.0 * (usr + sys_t) / wall if wall else 0.0
    mib = len(data) / (1 << 20)
    mibs = mib / wall
    lat_ms = np.array(lat) * 1e3
    ratio = sink.n / len(data) if data else 0.0
    rss_mib = ru1.ru_maxrss / 1024
    if terse:
        # 13 columns, reference benchmark.c:120-122 ordering
        print(f"{codec} {workers} {frame_mib} {wall:.3f} {usr:.3f} "
              f"{sys_t:.3f} {cpu_pct:.0f} {mibs:.1f} {mibs/max(1,workers):.1f} "
              f"{lat_ms.mean():.3f} {lat_ms.std():.3f} {rss_mib:.0f} "
              f"{ratio:.4f}")
    else:
        print(f"codec: {codec}  workers: {workers}  frame: {frame_mib} MiB  "
              f"frames: {st.frames}")
        print(f"wall: {wall:.3f}s  user: {usr:.3f}s  sys: {sys_t:.3f}s  "
              f"cpu: {cpu_pct:.0f}%")
        print(f"throughput: {mibs:.1f} MiB/s total, "
              f"{mibs/max(1,workers):.1f} MiB/s/worker")
        print(f"write latency ms: min {lat_ms.min():.2f} "
              f"mean {lat_ms.mean():.2f} std {lat_ms.std():.2f} "
              f"max {lat_ms.max():.2f}")
        print(f"max RSS: {rss_mib:.0f} MiB  ratio: {ratio:.4f} "
              f"({sink.n} / {len(data)})")
    return sink.n


def bench_pread(data: bytes, codec: str, frame_mib: int, terse: bool):
    import io

    from libzseek_jax.runtime.reader import Reader
    from libzseek_jax.runtime.writer import Writer

    buf = io.BytesIO()
    w = Writer(buf, codec=codec, min_frame_size=frame_mib << 20)
    w.write(data)
    w.close()
    arch = buf.getvalue()
    total = len(data)
    rng = np.random.default_rng(3)

    # compile warm-up (decode executables for this size), then measure a
    # fresh reader (cold cache, warm executables) — the same steady-state
    # convention as the compress side
    warm = Reader(arch, cache_frames=24)
    got = 0
    while got < total:
        got += len(warm.pread(1 << 20, got))

    r = Reader(arch, cache_frames=24)
    t0 = time.monotonic()
    got = 0
    while got < total:
        got += len(r.pread(1 << 20, got))
    seq_s = time.monotonic() - t0

    # zipfian random preads, 4 KiB each (hot cache after warmup)
    n_ops = 512
    zipf = np.minimum(rng.zipf(1.2, n_ops) - 1, max(0, total - 4096))
    lat = []
    for off in zipf:
        t = time.monotonic()
        r.pread(4096, int(off))
        lat.append(time.monotonic() - t)
    lat_ms = np.sort(np.array(lat) * 1e3)
    st = r.stats()
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[int(len(lat_ms) * 0.99)]
    if terse:
        print(f"pread {codec} {frame_mib} {total/(1<<20)/seq_s:.1f} "
              f"{p50:.3f} {p99:.3f} {st.cache_hits} {st.cache_misses}")
    else:
        print(f"sequential decode: {total/(1<<20)/seq_s:.1f} MiB/s")
        print(f"zipfian 4K pread latency ms: p50 {p50:.3f} p99 {p99:.3f}  "
              f"(cache {st.cache_hits} hits / {st.cache_misses} misses)")


def main():
    ap = argparse.ArgumentParser()
    grp = ap.add_mutually_exclusive_group(required=True)
    grp.add_argument("--zstd", action="store_true")
    grp.add_argument("--lz4", action="store_true")
    ap.add_argument("file", nargs="?", help="input file (omit for --synthetic)")
    ap.add_argument("workers", nargs="?", type=int, default=1)
    ap.add_argument("frame_mib", nargs="?", type=int, default=1)
    ap.add_argument("-t", "--terse", action="store_true")
    ap.add_argument("--synthetic", type=int, metavar="MB", default=0)
    ap.add_argument("--chunk", type=int, default=CHUNK_SIZE)
    ap.add_argument("--pread", action="store_true",
                    help="also run the read-side workloads")
    args = ap.parse_args()
    if args.synthetic and args.file is not None:
        # with --synthetic the FILE positional is vacant, but argparse
        # still assigns the first positional to it: shift
        # (file, workers) -> (workers, frame_mib)
        args.workers, args.frame_mib = int(args.file), args.workers
        args.file = None
    if not args.file and not args.synthetic:
        ap.error("need FILE or --synthetic MB")
    codec = "zstd" if args.zstd else "lz4"
    data = load_input(args)
    bench_compress(data, codec, args.workers, args.frame_mib, args.chunk,
                   args.terse)
    if args.pread:
        bench_pread(data, codec, args.frame_mib, args.terse)


if __name__ == "__main__":
    main()
