"""Ratio + conformance harness for the zstd encode pipeline.

For each corpus regime: compress with ZstdCodec, verify bit-exact
round-trip through stock libzstd (golden decoder), and compare compressed
size against golden ZSTD_compress2 level 3 / strategy fast — the gate from
SURVEY.md §7 (size <= reference at same level/frame-size).

Usage: python tools/zstd_ratio.py [--kb 128] [--regime all]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from libzseek_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden
from libzseek_jax.testing.corpus import mixed_corpus, text_corpus


def regimes(rng, n):
    out = {
        "text": text_corpus(rng, n),
        "mixed": mixed_corpus(rng, n),
        "periodic": np.tile(rng.integers(0, 256, 337, dtype=np.uint8),
                            n // 337 + 1)[:n],
        "periodic_txt": np.tile(text_corpus(rng, 512), n // 512 + 1)[:n],
        "zeros": np.zeros(n, np.uint8),
        "noise": rng.integers(0, 256, n, dtype=np.uint8),
        "struct": (np.arange(n, dtype=np.int64) % 251).astype(np.uint8)
                  .reshape(-1, 1).repeat(1, 1).ravel()[:n],
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kb", type=int, default=128)
    ap.add_argument("--regime", default="all")
    ap.add_argument("--level", type=int, default=3)
    args = ap.parse_args()
    n = args.kb * 1024
    rng = np.random.default_rng(7)
    codec = ZstdCodec(level=args.level)
    data = regimes(rng, n)
    if args.regime != "all":
        data = {args.regime: data[args.regime]}
    names = list(data)
    frames = [data[k].tobytes() for k in names]
    t0 = time.time()
    ours = codec.compress_frames(frames)
    dt = time.time() - t0
    print(f"{'regime':<14}{'raw':>9}{'ours':>9}{'golden':>9}{'ratio':>8}"
          f"{'vs_gold':>9}  ok")
    worst = 0.0
    for k, fr, c in zip(names, frames, ours):
        g = golden.zstd_compress(fr, level=args.level)
        rt = golden.zstd_decompress(c)
        ok = rt == fr
        rel = len(c) / len(g)
        worst = max(worst, rel)
        print(f"{k:<14}{len(fr):>9}{len(c):>9}{len(g):>9}"
              f"{len(c)/len(fr):>8.4f}{rel:>9.4f}  {'OK' if ok else 'FAIL'}")
        if not ok:
            sys.exit(1)
    print(f"compress wall: {dt:.2f}s  worst vs golden: {worst:.4f}")


if __name__ == "__main__":
    main()
