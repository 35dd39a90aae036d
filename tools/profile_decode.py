"""Wall time of the zstd decode path (with and without decode hints) on
the default JAX device."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libzseek_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing.corpus import mixed_corpus


def main():
    rng = np.random.default_rng(5)
    mb = int(os.environ.get("PROF_MB", "8"))
    data = mixed_corpus(rng, mb << 20).tobytes()
    frames_in = [data[i: i + (1 << 20)] for i in range(0, len(data), 1 << 20)]
    codec = ZstdCodec()
    frames, fhints = codec.compress_frames(frames_in, return_hints=True)
    sizes = [len(f) for f in frames_in]
    # warm
    outs = codec.decompress_frames(frames, sizes, frame_hints=fhints)
    assert all(o == f for o, f in zip(outs, frames_in))
    for rep in range(3):
        t0 = time.time()
        outs = codec.decompress_frames(frames, sizes, frame_hints=fhints)
        dt = time.time() - t0
        print(f"decode {mb} MiB (hints): {dt:.3f}s = {mb/dt:.1f} MiB/s")
    for rep in range(2):
        t0 = time.time()
        outs2 = codec.decompress_frames(frames, sizes)
        dt = time.time() - t0
        print(f"decode {mb} MiB (no hints): {dt:.3f}s = {mb/dt:.1f} MiB/s")
    assert all(o == f for o, f in zip(outs2, frames_in))


if __name__ == "__main__":
    main()
