"""Round-trip example / integration test CLI.

Parity with the reference's `example` (/root/reference/test/example.c):
compresses FILE into FILE.zsk (4 KiB write chunks, 1 MiB min frame size,
example.c:12-14), then reopens the archive and verifies it: sequential
zseek_pread loop comparing against the original (example.c:56-87), plus the
random-access pass the reference's own TODO wishes for (example.c:21).
Prints SUCCESS or FAIL.

Usage: python tools/example.py --zstd|--lz4 FILE [--keep]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from libzseek_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from libzseek_jax import open_reader, open_writer

CHUNK_SIZE = 4096          # example.c:13
MIN_FRAME_SIZE = 1 << 20   # example.c:14
READ_CHUNK = 4096


def compress(path: str, out_path: str, codec: str) -> None:
    with open(path, "rb") as f, \
            open_writer(out_path, codec, min_frame_size=MIN_FRAME_SIZE) as w:
        while True:
            buf = f.read(CHUNK_SIZE)
            if not buf:
                break
            w.write(buf)


def verify(path: str, archive: str) -> bool:
    ok = True
    with open(path, "rb") as f:
        original = f.read()
    r = open_reader(archive, cache_frames=8)
    # sequential pread scan (example.c decompress loop)
    pos = 0
    while pos < len(original):
        chunk = r.pread_full(READ_CHUNK, pos)
        if original[pos: pos + len(chunk)] != chunk or not chunk:
            print(f"sequential mismatch at offset {pos}")
            ok = False
            break
        pos += len(chunk)
    if pos != len(original):
        ok = False
    # random-access pass
    rng = np.random.default_rng(0)
    for _ in range(64):
        off = int(rng.integers(0, max(1, len(original))))
        size = int(rng.integers(1, 1 << 16))
        if r.pread_full(size, off) != original[off: off + size]:
            print(f"random pread mismatch at offset {off}")
            ok = False
            break
    st = r.close()
    print(f"frames={st.frames} compressed={st.compressed_size} "
          f"decompressed={st.decompressed_size} "
          f"ratio={st.compressed_size / max(1, st.decompressed_size):.4f} "
          f"cache_hits={st.cache_hits} cache_misses={st.cache_misses}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--zstd", action="store_true")
    g.add_argument("--lz4", action="store_true")
    ap.add_argument("file")
    ap.add_argument("--keep", action="store_true",
                    help="keep the .zsk archive afterwards")
    args = ap.parse_args()
    codec = "zstd" if args.zstd else "lz4"
    archive = args.file + ".zsk"
    compress(args.file, archive, codec)
    ok = verify(args.file, archive)
    if not args.keep:
        os.unlink(archive)
    print("SUCCESS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
