"""Seek-table per-frame checksums (zstd seekable spec: low 32 bits of
XXH64 of the uncompressed frame).  The reference never emits them
(checksumFlag=0, /root/reference/src/compress.c:152); we support emitting
(Writer(checksums=True)) and verifying (Reader(verify_checksums=True))."""

import io
import struct

import numpy as np
import pytest

from libzseek_jax.errors import FormatError
from libzseek_jax.format.xxhash import xxh64
from libzseek_jax.runtime.reader import Reader
from libzseek_jax.runtime.writer import Writer
from libzseek_jax.testing import golden


def test_xxh64_vectors():
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"", 1) == 0xD5AFBA1336A3BE4B


def test_checksummed_archive_roundtrip(rng):
    data = rng.integers(0, 200, 500_000, np.uint8).tobytes()
    buf = io.BytesIO()
    w = Writer(buf, codec="zstd", min_frame_size=1 << 17, checksums=True)
    w.write(data)
    w.close()
    arch = buf.getvalue()
    # stock zstd still decodes the whole archive (table is skippable)
    assert golden.zstd_decompress(arch) == data
    r = Reader(arch, verify_checksums=True)
    assert r.seek_table.checksums is not None
    assert r.pread_full(len(data), 0) == data
    # every stored checksum matches a fresh XXH64 of the frame bytes
    t = r.seek_table
    for i in range(t.num_frames):
        lo = t.frame_d_offset(i)
        fr = data[lo: lo + t.frame_d_size(i)]
        assert int(t.checksums[i]) == (xxh64(fr) & 0xFFFFFFFF)


def test_checksum_mismatch_detected(rng):
    data = rng.integers(0, 200, 300_000, np.uint8).tobytes()
    buf = io.BytesIO()
    w = Writer(buf, codec="zstd", min_frame_size=1 << 17, checksums=True)
    w.write(data)
    w.close()
    arch = bytearray(buf.getvalue())
    # flip a bit in the FIRST stored checksum (table entries at EOF:
    # footer is 9 bytes, entries of 12 bytes precede it)
    r0 = Reader(bytes(arch))
    n = r0.seek_table.num_frames
    table_start = len(arch) - 9 - 12 * n
    arch[table_start + 8] ^= 0xFF
    r = Reader(bytes(arch), verify_checksums=True)
    with pytest.raises(FormatError, match="checksum mismatch"):
        r.pread_full(1000, 0)
    # without verification the data still reads fine
    r2 = Reader(bytes(arch))
    assert r2.pread_full(len(data), 0) == data
