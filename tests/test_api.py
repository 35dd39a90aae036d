"""C-API-shaped shim coverage (zseek.h:225-443 one-to-one analogs)."""

import io

import numpy as np

from libzseek_jax import api


def test_full_open_shims(rng):
    data = rng.integers(0, 200, 300_000, np.uint8).tobytes()
    buf = io.BytesIO()
    w = api.zseek_writer_open_full(buf, api.CompressionParams(
        type="zstd", zstd=api.ZstdParams(compression_level=3,
                                         nb_workers=2)),
        min_frame_size=1 << 16)
    api.zseek_write(w, data)
    st = api.zseek_writer_close(w)
    assert st.frames >= 1
    r = api.zseek_reader_open_full(io.BytesIO(buf.getvalue()), cache_size=4)
    assert api.zseek_pread(r, 100, 5000) == data[5000:5100]
    assert api.zseek_read(r, 50) == data[:50]
    assert api.zseek_reader_stats(r).frames == st.frames
    api.zseek_reader_close(r)


def test_uncached_reader(rng):
    """cache_size=0 disables the frame cache (zseek.h:322-324 semantics)."""
    data = rng.integers(0, 50, 200_000, np.uint8).tobytes()
    buf = io.BytesIO()
    w = api.zseek_writer_open(buf, "lz4", min_frame_size=1 << 15)
    api.zseek_write(w, data)
    api.zseek_writer_close(w)
    r = api.zseek_reader_open_full(io.BytesIO(buf.getvalue()), cache_size=0)
    assert api.zseek_pread(r, 999, 77_777) == data[77_777: 78_776]
    st = api.zseek_reader_stats(r)
    assert st.cache_entries == 0
    api.zseek_reader_close(r)


def test_null_params_defaults(rng):
    """NULL params -> zstd level-3 defaults (src/compress.c:251-255)."""
    buf = io.BytesIO()
    w = api.zseek_writer_open_full(buf)
    api.zseek_write(w, b"x" * 100_000)
    api.zseek_writer_close(w)
    r = api.zseek_reader_open_full(io.BytesIO(buf.getvalue()))
    assert api.zseek_pread(r, 10, 0) == b"x" * 10


def test_checksums_through_public_api(rng):
    """`checksums` is reachable through open_writer/zseek_writer_open_full
    (not only the Writer constructor), and ReaderStats.seek_table_size
    accounts for the 12-byte checksummed entries."""
    data = rng.integers(0, 120, 400_000, np.uint8).tobytes()
    buf = io.BytesIO()
    w = api.zseek_writer_open_full(buf, api.CompressionParams(
        type="zstd", zstd=api.ZstdParams(compression_level=3)),
        min_frame_size=1 << 17, checksums=True)
    api.zseek_write(w, data)
    wst = api.zseek_writer_close(w)
    r = api.open_reader(io.BytesIO(buf.getvalue()), verify_checksums=True)
    assert r.seek_table.checksums is not None
    assert api.zseek_pread(r, 500, 123_456) == data[123_456: 123_956]
    st = api.zseek_reader_stats(r)
    # 8-byte header + 12 bytes/entry (with checksums) + 9-byte footer
    assert st.seek_table_size == 8 + 12 * st.frames + 9
    assert st.seek_table_size == wst.seek_table_size

    # same knob through open_writer with lz4
    buf2 = io.BytesIO()
    w2 = api.open_writer(buf2, "lz4", min_frame_size=1 << 16,
                         checksums=True)
    w2.write(data)
    w2.close()
    r2 = api.open_reader(io.BytesIO(buf2.getvalue()), verify_checksums=True)
    assert r2.seek_table.checksums is not None
    assert r2.pread_full(1000, 7777) == data[7777: 8777]
