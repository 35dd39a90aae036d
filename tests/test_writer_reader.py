"""End-to-end writer/reader tests: chunk-coalescing parity, archive
conformance via stock LZ4F, random preads, cache behavior, stats."""

import io

import numpy as np
import pytest

from libzseek_jax import (Reader, Writer, open_reader, zseek_pread,
                          zseek_read, zseek_writer_close, zseek_writer_open)
from libzseek_jax.errors import ZseekError
from libzseek_jax.format.seek_table import parse_seek_table_bytes
from libzseek_jax.runtime.io import CountingSink
from libzseek_jax.testing import golden
from libzseek_jax.testing.corpus import mixed_corpus

FRAME = 1 << 16  # small frames keep CPU tests fast


@pytest.fixture(scope="module")
def archive(rng):
    rng = np.random.default_rng(21)
    raw = mixed_corpus(rng, 300_000).tobytes()
    buf = io.BytesIO()
    from libzseek_jax.runtime.io import FileIO
    w = Writer(FileIO(buf), "lz4", min_frame_size=FRAME, batch_frames=3)
    # mixed write sizes: tiny (coalesced), huge (direct path)
    w.write(raw[:1000])
    w.write(raw[1000:200_000])   # >= frame size on non-empty buffer
    w.write(raw[200_000:200_100])
    w.write(raw[200_100:300_000])
    st = w.close()
    return raw, buf.getvalue(), st


def test_writer_chunking_semantics(archive):
    raw, data, st = archive
    table = parse_seek_table_bytes(data)
    # coalescing: first write buffered; second write pushes over the
    # threshold -> frame sizes follow the reference's accumulate-then-flush
    # rule (first frame is everything buffered when it crossed FRAME)
    assert table.num_frames == st.frames
    assert st.decompressed_size == len(raw)
    assert table.decompressed_size == len(raw)
    sizes = [table.frame_d_size(i) for i in range(table.num_frames)]
    assert sum(sizes) == len(raw)
    assert sizes[0] >= FRAME  # coalesced past the threshold
    assert st.compressed_size == table.compressed_size


def test_archive_reads_via_stock_lz4(archive):
    raw, data, _ = archive
    assert golden.lz4f_decompress(data) == raw


def test_sequential_read(archive):
    raw, data, _ = archive
    r = Reader(data, cache_frames=4)
    out = bytearray()
    while True:
        chunk = r.read(70_001)
        if not chunk:
            break
        out += chunk
    assert bytes(out) == raw
    assert r.stats().frames == r.seek_table.num_frames


def test_random_pread(archive):
    raw, data, _ = archive
    r = Reader(data, cache_frames=4)
    rng = np.random.default_rng(0)
    for _ in range(32):
        off = int(rng.integers(0, len(raw)))
        size = int(rng.integers(1, 5000))
        got = r.pread_full(size, off)
        assert got == raw[off: off + size]
    # reads at/past EOF
    assert r.pread(10, len(raw)) == b""
    assert r.pread(10, len(raw) + 5) == b""
    # short read never crosses a frame boundary
    t = r.seek_table
    if t.num_frames > 1:
        end0 = t.frame_d_size(0)
        got = r.pread(10_000, end0 - 5)
        assert len(got) == 5


def test_cache_hits_and_eviction(archive):
    raw, data, _ = archive
    r = Reader(data, cache_frames=1)
    r.pread(10, 0)
    st0 = r.stats()
    r.pread(10, 20)        # same frame -> hit
    st1 = r.stats()
    assert st1.cache_hits == st0.cache_hits + 1
    last_off = len(raw) - 10
    r.pread(10, last_off)  # different frame -> evicts (capacity 1)
    r.pread(10, 0)         # miss again
    st2 = r.stats()
    assert st2.cache_entries == 1
    assert st2.cache_misses >= st0.cache_misses + 2


def test_prefetch_batch(archive):
    raw, data, _ = archive
    r = Reader(data, cache_frames=8)
    offs = [0, 100_000, 250_000]
    r.prefetch(offs)
    st = r.stats()
    for off in offs:
        assert r.pread(4, off) == raw[off: off + 4]
    st2 = r.stats()
    assert st2.cache_hits >= st.cache_hits + len(set(
        r.seek_table.frame_for_offset(o) for o in offs))


def test_c_api_compat(tmp_path):
    raw = b"hello zseek " * 5000
    path = tmp_path / "a.zsk"
    w = zseek_writer_open(str(path), codec="lz4", min_frame_size=FRAME)
    assert w.write(raw[:30_000]) is None or True
    w.write(raw[30_000:])
    st = zseek_writer_close(w)
    assert st.frames >= 1
    r = open_reader(str(path))
    assert zseek_pread(r, 12, 0) == raw[:12]
    assert zseek_read(r, 12) == raw[:12]
    assert zseek_read(r, 12) == raw[12:24]
    r.close()


def test_counting_sink_and_empty_archive():
    sink = CountingSink()
    w = Writer(sink, "lz4", min_frame_size=FRAME)
    st = w.close()
    assert st.frames == 0
    assert sink.bytes_written == 8 + 9  # bare seek table
    with pytest.raises(ZseekError):
        w.write(b"too late")


def test_write_after_close_and_double_close():
    sink = CountingSink()
    w = Writer(sink, "lz4", min_frame_size=FRAME)
    w.write(b"abc")
    st1 = w.close()
    st2 = w.close()
    assert st1.frames == st2.frames == 1


def test_device_resident_frame_cache(rng):
    """device_cache=True keeps cached decompressed frames as DEVICE arrays
    (HBM frame cache): cache entries are jax Arrays, only the requested
    span crosses to host, and reads stay byte-exact."""
    import jax

    data = rng.integers(0, 150, 700_000, np.uint8).tobytes()
    buf = io.BytesIO()
    w = Writer(buf, codec="zstd", min_frame_size=1 << 17)
    w.write(data)
    w.close()
    r = Reader(buf.getvalue(), cache_frames=4, device_cache=True)
    assert r._device_frames
    assert r.pread(4096, 300_000) == data[300_000: 304_096]
    # the cache owns device-resident entries, not host bytes
    assert r._cache.entries >= 1
    for v in r._cache._map.values():
        assert isinstance(v, jax.Array)
    # hit path slices the cached device array
    st0 = r.stats()
    assert r.pread(100, 300_500) == data[300_500: 300_600]
    assert r.stats().cache_hits == st0.cache_hits + 1
    # cross-frame loop + boundary short count
    assert r.pread_full(len(data), 0) == data


def test_uncached_pread_bounded_host_memory(rng):
    """cache_frames=0 serves preads from device-resident frames: no whole
    decompressed frame is materialized on host (the reference's
    stream-and-discard analog, decompress.c:377-468)."""
    data = rng.integers(0, 150, 500_000, np.uint8).tobytes()
    buf = io.BytesIO()
    w = Writer(buf, codec="zstd", min_frame_size=1 << 18)
    w.write(data)
    w.close()
    r = Reader(buf.getvalue(), cache_frames=0)
    assert r._device_frames
    assert r._cache is None
    for off in (0, 100_000, 262_143, 499_000):
        assert r.pread(512, off) == data[off: off + 512]
    # lz4 arm
    buf2 = io.BytesIO()
    w2 = Writer(buf2, codec="lz4", min_frame_size=1 << 17)
    w2.write(data)
    w2.close()
    r2 = Reader(buf2.getvalue(), cache_frames=0)
    assert r2._device_frames
    assert r2.pread(4096, 123_456) == data[123_456: 127_552]
