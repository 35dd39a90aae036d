"""Seek-table format tests: round-trip, query semantics, and golden parity
with archives whose payload frames come from stock libzstd/liblz4."""

import numpy as np
import pytest

from libzseek_jax.format import seek_table as st
from libzseek_jax.testing import golden


def make_table(sizes):
    fl = st.FrameLog()
    for c, d in sizes:
        fl.log_frame(c, d)
    return fl.serialize()


def test_roundtrip_empty():
    data = make_table([])
    t = st.parse_seek_table_bytes(data)
    assert t.num_frames == 0
    assert t.decompressed_size == 0


def test_roundtrip_basic():
    sizes = [(100, 1000), (250, 2000), (7, 1)]
    data = make_table(sizes)
    fl = st.FrameLog()
    for c, d in sizes:
        fl.log_frame(c, d)
    assert fl.size() == len(data) == 8 + 8 * 3 + 9
    t = st.parse_seek_table_bytes(data)
    assert t.num_frames == 3
    assert t.compressed_size == 357
    assert t.decompressed_size == 3001
    assert [t.frame_c_size(i) for i in range(3)] == [100, 250, 7]
    assert [t.frame_d_size(i) for i in range(3)] == [1000, 2000, 1]
    assert [t.frame_d_offset(i) for i in range(3)] == [0, 1000, 3000]


def test_checksum_flag_roundtrip():
    fl = st.FrameLog(checksum_flag=True)
    fl.log_frame(10, 20, checksum=0xDEADBEEF)
    fl.log_frame(30, 40, checksum=0x12345678)
    data = fl.serialize()
    assert len(data) == 8 + 12 * 2 + 9
    t = st.parse_seek_table_bytes(data)
    assert t.num_frames == 2
    assert list(t.checksums) == [0xDEADBEEF, 0x12345678]


def test_offset_query_parity():
    # Mirrors offset_to_frame_idx semantics (src/seek_table.c:187-202)
    data = make_table([(5, 100), (5, 0), (5, 50), (5, 100)])
    t = st.parse_seek_table_bytes(data)
    assert t.frame_for_offset(0) == 0
    assert t.frame_for_offset(99) == 0
    assert t.frame_for_offset(100) == 2  # skips the empty frame
    assert t.frame_for_offset(149) == 2
    assert t.frame_for_offset(150) == 3
    assert t.frame_for_offset(249) == 3
    assert t.frame_for_offset(10**9) == 3  # clamps past EOF
    # vectorized variant agrees
    offs = np.array([0, 99, 100, 149, 150, 249])
    idx = t.frames_for_offsets(offs)
    assert list(idx) == [0, 0, 2, 2, 3, 3]  # vector path may not skip empties
    # but vector path never returns an empty covering frame for these offsets
    for o, i in zip(offs, idx):
        if t.frame_d_size(int(i)) > 0:
            assert t.frame_d_offset(int(i)) <= o < t.frame_d_offset(int(i)) + t.frame_d_size(int(i))


def test_footer_validation():
    data = make_table([(1, 1)])
    bad = bytearray(data)
    bad[-1] ^= 0xFF
    with pytest.raises(st.SeekTableError):
        st.parse_seek_table_bytes(bytes(bad))
    bad = bytearray(data)
    bad[-5] = 0x40  # reserved descriptor bit
    with pytest.raises(st.SeekTableError):
        st.parse_seek_table_bytes(bytes(bad))
    with pytest.raises(st.SeekTableError):
        st.parse_seek_table_bytes(data[:4])


@pytest.mark.skipif(not golden.have_zstd(), reason="no system libzstd")
def test_zstd_archive_with_table_decodes_via_stock_zstd(corpus):
    """A [zstd frame][zstd frame][seek table] archive must decompress through
    stock libzstd streaming (which skips our skippable frame)."""
    raw = corpus[:65536].tobytes()
    half = len(raw) // 2
    f0 = golden.zstd_compress(raw[:half])
    f1 = golden.zstd_compress(raw[half:])
    fl = st.FrameLog()
    fl.log_frame(len(f0), half)
    fl.log_frame(len(f1), len(raw) - half)
    archive = f0 + f1 + fl.serialize()
    assert golden.zstd_decompress(archive) == raw
    t = st.parse_seek_table_bytes(archive)
    assert t.num_frames == 2
    assert t.frame_c_offset(1) == len(f0)


@pytest.mark.skipif(not golden.have_lz4(), reason="no system liblz4")
def test_lz4_archive_with_table_decodes_via_stock_lz4(corpus):
    """Same for LZ4F: the zstd-seekable table magic is inside LZ4F's skippable
    range, so stock LZ4F consumers skip it (src/compress.c:217,547)."""
    raw = corpus[:65536].tobytes()
    half = len(raw) // 2
    f0 = golden.lz4f_compress(raw[:half])
    f1 = golden.lz4f_compress(raw[half:])
    fl = st.FrameLog()
    fl.log_frame(len(f0), half)
    fl.log_frame(len(f1), len(raw) - half)
    archive = f0 + f1 + fl.serialize()
    assert golden.lz4f_decompress(archive) == raw


@pytest.mark.skipif(not golden.have_zstd(), reason="no system libzstd")
def test_golden_zstd_roundtrip(corpus):
    raw = corpus.tobytes()
    comp = golden.zstd_compress(raw)
    assert golden.zstd_frame_decompress(comp, len(raw)) == raw
    assert len(comp) < len(raw)


@pytest.mark.skipif(not golden.have_lz4(), reason="no system liblz4")
def test_golden_lz4_roundtrip(corpus):
    raw = corpus.tobytes()
    comp = golden.lz4f_compress(raw)
    assert golden.lz4f_decompress(comp) == raw
    blk = golden.lz4_block_compress(raw[:65536])
    assert golden.lz4_block_decompress(blk, 65536) == raw[:65536]
