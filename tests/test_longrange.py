"""Long-distance matching (the zstd --long / LDM analog).  The device
parse window is its own 128 KiB block; the native LDM pre-pass
(zn_ldm_scan + apply_ldm_override) must catch
redundancy with periods far beyond it — the reference inherits libzstd's
multi-MiB window at L3 (/root/reference/src/compress.c:666), so archive
size on such inputs is a north-star gate ("compressed size <= reference
for the same level/frame-size", BASELINE.md)."""

import numpy as np
import pytest

from libzseek_jax import native
from libzseek_jax.runtime.reader import Reader
from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _roundtrip_and_ratio(raw: bytes):
    codec = ZstdCodec()
    fr = codec.compress_frames([raw])[0]
    assert golden.zstd_decompress(fr) == raw
    stock = len(golden.zstd_compress(raw, 3, strategy=None))
    return len(fr), stock


def test_aligned_period_repeat(rng):
    # 1 MiB random block repeated 6x: period == 8 blocks, every repeat
    # block must collapse to one long-match sequence
    blk = rng.integers(0, 256, 1 << 20, np.uint8).tobytes()
    raw = blk * 6
    size, stock = _roundtrip_and_ratio(raw)
    assert size <= 1.1 * stock, (size, stock)


def test_unaligned_period_repeat(rng):
    # period 1 MiB + 37 bytes: block boundaries never align with the
    # period — content-defined anchors must still find it
    per = (1 << 20) + 37
    raw = (rng.integers(0, 256, per, np.uint8).tobytes() * 7)[: 6 << 20]
    size, stock = _roundtrip_and_ratio(raw)
    # boundary blocks are caught by PARTIAL span coverage (head/tail
    # literals + one long match), so the bound is near-parity
    assert size <= 1.1 * stock, (size, stock)


def test_reader_roundtrip_long_offsets(rng):
    # our own decoder must reproduce long-offset frames bit-exact
    blk = rng.integers(0, 256, 768 << 10, np.uint8).tobytes()
    raw = blk * 3
    codec = ZstdCodec()
    fr = codec.compress_frames([raw])[0]
    from libzseek_jax.ops.zstd_decode import decode_frames
    assert decode_frames([fr], [len(raw)])[0] == raw


def test_mixed_frames_with_and_without_ldm(rng):
    # several frames in one batch: one long-range-redundant, one plain —
    # frame fences must hold (no cross-frame long matches)
    blk = rng.integers(0, 256, 512 << 10, np.uint8).tobytes()
    f1 = blk * 3                      # covered
    f2 = rng.integers(0, 256, 300 << 10, np.uint8).tobytes()
    codec = ZstdCodec()
    frs = codec.compress_frames([f1, f2])
    assert golden.zstd_decompress(frs[0]) == f1
    assert golden.zstd_decompress(frs[1]) == f2


def test_ldm_scan_no_false_positives(rng):
    x = rng.integers(0, 256, 4 << 20, np.uint8)
    B, N = 32, 1 << 17
    d = native.ldm_scan(x, B, N, np.zeros(B, np.int64),
                        np.full(B, N, np.int32), 1 << 17)
    assert (d == 0).all()


def test_partial_spans_never_beat_the_parse(rng):
    """Partial-span coverage must not replace parse output for distances
    the block parse can reach itself (d < 2 blocks): a periodic corpus
    with period ~70 KiB (multi-period distances land inside the parse
    window) must compress no worse with the LDM enabled."""
    import os

    piece = rng.integers(32, 127, 70_000, np.uint8).tobytes()
    raw = (piece * 16)[: 1 << 20]
    codec_on = ZstdCodec()
    size_on = len(codec_on.compress_frames([raw])[0])
    os.environ["ZN_LDM"] = "off"
    try:
        size_off = len(ZstdCodec().compress_frames([raw])[0])
    finally:
        os.environ.pop("ZN_LDM", None)
    assert size_on <= size_off * 1.02 + 64, (size_on, size_off)


def test_small_period_whole_block_coverage(rng):
    # short-period content (period far below the 128 KiB min_dist): the
    # always-overwrite candidate table must surface the small distance and
    # cover repeat blocks whole, each as one long-match sequence
    N = 131072
    period = rng.integers(0, 256, 337, np.uint8).tobytes()
    raw = (period * ((5 * N) // 337 + 1))[: 5 * N]
    x = np.frombuffer(raw, np.uint8)
    d = native.ldm_scan(x, 5, N, np.zeros(5, np.int64),
                        np.full(5, N, np.int32), 1 << 17)
    # block 0 has no in-frame source; later blocks must be covered whole
    assert (d[1:, 0] > 0).all() and (d[1:, 1] == 0).all() \
        and (d[1:, 2] == N).all(), d.tolist()
