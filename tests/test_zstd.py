"""zstd codec conformance tests.

Strategy per SURVEY.md §4 / §7: our encoder's frames must decode bit-exact
through stock libzstd (format conformance oracle), our decoder must decode
stock libzstd's frames (full RFC 8878 coverage including repcodes, treeless
literals, repeat-FSE modes, multi-block frames), and encode→decode must
round-trip internally.  Reference counterpart: implicit conformance via
linking libzstd (/root/reference/src/compress.c:666, decompress.c:537).
"""

import numpy as np
import pytest

from libzseek_jax.ops.zstd_decode import decode_frames
from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden
from libzseek_jax.testing.corpus import text_corpus

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _cases(rng, n=24 * 1024):
    return {
        "text": text_corpus(rng, n).tobytes(),
        "periodic": (rng.integers(0, 256, 337, np.uint8).tobytes()
                     * (n // 337 + 1))[:n],
        "zeros": bytes(n),
        "noise": rng.integers(0, 256, n, np.uint8).tobytes(),
        "tiny": b"abcabcabcabc",
        "one": b"x",
    }


@pytest.fixture(scope="module")
def cases(rng):
    return _cases(rng)


def test_encode_decodes_via_libzstd(cases):
    codec = ZstdCodec()
    frames = codec.compress_frames(list(cases.values()))
    for (name, raw), fr in zip(cases.items(), frames):
        assert golden.zstd_decompress(fr) == raw, name


def test_decode_of_golden_frames(cases):
    for level in (1, 3, 19):
        frames = [golden.zstd_compress(v, level=level)
                  for v in cases.values()]
        outs = decode_frames(frames, [len(v) for v in cases.values()])
        for (name, raw), out in zip(cases.items(), outs):
            assert out == raw, (name, level)


def test_decode_of_golden_multiblock(rng):
    raw = (text_corpus(rng, 150 * 1024).tobytes()
           + bytes(100 * 1024)
           + rng.integers(0, 256, 80 * 1024, np.uint8).tobytes())
    fr = golden.zstd_compress(raw, level=3)
    assert decode_frames([fr], [len(raw)])[0] == raw


def test_internal_roundtrip(cases):
    codec = ZstdCodec()
    frames = codec.compress_frames(list(cases.values()))
    outs = codec.decompress_frames(frames, [len(v) for v in cases.values()])
    for (name, raw), out in zip(cases.items(), outs):
        assert out == raw, name


def test_ratio_not_worse_than_golden(cases):
    """SURVEY.md §7 gate: compressed size <= reference's for the same
    level/frame-size (with a small tolerance on the hardest regime)."""
    codec = ZstdCodec()
    frames = codec.compress_frames(list(cases.values()))
    for (name, raw), fr in zip(cases.items(), frames):
        g = golden.zstd_compress(raw, level=3)
        assert len(fr) <= max(len(g) * 1.005, len(g) + 16), \
            (name, len(fr), len(g))


def test_ratio_large_corpus(rng):
    """BASELINE "size <= reference" on a large (32 MiB) corpus — the small
    gates alone let large-scale regressions through."""
    from libzseek_jax.testing.corpus import mixed_corpus
    raw = mixed_corpus(rng, 32 << 20).tobytes()
    codec = ZstdCodec()
    step = 4 << 20
    frames = codec.compress_frames(
        [raw[i: i + step] for i in range(0, len(raw), step)])
    ours = sum(len(f) for f in frames)
    stock = sum(len(golden.zstd_compress(raw[i: i + step], level=3))
                for i in range(0, len(raw), step))
    assert ours <= stock * 1.005, (ours, stock)
    for i, fr in enumerate(frames):
        assert golden.zstd_decompress(fr) == raw[i * step: (i + 1) * step]


def test_rle_blocks_for_constant_data():
    """Constant blocks must be emitted as zstd RLE blocks (block type 1),
    within ~2x of libzstd's size for all-zeros input, and decode bit-exact
    through the stock library."""
    data = bytes(2 << 20)
    codec = ZstdCodec()
    frames = codec.compress_frames([data])
    g = golden.zstd_compress(data, level=3)
    total = sum(len(f) for f in frames)
    assert total <= 2 * len(g) + 64, (total, len(g))
    assert golden.zstd_frame_decompress(frames[0], len(data)) == data
    # round-trips through our own decoder too
    assert codec.decompress_frames(frames, [len(data)])[0] == data
