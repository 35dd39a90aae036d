"""LZ4 block codec tests: our encoder must produce blocks that stock liblz4
decodes bit-for-bit; our decoder must decode stock-liblz4-produced blocks;
and the pair must round-trip, across every data regime."""

import numpy as np
import pytest
import jax.numpy as jnp

from libzseek_jax.ops.lz4_encode import lz4_encode_blocks, lz4_compress_bound
from libzseek_jax.ops.lz4_decode import lz4_decode_blocks
from libzseek_jax.testing import golden
from libzseek_jax.testing.corpus import mixed_corpus, text_corpus

N = 16384
pytestmark = pytest.mark.skipif(
    not golden.have_lz4(), reason="no system liblz4")


def make_batch(rows, lens):
    B = len(rows)
    X = np.zeros((B, N), np.uint8)
    for i, (r, l) in enumerate(zip(rows, lens)):
        X[i, :l] = r[:l]
    return X, np.asarray(lens, np.int32)


@pytest.fixture(scope="module")
def batch(rng):
    rng = np.random.default_rng(11)
    rows = [
        mixed_corpus(rng, N),
        text_corpus(rng, N),
        np.zeros(N, np.uint8),
        rng.integers(0, 256, N, dtype=np.uint8),      # incompressible
        np.tile(np.arange(64, dtype=np.uint8), N // 64),  # periodic
        rng.integers(0, 4, N, dtype=np.uint8),        # tiny alphabet
    ]
    lens = [N, N, N, N // 2, N, N - 37]
    return make_batch(rows, lens)


def test_encode_decodes_via_stock_lz4(batch):
    X, lens = batch
    out, olens = lz4_encode_blocks(jnp.asarray(X), jnp.asarray(lens))
    out, olens = np.asarray(out), np.asarray(olens)
    for i in range(X.shape[0]):
        ref = X[i, : lens[i]].tobytes()
        dec = golden.lz4_block_decompress(out[i, : olens[i]].tobytes(), int(lens[i]))
        assert dec == ref, f"row {i} round-trip mismatch"


def test_encode_ratio_competitive(batch):
    """Compressed size within 5% of stock LZ4 default level on every regime
    (target: parity or better; see BASELINE.md)."""
    X, lens = batch
    out, olens = lz4_encode_blocks(jnp.asarray(X), jnp.asarray(lens))
    olens = np.asarray(olens)
    for i in range(X.shape[0]):
        ref = X[i, : lens[i]].tobytes()
        gold = len(golden.lz4_block_compress(ref))
        assert olens[i] <= gold * 1.01 + 16, \
            f"row {i}: ours {olens[i]} vs stock {gold}"


def test_decode_stock_blocks(batch):
    X, lens = batch
    comps = [golden.lz4_block_compress(X[i, : lens[i]].tobytes())
             for i in range(X.shape[0])]
    M = max(len(c) for c in comps)
    M += (-M) % 128
    CB = np.zeros((len(comps), M), np.uint8)
    for i, c in enumerate(comps):
        CB[i, : len(c)] = np.frombuffer(c, np.uint8)
    clens = np.asarray([len(c) for c in comps], np.int32)
    out, olens, ok = lz4_decode_blocks(jnp.asarray(CB), jnp.asarray(clens), N)
    out, olens, ok = np.asarray(out), np.asarray(olens), np.asarray(ok)
    for i in range(X.shape[0]):
        assert ok[i]
        assert olens[i] == lens[i]
        assert out[i, : olens[i]].tobytes() == X[i, : lens[i]].tobytes()


def test_roundtrip_self(batch):
    X, lens = batch
    eout, eolens = lz4_encode_blocks(jnp.asarray(X), jnp.asarray(lens))
    out, olens, ok = lz4_decode_blocks(eout, eolens, N)
    out, olens, ok = np.asarray(out), np.asarray(olens), np.asarray(ok)
    for i in range(X.shape[0]):
        assert ok[i] and olens[i] == lens[i]
        assert out[i, : olens[i]].tobytes() == X[i, : lens[i]].tobytes()


def test_decoder_rejects_corrupt():
    raw = text_corpus(np.random.default_rng(5), 4096).tobytes()
    comp = bytearray(golden.lz4_block_compress(raw))
    # corrupt an offset field to point before the block start
    comp[1] = 0xFF
    comp[2] = 0xFF
    M = len(comp) + (-len(comp)) % 128
    CB = np.zeros((1, M), np.uint8)
    CB[0, : len(comp)] = np.frombuffer(bytes(comp), np.uint8)
    out, olens, ok = lz4_decode_blocks(
        jnp.asarray(CB), jnp.asarray([len(comp)], np.int32), 4096)
    # either flagged bad or (if the mutation stayed parseable) still bounded
    assert np.asarray(out).shape == (1, 4096)


def test_tiny_and_empty_blocks():
    # < 13 bytes: must be all literals per the spec's end rules
    for raw in (b"a", b"hello world!", b"x" * 12):
        X = np.zeros((1, N), np.uint8)
        X[0, : len(raw)] = np.frombuffer(raw, np.uint8)
        out, olens = lz4_encode_blocks(
            jnp.asarray(X), jnp.asarray([len(raw)], np.int32))
        blk = np.asarray(out)[0, : int(np.asarray(olens)[0])].tobytes()
        assert golden.lz4_block_decompress(blk, len(raw)) == raw


def test_compress_bound():
    assert lz4_compress_bound(65536) >= 65536 + 16


def test_host_decode_rejects_corrupt_blocks(native_lib):
    """The native LZ4 host decoder must fail corrupt input (offset past
    the window start, truncated streams), not produce bytes."""
    from libzseek_jax.runtime.codec import LZ4Codec

    native = native_lib
    data = b"abcdefgh" * 4096
    codec = LZ4Codec()
    fr = codec.compress_frames([data])[0]
    assert codec.decompress_frames([fr], [len(data)])[0] == data
    # truncate inside the block payload
    bad = fr[: len(fr) - 12]
    with pytest.raises(Exception):
        codec.decompress_frames([bad], [len(data)])
    # offset reaching before the frame start
    out = np.zeros(64, np.uint8)
    tok = bytes([0x12, 0x41, 0x10, 0x00])  # 1 literal, match off=16 at op=1
    assert native.lz4_block_decode(np.frombuffer(tok, np.uint8),
                                   out, 0) == -1
