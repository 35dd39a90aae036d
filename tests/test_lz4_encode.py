"""LZ4 block encoder (ops/lz4_encode.lz4_encode_blocks) in both frame
modes: linked blocks that carry the previous block as a context prefix
must decode through stock liblz4 as one linked LZ4F frame, and an
independent block must match the block-level oracle's size."""

import numpy as np
import jax.numpy as jnp
import pytest

from libzseek_jax.format import lz4f
from libzseek_jax.ops.lz4_encode import lz4_encode_blocks
from libzseek_jax.testing import golden

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")

BK = 4096  # small blocks keep the CPU compile and run fast


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(23)
    s = rng.choice(np.frombuffer(b"a modest shared vocabulary ", np.uint8),
                   3 * BK).astype(np.uint8)
    s[BK + 100: BK + 400] = s[50: 350]          # cross-block reference
    s[2 * BK + 10: 2 * BK + 200] = s[2 * BK - 150: 2 * BK + 40]
    return s


def _linked_frame(stream, seg_size=4):
    """Encode 3 linked blocks: row i = [block i-1 | block i]; the first
    block of the frame has no history (min_ref = BK)."""
    B = 3
    X = np.zeros((B, 2 * BK), np.uint8)
    for i in range(B):
        if i:
            X[i, :BK] = stream[(i - 1) * BK: i * BK]
        X[i, BK:] = stream[i * BK: (i + 1) * BK]
    lens = np.full((B,), 2 * BK, np.int32)
    min_ref = np.array([BK, 0, 0], np.int32)
    out, olen = lz4_encode_blocks(jnp.asarray(X), jnp.asarray(lens),
                                  seg_size=seg_size, ctx_len=BK,
                                  min_ref=jnp.asarray(min_ref))
    out, olen = np.asarray(out), np.asarray(olen)
    blocks = [(out[i, : olen[i]].tobytes(), False) for i in range(B)]
    return lz4f.assemble_frame(blocks, 3 * BK, block_independent=False), \
        int(olen.sum())


def test_linked_blocks_golden(stream):
    frame, _ = _linked_frame(stream)
    assert bytes(golden.lz4f_decompress(frame)) == stream.tobytes()


def test_block_without_context_matches_oracle(stream):
    # single independent block: decoded bytes must round-trip and the
    # compressed size must be sane vs liblz4's own encoder
    out, olen = lz4_encode_blocks(jnp.asarray(stream[None, :BK]),
                                  jnp.asarray(np.array([BK], np.int32)))
    comp = np.asarray(out)[0, : int(np.asarray(olen)[0])].tobytes()
    ref = golden.lz4_block_compress(stream[:BK].tobytes())
    assert len(comp) <= int(len(ref) * 1.1) + 16
    frame = lz4f.assemble_frame([(comp, False)], BK, block_independent=True)
    assert bytes(golden.lz4f_decompress(frame)) == stream[:BK].tobytes()


def test_levels_golden_and_monotone(stream):
    """The level knob (LZ4Codec: 8-byte candidate segments below level 0,
    4-byte ones from level 0) must stay golden-decodable, and the finer
    segments must never compress worse."""
    from libzseek_jax.runtime.codec import LZ4Codec

    sizes = {}
    for lvl in (-1, 0):
        frame, sizes[lvl] = _linked_frame(stream, LZ4Codec(lvl).seg_size)
        assert bytes(golden.lz4f_decompress(frame)) == stream.tobytes(), lvl
    assert sizes[0] <= sizes[-1], sizes
