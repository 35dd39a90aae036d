"""Native host-runtime (libzseek_native.so) parity tests.

The native module must agree with the pure-Python implementations it
accelerates: Huffman table construction + tree serialization (trees parse
back through the Python reader and through golden conformance paths) and
seek-table (de)serialization byte-for-byte.  Reference counterpart: the
all-C host runtime of /root/reference/src/.
"""

import numpy as np
import pytest

from libzseek_jax import native
from libzseek_jax.format.seek_table import FrameLog
from libzseek_jax.ops import huffman
from libzseek_jax.testing.corpus import mixed_corpus, text_corpus

pytestmark = pytest.mark.usefixtures("native_lib")


def _hists(rng):
    return np.stack([
        np.bincount(text_corpus(rng, 1 << 17), minlength=256),
        np.bincount(mixed_corpus(rng, 1 << 17), minlength=256),
        np.bincount(rng.integers(0, 7, 5000), minlength=256),
        np.bincount(np.array([1, 1, 1, 2], np.uint8), minlength=256),
    ]).astype(np.uint32)


def test_huf_build_matches_python(rng):
    hists = _hists(rng)
    lengths, codes, trees, max_bits = native.huf_build_batch(hists)
    for i in range(hists.shape[0]):
        py = huffman.build_ctable(hists[i])
        assert max_bits[i] == py.max_bits
        # equal total coded size (both package-merge optimal)
        assert int(np.sum(hists[i] * lengths[i])) == \
            int(np.sum(hists[i] * py.lengths))
        # canonical codes consistent with the lengths
        assert np.array_equal(
            huffman._canonical_codes(lengths[i]).codes, codes[i])
        # serialized tree parses back to the same code lengths
        w, _ = huffman.read_weights(trees[i], 0)
        ct = huffman.ctable_from_weights(w)
        assert np.array_equal(ct.lengths, lengths[i])


def test_huf_degenerate_cases():
    one = np.zeros(256, np.uint32)
    one[65] = 100
    uniform = np.ones(256, np.uint32)
    lengths, codes, trees, max_bits = native.huf_build_batch(
        np.stack([one, uniform]))
    assert max_bits[0] == 0          # single symbol: no table
    assert max_bits[1] == -1         # 255 equal weights: unserializable -> raw


def test_seektable_matches_python(rng):
    entries = rng.integers(1, 1 << 30, size=(500, 2)).astype(np.uint32)
    fl = FrameLog()
    for c, d in entries:
        fl.log_frame(int(c), int(d))
    blob = native.seektable_serialize(entries)
    assert blob == fl.serialize()
    n, cum = native.seektable_parse(blob)
    assert n == 500
    assert cum[-1, 0] == int(entries[:, 0].astype(np.int64).sum())
    assert cum[-1, 1] == int(entries[:, 1].astype(np.int64).sum())
    assert native.seektable_parse(blob[:-1] + b"\x00") is None
