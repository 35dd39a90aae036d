"""The zstd write route end to end on the CPU: golden round trips over
levels x corpora, the integer entropy gate, and an exact pin of the
route's output size on the frozen source corpus (byte counts are
deterministic, so any change to the route's output shows here)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from libzseek_jax.ops.zstd_encode import block_entropy_h16
from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden
from libzseek_jax.testing.corpus import mixed_corpus, text_corpus

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_results", "corpus_source_r5.bin")

N = 96 * 1024


def _corpus(name):
    rng = np.random.default_rng(17)
    if name == "text":
        return text_corpus(rng, N).tobytes()
    if name == "mixed":
        return mixed_corpus(rng, N).tobytes()
    if name == "periodic":
        return (rng.integers(0, 256, 1000, np.uint8).tobytes() * 100)[:N]
    if name == "zeros":
        return bytes(N)
    with open(SOURCE, "rb") as f:      # "source": structured text
        return f.read()[:N]


@pytest.mark.parametrize("level", [1, 3, 9])
@pytest.mark.parametrize("name", ["text", "mixed", "periodic", "zeros",
                                  "source"])
def test_golden_roundtrip(level, name):
    raw = _corpus(name)
    frames = ZstdCodec(level=level).compress_frames([raw[: N // 2],
                                                      raw[N // 2:]])
    assert golden.zstd_decompress(b"".join(frames)) == raw
    assert sum(map(len, frames)) < len(raw) or name == "mixed"


def test_entropy_gate_matches_float_reference():
    rng = np.random.default_rng(3)
    hists, lens = [], []
    for k in (1, 2, 7, 30, 256):
        for n in (64, 4000, 131072):
            h = np.zeros(256, np.int64)
            w = rng.random(k) + 0.05
            h[rng.choice(256, k, replace=False)] = rng.multinomial(
                n, w / w.sum())
            hists.append(h)
            lens.append(n)
    hists, lens = np.array(hists), np.array(lens)
    got = np.asarray(block_entropy_h16(jnp.asarray(hists, jnp.int32),
                                       jnp.asarray(lens, jnp.int32)))
    p = hists / lens[:, None]
    H = -np.sum(np.where(p > 0, p * np.log2(np.where(p > 0, p, 1)), 0), 1)
    want = np.clip(np.floor(16 * H), 16, 128)
    assert np.abs(got - want).max() <= 1, (got, want)


@pytest.mark.parametrize("level,size", [(3, 177945), (4, 177945)])
def test_source_corpus_size_pin(native_lib, level, size):
    """One 506,092-byte frame of the frozen source corpus.  Levels >= 2
    share the parse parameters and keep 128 KiB blocks, so L4 equals L3."""
    with open(SOURCE, "rb") as f:
        raw = f.read()
    frames = ZstdCodec(level=level).compress_frames([raw])
    assert golden.zstd_decompress(frames[0]) == raw
    assert len(frames[0]) == size
