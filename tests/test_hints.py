"""Decode-anchor sidecar tests (format/hints.py).

The anchored decode path must produce bit-identical output to the generic
path, the sidecar must survive a serialize/parse round-trip, stock zstd
tooling must still read archives that carry it (it is a skippable frame),
and the Writer/Reader pair must publish and use it transparently.
"""

import io

import numpy as np
import pytest

from libzseek_jax.format import hints as H
from libzseek_jax.ops import zstd_decode as zd
from libzseek_jax.runtime.reader import Reader
from libzseek_jax.runtime.writer import Writer
from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden
from libzseek_jax.testing.corpus import mixed_corpus, text_corpus


@pytest.fixture(scope="module")
def payloads(rng):
    n = 160 * 1024  # > one block: exercises multi-block frames
    return {
        "text": text_corpus(rng, n).tobytes(),
        "mixed": mixed_corpus(rng, n).tobytes(),
        "periodic": (rng.integers(0, 256, 337, np.uint8).tobytes()
                     * (n // 337 + 1))[:n],
    }


def test_hints_roundtrip_serialization(payloads):
    codec = ZstdCodec()
    frames, fh = codec.compress_frames(list(payloads.values()),
                                       return_hints=True)
    blob = H.serialize(fh)
    parsed = H.parse(blob, 0)
    assert parsed is not None and len(parsed) == len(fh)
    for a, b in zip(fh, parsed):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if x is None:
                assert y is None
                continue
            if x.lit is None:
                assert y.lit is None
            else:
                assert y.lit.interval == x.lit.interval
                assert y.lit.bitpos == x.lit.bitpos
            if x.seq is None:
                assert y.seq is None or not y.seq.bitpos
            else:
                assert y.seq.bitpos == x.seq.bitpos
                assert y.seq.states == x.seq.states
                assert y.seq.rep1 == x.seq.rep1


def test_anchored_decode_matches_generic(payloads):
    codec = ZstdCodec()
    frames, fh = codec.compress_frames(list(payloads.values()),
                                       return_hints=True)
    sizes = [len(v) for v in payloads.values()]
    generic = zd.decode_frames(frames, sizes)
    anchored = zd.decode_frames(frames, sizes, hints=fh)
    for (name, raw), g, a in zip(payloads.items(), generic, anchored):
        assert g == raw, name
        assert a == raw, (name, "anchored")


def test_writer_publishes_reader_uses(payloads):
    buf = io.BytesIO()
    w = Writer(buf, codec="zstd", min_frame_size=128 * 1024)
    raw = b"".join(payloads.values())
    w.write(raw)
    w.close()
    arch = buf.getvalue()
    r = Reader(arch)
    assert r._hints is not None, "sidecar not found"
    assert r.pread_full(len(raw), 0) == raw
    # stock zstd still decodes every frame (the sidecar is skippable)
    t = r.seek_table
    rebuilt = b"".join(
        golden.zstd_decompress(arch[t.frame_c_offset(i):
                                    t.frame_c_offset(i) + t.frame_c_size(i)])
        for i in range(t.num_frames))
    assert rebuilt == raw


def test_hints_disabled_still_works(payloads):
    buf = io.BytesIO()
    w = Writer(buf, codec=ZstdCodec(collect_hints=False),
               min_frame_size=128 * 1024)
    raw = payloads["mixed"]
    w.write(raw)
    w.close()
    r = Reader(buf.getvalue())
    assert r._hints is None
    assert r.pread_full(len(raw), 0) == raw
