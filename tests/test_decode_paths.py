"""zstd decode through the XLA passes, delivered to the host (bytes) or
kept on the device (jax arrays, the device frame cache's path): both
deliveries must give the same bytes on our encoder's archives and on
stock-libzstd frames, including multi-block frames, long offsets and
hint-anchored decoding."""

import jax
import numpy as np
import pytest

from libzseek_jax.ops.zstd_decode import decode_frames
from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden
from libzseek_jax.testing.corpus import mixed_corpus, text_corpus


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(91)


@pytest.fixture(params=["host", "device"])
def decode(request):
    """decode_frames with the delivery under test; returns host bytes."""
    to_device = request.param == "device"

    def run(frames, sizes, hints=None):
        outs = decode_frames(frames, sizes, hints=hints, to_device=to_device)
        if to_device:
            assert all(isinstance(o, jax.Array) for o in outs)
            return [np.asarray(o).tobytes() for o in outs]
        return outs

    run.to_device = to_device
    return run


def _cases(rng, n=24 * 1024):
    return {
        "text": text_corpus(rng, n).tobytes(),
        "periodic": (rng.integers(0, 256, 337, np.uint8).tobytes()
                     * (n // 337 + 1))[:n],
        "zeros": bytes(n),
        "noise": rng.integers(0, 256, n, np.uint8).tobytes(),
        "tiny": b"abcabcabcabc",
        "one": b"x",
        "empty": b"",
    }


def test_roundtrip_own_encoder(rng, decode):
    cases = _cases(rng)
    codec = ZstdCodec()
    frames = codec.compress_frames(list(cases.values()))
    outs = decode(frames, [len(v) for v in cases.values()])
    for (name, raw), out in zip(cases.items(), outs):
        assert out == raw, name


def test_multiblock_linked(rng, decode):
    # 3 blocks with cross-block matches in one frame: the cross-block
    # repcode chain and frame-wide execution
    raw = mixed_corpus(rng, 300 * 1024).tobytes()
    raw = raw[:150 * 1024] + raw[:100 * 1024] + raw[150 * 1024:]
    raw = raw[:300 * 1024]
    codec = ZstdCodec()
    fr = codec.compress_frames([raw])[0]
    assert decode([fr], [len(raw)])[0] == raw


@pytest.mark.skipif(not golden.have_zstd(), reason="libzstd unavailable")
def test_golden_frames(rng, decode):
    cases = _cases(rng)
    for level in (1, 3, 19):
        frames = [golden.zstd_compress(v, level=level)
                  for v in cases.values() if v]
        sizes = [len(v) for v in cases.values() if v]
        outs = decode(frames, sizes)
        for raw, out in zip((v for v in cases.values() if v), outs):
            assert out == raw, level


@pytest.mark.skipif(not golden.have_zstd(), reason="libzstd unavailable")
def test_golden_multiblock_multiframe_batch(rng, decode):
    raws = [
        (text_corpus(rng, 150 * 1024).tobytes() + bytes(100 * 1024)
         + rng.integers(0, 256, 80 * 1024, np.uint8).tobytes()),
        text_corpus(rng, 200 * 1024).tobytes(),
    ]
    frames = [golden.zstd_compress(r, level=3) for r in raws]
    outs = decode(frames, [len(r) for r in raws])
    for raw, out in zip(raws, outs):
        assert out == raw


def test_device_resident_output(rng, decode):
    raw = mixed_corpus(rng, 64 * 1024).tobytes()
    codec = ZstdCodec()
    fr = codec.compress_frames([raw])[0]
    outs = decode_frames([fr], [len(raw)], to_device=decode.to_device)
    assert isinstance(outs[0], jax.Array) == decode.to_device
    assert np.asarray(outs[0]).tobytes() == raw


def test_large_frame_with_hints(rng, decode):
    """A six-block frame decoded through the hint-anchored chunk lanes
    must match the input bit-exact."""
    raw = mixed_corpus(rng, 768 * 1024).tobytes()
    codec = ZstdCodec()
    fr, fh = codec.compress_frames([raw], return_hints=True)
    assert any(h is not None for h in fh[0])
    assert decode([fr[0]], [len(raw)], hints=[fh[0]])[0] == raw


@pytest.mark.skipif(not golden.have_zstd(), reason="libzstd unavailable")
def test_foreign_long_window_frame(rng, decode):
    """Stock zstd with a multi-MiB window produces offsets beyond one
    block; frame-wide execution must still resolve them."""
    blk = rng.integers(0, 256, 400 * 1024, np.uint8).tobytes()
    raw = blk + bytes(16) + blk   # match at distance ~400 KiB
    fr = golden.zstd_compress(raw, level=19, strategy=None)
    assert decode([fr], [len(raw)])[0] == raw
