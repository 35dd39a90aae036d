"""Randomized round-trip fuzz + concurrency tests.

The reference has no fuzzing (SURVEY.md §4 lists it as a gap) — these
property tests cover what its manual example.c run cannot: randomized
write-chunk boundaries vs frame boundaries, pathological byte patterns,
random pread spans, and concurrent readers hammering one Reader (the
documented-concurrent path, /root/reference/src/zseek.h:401-404, whose
unlocked-cursor race we fixed rather than replicated)."""

import io
import threading

import numpy as np
import pytest

from libzseek_jax.runtime.reader import Reader
from libzseek_jax.runtime.writer import Writer
from libzseek_jax.testing import golden


def _patterned(rng, n):
    """Adversarial generator: abrupt regime switches at random points."""
    out = np.empty(n, np.uint8)
    pos = 0
    while pos < n:
        k = int(rng.integers(1, max(2, n // 4)))
        k = min(k, n - pos)
        kind = int(rng.integers(0, 5))
        if kind == 0:
            out[pos: pos + k] = rng.integers(0, 256, k)
        elif kind == 1:
            out[pos: pos + k] = int(rng.integers(0, 256))
        elif kind == 2:
            period = int(rng.integers(1, 300))
            pat = rng.integers(0, 256, period, np.uint8)
            out[pos: pos + k] = np.tile(pat, k // period + 1)[:k]
        elif kind == 3:
            out[pos: pos + k] = rng.choice(
                np.frombuffer(b"abcdef ", np.uint8), k)
        else:
            out[pos: pos + k] = (np.arange(k) & 0xFF).astype(np.uint8)
        pos += k
    return out.tobytes()


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_fuzz_roundtrip(codec, rng):
    for trial in range(3):
        n = int(rng.integers(1, 700_000))
        data = _patterned(rng, n)
        buf = io.BytesIO()
        w = Writer(buf, codec=codec,
                   min_frame_size=int(rng.integers(1 << 12, 1 << 18)))
        pos = 0
        while pos < n:
            c = int(rng.integers(1, 200_000))
            w.write(data[pos: pos + c])
            pos += c
        w.close()
        arch = buf.getvalue()
        dec = golden.zstd_decompress(arch) if codec == "zstd" \
            else golden.lz4f_decompress(arch)
        assert dec == data, (codec, trial, n)
        r = Reader(arch)
        for _ in range(16):
            off = int(rng.integers(0, n))
            ln = int(rng.integers(1, 300_000))
            want = data[off: off + ln]
            assert r.pread_full(ln, off) == want, (codec, trial, off, ln)
        # cursor reads across frame boundaries
        r.seek(0)
        got = bytearray()
        while True:
            chunk = r.read(int(rng.integers(1, 99_991)))
            if not chunk:
                break
            got += chunk
        assert bytes(got) == data
        r.close()


def test_concurrent_readers(rng):
    n = 400_000
    data = _patterned(rng, n)
    buf = io.BytesIO()
    w = Writer(buf, codec="zstd", min_frame_size=1 << 14)
    w.write(data)
    w.close()
    r = Reader(buf.getvalue(), cache_frames=4)
    errs = []

    def hammer(seed):
        g = np.random.default_rng(seed)
        try:
            for _ in range(40):
                off = int(g.integers(0, n))
                ln = int(g.integers(1, 50_000))
                if r.pread_full(ln, off) != data[off: off + ln]:
                    errs.append((seed, off, ln))
        except Exception as e:  # noqa: BLE001
            errs.append((seed, repr(e)))

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs[:3]
