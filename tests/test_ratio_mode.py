"""Ratio paths: the full repcode rewrite (decoder-state simulation) and
levels >= 4, which keep the format's full 128 KiB blocks."""

from __future__ import annotations

import io

import numpy as np
import jax.numpy as jnp
import pytest

from libzseek_jax.api import Writer, Reader
from libzseek_jax.ops.zstd_encode import _rep1_rewrite
from libzseek_jax.runtime.io import BytesIOSource
from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden


def _decoder_rep_resolve(out_offv, lls):
    """Reference simulation of RFC 8878 §3.1.1.5 repeat offsets over one
    block (initial reps are irrelevant here: the rewrite never emits a
    rep before an in-block explicit write of that slot)."""
    r = [None, None, None]
    dists = []
    for ov, ll in zip(out_offv, lls):
        if ov > 3:
            d = ov - 3
            r = [d, r[0], r[1]]
        elif ov == 1:
            assert ll > 0
            d = r[0]
        elif ov == 2:
            assert ll > 0
            d = r[1]
            r = [r[1], r[0], r[2]]
        else:
            assert ll > 0
            d = r[2]
            r = [r[2], r[0], r[1]]
        assert d is not None, "rep before any in-block explicit"
        dists.append(d)
    return dists


def test_rep_rewrite_matches_decoder_state():
    rng = np.random.default_rng(3)
    B, S = 4, 64
    # distances drawn from a small pool so rep2/rep3 hits actually occur
    pool = np.array([8, 64, 777, 7777])
    dist = pool[rng.integers(0, 4, (B, S))]
    offv = (dist + 3).astype(np.int32)
    ll = rng.integers(0, 3, (B, S)).astype(np.int32)   # some ll == 0
    n_seq = np.array([S, S - 5, 1, 0], np.int32)
    valid = np.arange(S)[None, :] < n_seq[:, None]
    offv = np.where(valid, offv, 0)
    out = np.asarray(_rep1_rewrite(jnp.asarray(offv), jnp.asarray(ll),
                                   jnp.asarray(valid)))
    hits = 0
    for b in range(B):
        n = int(n_seq[b])
        got = _decoder_rep_resolve(out[b, :n].tolist(), ll[b, :n].tolist())
        np.testing.assert_array_equal(got, dist[b, :n],
                                      err_msg=f"row {b}")
        hits += int((out[b, :n] <= 3).sum())
    assert hits > S // 2, "rewrite found almost no repcodes on rep-heavy data"


def test_level4_full_blocks_roundtrip():
    """Level >= 4 codecs keep 128 KiB blocks (the parser has no per-block
    sequence cap that smaller blocks would work around): full archive
    roundtrip through stock libzstd plus random preads."""
    rng = np.random.default_rng(9)
    base = np.frombuffer(b"def probe(self, x):\n    return x + 1\n",
                         np.uint8)
    piece = rng.choice(base, 200_000).astype(np.uint8).tobytes()
    data = piece * 3 + rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
    codec = ZstdCodec(level=4)
    assert codec.block == 131072
    frames = codec.compress_frames([data])
    assert golden.zstd_decompress(b"".join(frames)) == data
    # through the Writer/Reader stack
    buf = io.BytesIO()
    w = Writer(buf, codec="zstd", level=4, min_frame_size=1 << 18)
    for p in range(0, len(data), 65536):
        w.write(data[p: p + 65536])
    w.close()
    arc = buf.getvalue()
    assert golden.zstd_decompress(arc) == data
    r = Reader(BytesIOSource(arc))
    for _ in range(40):
        off = int(rng.integers(0, len(data) - 1))
        got = r.pread(int(rng.integers(1, 4000)), off)
        assert data[off: off + len(got)] == got and got


def test_level4_no_worse_than_level3_on_source_text():
    # structured text = a finite pool of LINES in random order (the
    # source-code regime: abundant 5-30 byte repeats at long distances),
    # every line unique (no whole-line matches) but dense in shared 5-15
    # byte idioms
    rng = np.random.default_rng(2)
    names = ["total", "value", "index", "offset", "result", "buffer"]
    lines = []
    for i in range(9000):
        a = names[int(rng.integers(0, 6))]
        b = names[int(rng.integers(0, 6))]
        lines.append(f"        self.{a}_{int(rng.integers(0, 10 ** 6))}"
                     f" = compute_{b}(x_{int(rng.integers(0, 10 ** 6))})\n"
                     .encode())
    data = b"".join(lines)
    f3 = ZstdCodec(level=3).compress_frames([data])
    f4 = ZstdCodec(level=4).compress_frames([data])
    assert golden.zstd_decompress(b"".join(f4)) == data
    s3, s4 = sum(map(len, f3)), sum(map(len, f4))
    assert s4 <= s3, (s4, s3)
