"""Mesh-sharded frame compression tests (virtual 8-device CPU mesh, per
SURVEY.md §4 multi-node strategy).  Sharding must not change bytes: a
batch compressed with rows sharded over the mesh equals the single-device
result, and the graft dry-run path (full pipeline under in/out shardings
with a replicated-output collective) executes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libzseek_jax.ops.lz4_encode import lz4_encode_blocks
from libzseek_jax.parallel import mesh as PM
from libzseek_jax.testing.corpus import mixed_corpus


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def test_sharded_lz4_encode_matches_single_device(eight_devices, rng):
    m = PM.frame_mesh(eight_devices)
    B, N = 8, 1 << 15
    X = np.stack([mixed_corpus(np.random.default_rng(i), N) for i in range(B)])
    lens = np.full((B,), N, np.int32)
    out0, olen0 = lz4_encode_blocks(jnp.asarray(X), jnp.asarray(lens))
    Xs, Ls = PM.shard_rows(m, X, lens)
    out1, olen1 = lz4_encode_blocks(Xs, Ls)
    assert np.array_equal(np.asarray(olen0), np.asarray(olen1))
    assert np.array_equal(np.asarray(out0), np.asarray(out1))


def test_pad_rows():
    a = np.arange(10).reshape(5, 2)
    (b,), n = PM.pad_rows([a], 8)
    assert n == 5 and b.shape == (8, 2) and (b[5:] == 0).all()
    (c,), n2 = PM.pad_rows([a], 5)
    assert c is a and n2 == 5


def test_ordered_gather(eight_devices):
    m = PM.frame_mesh(eight_devices)
    payloads = np.arange(64, dtype=np.uint8).reshape(8, 8)
    lengths = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
    ps, ls = PM.shard_rows(m, payloads, lengths)
    got = PM.ordered_gather(ps, ls)
    for i in range(8):
        assert np.array_equal(got[i], payloads[i, : lengths[i]])


def test_graft_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(min(8, len(jax.devices())))


def test_distributed_gather_single_process(eight_devices):
    from libzseek_jax.parallel import distributed as D
    m = PM.frame_mesh(eight_devices)
    payloads = np.arange(64, dtype=np.uint8).reshape(8, 8)
    lengths = np.arange(1, 9, dtype=np.int32)
    ps, ls = PM.shard_rows(m, payloads, lengths)
    frames = D.gather_frames_in_order(m, ps, ls)
    assert frames[3] == payloads[3, :4].tobytes()
    assert D.is_writer_process()


def test_workers_round_robin_chain(eight_devices, rng):
    """Writer(workers=N): batches round-robin across N devices — the
    reference's nb_workers knob (/root/reference/src/zseek.h:136-139)
    mapped to devices.  Each device must parse batches, and the archive
    must be byte-identical to the workers=1 archive and golden-decode."""
    import io

    from libzseek_jax.runtime.reader import Reader
    from libzseek_jax.runtime.writer import Writer
    from libzseek_jax.runtime.zstd_codec import ZstdCodec
    from libzseek_jax.testing import golden
    from libzseek_jax.testing.corpus import mixed_corpus

    data = mixed_corpus(rng, 2 << 20).tobytes()
    archives, codecs = [], []
    for workers in (8, 1):
        codec = ZstdCodec(workers=workers, max_batch_blocks=2)
        buf = io.BytesIO()
        w = Writer(buf, codec=codec, min_frame_size=1 << 18,
                   batch_frames=2)
        for pos in range(0, len(data), 300_000):
            w.write(data[pos: pos + 300_000])
        w.close()
        archives.append(buf.getvalue())
        codecs.append(codec)
    assert set(codecs[0].device_batches) == {d.id for d in eight_devices}
    assert set(codecs[1].device_batches) == {jax.devices()[0].id}
    assert archives[0] == archives[1]
    assert golden.zstd_decompress(archives[0]) == data
    r = Reader(archives[0])
    assert r.pread_full(64_000, 1_000_000) == data[1_000_000:1_064_000]


def test_two_process_distributed_gather():
    """Real multi-process jax.distributed run (VERDICT r1 item 6): two OS
    processes, localhost coordinator, 2 virtual CPU devices each; the
    ordered frame gather crosses the process boundary.  Host-scale analog
    of the reference's worker knob (/root/reference/src/compress.c:96-141).
    """
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "distributed_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=root, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, (rc, err.decode()[-2000:])
    assert b"DIST-OK" in outs[0][1]
    # the multi-host write PRODUCT path: both processes compress shards,
    # process 0 assembles the complete archive and verifies it end-to-end
    assert b"DIST-WRITE-OK" in outs[0][1]
