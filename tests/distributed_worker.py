"""Worker program for the 2-process jax.distributed test.

Run as: python tests/distributed_worker.py <process_id> <num_processes>
<coordinator_port>.  Each process owns 2 virtual CPU devices; the global
mesh spans 4 devices over 2 processes.  Process 0 prints DIST-OK after
verifying an ordered cross-process frame gather (the multi-host writer
collective from libzseek_jax/parallel/distributed.py).

This is the scale-out analog of the reference's worker-pool knob
(/root/reference/src/compress.c:96-141): hosts ≙ workers, and the frame
payload gather is the only cross-host communication the design needs.
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libzseek_jax.parallel import distributed as dist  # noqa: E402
from libzseek_jax.parallel.mesh import FRAME_AXIS  # noqa: E402


def main():
    dist.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                    process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc

    mesh = dist.global_frame_mesh()
    B, CAP = 8, 64
    rows = np.stack([(np.arange(CAP) + 10 * i).astype(np.uint8)
                     for i in range(B)])
    lengths = (np.arange(B, dtype=np.int32) % CAP) + 3

    sh = NamedSharding(mesh, P(FRAME_AXIS))
    payloads = jax.make_array_from_callback((B, CAP), sh,
                                            lambda idx: rows[idx])
    lens = jax.make_array_from_callback(
        (B,), NamedSharding(mesh, P(FRAME_AXIS)), lambda idx: lengths[idx])

    # every local shard really lives on this process before the gather
    own = {d.process_index for d in payloads.sharding.device_set}
    assert own == set(range(nproc))

    frames = dist.gather_frames_in_order(mesh, payloads, lens)
    assert len(frames) == B
    for i, fr in enumerate(frames):
        want = rows[i, : lengths[i]].tobytes()
        assert fr == want, (pid, i, fr[:8], want[:8])

    if dist.is_writer_process():
        print("DIST-OK", flush=True)
    product_write()
    jax.distributed.shutdown()




def product_write():
    """Multi-host write product path: both processes compress their frame
    shard, process 0 assembles the complete archive; verified via the
    Reader and byte equality."""
    import io

    from libzseek_jax.runtime.reader import Reader

    rng = np.random.default_rng(100 + pid)
    my_frames = [
        (b"process %d frame %d " % (pid, k)) * 600 +
        rng.integers(0, 256, 512, np.uint8).tobytes()
        for k in range(2 + pid)   # uneven shard sizes on purpose
    ]
    sink = io.BytesIO()
    wrote = dist.write_archive(sink, my_frames)
    if not dist.is_writer_process():
        return
    assert wrote == 2 * nproc + sum(range(nproc)), wrote
    # reconstruct the expected global byte stream (process-major order)
    want = b""
    for p in range(nproc):
        r = np.random.default_rng(100 + p)
        for k in range(2 + p):
            want += (b"process %d frame %d " % (p, k)) * 600 + \
                r.integers(0, 256, 512, np.uint8).tobytes()
    arch = sink.getvalue()
    rd = Reader(arch)
    got = rd.pread_full(rd.decompressed_size, 0)
    assert got == want, "multi-host archive mismatch"
    print("DIST-WRITE-OK", flush=True)


if __name__ == "__main__":
    main()
