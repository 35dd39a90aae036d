"""Multi-host scale-out via jax.distributed.

The reference has no distributed anything (SURVEY.md §2/§5: zero network
code; parallelism ends at libzstd's in-process worker pool).  This
framework's multi-host story, per the BASELINE north star:

  * every process (host) runs the same program under `jax.distributed`;
  * the frame batch is sharded over the GLOBAL device mesh — each host's
    devices compress the frame rows placed on them;
  * per-frame compressed lengths are all-gathered (tiny);
  * frame payloads are gathered IN FRAME ORDER to the writing host by
    replicating the (compress-bound-padded) output array — XLA turns the
    out-sharding change into the collective — and host 0 materializes and
    writes them sequentially, preserving the archive's ordering contract.

Single-process runs degenerate to the local mesh with no collectives, so
the same code path is exercised by the CPU test mesh (SURVEY.md §4).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libzseek_jax.parallel.mesh import FRAME_AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime (no-op when single-process and
    nothing is configured).  Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); a
    GPU host has no cluster metadata, so pass them explicitly."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def global_frame_mesh() -> Mesh:
    """1-D mesh over every device of every participating host."""
    return Mesh(np.asarray(jax.devices()), (FRAME_AXIS,))


def is_writer_process() -> bool:
    return jax.process_index() == 0


def replicate_to_hosts(mesh: Mesh, sharded) -> np.ndarray:
    """Materialize a row-sharded array on every host (the ordered payload
    gather): jit identity with replicated out-sharding inserts the
    all-gather; device_get then pulls local copies only."""
    rep = NamedSharding(mesh, P())
    out = jax.jit(lambda a: a, out_shardings=rep)(sharded)
    return np.asarray(jax.device_get(out))


def write_archive(sink, local_frames, codec=None):
    """Multi-host seekable-archive write — the product path over the
    collectives below.  Every process calls this with ITS shard of the
    frame list (global frame order = process order, then local order);
    each host compresses its shard on its own devices, compressed
    payloads gather in frame order to process 0, and process 0 writes
    the complete archive (frames + seek table).  Returns the writer
    process's ReaderStats-compatible frame count, or None on other
    processes.

    The reference's nearest analog is N zstd worker threads feeding one
    writer (/root/reference/src/compress.c:599-648) — here the workers
    are hosts and the drain is one ordered gather."""
    import jax.experimental.multihost_utils as mhu

    from libzseek_jax.format.seek_table import FrameLog

    if codec is None:
        from libzseek_jax.runtime.zstd_codec import ZstdCodec
        codec = ZstdCodec(collect_hints=False)
    payloads = codec.compress_frames(list(local_frames))
    nproc = jax.process_count()
    ndev_local = len(jax.local_devices())

    # global geometry: per-process frame counts and the payload byte cap
    counts = np.asarray(mhu.process_allgather(
        np.array([len(payloads)], np.int64))).reshape(-1)
    rows = int(counts.max())
    rows += (-rows) % max(1, ndev_local)   # rows divisible per host
    local_meta = np.zeros((rows, 2), np.int64)
    for i, (p, f) in enumerate(zip(payloads, local_frames)):
        local_meta[i] = (len(p), len(f))
    metas = np.asarray(mhu.process_allgather(local_meta)).reshape(-1, 2)
    cap = int(max(1, metas[:, 0].max()))
    cap += (-cap) % 4

    local_pay = np.zeros((rows, cap), np.uint8)
    for i, p in enumerate(payloads):
        local_pay[i, : len(p)] = np.frombuffer(p, np.uint8)

    mesh = global_frame_mesh()
    sh = NamedSharding(mesh, P(FRAME_AXIS))
    glob = jax.make_array_from_process_local_data(sh, local_pay,
                                                  (rows * nproc, cap))
    lens = metas[:, 0].astype(np.int32)
    ordered = gather_frames_in_order(mesh, glob, jnp.asarray(lens))

    if not is_writer_process():
        return None
    fl = FrameLog()
    written = 0
    for pi in range(nproc):
        for k in range(int(counts[pi])):
            row = pi * rows + k
            c, d = int(metas[row, 0]), int(metas[row, 1])
            sink.write(ordered[row][:c])
            fl.log_frame(c, d)
            written += 1
    sink.write(fl.serialize())
    return written


def gather_frames_in_order(mesh: Mesh, payloads, lengths) -> list[bytes]:
    """All hosts participate; returns the ordered frame payload list (only
    meaningful on the writer process, but safe everywhere).

    payloads: (B, CAP) row-sharded device array of compress-bound-padded
    frame bytes; lengths: (B,) true byte counts."""
    host_payloads = replicate_to_hosts(mesh, payloads)
    host_lengths = replicate_to_hosts(mesh, lengths)
    return [host_payloads[i, : int(host_lengths[i])].tobytes()
            for i in range(host_payloads.shape[0])]
