"""Frame-parallel scale-out over a device mesh.

The reference's only parallelism is libzstd's intra-frame worker pool
(`ZSTD_c_nbWorkers`, /root/reference/src/compress.c:96-141) plus CPU-affinity
pinning.  The accelerator equivalent (SURVEY.md §2, parallelism inventory):
frames/blocks are *independent* compression units, so the batch row axis is
sharded round-robin across devices of a mesh — N devices stand in for the
reference's N workers — and XLA partitions the (row-independent) codec
programs with zero cross-device communication in the hot loop.  The only
collectives are the small ones of the runtime protocol:

  * all-gather of per-frame compressed LENGTHS (variable-size outputs are
    carried as compress-bound-padded buffers + true lengths);
  * ordered gather of frame payloads to the writer host at sink time
    (jax.device_get of the sharded output pulls each shard; on GPUs of
    one host that is NVLink or PCIe, all to all).

Multi-host: the same code runs under `jax.distributed` — the mesh spans all
hosts' devices and the writing host materializes outputs in frame order.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = "frames"


def frame_mesh(devices=None, n: int | None = None) -> Mesh:
    """1-D mesh over the frame (batch-row) axis — the workers knob.

    `n` limits the device count (reference: nb_workers,
    /root/reference/src/zseek.h:136-139)."""
    if devices is None:
        devices = jax.devices()
    if n is not None:
        devices = devices[:n]
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(FRAME_AXIS))


def pad_rows(arrs: list[np.ndarray], multiple: int):
    """Pad the leading (frame) axis of each array to a multiple of the mesh
    size so rows divide evenly across devices.  Returns (padded, orig_rows)."""
    rows = arrs[0].shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return arrs, rows
    out = []
    for a in arrs:
        pad = [(0, target - rows)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad))
    return out, rows


def shard_rows(mesh: Mesh, *arrays):
    """device_put each array with rows sharded over the mesh."""
    sh = row_sharding(mesh)
    return tuple(jax.device_put(a, sh) for a in arrays)


def gather_frame_lengths(lengths) -> np.ndarray:
    """All-gather of per-frame compressed lengths to the host (the reference
    analog: the writer thread learning each worker's output size as it
    drains ZSTD_compressStream2, src/compress.c:294-333)."""
    return np.asarray(jax.device_get(lengths))


def ordered_gather(payloads, lengths) -> list[np.ndarray]:
    """Materialize variable-length frame payloads in frame order on the
    host: device_get pulls each row from its owning device."""
    host = np.asarray(jax.device_get(payloads))
    lens = gather_frame_lengths(lengths)
    return [host[i, : lens[i]] for i in range(host.shape[0])]
