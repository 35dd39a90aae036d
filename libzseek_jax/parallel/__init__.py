"""Scale-out: frame-axis mesh sharding (single host) and jax.distributed
multi-host helpers.  See mesh.py and distributed.py."""

from libzseek_jax.parallel.mesh import (  # noqa: F401
    FRAME_AXIS, frame_mesh, gather_frame_lengths, ordered_gather, pad_rows,
    row_sharding, shard_rows,
)
