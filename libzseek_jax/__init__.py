"""libzseek_jax: a seekable-compression framework on JAX.

Brand-new implementation (JAX/XLA compute path, C++ host runtime) of
the capabilities of foxeng/libzseek: sequential-write / random-read compressed
archives in the zstd seekable format and LZ4 frame format, where each frame is
an independently compressed unit indexed by an appended skippable-frame seek
table.  Unlike the reference — a C wrapper over libzstd/liblz4 — the codecs
themselves (LZ77 match finding, LZ4 token packing, zstd FSE/Huffman entropy
coding) run as batched, fully-vectorized XLA programs on an accelerator, and
frames are the unit of data parallelism across its devices.
"""

__version__ = "0.1.0"

from libzseek_jax.errors import ZseekError  # noqa: F401
from libzseek_jax.api import (  # noqa: F401
    Reader, Writer, open_reader, open_writer,
    zseek_pread, zseek_read, zseek_reader_close, zseek_reader_open,
    zseek_reader_stats, zseek_write, zseek_writer_close, zseek_writer_open,
    zseek_writer_stats,
)
