"""zstd seekable-format seek table: serialization, parsing, and offset queries.

Format (zstd contrib "seekable format", as used by the reference library,
/root/reference/src/seek_table.c:15-21,243-434):

    [skippable frame magic 0x184D2A5E (LE u32)]
    [frame size = 8*N + 9 (+4*N with checksums) (LE u32)]
    [entry 0: cSize (LE u32), dSize (LE u32) [, checksum (LE u32)]]
    ...
    [entry N-1]
    [footer: numFrames (LE u32), descriptor byte (checksumFlag<<7), magic 0x8F92EAB1 (LE u32)]

The skippable magic 0x184D2A5E also falls inside LZ4F's skippable range
(0x184D2A50-5F), so one table format serves both codecs
(/root/reference/src/compress.c:217,547).

This module is the host-side metadata layer (cold path).  The hot query path
(binary search of decompressed offset -> frame index) is also exposed as a
vectorized NumPy routine for batched queries, and the native C++ runtime
(libzseek_jax/native) provides an equivalent for the low-latency reader path.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

SKIPPABLE_MAGIC = 0x184D2A5E  # ZSTD_MAGIC_SKIPPABLE_START | 0xE
SEEKABLE_MAGIC = 0x8F92EAB1
SKIPPABLE_HEADER_SIZE = 8
FOOTER_SIZE = 9
MAX_FRAMES = 0x8000000  # 2^27, reference cap (src/seek_table.c:17)
ENTRY_SIZE = 8
ENTRY_CHECKSUM_SIZE = 4


class SeekTableError(ValueError):
    pass


@dataclasses.dataclass
class SeekTable:
    """Parsed seek table: cumulative compressed/decompressed offsets.

    ``c_offsets``/``d_offsets`` have N+1 entries (sentinel at the end), like
    the reference's in-memory layout (src/seek_table.c:62-110).
    """

    c_offsets: np.ndarray  # (N+1,) uint64
    d_offsets: np.ndarray  # (N+1,) uint64
    checksums: np.ndarray | None = None  # (N,) uint32 or None

    @property
    def num_frames(self) -> int:
        return len(self.c_offsets) - 1

    @property
    def decompressed_size(self) -> int:
        return int(self.d_offsets[-1])

    @property
    def compressed_size(self) -> int:
        """Total compressed payload size (excluding the seek table itself)."""
        return int(self.c_offsets[-1])

    def frame_for_offset(self, d_offset: int) -> int:
        """Binary-search a decompressed offset to its covering frame index.

        Mirrors offset_to_frame_idx (src/seek_table.c:187-202): offsets past
        EOF clamp to the last frame.
        """
        n = self.num_frames
        if n == 0:
            raise SeekTableError("empty seek table")
        if d_offset >= int(self.d_offsets[-1]):
            return n - 1
        # d_offsets is non-decreasing; find rightmost frame with start <= off
        idx = int(np.searchsorted(self.d_offsets, d_offset, side="right")) - 1
        # Skip over empty frames (dSize == 0) like the reference binary search
        while self.d_offsets[idx + 1] == self.d_offsets[idx] and idx < n - 1:
            idx += 1
        return idx

    def frames_for_offsets(self, d_offsets: np.ndarray) -> np.ndarray:
        """Vectorized frame_for_offset for batched random reads."""
        d_offsets = np.asarray(d_offsets, dtype=np.uint64)
        n = self.num_frames
        idx = np.searchsorted(self.d_offsets, d_offsets, side="right") - 1
        return np.clip(idx, 0, n - 1).astype(np.int64)

    def frame_c_offset(self, idx: int) -> int:
        return int(self.c_offsets[idx])

    def frame_d_offset(self, idx: int) -> int:
        return int(self.d_offsets[idx])

    def frame_c_size(self, idx: int) -> int:
        return int(self.c_offsets[idx + 1] - self.c_offsets[idx])

    def frame_d_size(self, idx: int) -> int:
        return int(self.d_offsets[idx + 1] - self.d_offsets[idx])

    def memory_usage(self) -> int:
        mem = self.c_offsets.nbytes + self.d_offsets.nbytes
        if self.checksums is not None:
            mem += self.checksums.nbytes
        return mem


class FrameLog:
    """Accumulates per-frame (cSize, dSize[, checksum]) entries and serializes
    them as the seek-table skippable frame.

    Parity with ZSTD_seekable_createFrameLog / logFrame / writeSeekTable
    (src/seek_table.c:281-419), including the 2^27 frame cap.  Serialization
    here is single-shot (the resumable partial-buffer protocol of the
    reference exists to cope with tiny output buffers; our writer hands whole
    buffers to the IO callback).
    """

    def __init__(self, checksum_flag: bool = False):
        self.checksum_flag = bool(checksum_flag)
        self._c_sizes: list[int] = []
        self._d_sizes: list[int] = []
        self._checksums: list[int] = []

    def log_frame(self, c_size: int, d_size: int, checksum: int = 0) -> None:
        if len(self._c_sizes) >= MAX_FRAMES:
            raise SeekTableError("frame index too large (2^27 frames max)")
        if not (0 <= c_size < 2**32 and 0 <= d_size < 2**32):
            raise SeekTableError("frame sizes must fit in 32 bits")
        self._c_sizes.append(int(c_size))
        self._d_sizes.append(int(d_size))
        self._checksums.append(int(checksum) & 0xFFFFFFFF)

    def __len__(self) -> int:
        return len(self._c_sizes)

    @property
    def entries(self) -> int:
        return len(self._c_sizes)

    def size(self) -> int:
        """Serialized size of the seek table (framelog_size parity)."""
        per = ENTRY_SIZE + (ENTRY_CHECKSUM_SIZE if self.checksum_flag else 0)
        return SKIPPABLE_HEADER_SIZE + per * len(self._c_sizes) + FOOTER_SIZE

    def memory_usage(self) -> int:
        return 3 * 8 * len(self._c_sizes) + 64

    def serialize(self) -> bytes:
        n = len(self._c_sizes)
        per = ENTRY_SIZE + (ENTRY_CHECKSUM_SIZE if self.checksum_flag else 0)
        table_len = SKIPPABLE_HEADER_SIZE + per * n + FOOTER_SIZE
        out = bytearray()
        out += struct.pack("<II", SKIPPABLE_MAGIC, table_len - SKIPPABLE_HEADER_SIZE)
        if self.checksum_flag:
            arr = np.empty((n, 3), dtype="<u4")
            arr[:, 2] = self._checksums
        else:
            arr = np.empty((n, 2), dtype="<u4")
        arr[:, 0] = self._c_sizes
        arr[:, 1] = self._d_sizes
        out += arr.tobytes()
        out += struct.pack("<I", n)
        out += bytes([int(self.checksum_flag) << 7])
        out += struct.pack("<I", SEEKABLE_MAGIC)
        assert len(out) == table_len
        return bytes(out)


def parse_seek_table(pread, fsize: int) -> SeekTable:
    """Read and validate a seek table from the end of an archive.

    ``pread(offset, size) -> bytes`` is the pluggable read callback; ``fsize``
    the total file size.  Mirrors read_seek_table (src/seek_table.c:112-176):
    validates the footer magic, descriptor reserved bits, skippable magic, and
    the frame-size arithmetic.
    """
    if fsize < FOOTER_SIZE:
        raise SeekTableError("file too small for seek-table footer")
    footer = pread(fsize - FOOTER_SIZE, FOOTER_SIZE)
    if len(footer) != FOOTER_SIZE:
        raise SeekTableError("short read on seek-table footer")
    num_frames = struct.unpack_from("<I", footer, 0)[0]
    descriptor = footer[4]
    magic = struct.unpack_from("<I", footer, 5)[0]
    if magic != SEEKABLE_MAGIC:
        raise SeekTableError(f"bad seekable magic 0x{magic:08X}")
    if descriptor & 0x7C:
        raise SeekTableError("unsupported seek-table descriptor (reserved bits set)")
    checksum_flag = bool(descriptor >> 7)
    per = ENTRY_SIZE + (ENTRY_CHECKSUM_SIZE if checksum_flag else 0)
    table_len = SKIPPABLE_HEADER_SIZE + per * num_frames + FOOTER_SIZE
    if fsize < table_len:
        raise SeekTableError("file too small for declared seek table")
    table_start = fsize - table_len
    header = pread(table_start, SKIPPABLE_HEADER_SIZE)
    h_magic, h_size = struct.unpack("<II", header)
    if h_magic != SKIPPABLE_MAGIC:
        raise SeekTableError(f"bad skippable magic 0x{h_magic:08X}")
    if h_size != table_len - SKIPPABLE_HEADER_SIZE:
        raise SeekTableError("seek-table size mismatch")
    raw = pread(table_start + SKIPPABLE_HEADER_SIZE, per * num_frames)
    if len(raw) != per * num_frames:
        raise SeekTableError("short read on seek-table entries")
    arr = np.frombuffer(raw, dtype="<u4").reshape(num_frames, per // 4) if num_frames else np.zeros((0, per // 4), dtype="<u4")
    c_offsets = np.zeros(num_frames + 1, dtype=np.uint64)
    d_offsets = np.zeros(num_frames + 1, dtype=np.uint64)
    if num_frames:
        np.cumsum(arr[:, 0], dtype=np.uint64, out=c_offsets[1:])
        np.cumsum(arr[:, 1], dtype=np.uint64, out=d_offsets[1:])
    checksums = arr[:, 2].copy() if checksum_flag and num_frames else None
    return SeekTable(c_offsets=c_offsets, d_offsets=d_offsets, checksums=checksums)


def parse_seek_table_bytes(data: bytes) -> SeekTable:
    """Convenience: parse from an in-memory archive."""
    return parse_seek_table(lambda off, size: data[off : off + size], len(data))
