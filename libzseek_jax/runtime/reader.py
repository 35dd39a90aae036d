"""Random-access archive reader.

Parity with the reference read path (/root/reference/src/decompress.c):

  * open sniffs the codec from the archive's first 4 bytes
    (ZSTD_MAGIC 0xFD2FB528 / LZ4_MAGIC 0x184D2204, :22-23,261-288);
  * the seek table is read from EOF via the pluggable pread/fsize callbacks;
  * pread(size, offset) binary-searches the covering frame, serves from the
    decompressed-frame LRU cache or decodes the frame (on device) on a miss,
    and returns a short count at frame boundaries (:470-574) — callers loop,
    or use pread_full;
  * read() is the sequential cursor shim (:826-835) — with the cursor update
    made atomic under the reader lock (the reference documents concurrency
    safety but updates `pos` unlocked; that wart is fixed, not replicated —
    SURVEY.md §5).

Reader-side concurrency: one RLock guards cache + cursor, mirroring the
reference's single rwlock (:38).  Frame decode happens outside the lock so
concurrent readers overlap device work (double-checked cache insert, like
the reference's rdlock->wrlock upgrade, :484-553).
"""

from __future__ import annotations

import struct
import threading

from libzseek_jax.errors import FormatError, ParameterError, ZseekError
from libzseek_jax.format.seek_table import SeekTable, parse_seek_table
from libzseek_jax.runtime import io as zio
from libzseek_jax.runtime.cache import FrameCache
from libzseek_jax.runtime.stats import ReaderStats

ZSTD_MAGIC = 0xFD2FB528
LZ4F_MAGIC = 0x184D2204
DEFAULT_CACHE_FRAMES = 8


class Reader:
    def __init__(self, source, *, cache_frames: int = DEFAULT_CACHE_FRAMES,
                 codec=None, level: int | None = None, readahead: int = 8,
                 verify_checksums: bool = False,
                 device_cache: bool = False):
        """device_cache=True keeps decompressed frames DEVICE-resident
        (device frame cache): cached entries are jax uint8 arrays and pread fetches
        only the requested span to the host.  cache_frames=0 (no cache)
        also decodes device-resident and fetches only the span, so host
        memory stays bounded by the request size — the parity analog of the
        reference's stream-and-discard no-cache path
        (/root/reference/src/decompress.c:377-468)."""
        if isinstance(source, (bytes, bytearray, memoryview)):
            source = zio.BytesIOSource(bytes(source))
        if not hasattr(source, "pread"):
            raise ParameterError("source must provide pread/fsize")
        self._src = source
        self._fsize = source.fsize()
        magic_bytes = source.pread(0, 4)
        if len(magic_bytes) < 4:
            raise FormatError("archive too small")
        magic = struct.unpack("<I", magic_bytes)[0]
        if codec is not None and hasattr(codec, "decompress_frames"):
            self._codec = codec
        elif magic == LZ4F_MAGIC:
            from libzseek_jax.runtime.codec import LZ4Codec
            self._codec = LZ4Codec()
        elif magic == ZSTD_MAGIC:
            from libzseek_jax.runtime.zstd_codec import ZstdCodec
            self._codec = ZstdCodec()
        else:
            raise FormatError(f"unknown archive magic 0x{magic:08X}")
        self._table: SeekTable = parse_seek_table(source.pread, self._fsize)
        self._cache = FrameCache(cache_frames) if cache_frames > 0 else None
        self._lock = threading.RLock()
        self._pos = 0
        self._closed = False
        # sequential-miss readahead: consecutive frame misses batch the
        # next `readahead` frames into one device decode (frames are rows
        # of one batched program; per-frame calls waste the batch axis)
        self._readahead = max(1, readahead)
        self._last_miss = -2
        # async sequential prefetch: while the consumer drains window k,
        # background threads decode windows k+1 and k+2 into the cache
        # (upload/device work of one window overlaps the device->host
        # fetch of the other on the duplex link)
        from collections import deque
        self._ahead = deque()   # (start, end, future)
        self._pf_pool = None
        # opt-in verification of per-frame seek-table checksums (low 32
        # bits of XXH64 of the decompressed frame) when the table has them
        self._verify = bool(verify_checksums) and \
            self._table.checksums is not None
        self._hints = self._load_hints() \
            if getattr(self._codec, "supports_hints", False) else None
        # device-resident frames: opt-in via device_cache, and the default
        # for the no-cache path (bounded host memory) when the codec can
        # decode to device arrays
        self._device_frames = (
            (bool(device_cache) or cache_frames <= 0)
            and getattr(self._codec, "supports_device_frames", False))

    # --- public API ---

    @property
    def seek_table(self) -> SeekTable:
        return self._table

    @property
    def decompressed_size(self) -> int:
        return self._table.decompressed_size

    def pread(self, size: int, offset: int) -> bytes:
        """Read up to `size` decompressed bytes at `offset`.  Like the
        reference, never crosses a frame boundary — returns a short count;
        b"" at or past EOF."""
        if self._closed:
            raise ZseekError("reader is closed")
        if size < 0 or offset < 0:
            raise ParameterError("negative size/offset")
        total = self._table.decompressed_size
        if offset >= total or size == 0:
            return b""
        idx = self._table.frame_for_offset(offset)
        in_off = offset - self._table.frame_d_offset(idx)
        if self._device_frames:
            return self._pread_span(idx, in_off, size)
        frame = self._get_frame(idx)
        return frame[in_off: in_off + size]

    def pread_full(self, size: int, offset: int) -> bytes:
        """Loop pread across frame boundaries (the caller-side loop of
        test/example.c:63-80, provided as a convenience)."""
        out = bytearray()
        while size > 0:
            chunk = self.pread(size, offset)
            if not chunk:
                break
            out += chunk
            size -= len(chunk)
            offset += len(chunk)
        return bytes(out)

    def read(self, size: int) -> bytes:
        """Sequential read at the internal cursor (zseek_read parity, with
        the cursor update done under the lock)."""
        with self._lock:
            data = self.pread(size, self._pos)
            self._pos += len(data)
            return data

    def seek(self, pos: int) -> None:
        with self._lock:
            self._pos = pos

    def prefetch(self, offsets: list[int]) -> None:
        """Batch-decode the frames covering `offsets` into the cache in one
        device call (no reference equivalent — the batched analog of issuing
        N preads)."""
        need = []
        seen = set()
        for off in offsets:
            if off >= self._table.decompressed_size:
                continue
            idx = self._table.frame_for_offset(off)
            if idx in seen:
                continue
            seen.add(idx)
            with self._lock:
                hit = self._cache is not None and self._cache.find(idx) is not None
            if not hit:
                need.append(idx)
        if not need:
            return
        datas = [self._read_frame_bytes(i) for i in need]
        d_sizes = [self._table.frame_d_size(i) for i in need]
        kw = {"to_device": True} if self._device_frames else {}
        if self._hints is not None:
            frames = self._codec.decompress_frames(
                datas, d_sizes, [self._frame_hints(i) for i in need], **kw)
        else:
            frames = self._codec.decompress_frames(datas, d_sizes, **kw)
        for i, fr in zip(need, frames):
            self._check_frame(i, fr)
        if self._cache is not None:
            with self._lock:
                for i, fr in zip(need, frames):
                    self._cache.insert(i, fr)

    def close(self) -> ReaderStats:
        self._closed = True
        return self.stats()

    def stats(self) -> ReaderStats:
        entry = 12 if self._table.checksums is not None else 8
        st = ReaderStats(
            seek_table_size=(8 + entry * self._table.num_frames + 9),
            seek_table_memory=self._table.memory_usage(),
            frames=self._table.num_frames,
            compressed_size=self._table.compressed_size,
            decompressed_size=self._table.decompressed_size,
        )
        if self._cache is not None:
            st.cache_memory = self._cache.memory_usage()
            st.cache_entries = self._cache.entries
            st.cache_hits = self._cache.hits
            st.cache_misses = self._cache.misses
        return st

    # --- internals ---

    def _load_hints(self):
        """Locate the decode-anchor sidecar (format/hints.py): a skippable
        frame immediately before the seek table, self-sized by its trailing
        u32.  Absent or foreign -> None (the decoder's generic paths)."""
        from libzseek_jax.format import hints as H
        entry = 12 if self._table.checksums is not None else 8
        table_bytes = 8 + entry * self._table.num_frames + 9
        end = self._fsize - table_bytes
        if end < 16:
            return None
        tail = self._src.pread(end - 4, 4)
        if len(tail) != 4:
            return None
        total = int.from_bytes(tail, "little")
        if total < 16 or total > end:
            return None
        blob = self._src.pread(end - total, total)
        parsed = H.parse(blob, 0)
        if parsed is None or len(parsed) != self._table.num_frames:
            return None
        return parsed

    def _frame_hints(self, idx: int):
        return self._hints[idx] if self._hints is not None else None

    def _check_frame(self, idx: int, frame) -> None:
        if not self._verify:
            return
        if not isinstance(frame, (bytes, bytearray, memoryview)):
            import numpy as np
            frame = np.asarray(frame).tobytes()
        from libzseek_jax.format.xxhash import xxh64
        want = int(self._table.checksums[idx])
        got = xxh64(frame) & 0xFFFFFFFF
        if got != want:
            raise FormatError(
                f"frame {idx} checksum mismatch: {got:#010x} != "
                f"{want:#010x}")

    def _decode_frame_device(self, idx: int):
        """Decode frame idx to a DEVICE uint8 array (never materialized on
        host in full, unless checksum verification demands it)."""
        data = self._read_frame_bytes(idx)
        d = self._table.frame_d_size(idx)
        if self._hints is not None:
            fr = self._codec.decompress_frames(
                [data], [d], [self._frame_hints(idx)], to_device=True)[0]
        else:
            fr = self._codec.decompress_frames([data], [d],
                                               to_device=True)[0]
        if self._verify:
            import numpy as np
            self._check_frame(idx, np.asarray(fr).tobytes())
        return fr

    def _pread_span(self, idx: int, in_off: int, size: int) -> bytes:
        """Device-resident pread: cache (if any) holds jax arrays; only the
        requested span crosses device->host."""
        import numpy as np
        fr = None
        if self._cache is not None:
            with self._lock:
                fr = self._cache.find(idx)
        if fr is None:
            fr = self._decode_frame_device(idx)
            if self._cache is not None:
                with self._lock:
                    if self._cache.find(idx) is None:
                        self._cache.insert(idx, fr)
        n = min(size, int(fr.shape[0]) - in_off)
        return np.asarray(fr[in_off: in_off + n]).tobytes()

    def _read_frame_bytes(self, idx: int) -> bytes:
        off = self._table.frame_c_offset(idx)
        size = self._table.frame_c_size(idx)
        data = self._src.pread(off, size)
        if len(data) != size:
            raise FormatError(f"short read of frame {idx}")
        return data

    def _window(self) -> int:
        """Sequential decode window: half the cache holds the window being
        consumed, the other half the one being prefetched."""
        return min(self._readahead, max(1, self._cache.capacity // 2))

    def _depth(self) -> int:
        """Prefetch windows in flight: 2 when the cache can hold the
        consuming window plus both (pipelines the duplex link), else 1."""
        return 2 if self._cache.capacity >= 3 * self._window() else 1

    def _schedule_ahead(self, start: int, count: int, depth: int = 2)\
            -> None:
        """Queue up to `depth` prefetch windows of `count` frames starting
        at `start` (skipping any already queued)."""
        if self._cache is None or count <= 0:
            return
        if self._ahead:
            start = max(start, self._ahead[-1][1])
        if self._pf_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pf_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="zseek-prefetch")

        while len(self._ahead) < depth and start < self._table.num_frames:
            end = min(start + count, self._table.num_frames)
            idxs = list(range(start, end))

            def work(idxs=idxs):
                datas = [self._read_frame_bytes(i) for i in idxs]
                d_sizes = [self._table.frame_d_size(i) for i in idxs]
                if self._hints is not None:
                    frames = self._codec.decompress_frames(
                        datas, d_sizes,
                        [self._frame_hints(i) for i in idxs])
                else:
                    frames = self._codec.decompress_frames(datas, d_sizes)
                for i, fr in zip(idxs, frames):
                    self._check_frame(i, fr)
                with self._lock:
                    for i, fr in zip(idxs, frames):
                        if self._cache.find(i) is None:
                            self._cache.insert(i, fr)

            self._ahead.append((start, end, self._pf_pool.submit(work)))
            start = end

    def _get_frame(self, idx: int) -> bytes:
        if self._cache is not None:
            with self._lock:
                hit = self._cache.find(idx)
            if hit is not None:
                return hit
        while self._ahead and self._ahead[0][1] <= idx:
            self._ahead.popleft()   # stale window (seek jumped past it)
        if self._ahead and self._ahead[0][0] <= idx < self._ahead[0][1]:
            # the prefetched window covers this frame: wait for it and
            # immediately pipeline the next window(s)
            s, e, fut = self._ahead.popleft()
            fut.result()
            self._last_miss = e - 1
            self._schedule_ahead(e, self._window(), self._depth())
            with self._lock:
                hit = self._cache.find(idx)
            if hit is not None:
                return hit
        # batch ahead on a sequential miss streak
        streak = idx == self._last_miss + 1
        self._last_miss = idx
        count = 1
        if streak and self._cache is not None:
            count = min(self._window(), self._table.num_frames - idx)
        idxs = [idx]
        for j in range(idx + 1, idx + count):
            with self._lock:
                if self._cache is not None and \
                        self._cache.find(j) is not None:
                    break
            idxs.append(j)
        datas = [self._read_frame_bytes(i) for i in idxs]
        d_sizes = [self._table.frame_d_size(i) for i in idxs]
        if self._hints is not None:
            frames = self._codec.decompress_frames(
                datas, d_sizes, [self._frame_hints(i) for i in idxs])
        else:
            frames = self._codec.decompress_frames(datas, d_sizes)
        for i, fr in zip(idxs, frames):
            self._check_frame(i, fr)
        if self._cache is not None:
            with self._lock:
                # double-checked: a concurrent reader may have inserted it
                for i, fr in zip(idxs, frames):
                    if self._cache.find(i) is None:
                        self._cache.insert(i, fr)
        # the streak continues at the window's end, and the next window
        # decodes in the background while this one is consumed
        self._last_miss = idxs[-1]
        if len(idxs) > 1 and not self._ahead:
            self._schedule_ahead(idxs[-1] + 1, self._window(),
                                 self._depth())
        return frames[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
