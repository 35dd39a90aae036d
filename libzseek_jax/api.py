"""Public API.

Pythonic surface (Writer/Reader/open_writer/open_reader) plus a
C-API-shaped compatibility layer mirroring the reference's exported symbols
(/root/reference/src/zseek.h:225-443) so users porting from libzseek find
one-to-one equivalents:

    zseek_writer_open(file, ...)   -> Writer
    zseek_write(writer, buf)
    zseek_writer_close(writer)     -> WriterStats
    zseek_writer_stats(writer)
    zseek_reader_open(file, ...)   -> Reader
    zseek_pread(reader, size, offset)
    zseek_read(reader, size)
    zseek_reader_close(reader)
    zseek_reader_stats(reader)

Errors raise ZseekError subclasses (the errbuf convention's typed analog).
"""

from __future__ import annotations

import io
from pathlib import Path

from libzseek_jax.runtime.io import FileIO
from libzseek_jax.runtime.reader import Reader
from libzseek_jax.runtime.stats import ReaderStats, WriterStats
from libzseek_jax.runtime.writer import DEFAULT_MIN_FRAME_SIZE, Writer

__all__ = [
    "Writer", "Reader", "open_writer", "open_reader",
    "ZstdParams", "LZ4Params", "CompressionParams",
    "zseek_writer_open", "zseek_writer_open_full", "zseek_write",
    "zseek_writer_close", "zseek_writer_stats", "zseek_reader_open",
    "zseek_reader_open_full", "zseek_pread", "zseek_read",
    "zseek_reader_close", "zseek_reader_stats",
]


# --- per-algorithm parameter structs (zseek.h:121-159 analogs) ---

import dataclasses


@dataclasses.dataclass
class ZstdParams:
    """zseek_zstd_param_t analog (/root/reference/src/zseek.h:129-140).
    nb_workers maps to devices (SURVEY.md §2); cpuset has no accelerator
    meaning (device selection replaces affinity) and is accepted but
    ignored; strategy folds into `level` (our level knob selects parse
    effort the way zstd's level indexes cParams)."""
    compression_level: int = 3
    nb_workers: int = 1
    strategy: int | None = None
    cpuset: object | None = None


@dataclasses.dataclass
class LZ4Params:
    """zseek_lz4_param_t analog (/root/reference/src/zseek.h:145-148)."""
    compression_level: int = 0
    nb_workers: int = 1


@dataclasses.dataclass
class CompressionParams:
    """zseek_compression_param_t analog (/root/reference/src/zseek.h:
    153-159): tagged union of the per-algorithm structs."""
    type: str = "zstd"            # "zstd" | "lz4"
    zstd: ZstdParams | None = None
    lz4: LZ4Params | None = None


def open_writer(path_or_file, codec: str = "zstd", *, level: int | None = None,
                min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
                batch_frames: int = 8, workers: int = 1,
                checksums: bool = False) -> Writer:
    if isinstance(path_or_file, (str, Path)):
        f = open(path_or_file, "wb")
        return Writer(FileIO(f), codec, level=level,
                      min_frame_size=min_frame_size,
                      batch_frames=batch_frames, workers=workers,
                      checksums=checksums, owned_file=f)
    sink = path_or_file if hasattr(path_or_file, "pread") or hasattr(path_or_file, "write") else FileIO(path_or_file)
    if isinstance(path_or_file, io.IOBase):
        sink = FileIO(path_or_file)
    return Writer(sink, codec, level=level, min_frame_size=min_frame_size,
                  batch_frames=batch_frames, workers=workers,
                  checksums=checksums)


def open_reader(path_or_file, *, cache_frames: int = 8,
                verify_checksums: bool = False,
                device_cache: bool = False) -> Reader:
    if isinstance(path_or_file, (str, Path)):
        f = open(path_or_file, "rb")
        return Reader(FileIO(f), cache_frames=cache_frames,
                      verify_checksums=verify_checksums,
                      device_cache=device_cache)
    if isinstance(path_or_file, io.IOBase):
        return Reader(FileIO(path_or_file), cache_frames=cache_frames,
                      verify_checksums=verify_checksums,
                      device_cache=device_cache)
    return Reader(path_or_file, cache_frames=cache_frames,
                  verify_checksums=verify_checksums,
                  device_cache=device_cache)


# --- C-API-shaped compatibility layer ---

def zseek_writer_open(file, codec: str = "zstd", level: int | None = None,
                      min_frame_size: int = DEFAULT_MIN_FRAME_SIZE) -> Writer:
    return open_writer(file, codec, level=level, min_frame_size=min_frame_size)


def zseek_writer_open_full(file, params: CompressionParams | None = None,
                           min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
                           checksums: bool = False) -> Writer:
    """zseek_writer_open_full analog (/root/reference/src/zseek.h:225):
    NULL params -> zstd defaults (level 3), like src/compress.c:251-255.
    `checksums` turns on per-frame seek-table checksums (zstd seekable
    format checksumFlag; the reference leaves it 0, src/compress.c:152)."""
    if params is None:
        return open_writer(file, "zstd", min_frame_size=min_frame_size,
                           checksums=checksums)
    if params.type == "zstd":
        p = params.zstd or ZstdParams()
        return open_writer(file, "zstd", level=p.compression_level,
                           min_frame_size=min_frame_size,
                           workers=p.nb_workers, checksums=checksums)
    if params.type == "lz4":
        p4 = params.lz4 or LZ4Params()
        return open_writer(file, "lz4", level=p4.compression_level,
                           min_frame_size=min_frame_size,
                           workers=p4.nb_workers, checksums=checksums)
    from libzseek_jax.errors import ParameterError
    raise ParameterError(f"unknown compression type {params.type!r}")


def zseek_reader_open_full(file, cache_size: int = 8) -> Reader:
    """zseek_reader_open_full analog (/root/reference/src/zseek.h:335):
    cache_size counts frames; 0 disables the cache (streaming pread)."""
    return open_reader(file, cache_frames=cache_size)


def zseek_write(writer: Writer, buf) -> bool:
    writer.write(buf)
    return True


def zseek_writer_close(writer: Writer) -> WriterStats:
    return writer.close()


def zseek_writer_stats(writer: Writer) -> WriterStats:
    return writer.stats()


def zseek_reader_open(file, cache_size: int = 8) -> Reader:
    return open_reader(file, cache_frames=cache_size)


def zseek_pread(reader: Reader, size: int, offset: int) -> bytes:
    return reader.pread(size, offset)


def zseek_read(reader: Reader, size: int) -> bytes:
    return reader.read(size)


def zseek_reader_close(reader: Reader) -> ReaderStats:
    return reader.close()


def zseek_reader_stats(reader: Reader) -> ReaderStats:
    return reader.stats()
