"""ctypes bindings for the native host runtime (zn.cc).

Loads libzseek_native.so if present (build: ``make -C libzseek_jax/native``);
callers check ``have_native()`` and fall back to the pure-Python
implementations otherwise.  ctypes argtypes are always declared — a missing
signature truncates 64-bit pointers and segfaults (verify-skill gotcha).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_SO = os.path.join(os.path.dirname(__file__), "libzseek_native.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        return None
    lib = ctypes.CDLL(_SO)
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.zn_huf_build.argtypes = [u32p, i32p, i32p, u8p,
                                 ctypes.POINTER(ctypes.c_int32)]
    lib.zn_huf_build.restype = ctypes.c_int
    lib.zn_huf_build_batch.argtypes = [u32p, ctypes.c_int, i32p, i32p, u8p,
                                       i32p, i32p]
    lib.zn_huf_build_batch.restype = None
    lib.zn_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_uint64]
    lib.zn_xxh64.restype = ctypes.c_uint64
    lib.zn_seektable_serialize.argtypes = [u32p, ctypes.c_int64, u8p]
    lib.zn_seektable_serialize.restype = ctypes.c_int64
    lib.zn_seektable_parse.argtypes = [u8p, ctypes.c_int64, i64p]
    lib.zn_seektable_parse.restype = ctypes.c_int64
    if hasattr(lib, "zn_lz4_decode"):
        lib.zn_lz4_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64]
        lib.zn_lz4_decode.restype = ctypes.c_int64
    if hasattr(lib, "zn_ldm_scan"):
        lib.zn_ldm_scan.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                    i64p, i32p, ctypes.c_int64, i64p]
        lib.zn_ldm_scan.restype = ctypes.c_int64
    _lib = lib
    return lib


def have_native() -> bool:
    return _load() is not None


def huf_build_batch(hists: np.ndarray):
    """hists: (nh, 256) uint32 -> (lengths (nh,256) i32, codes (nh,256) i32,
    trees list[bytes|None], max_bits (nh,) i32).  max_bits 0 = degenerate
    (<2 symbols), -1 = unserializable tree."""
    lib = _load()
    nh = hists.shape[0]
    hists = np.ascontiguousarray(hists, np.uint32)
    lengths = np.zeros((nh, 256), np.int32)
    codes = np.zeros((nh, 256), np.int32)
    trees = np.zeros((nh, 200), np.uint8)
    tree_lens = np.zeros(nh, np.int32)
    max_bits = np.zeros(nh, np.int32)
    lib.zn_huf_build_batch(hists, nh, lengths.reshape(-1), codes.reshape(-1),
                           trees.reshape(-1), tree_lens, max_bits)
    tree_list = [trees[i, : tree_lens[i]].tobytes() if max_bits[i] > 0 else None
                 for i in range(nh)]
    return lengths, codes, tree_list, max_bits


def xxh64(data: bytes, seed: int = 0) -> int | None:
    lib = _load()
    if lib is None:
        return None
    return int(lib.zn_xxh64(bytes(data), len(data), seed))


def seektable_serialize(entries: np.ndarray) -> bytes:
    """entries: (n, 2) uint32 (c_size, d_size) -> serialized skippable frame."""
    lib = _load()
    n = entries.shape[0]
    entries = np.ascontiguousarray(entries, np.uint32)
    out = np.zeros(8 + 8 * n + 9, np.uint8)
    wrote = lib.zn_seektable_serialize(entries.reshape(-1), n, out)
    return out[:wrote].tobytes()


def seektable_parse(table_frame: bytes):
    """Skippable-frame bytes (from magic through footer) -> (n, cumulative
    (n+1, 2) int64 (c_off, d_off)) or None on malformed input."""
    lib = _load()
    buf = np.frombuffer(table_frame, np.uint8)
    max_n = max(1, (len(table_frame) - 17) // 8 + 1)
    cum = np.zeros((max_n + 1, 2), np.int64)
    n = lib.zn_seektable_parse(np.ascontiguousarray(buf), len(buf),
                               cum.reshape(-1))
    if n < 0:
        return None
    return int(n), cum[: n + 1]


def ldm_scan(x: np.ndarray, nblocks: int, bsize: int,
             frame_base: np.ndarray, lens: np.ndarray,
             min_dist: int) -> np.ndarray | None:
    """Long-distance match scan over a batch (see zn.cc zn_ldm_scan).
    x: concatenated block bytes (nblocks*bsize,); frame_base (nblocks,)
    int64 frame-start byte offsets (-1 = exclude); lens (nblocks,)
    int32.  Returns (nblocks, 3) int64 rows [dist, span_start,
    span_end) — dist 0 = no hit, [0, bsize) = whole-block match —
    or None without the native library."""
    lib = _load()
    if lib is None or not hasattr(lib, "zn_ldm_scan"):
        return None
    x = np.ascontiguousarray(x, np.uint8)
    out = np.zeros((nblocks, 3), np.int64)
    lib.zn_ldm_scan(x, nblocks, bsize,
                    np.ascontiguousarray(frame_base, np.int64),
                    np.ascontiguousarray(lens, np.int32),
                    min_dist, out.reshape(-1))
    return out


def lz4_block_decode(src: np.ndarray, out: np.ndarray, base: int,
                     lo: int = 0) -> int:
    """Decode one LZ4 block into the frame buffer `out` at `base`; matches
    may reach back to byte `lo` (frame start for linked blocks).  Returns
    the decompressed size, -1 on corrupt input, -2 without the native
    library."""
    lib = _load()
    if lib is None or not hasattr(lib, "zn_lz4_decode"):
        return -2
    src = np.ascontiguousarray(src, np.uint8)
    return int(lib.zn_lz4_decode(src.ctypes.data, src.shape[0],
                                 out.ctypes.data, out.shape[0], base, lo))
