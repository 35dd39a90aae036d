"""XXH32 — needed by the LZ4 frame format (header checksum byte, optional
content/block checksums) and by zstd's optional XXH64 content checksum.

Host-side implementation: checksums guard container metadata (cold path);
frame payload checksumming is optional in both formats and off by default in
the reference writer (LZ4F_preferences_t zeroed except autoFlush/blockSizeID,
/root/reference/src/compress.c:203-207; zstd checksumFlag unset).
"""

from __future__ import annotations

import numpy as np

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """Reference-exact XXH32 (validated against stock lz4 frame headers)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P1) & _M32
        limit = n - 16
        while i <= limit:
            for k, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 4 * k: i + 4 * k + 4], "little")
                v = (v + lane * _P2) & _M32
                v = _rotl(v, 13)
                v = (v * _P1) & _M32
                if k == 0: v1 = v
                elif k == 1: v2 = v
                elif k == 2: v3 = v
                else: v4 = v
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        lane = int.from_bytes(data[i: i + 4], "little")
        h = (h + lane * _P3) & _M32
        h = (_rotl(h, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M32
        h = (_rotl(h, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# --- XXH64 (zstd seekable per-frame checksum = low 32 bits of XXH64 of the
# uncompressed frame, per the zstd contrib spec; the reference never emits
# them — checksumFlag is always 0, /root/reference/src/compress.c:152) ---

_Q1 = 0x9E3779B185EBCA87
_Q2 = 0xC2B2AE3D27D4EB4F
_Q3 = 0x165667B19E3779F9
_Q4 = 0x85EBCA77C2B2AE63
_Q5 = 0x27D4EB2F165667C5
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round64(acc: int, lane: int) -> int:
    acc = (acc + lane * _Q2) & _M64
    return (_rotl64(acc, 31) * _Q1) & _M64


def _merge64(h: int, acc: int) -> int:
    h ^= _round64(0, acc)
    return ((h * _Q1) + _Q4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """Reference-exact XXH64.  Uses the native module when available (the
    pure-Python stripe loop is the fallback, fine for tests/cold paths)."""
    from libzseek_jax import native
    if native.have_native():
        h = native.xxh64(data, seed)
        if h is not None:
            return h
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _Q1 + _Q2) & _M64
        v2 = (seed + _Q2) & _M64
        v3 = seed & _M64
        v4 = (seed - _Q1) & _M64
        u = np.frombuffer(data[: n & ~31], "<u8")
        for k in range(0, len(u), 4):
            v1 = _round64(v1, int(u[k]))
            v2 = _round64(v2, int(u[k + 1]))
            v3 = _round64(v3, int(u[k + 2]))
            v4 = _round64(v4, int(u[k + 3]))
        i = n & ~31
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
             + _rotl64(v4, 18)) & _M64
        h = _merge64(h, v1)
        h = _merge64(h, v2)
        h = _merge64(h, v3)
        h = _merge64(h, v4)
    else:
        h = (seed + _Q5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round64(0, int.from_bytes(data[i: i + 8], "little"))
        h = (_rotl64(h, 27) * _Q1 + _Q4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i: i + 4], "little") * _Q1) & _M64
        h = (_rotl64(h, 23) * _Q2 + _Q3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _Q5) & _M64
        h = (_rotl64(h, 11) * _Q1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _Q2) & _M64
    h ^= h >> 29
    h = (h * _Q3) & _M64
    h ^= h >> 32
    return h
