"""Shared vectorized building blocks for the device codec pipelines.

Everything here operates on batched byte arrays ``(B, N) uint8`` (rows =
independent compression blocks/frames, the unit of data parallelism) and is
pure jax.numpy/lax — no data-dependent Python control flow, static shapes —
so a single compiled program serves every frame in a batch and shards over a
device mesh.  These replace the scalar C hot loops of the reference
(/root/reference/src/compress.c, src/decompress.c) with vector programs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Plain numpy constant: a module-level jnp scalar would be created eagerly on
# the default accelerator at import time.
INVALID = np.int32(-1)


def u32_window(x: jnp.ndarray) -> jnp.ndarray:
    """Little-endian 4-byte value starting at every position.

    x: (B, N) uint8 -> (B, N) int32 where out[:, i] = LE32(x[:, i:i+4])
    (positions N-3.. read zero padding; callers mask by valid length).
    """
    xi = x.astype(jnp.int32)

    def sh(k):
        return jnp.pad(xi[:, k:], ((0, 0), (0, k)))

    return sh(0) | (sh(1) << 8) | (sh(2) << 16) | (sh(3) << 24)


def exclusive_cumsum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    inc = jnp.cumsum(x, axis=axis)
    return inc - x


def take1(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Batched gather along axis 1 with clamped indices.

    table: (B, T), idx: (B, ...) int32 -> (B, ...) values.
    """
    T = table.shape[1]
    safe = jnp.clip(idx, 0, T - 1)
    flat = safe.reshape(safe.shape[0], -1)
    out = jnp.take_along_axis(table, flat, axis=1)
    return out.reshape(idx.shape)


def scatter1_set(dst: jnp.ndarray, idx: jnp.ndarray, vals: jnp.ndarray,
                 mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Batched scatter-set along axis 1; masked-out entries are dropped."""
    B = dst.shape[0]
    if mask is not None:
        idx = jnp.where(mask, idx, dst.shape[1])  # out of range -> dropped
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], idx.shape)
    return dst.at[rows, idx].set(vals, mode="drop")


def scatter1_add(dst: jnp.ndarray, idx: jnp.ndarray, vals: jnp.ndarray,
                 mask: jnp.ndarray | None = None) -> jnp.ndarray:
    B = dst.shape[0]
    if mask is not None:
        idx = jnp.where(mask, idx, dst.shape[1])
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], idx.shape)
    return dst.at[rows, idx].add(vals, mode="drop")


def fill_regions(length: int, starts: jnp.ndarray, ends: jnp.ndarray,
                 mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Boolean (B, length) mask that is True inside each [start, end) region.

    Regions must be disjoint per row.  Implemented as +1/-1 boundary markers
    plus a cumulative sum — the vector replacement for per-region byte loops.
    """
    B = starts.shape[0]
    markers = jnp.zeros((B, length + 1), dtype=jnp.int32)
    valid = (ends > starts)
    if mask is not None:
        valid = valid & mask
    markers = scatter1_add(markers, starts, jnp.ones_like(starts), valid)
    markers = scatter1_add(markers, ends, -jnp.ones_like(ends), valid)
    return jnp.cumsum(markers[:, :length], axis=1) > 0


def region_index(length: int, starts: jnp.ndarray,
                 mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """(B, length) int32: for each position, the number of region-starts at or
    before it, minus one — i.e. the index of the region this position belongs
    to when regions are ordered by start.  Pair with fill_regions to identify
    membership."""
    B = starts.shape[0]
    markers = jnp.zeros((B, length + 1), dtype=jnp.int32)
    ok = mask if mask is not None else jnp.ones(starts.shape, dtype=bool)
    markers = scatter1_add(markers, starts, jnp.ones_like(starts), ok)
    return jnp.cumsum(markers[:, :length], axis=1) - 1


def ff_run_length(x: jnp.ndarray, value: int = 0xFF) -> jnp.ndarray:
    """(B, N) uint8 -> (B, N) int32: number of consecutive bytes equal to
    ``value`` starting at each position (0 if x[i] != value).

    Used by the LZ4 decoder to take extension-byte runs in O(1) per sequence.
    Computed via a reverse cumulative-min of next-non-value positions.
    """
    B, N = x.shape
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    non = jnp.where(x != jnp.uint8(value), pos, jnp.int32(N))
    # next non-value position at or after i: reverse cummin
    nxt = jax.lax.cummin(non, axis=1, reverse=True)
    return nxt - pos


def hist256(x: jnp.ndarray, mask: jnp.ndarray, chunk: int = 16384) -> jnp.ndarray:
    """Masked per-row byte histogram: (B, N) uint8 + (B, N) bool -> (B, 256)
    int32.  Nibble decomposition onto a matrix product: hist[hi*16+lo] =
    sum_i [hi_i==hi]*m_i * [lo_i==lo] is a batched (16, N) x (N, 16)
    matmul with one-hot nibble planes as inputs — 0/1 values are exact in
    bf16 and row sums stay far below 2^24, so f32 accumulation is exact
    (no TF32 rounding: the operands are bf16).  Avoids both a
    scatter-add and a 256-value compare-plane reduce."""
    B, N = x.shape
    xi = x.astype(jnp.int32)
    m = mask
    hi_vals = jnp.arange(16, dtype=jnp.int32)
    parts = []
    for s in range(0, N, chunk):
        xc = xi[:, s: s + chunk]
        mc = m[:, s: s + chunk]
        a = ((xc[:, :, None] >> 4) == hi_vals[None, None, :]) & \
            mc[:, :, None]
        b = (xc[:, :, None] & 15) == hi_vals[None, None, :]
        h = jax.lax.dot_general(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
            (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        parts.append(h)
    return sum(parts).reshape(B, 256).astype(jnp.int32)


def resolve_copy_chains(src: jnp.ndarray, rounds: int) -> jnp.ndarray:
    """Pointer-double src indices until fixpoint: src[i] <- src[src[i]].

    For LZ back-reference execution: positions whose value is defined by an
    earlier position (matches) point backward; literals point to themselves.
    After ceil(log2(N)) rounds every index lands on a literal.  This is the
    parallel substitute for the reference's inherently-serial match copy
    (src/decompress.c match execution inside libzstd/liblz4).

    Exits as soon as a round changes nothing — real chains are shallow
    (matches rarely stack more than a handful deep), so typical depth is
    3-6 rounds, not log2(N).
    """
    def cond(state):
        i, s, done = state
        return (i < rounds) & ~done

    def body(state):
        i, s, _ = state
        ns = take1(s, s)
        return i + 1, ns, jnp.all(ns == s)

    _, out, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), src, jnp.bool_(False)))
    return out


def pack_u8(x_i32: jnp.ndarray) -> jnp.ndarray:
    """Clamp-free cast of per-byte int32 planes to uint8."""
    return x_i32.astype(jnp.uint8)
