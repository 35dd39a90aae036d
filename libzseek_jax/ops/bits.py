"""Parallel bitstream packing.

zstd's FSE/Huffman streams are sequences of (value, nbits) emissions packed
LSB-first.  The reference packs them serially byte-by-byte inside libzstd;
here every emission knows its absolute bit offset (a prefix sum over nbits),
so packing is one scatter-add of word contributions — bit-disjoint, so
add == or.  Runs batched over rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from libzseek_jax.ops import common as C


def pack_bits_at(values: jnp.ndarray, nbits: jnp.ndarray, bitpos: jnp.ndarray,
                 out_words: int) -> jnp.ndarray:
    """Scatter (value, nbits) emissions at absolute bit offsets into a
    (B, out_words) uint32 buffer.  Emissions must be bit-disjoint.  Each may
    span two 32-bit words."""
    values = values.astype(jnp.uint32)
    nbits = nbits.astype(jnp.int32)
    mask = (jnp.uint32(1) << nbits.astype(jnp.uint32)) - jnp.uint32(1)
    mask = jnp.where(nbits >= 32, jnp.uint32(0xFFFFFFFF), mask)
    values = values & mask
    word = bitpos >> 5
    sh = (bitpos & 31).astype(jnp.uint32)
    lo = values << sh
    # high part: value >> (32 - sh); sh == 0 -> no high part
    hi = jnp.where(sh > 0, values >> (jnp.uint32(32) - sh), jnp.uint32(0))
    out = jnp.zeros((values.shape[0], out_words), jnp.uint32)
    valid = nbits > 0
    out = C.scatter1_add(out, word, lo, valid)
    out = C.scatter1_add(out, word + 1, hi, valid & (hi != 0))
    return out


def pack_bits(values: jnp.ndarray, nbits: jnp.ndarray, out_words: int):
    """In-order emission packing: bit offsets are the running sum of nbits.
    Returns (words (B, out_words) uint32, total_bits (B,) int32)."""
    nbits = nbits.astype(jnp.int32)
    end = jnp.cumsum(nbits, axis=1)
    start = end - nbits
    total_bits = end[:, -1]
    return pack_bits_at(values, nbits, start, out_words), total_bits


def close_stream_bits(total_bits: jnp.ndarray):
    """The (value, nbits) emission that closes a zstd bitstream: a single 1
    sentinel bit (BIT_closeCStream); byte padding is implicit in the byte
    count.  Returns the byte length of the closed stream."""
    return (total_bits + 1 + 7) >> 3


def words_to_bytes(words: jnp.ndarray, n_bytes: int) -> jnp.ndarray:
    """(B, W) uint32 -> (B, n_bytes) uint8 little-endian."""
    B, W = words.shape
    b0 = (words & 0xFF).astype(jnp.uint8)
    b1 = ((words >> 8) & 0xFF).astype(jnp.uint8)
    b2 = ((words >> 16) & 0xFF).astype(jnp.uint8)
    b3 = ((words >> 24) & 0xFF).astype(jnp.uint8)
    out = jnp.stack([b0, b1, b2, b3], axis=2).reshape(B, W * 4)
    return out[:, :n_bytes]
