"""LZ4 block encoder as a batched device program.

Emits raw LZ4 block format (token / literal-run / offset / match-run
sequences) for a batch of independent blocks at once.  The reference gets
this from liblz4's scalar LZ4F_compressFrame (/root/reference/src/compress.c:
737-786); here the whole emission is vector code:

  match pipeline (ops.match) -> per-sequence geometry -> closed-form encoded
  sizes -> prefix-sum output offsets -> region fills + batched scatters.

End-of-block rules enforced: the last 5 bytes are literals, no match starts
within the last 12 bytes, and the block always ends with a literals-only
sequence (LZ4 block format spec).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from libzseek_jax.ops import common as C
from libzseek_jax.ops import match as M


def lz4_compress_bound(n: int) -> int:
    """Worst-case encoded size of one block (mirrors LZ4_compressBound)."""
    return n + n // 255 + 16


def _ext_count(v: jnp.ndarray) -> jnp.ndarray:
    """Number of extension bytes for a length nibble value v (v = litlen or
    matchlen-4): 0 if v < 15 else 1 + (v-15)//255."""
    return jnp.where(v < 15, 0, 1 + (v - 15) // 255)


@partial(jax.jit, static_argnames=("seg_size", "max_len", "max_back",
                                   "dual", "ctx_len"))
def lz4_encode_blocks(x: jnp.ndarray, lengths: jnp.ndarray, *,
                      seg_size: int = 4, max_len: int = 48, max_back: int = 4,
                      dual: bool = True, ctx_len: int = 0,
                      min_ref: jnp.ndarray | None = None):
    """Encode a batch of LZ4 blocks.

    x: (B, N) uint8 zero-padded input rows; lengths: (B,) int32 valid bytes.
    Returns (out, out_lens): out (B, M) uint8, out_lens (B,) int32.  Rows
    whose encoded size >= their input length should be stored uncompressed by
    the frame layer (LZ4F uncompressed-block flag), like stock lz4.

    Linked-block mode (stock LZ4F default, which the reference inherits via
    LZ4F_compressFrame defaults): pass the previous block's window as a
    ctx_len-byte prefix of each row — the block's bytes start at ctx_len,
    matches may reference back into the prefix (but not below min_ref (B,),
    the first real history byte).  All emitted geometry is relative, so the
    packing below is position-base agnostic.
    """
    B, N = x.shape
    nseg = N // seg_size
    nseq = (N - ctx_len) // seg_size + 1
    Mcap = lz4_compress_bound(N - ctx_len)
    Mcap += (-Mcap) % 128

    p, off, e, has = M.find_segment_matches(
        x, lengths, seg_size=seg_size, max_len=max_len, min_tail=12,
        max_back=max_back, dual=dual, ctx_len=ctx_len, min_ref=min_ref)
    sel, start, end, off, lit_from, c_final = M.greedy_select(
        p, off, e, has, lengths, min_tail=12, c0=ctx_len)
    is_head, merged_end = M.merge_runs(sel, start, end, off, lit_from)

    # --- compact heads into per-sequence arrays (B, nseq) ---
    rank = jnp.cumsum(is_head.astype(jnp.int32), axis=1) - 1
    n_heads = jnp.sum(is_head.astype(jnp.int32), axis=1)

    def compact(vals, fill=0):
        dst = jnp.full((B, nseq), fill, dtype=jnp.int32)
        return C.scatter1_set(dst, rank, vals.astype(jnp.int32), is_head)

    seq_lit_from = compact(lit_from)
    seq_start = compact(start)
    seq_end = compact(merged_end)
    seq_off = compact(off)
    return _pack_lz4(x, lengths, seq_lit_from, seq_start, seq_end, seq_off,
                     n_heads, c_final, Mcap)


def _pack_lz4(x, lengths, seq_lit_from, seq_start, seq_end, seq_off,
              n_heads, c_final, Mcap: int):
    """Token/literal/offset emission from per-sequence geometry.  All
    positions may carry a context-prefix base; only differences reach the
    output."""
    B, N = x.shape
    nseq = seq_start.shape[1]
    # final literals-only sequence at index n_heads
    idxs = jnp.broadcast_to(jnp.arange(nseq, dtype=jnp.int32)[None, :], (B, nseq))
    final = idxs == n_heads[:, None]
    seq_lit_from = jnp.where(final, c_final[:, None], seq_lit_from)
    seq_start = jnp.where(final, lengths[:, None], seq_start)
    seq_end = jnp.where(final, lengths[:, None], seq_end)
    valid = idxs <= n_heads[:, None]
    has_match = valid & ~final

    ll = jnp.where(valid, seq_start - seq_lit_from, 0)
    ml = jnp.where(has_match, seq_end - seq_start, 0)
    mlx = jnp.maximum(ml - 4, 0)  # matchlen nibble value
    ext_ll = jnp.where(valid, _ext_count(ll), 0)
    ext_ml = jnp.where(has_match, _ext_count(mlx), 0)

    seq_size = jnp.where(
        valid,
        1 + ext_ll + ll + jnp.where(has_match, 2 + ext_ml, 0),
        0)
    tp = C.exclusive_cumsum(seq_size, axis=1)  # token position per sequence
    out_lens = jnp.sum(seq_size, axis=1)

    lit_out = tp + 1 + ext_ll
    mo = lit_out + ll  # offset field position

    # --- emit ---
    # 1) 0xFF extension runs (disjoint regions across all sequences)
    ff_starts = jnp.concatenate([tp + 1, mo + 2], axis=1)
    ff_ends = jnp.concatenate([tp + ext_ll, mo + 1 + ext_ml], axis=1)
    ff_mask_valid = jnp.concatenate(
        [valid & (ext_ll > 0), has_match & (ext_ml > 0)], axis=1)
    ff = C.fill_regions(Mcap, ff_starts, ff_ends, ff_mask_valid)
    out = jnp.where(ff, jnp.int32(0xFF), jnp.int32(0))

    # 2) token bytes
    token = (jnp.minimum(ll, 15) << 4) | jnp.where(has_match, jnp.minimum(mlx, 15), 0)
    out = C.scatter1_set(out, tp, token, valid)
    # 3) extension terminator bytes
    out = C.scatter1_set(out, tp + ext_ll, (ll - 15) % 255, valid & (ext_ll > 0))
    out = C.scatter1_set(out, mo + 1 + ext_ml, (mlx - 15) % 255,
                         has_match & (ext_ml > 0))
    # 4) offset bytes (little-endian u16)
    out = C.scatter1_set(out, mo, seq_off & 0xFF, has_match)
    out = C.scatter1_set(out, mo + 1, seq_off >> 8, has_match)

    # 5) literal bytes: input-centric scatter.  Each literal input byte finds
    # its sequence via start markers, then lands at lit_out + rank-in-run.
    has_lits = valid & (ll > 0)
    is_lit = C.fill_regions(N, seq_lit_from, seq_start, has_lits)
    # tables indexed by literal-run rank
    lr_rank = jnp.cumsum(has_lits.astype(jnp.int32), axis=1) - 1
    lit_from_tab = jnp.zeros((B, nseq), dtype=jnp.int32)
    lit_from_tab = C.scatter1_set(lit_from_tab, lr_rank, seq_lit_from, has_lits)
    lit_out_tab = jnp.zeros((B, nseq), dtype=jnp.int32)
    lit_out_tab = C.scatter1_set(lit_out_tab, lr_rank, lit_out, has_lits)
    byte_region = C.region_index(N, seq_lit_from, has_lits)
    dst = C.take1(lit_out_tab, byte_region) + \
        (jnp.arange(N, dtype=jnp.int32)[None, :] - C.take1(lit_from_tab, byte_region))
    out = C.scatter1_set(out, dst, x.astype(jnp.int32), is_lit)

    return out.astype(jnp.uint8), out_lens
