"""LZ4 decoder as a batched device program.

Two phases, mirroring how a decoder must treat the format's two kinds of
state (reference scalar equivalent: liblz4 inside zseek_pread_lz4,
/root/reference/src/decompress.c:576-683):

  A. **Sequence parse** — the token stream is inherently sequential *per
     block*, so we run one jax.lax.while_loop whose state is vectorized over
     all blocks of all frames in the batch (lanes).  Extension-byte runs
     (0xFF chains) are pre-computed for the whole buffer in parallel, so each
     step consumes an entire sequence header in O(1) gathers.

  B. **Sequence execution** — per-frame: block outputs are concatenated
     (exclusive scan of parsed block sizes), literals land via one batched
     scatter, and match back-references form copy chains (offset < length
     allowed) resolved with log2(F) pointer-doubling rounds instead of a
     serial byte copy.  Because execution is frame-wide, *linked* LZ4F frames
     (the stock/reference default, where matches reach into previous blocks)
     decode with the same code path as independent ones.

Malformed input yields ok=False per frame rather than undefined behavior.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from libzseek_jax.ops import common as C


def _parse_blocks(comp: jnp.ndarray, comp_lens: jnp.ndarray, max_seqs: int,
                  linked: bool):
    """Phase A over a flat batch of blocks: comp (L, M), comp_lens (L,).

    Returns per-sequence arrays (L, max_seqs): lit_src, lit_len, lit_dst
    (block-local), m_off, m_len, m_dst (block-local), plus out_lens (L,) and
    bad (L,)."""
    L, Mcap = comp.shape
    ff = C.ff_run_length(comp, 0xFF)
    compi = comp.astype(jnp.int32)

    def g(idx):
        return C.take1(compi, idx)

    def cond(state):
        k, ip, op, active, bad, *_ = state
        return (k < max_seqs) & jnp.any(active)

    def body(state):
        (k, ip, op, active, bad,
         lit_src, lit_len, lit_dst, m_off, m_len, m_dst) = state
        token = g(ip)
        ll0 = token >> 4
        ll_ext = ll0 == 15
        ffr = C.take1(ff, ip + 1)
        ll_extbytes = jnp.where(ll_ext, ffr + 1, 0)
        ll = jnp.where(ll_ext, 15 + 255 * ffr + g(ip + 1 + ffr), ll0)
        src = ip + 1 + ll_extbytes
        dst = op
        lit_end = src + ll
        is_last = lit_end >= comp_lens
        ml0 = token & 15
        off = g(lit_end) | (g(lit_end + 1) << 8)
        ml_ext = ml0 == 15
        ffr2 = C.take1(ff, lit_end + 2)
        ml_extbytes = jnp.where(ml_ext, ffr2 + 1, 0)
        ml = jnp.where(ml_ext, 4 + 15 + 255 * ffr2 + g(lit_end + 2 + ffr2), ml0 + 4)
        ml = jnp.where(is_last, 0, ml)
        match_dst = op + ll
        overrun = (lit_end > comp_lens) | \
            (~is_last & (lit_end + 2 + ml_extbytes > comp_lens)) | \
            (~is_last & (off == 0))
        if not linked:
            overrun = overrun | (~is_last & (off > match_dst))
        bad = bad | (active & overrun)
        upd = active & ~bad

        def put(arr, vals):
            return arr.at[:, k].set(jnp.where(upd, vals, arr[:, k]))

        lit_src = put(lit_src, src)
        lit_len = put(lit_len, jnp.where(upd, ll, 0))
        lit_dst = put(lit_dst, dst)
        m_off = put(m_off, off)
        m_len = put(m_len, jnp.where(upd, ml, 0))
        m_dst = put(m_dst, match_dst)

        ip = jnp.where(upd & ~is_last, lit_end + 2 + ml_extbytes, ip)
        op = jnp.where(upd, match_dst + ml, op)
        active = upd & ~is_last
        return (k + 1, ip, op, active, bad,
                lit_src, lit_len, lit_dst, m_off, m_len, m_dst)

    z = jnp.zeros((L,), jnp.int32)
    zk = jnp.zeros((L, max_seqs), jnp.int32)
    state = (jnp.int32(0), z, z, comp_lens > 0, jnp.zeros((L,), bool),
             zk, zk, zk, zk, zk, zk)
    (k, ip, op, active, bad,
     lit_src, lit_len, lit_dst, m_off, m_len, m_dst) = jax.lax.while_loop(
        cond, body, state)
    bad = bad | active  # ran out of sequence budget mid-block
    return lit_src, lit_len, lit_dst, m_off, m_len, m_dst, op, bad


@partial(jax.jit, static_argnames=("out_size", "max_seqs", "linked"))
def lz4_decode_frames(comp: jnp.ndarray, comp_lens: jnp.ndarray,
                      uncompressed: jnp.ndarray, out_size: int,
                      max_seqs: int | None = None, linked: bool = False):
    """Decode a batch of frames, each given as K zero-padded blocks.

    comp: (B, K, M) uint8; comp_lens: (B, K) int32 (0 = absent block);
    uncompressed: (B, K) bool (LZ4F uncompressed-block flag).
    out_size: static per-frame decompressed capacity.
    Returns (out (B, out_size) uint8, out_lens (B,) int32, ok (B,) bool).
    """
    B, K, Mcap = comp.shape
    F = out_size
    if max_seqs is None:
        max_seqs = min(Mcap // 3 + 2, F // 4 + 2)

    flat = comp.reshape(B * K, Mcap)
    flat_lens = comp_lens.reshape(B * K)
    flat_unc = uncompressed.reshape(B * K)
    # uncompressed blocks skip the parser entirely
    parse_lens = jnp.where(flat_unc, 0, flat_lens)
    (lit_src, lit_len, lit_dst, m_off, m_len, m_dst,
     blk_out, bad) = _parse_blocks(flat, parse_lens, max_seqs, linked)
    # inject a single whole-block literal sequence for uncompressed blocks
    lit_src = lit_src.at[:, 0].set(jnp.where(flat_unc, 0, lit_src[:, 0]))
    lit_len = lit_len.at[:, 0].set(jnp.where(flat_unc, flat_lens, lit_len[:, 0]))
    lit_dst = lit_dst.at[:, 0].set(jnp.where(flat_unc, 0, lit_dst[:, 0]))
    m_len = m_len.at[:, 0].set(jnp.where(flat_unc, 0, m_len[:, 0]))
    blk_out = jnp.where(flat_unc, flat_lens, blk_out)

    # per-frame block output bases (exclusive scan)
    blk_out_bk = blk_out.reshape(B, K)
    base = C.exclusive_cumsum(blk_out_bk, axis=1)
    out_lens = jnp.sum(blk_out_bk, axis=1)

    # flatten sequences frame-wide: (B, K*S)
    S = max_seqs

    def to_frame(arr):
        return arr.reshape(B, K * S)

    base_rep = jnp.repeat(base, S, axis=1)              # (B, K*S)
    blk_idx = np.repeat(np.arange(K, dtype=np.int32), S)[None, :]
    lit_src_f = to_frame(lit_src) + blk_idx * Mcap
    lit_len_f = to_frame(lit_len)
    lit_dst_f = to_frame(lit_dst) + base_rep
    m_off_f = to_frame(m_off)
    m_len_f = to_frame(m_len)
    m_dst_f = to_frame(m_dst) + base_rep
    bad_f = jnp.any(bad.reshape(B, K), axis=1)

    comp_frame = comp.reshape(B, K * Mcap)
    nseq = K * S

    # literals: comp-stream membership -> output scatter, via rank-compacted
    # tables (region_index ranks among masked starts only)
    seq_valid = lit_len_f > 0
    is_lit_src = C.fill_regions(K * Mcap, lit_src_f, lit_src_f + lit_len_f, seq_valid)
    src_region = C.region_index(K * Mcap, lit_src_f, seq_valid)
    lr_rank = jnp.cumsum(seq_valid.astype(jnp.int32), axis=1) - 1
    lit_src_tab = C.scatter1_set(jnp.zeros((B, nseq), jnp.int32), lr_rank,
                                 lit_src_f, seq_valid)
    lit_dst_tab = C.scatter1_set(jnp.zeros((B, nseq), jnp.int32), lr_rank,
                                 lit_dst_f, seq_valid)
    jpos = jnp.broadcast_to(np.arange(K * Mcap, dtype=np.int32)[None, :],
                            (B, K * Mcap))
    ldst = C.take1(lit_dst_tab, src_region) + \
        (jpos - C.take1(lit_src_tab, src_region))
    val_layer = jnp.zeros((B, F), jnp.int32)
    val_layer = C.scatter1_set(val_layer, ldst,
                               comp_frame.astype(jnp.int32), is_lit_src)

    # matches: output membership -> frame-wide back references
    m_valid = m_len_f > 0
    in_match = C.fill_regions(F, m_dst_f, m_dst_f + m_len_f, m_valid)
    m_region = C.region_index(F, m_dst_f, m_valid)
    mr_rank = jnp.cumsum(m_valid.astype(jnp.int32), axis=1) - 1
    m_off_tab = C.scatter1_set(jnp.ones((B, nseq), jnp.int32), mr_rank,
                               m_off_f, m_valid)
    ipos = jnp.broadcast_to(np.arange(F, dtype=np.int32)[None, :], (B, F))
    ref = ipos - C.take1(m_off_tab, m_region)
    bad_f = bad_f | jnp.any(in_match & (ref < 0), axis=1)
    src0 = jnp.where(in_match, jnp.clip(ref, 0, F - 1), ipos)
    rounds = max(1, int(np.ceil(np.log2(max(2, F)))))
    src_final = C.resolve_copy_chains(src0, rounds)
    out = C.take1(val_layer, src_final).astype(jnp.uint8)
    return out, out_lens, ~bad_f


def lz4_decode_blocks(comp: jnp.ndarray, comp_lens: jnp.ndarray,
                      out_size: int, max_seqs: int | None = None):
    """Single-block convenience wrapper (independent blocks)."""
    B, M = comp.shape
    return lz4_decode_frames(
        comp.reshape(B, 1, M), comp_lens.reshape(B, 1),
        jnp.zeros((B, 1), bool), out_size, max_seqs=max_seqs, linked=False)
