"""zstd block encoder — device pipelines (RFC 8878).

Three batched stages (rows = independent 128 KiB blocks):

  1. zstd_sequences: LZ77 parse (shared ops.match pipeline, zstd end rules)
     -> per-sequence (litLen, offset_value, matchLen), compacted literal
     bytes, and literal histograms.
  2. huffman_encode_literals: per-literal code lookup, 4-stream split,
     prefix-sum bit offsets, one scatter-add packing pass.
  3. fse_encode_sequences: the interleaved 3-state tANS walk (predefined
     distributions), reverse-order scan with lane-vectorized state, then
     parallel bit packing.

The reference gets all of this from libzstd's scalar encoder
(ZSTD_compress2, /root/reference/src/compress.c:666).  Table construction
and container assembly are host-side (runtime/zstd_codec.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from libzseek_jax.format import zstd_frame as zf
from libzseek_jax.ops import bits as BITS
from libzseek_jax.ops import common as C
from libzseek_jax.ops import fse
from libzseek_jax.ops import match as M

import os as _os

# Profitability gate: fixed per-sequence bits (three predefined-FSE state
# updates + LL/ML extras) charged on top of the offset's extra bits.
SORT_GATE_BITS = 20

# c * log2(c) in 1/256-bit fixed point for every count a block can hold.
# The gate's block entropy is summed from this table in int32, so it is
# the same on every backend (XLA's CPU and GPU log2 may differ in the last
# bit, which would let one match flip and the archives diverge).
_CLOG2 = np.round(np.arange(zf.BLOCK_MAX + 1, dtype=np.float64)
                  * np.log2(np.maximum(np.arange(zf.BLOCK_MAX + 1), 1))
                  * 256).astype(np.int32)

# --- small constant code tables (device-resident) ---
_LL_CODE_TAB64 = np.searchsorted(zf._LL_BASE, np.arange(64), side="right") - 1
_ML_CODE_TAB128 = np.searchsorted(zf._ML_BASE, np.arange(3, 131), side="right") - 1

# predefined FSE encode tables (built once, host numpy)
_LL_ET = fse.build_encode_table(zf.LL_DEFAULT_NORM, zf.LL_DEFAULT_LOG)
_OF_ET = fse.build_encode_table(zf.OF_DEFAULT_NORM, zf.OF_DEFAULT_LOG)
_ML_ET = fse.build_encode_table(zf.ML_DEFAULT_NORM, zf.ML_DEFAULT_LOG)


def _exp_of(v):
    """floor(log2(v)) for 1 <= v < 2^24, exact via the float32 exponent."""
    f = v.astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127


def ll_code_dev(ll):
    # dense 20-way compare-count instead of a table gather
    base = jnp.asarray(np.asarray(zf._LL_BASE[16:], np.int32))
    small = jnp.where(
        ll < 16, ll,
        15 + jnp.sum((ll[..., None] >= base).astype(jnp.int32), axis=-1))
    return jnp.where(ll > 63, _exp_of(jnp.maximum(ll, 1)) + 19, small)


def ml_code_dev(ml):
    mb = ml - 3
    base = jnp.asarray(np.asarray(zf._ML_BASE[32:], np.int32))
    small = jnp.where(
        mb < 32, mb,
        31 + jnp.sum((ml[..., None] >= base).astype(jnp.int32), axis=-1))
    return jnp.where(mb > 127, _exp_of(jnp.maximum(mb, 1)) + 36, small)



def _const_byte(x, lengths, in_range):
    """Per-row constant-block detector: byte value if every in-range byte
    equals the first, else -1 (zstd RLE block candidates)."""
    nonconst = jnp.sum(((x != x[:, :1]) & in_range).astype(jnp.int32),
                       axis=1)
    return jnp.where((nonconst == 0) & (lengths > 0),
                     x[:, 0].astype(jnp.int32), jnp.int32(-1))


@partial(jax.jit, static_argnames=("seg_size", "max_len", "max_back",
                                   "max_offset", "dual", "window"))
def zstd_sequences(x: jnp.ndarray, lengths: jnp.ndarray, *,
                   seg_size: int = 4, max_len: int = 16, max_back: int = 0,
                   max_offset: int = (1 << 17) - 1, dual: bool = False,
                   window: int = 8):
    """LZ77 parse for zstd blocks.

    Returns dict with (B, NSEQ) arrays ll, ml, offv (offset_value =
    offset + 3), n_seq (B,), last_literals (B,), literals (B, N) compacted,
    lit_count (B,), hist (B, 256).
    """
    B, N = x.shape
    nseq = N // seg_size + 1
    p, off, e, has = M.find_segment_matches(
        x, lengths, seg_size=seg_size, max_len=max_len, min_tail=4,
        max_back=max_back, end_margin=0, max_offset=max_offset, dual=dual,
        window=window)
    # --- profitability gate ---
    # A sequence costs ~18 state/extra bits + log2(offset) offset bits; a
    # skipped match costs ~H bits per literal byte (block byte entropy).
    # zstd's own encoders get this implicitly from recency-biased hash
    # tables + repcodes; with an exact nearest-occurrence finder the gate
    # must be explicit or far/short matches bloat the sequence section.
    pos = jnp.broadcast_to(np.arange(N, dtype=np.int32)[None, :], (B, N))
    in_range = pos < lengths[:, None]
    h16 = block_entropy_h16(C.hist256(x, in_range), lengths)[:, None]
    cost = SORT_GATE_BITS + _exp_of(jnp.maximum(off + 3, 1))
    has = has & ((e - p) * h16 > 16 * cost)
    sel, start, end, off, lit_from, c_final = M.greedy_select(
        p, off, e, has, lengths, min_tail=4)
    is_head, merged_end = M.merge_runs(sel, start, end, off, lit_from)

    rank = jnp.cumsum(is_head.astype(jnp.int32), axis=1) - 1
    n_seq = jnp.sum(is_head.astype(jnp.int32), axis=1)

    def compact(vals):
        dst = jnp.zeros((B, nseq), dtype=jnp.int32)
        return C.scatter1_set(dst, rank, vals.astype(jnp.int32), is_head)

    seq_lit_from = compact(lit_from)
    seq_start = compact(start)
    seq_end = compact(merged_end)
    seq_off = compact(off)
    idxs = jnp.broadcast_to(np.arange(nseq, dtype=np.int32)[None, :], (B, nseq))
    valid = idxs < n_seq[:, None]
    ll = jnp.where(valid, seq_start - seq_lit_from, 0)
    ml = jnp.where(valid, seq_end - seq_start, 0)
    offv = _rep1_rewrite(jnp.where(valid, seq_off + 3, 0), ll, valid)
    last_literals = lengths - c_final

    # literal extraction: bytes not covered by any selected match
    in_match = C.fill_regions(N, seq_start, seq_end, valid)
    pos = jnp.broadcast_to(np.arange(N, dtype=np.int32)[None, :], (B, N))
    is_lit = (~in_match) & (pos < lengths[:, None])
    lit_rank = C.exclusive_cumsum(is_lit.astype(jnp.int32), axis=1)
    lit_count = jnp.sum(is_lit.astype(jnp.int32), axis=1)
    literals = jnp.zeros((B, N), jnp.uint8)
    literals = C.scatter1_set(literals, lit_rank, x, is_lit)
    return dict(ll=ll, ml=ml, offv=offv, n_seq=n_seq,
                last_literals=last_literals, literals=literals,
                lit_count=lit_count, hist=C.hist256(x, is_lit),
                const=_const_byte(x, lengths, in_range))


def block_entropy_h16(hist: jnp.ndarray, lengths: jnp.ndarray):
    """Per-row byte entropy in 1/16 bit, clipped to [1, 8] bits, from the
    (B, 256) byte histogram: 16 * (n log2 n - sum c log2 c) / n, all in
    int32 fixed point (see _CLOG2)."""
    tab = jnp.asarray(_CLOG2)
    n = jnp.maximum(lengths, 1)
    h_fx = tab[lengths] - jnp.sum(tab[hist], axis=1)
    return jnp.clip(h_fx // (16 * n), 16, 128)


@partial(jax.jit, static_argnames=("out_bytes", "anchor_interval",
                                   "return_words"))
def huffman_encode_literals(lits: jnp.ndarray, lit_count: jnp.ndarray,
                            code_vals: jnp.ndarray, code_bits: jnp.ndarray,
                            out_bytes: int, anchor_interval: int = 0,
                            return_words: bool = False):
    """4-stream Huffman encode.

    lits: (B, LC) compacted literal bytes; code_vals/code_bits: (B, 256).
    Returns (stream_bytes (B, out_bytes) uint8, sizes (B, 4) int32) where
    sizes are the closed byte sizes of the four streams (jump table source).

    anchor_interval A > 0 additionally returns decode anchors (see
    format/hints.py): anchors (B, 4, MAXA) int32 — the decoder's bit
    position (within each stream, reading backward from its sentinel) after
    it has produced k*A symbols, for k = 1..  -1 marks absent anchors.
    """
    B, LC = lits.shape
    idx = jnp.broadcast_to(np.arange(LC, dtype=np.int32)[None, :], (B, LC))
    active = idx < lit_count[:, None]
    cv = C.take1(code_vals, lits.astype(jnp.int32))
    cb = jnp.where(active, C.take1(code_bits, lits.astype(jnp.int32)), 0)
    # stream split: first 3 streams of ceil(cnt/4), 4th the remainder
    s = (lit_count + 3) >> 2
    sid = jnp.minimum(idx // jnp.maximum(s[:, None], 1), 3)
    # per-stream running bit offsets
    cum = jnp.cumsum(cb, axis=1)
    start_all = cum - cb
    # cumulative bits at each stream's first element
    stream_start_idx = jnp.stack([jnp.zeros_like(s), s, 2 * s, 3 * s], axis=1)
    stream_cum0 = C.take1(jnp.pad(cum, ((0, 0), (1, 0))),
                          jnp.clip(stream_start_idx, 0, LC))
    bit_in_stream_fwd = start_all - C.take1(stream_cum0, sid)
    # stream bit totals (+1 sentinel each) -> byte sizes
    end_idx = jnp.stack([s, 2 * s, 3 * s, lit_count], axis=1)
    stream_bits = C.take1(jnp.pad(cum, ((0, 0), (1, 0))),
                          jnp.clip(end_idx, 0, LC)) - stream_cum0
    # literals are emitted in REVERSE order within each stream (the decoder
    # reads the stream backward and must produce them forward)
    bit_in_stream = C.take1(stream_bits, sid) - bit_in_stream_fwd - cb
    sizes = (stream_bits + 1 + 7) >> 3
    base_bytes = C.exclusive_cumsum(sizes, axis=1)
    abs_pos = (C.take1(base_bytes, sid) << 3) + bit_in_stream
    # sentinels: one per stream at its end
    sent_pos = (base_bytes << 3) + stream_bits
    values = jnp.concatenate([cv.astype(jnp.uint32),
                              jnp.ones((B, 4), jnp.uint32)], axis=1)
    nbits = jnp.concatenate([cb, jnp.ones((B, 4), jnp.int32)], axis=1)
    bitpos = jnp.concatenate([abs_pos, sent_pos], axis=1)
    words = BITS.pack_bits_at(values, nbits, bitpos, out_bytes // 4)
    stream_bytes = words if return_words else \
        BITS.words_to_bytes(words, out_bytes)
    if not anchor_interval:
        return stream_bytes, sizes
    # decode anchors: pos after the first k*A symbols of each stream =
    # stream_bits - (cum at stream_start + k*A  -  cum at stream_start)
    A = anchor_interval
    maxa = (((LC + 3) // 4) + A - 1) // A
    ks = np.arange(1, maxa + 1, dtype=np.int32) * A  # symbols per anchor
    counts = jnp.stack([s, s, s, lit_count - 3 * s], axis=1)
    m = jnp.broadcast_to(ks[None, None, :], (B, 4, maxa))
    valid_a = m < counts[:, :, None]
    cum_pad = jnp.pad(cum, ((0, 0), (1, 0)))
    idx_a = jnp.clip(stream_start_idx[:, :, None] + m, 0, LC)
    consumed = C.take1(cum_pad, idx_a.reshape(B, -1)).reshape(B, 4, maxa) \
        - stream_cum0[:, :, None]
    anchors = jnp.where(valid_a, stream_bits[:, :, None] - consumed,
                        jnp.int32(-1))
    return stream_bytes, sizes, anchors


def _enc_tables_dev():
    def tt(et):
        return (jnp.asarray(et.state_table, jnp.int32),
                jnp.asarray(et.delta_nb_bits, jnp.int32),
                jnp.asarray(et.delta_find_state, jnp.int32))
    return tt(_LL_ET), tt(_OF_ET), tt(_ML_ET)


@partial(jax.jit, static_argnames=("out_bytes", "smax", "anchor_interval",
                                   "return_words"))
def fse_encode_sequences(ll: jnp.ndarray, ml: jnp.ndarray, offv: jnp.ndarray,
                         n_seq: jnp.ndarray, out_bytes: int,
                         smax: int | None = None, anchor_interval: int = 0,
                         return_words: bool = False):
    """Encode sequence codes with the predefined FSE tables.

    Emission order (forward write order, = what libzstd's
    ZSTD_encodeSequences_body produces): last sequence's extra bits (LL, ML,
    OF), then for each earlier sequence (reverse order): state bits (OF, ML,
    LL) and extra bits (LL, ML, OF); finally state flushes (ML, OF, LL) and
    the sentinel bit.

    Only the 3-state tANS chain is sequential; per-sequence codes and
    extra-bit values are precomputed vectorized, reversed into encode order,
    and the lax.scan carries just three (B,) states.  smax (static) bounds
    the scan trip count — callers that already hold n_seq on the host pass a
    small bucket instead of the worst-case NSEQ.

    Returns (stream (B, out_bytes) uint8, byte_sizes (B,) int32); with
    anchor_interval A > 0 additionally (anchor_bits (B, MAXA) int32 — the
    decoder's bit position before decoding sequence k*A, -1 when absent —
    anchor_states (B, MAXA, 3) int32 (LL, OF, ML), anchor_rep1 (B, MAXA)
    int32), per format/hints.py.
    """
    B, NSEQ = ll.shape
    S = NSEQ if smax is None else min(smax, NSEQ)
    (ll_st, ll_dnb, ll_dfs), (of_st, of_dnb, of_dfs), (ml_st, ml_dnb, ml_dfs) = \
        _enc_tables_dev()
    llc = ll_code_dev(ll)
    mlc = jnp.where(ml >= 3, ml_code_dev(jnp.maximum(ml, 3)), 0)
    ofc = jnp.where(offv > 0, _exp_of(jnp.maximum(offv, 1)), 0)
    ll_bits_t = jnp.asarray(zf.LL_BITS, jnp.int32)
    ll_base_t = jnp.asarray(zf.LL_BASELINE, jnp.int32)
    ml_bits_t = jnp.asarray(zf.ML_BITS, jnp.int32)
    ml_base_t = jnp.asarray(zf.ML_BASELINE, jnp.int32)

    # reverse into encode order: step t handles sequence n_seq-1-t
    steps = jnp.broadcast_to(np.arange(S, dtype=np.int32)[None, :], (B, S))
    rev_idx = jnp.clip(n_seq[:, None] - 1 - steps, 0, NSEQ - 1)

    def rev(a):
        return jnp.take_along_axis(a, rev_idx, axis=1)

    r_llc, r_mlc, r_ofc = rev(llc), rev(mlc), rev(ofc)
    r_ll, r_ml, r_offv = rev(ll), rev(ml), rev(offv)
    active = steps < n_seq[:, None]
    later = active & (steps > 0)
    # extra-bit values/counts, fully vectorized
    llb = jnp.where(active, ll_bits_t[jnp.clip(r_llc, 0, 35)], 0)
    llv = (r_ll - ll_base_t[jnp.clip(r_llc, 0, 35)]).astype(jnp.uint32)
    mlb = jnp.where(active, ml_bits_t[jnp.clip(r_mlc, 0, 52)], 0)
    mlv = (r_ml - ml_base_t[jnp.clip(r_mlc, 0, 52)]).astype(jnp.uint32)
    ofb = jnp.where(active, r_ofc, 0)
    ofvx = (r_offv - (1 << jnp.maximum(r_ofc, 0))).astype(jnp.uint32)

    def enc_sym(state, sym, st_tab, dnb, dfs):
        nb = (state + dnb[sym]) >> 16
        bits_v = state & ((1 << nb) - 1)
        new = st_tab[(state >> nb) + dfs[sym]]
        return new, bits_v, nb

    def init_state(sym, st_tab, dnb, dfs):
        nb = (dnb[sym] + (1 << 15)) >> 16
        v = (nb << 16) - dnb[sym]
        return st_tab[(v >> nb) + dfs[sym]]

    def scan_step(carry, xs):
        s_ll, s_of, s_ml = carry
        llc_t, mlc_t, ofc_t, first_t, later_t = xs
        n_of, bv_of, nb_of = enc_sym(s_of, ofc_t, of_st, of_dnb, of_dfs)
        n_ml, bv_ml, nb_ml = enc_sym(s_ml, mlc_t, ml_st, ml_dnb, ml_dfs)
        n_ll, bv_ll, nb_ll = enc_sym(s_ll, llc_t, ll_st, ll_dnb, ll_dfs)
        i_ll = init_state(llc_t, ll_st, ll_dnb, ll_dfs)
        i_of = init_state(ofc_t, of_st, of_dnb, of_dfs)
        i_ml = init_state(mlc_t, ml_st, ml_dnb, ml_dfs)
        s_ll = jnp.where(first_t, i_ll, jnp.where(later_t, n_ll, s_ll))
        s_of = jnp.where(first_t, i_of, jnp.where(later_t, n_of, s_of))
        s_ml = jnp.where(first_t, i_ml, jnp.where(later_t, n_ml, s_ml))
        sb = jnp.stack([jnp.where(later_t, bv_of, 0),
                        jnp.where(later_t, bv_ml, 0),
                        jnp.where(later_t, bv_ll, 0)]).astype(jnp.uint32)
        sn = jnp.stack([jnp.where(later_t, nb_of, 0),
                        jnp.where(later_t, nb_ml, 0),
                        jnp.where(later_t, nb_ll, 0)])
        st = jnp.stack([s_ll, s_of, s_ml])
        return (s_ll, s_of, s_ml), (sb, sn, st)

    first = active & (steps == 0)
    z32 = jnp.zeros((B,), jnp.int32)
    xs = (r_llc.T, r_mlc.T, r_ofc.T, first.T, later.T)
    (s_ll, s_of, s_ml), (sb, sn, st_steps) = jax.lax.scan(
        scan_step, (z32, z32, z32), xs)
    # sb: (S, 3, B) -> (B, S, 3)
    state_vals = jnp.transpose(sb, (2, 0, 1))
    state_nbs = jnp.transpose(sn, (2, 0, 1))

    # per-step emission: [of_state, ml_state, ll_state, llv, mlv, ofvx]
    extra_vals = jnp.stack([llv, mlv, ofvx], axis=2)
    extra_nbs = jnp.stack([llb, mlb, ofb], axis=2)
    vals = jnp.concatenate([state_vals, extra_vals.astype(jnp.uint32)],
                           axis=2).reshape(B, S * 6)
    nbs = jnp.concatenate([state_nbs, extra_nbs], axis=2).reshape(B, S * 6)

    # flush states (ML, OF, LL) + sentinel
    has = n_seq > 0
    tsz = lambda log: jnp.int32((1 << log) - 1)
    flush_vals = jnp.stack([
        (s_ml & tsz(zf.ML_DEFAULT_LOG)).astype(jnp.uint32),
        (s_of & tsz(zf.OF_DEFAULT_LOG)).astype(jnp.uint32),
        (s_ll & tsz(zf.LL_DEFAULT_LOG)).astype(jnp.uint32),
        jnp.ones((B,), jnp.uint32)], axis=1)
    flush_nbs = jnp.stack([
        jnp.where(has, zf.ML_DEFAULT_LOG, 0),
        jnp.where(has, zf.OF_DEFAULT_LOG, 0),
        jnp.where(has, zf.LL_DEFAULT_LOG, 0),
        jnp.where(has, 1, 0)], axis=1)

    all_vals = jnp.concatenate([vals, flush_vals], axis=1)
    all_nbs = jnp.concatenate([nbs, flush_nbs], axis=1)
    words, total_bits = BITS.pack_bits(all_vals, all_nbs, out_bytes // 4)
    byte_sizes = (total_bits + 7) >> 3  # sentinel included in total_bits
    stream_bytes = words if return_words else \
        BITS.words_to_bytes(words, out_bytes)
    if not anchor_interval:
        return stream_bytes, byte_sizes
    # --- decode anchors (format/hints.py) ---
    A = anchor_interval
    maxa = (S + A - 1) // A
    anchor_j = np.arange(1, maxa + 1, dtype=np.int32)[None, :] * A  # (1,maxa)
    anchor_j = jnp.broadcast_to(anchor_j, (B, maxa))
    valid_a = anchor_j < n_seq[:, None]
    ja = jnp.minimum(anchor_j, NSEQ - 1)
    # extras consumed by the decoder for sequences i < j (decode order)
    dec_idx = jnp.broadcast_to(np.arange(NSEQ, dtype=np.int32)[None, :],
                               (B, NSEQ))
    dactive = dec_idx < n_seq[:, None]
    ex_dec = jnp.where(dactive,
                       ll_bits_t[jnp.clip(llc, 0, 35)] +
                       ml_bits_t[jnp.clip(mlc, 0, 52)] + ofc, 0)
    ex_cum = jnp.pad(jnp.cumsum(ex_dec, axis=1), ((0, 0), (1, 0)))
    ex_before = C.take1(ex_cum, ja)
    # state-update bits consumed before seq j: the decoder's update after
    # seq i reads the encoder's step t = n-1-i state bits, so the prefix
    # over i < j is a SUFFIX over encode steps t >= n-j
    snsum = jnp.transpose(jnp.sum(sn, axis=1))          # (B, S)
    sn_cum = jnp.cumsum(snsum, axis=1)
    sn_total = sn_cum[:, -1]
    t_at = jnp.clip(n_seq[:, None] - 1 - anchor_j, 0, S - 1)
    st_before = sn_total[:, None] - C.take1(sn_cum, t_at)
    init_reads = zf.LL_DEFAULT_LOG + zf.OF_DEFAULT_LOG + zf.ML_DEFAULT_LOG
    bits_a = (total_bits - 1)[:, None] - init_reads - ex_before - st_before
    bits_a = jnp.where(valid_a, bits_a, -1)
    # decoder states before seq j = encoder states after step t = n-1-j,
    # rebased from the encoder's [tableSize, 2*tableSize) range to the
    # decoder's table indices
    st_bst = jnp.transpose(st_steps, (2, 0, 1))          # (B, S, 3)
    bias = np.array([1 << zf.LL_DEFAULT_LOG, 1 << zf.OF_DEFAULT_LOG,
                     1 << zf.ML_DEFAULT_LOG], np.int32)
    states_a = jnp.stack(
        [C.take1(st_bst[:, :, k], t_at) - bias[k] for k in range(3)], axis=2)
    # rep1 before seq j = last explicitly-coded offset among sequences < j
    push = dactive & (offv > 3)
    marked = jnp.where(push, dec_idx, -1)
    lastpush = jax.lax.cummax(marked, axis=1)
    lastpush_excl = jnp.pad(lastpush[:, :-1], ((0, 0), (1, 0)),
                            constant_values=-1)
    lp = C.take1(lastpush_excl, ja)
    rep1_a = jnp.where(lp >= 0,
                      C.take1(offv, jnp.maximum(lp, 0)) - 3, 1)
    return (stream_bytes, byte_sizes,
            (bits_a, states_a, jnp.where(valid_a, rep1_a, 1)))


@partial(jax.jit, static_argnames=("cap_words",))
def compact_payload(lit_words: jnp.ndarray, lit_bytes: jnp.ndarray,
                    seq_words: jnp.ndarray, seq_bytes: jnp.ndarray,
                    cap_words: int):
    """Pack the live prefix of each row's literal + sequence streams into one
    dense word buffer, so the host fetches only real payload bytes instead of
    (B, lit_cap)-shaped planes that are mostly padding.

    lit_words: (B, LW) uint32, lit_bytes: (B,) int32 used bytes (0 = skip
    row); seq_words: (B, SW) uint32, seq_bytes: (B,) int32.  Returns
    (flat (cap_words,) uint32, base_words (B,) int32, lit_words_used (B,)
    int32) where row r's literal stream occupies bytes
    [4*base[r], 4*base[r]+lit_bytes[r]) of the flat buffer and its sequence
    stream starts at byte 4*(base[r]+lit_words_used[r])."""
    B, LW = lit_words.shape
    SW = seq_words.shape[1]
    # Sections padded to whole 32-word (128 B) TILES so compaction can
    # gather (nt, 32) tile rows instead of single words: 32x fewer gather
    # elements for the same bytes.  The pad tiles ride along as payload
    # padding; callers address sections via the returned base/lw anyway.
    T = 32
    assert cap_words % T == 0, cap_words
    assert LW % T == 0, LW  # seq-section tile mapping needs an aligned split
    lw = (((lit_bytes + 3) >> 2) + T - 1) & ~(T - 1)
    sw = (((seq_bytes + 3) >> 2) + T - 1) & ~(T - 1)
    row_words = lw + sw
    base = jnp.cumsum(row_words) - row_words
    src = jnp.concatenate([lit_words, seq_words], axis=1)   # (B, LW+SW)
    LT = LW + SW
    pad = (-LT) % T
    if pad:
        src = jnp.pad(src, ((0, 0), (0, pad)))
        LT += pad
    src2 = src.reshape(B * (LT // T), T)
    nt = cap_words // T
    it = np.arange(nt, dtype=np.int32) * T                  # tile word idx
    # owning row via sorted-prefix search: O(nt log B), not the
    # O(nt x B) broadcast-compare; base/lw/sw are all tile-
    # aligned (and the lit plane width LW is a tile multiple), so a tile
    # never straddles a row or a lit/seq section boundary
    r = jnp.clip(jnp.searchsorted(base, it, side="right") - 1, 0, B - 1)
    d = it - base[r]
    lwr = lw[r]
    ct = jnp.where(d < lwr, d, LW + (d - lwr)) // T
    ct = jnp.clip(r * (LT // T) + ct, 0, B * (LT // T) - 1)
    live = d < row_words[r]
    flat2 = jnp.where(live[:, None], src2[ct], jnp.uint32(0))
    return flat2.reshape(-1), base, lw


def _rep1_rewrite(offv, ll, valid):
    """Code repeated distances as repcodes (RFC 8878 §3.1.1.5: with
    litLength != 0, offset_value 1/2/3 resolve to the three most recent
    offsets).  A rep sequence saves the log2(d) offset extra bits plus
    most of the FSE symbol — the dominant sequence-section cost on
    structured data.  ZN_REP1=off disables; ZN_REP1=first keeps only the
    consecutive-equal rep1 rewrite (the pre-r5 behavior).

    The full rewrite SIMULATES the decoder's repeat-offset state machine
    (scan over the sequence axis): rep slots only become eligible once
    written by an in-block explicit offset, so blocks stay
    self-decodable regardless of what preceded them.  ll == 0 sequences
    (shifted rep semantics) and each block's first sequence stay
    explicit.  libzstd gets the same effect from its repcode search
    (/root/reference/src/compress.c:666 delegating to ZSTD_compress2)."""
    mode = _os.environ.get("ZN_REP1", "full")
    if mode == "off":
        return offv
    cap = offv.shape[1]
    idxs = jnp.broadcast_to(np.arange(cap, dtype=np.int32)[None, :],
                            offv.shape)
    prev = jnp.pad(offv[:, :-1], ((0, 0), (1, 0)))
    is_rep1 = valid & (idxs > 0) & (offv == prev) & (ll > 0) & (offv > 3)
    if mode == "first":
        return jnp.where(is_rep1, 1, offv)

    def step(state, x):
        r1, r2, r3 = state
        ov, ll_i, ok = x
        dist = ov - 3
        explicit_ok = ok & (ov > 3)
        # slots initialized to an impossible sentinel (< 1) stand in for
        # "carried in from outside the block" — they can never match, so
        # a slot only becomes rep-eligible once written in-block
        hit1 = explicit_ok & (ll_i > 0) & (dist == r1)
        hit2 = explicit_ok & (ll_i > 0) & (dist == r2) & ~hit1
        hit3 = explicit_ok & (ll_i > 0) & (dist == r3) & ~hit1 & ~hit2
        out = jnp.where(hit1, 1,
                        jnp.where(hit2, 2, jnp.where(hit3, 3, ov)))
        # decoder state update (RFC 8878: rep1 leaves the order; rep2
        # swaps R1,R2; rep3 rotates; explicit pushes).  In every
        # explicit_ok case the new R1 is the resolved distance.
        n1 = jnp.where(explicit_ok, dist, r1)
        n2 = jnp.where(explicit_ok & ~hit1, r1, r2)
        n3 = jnp.where(hit3 | (explicit_ok & ~hit1 & ~hit2), r2, r3)
        return (n1, n2, n3), out

    B = offv.shape[0]
    z = jnp.full((B,), -(1 << 30), jnp.int32)
    _, out = jax.lax.scan(
        step, (z, z, z),
        (offv.T, ll.T, valid.T))
    return out.T


def apply_ldm_override(seqs: dict, spans: np.ndarray, lengths: np.ndarray,
                       lit_hist: np.ndarray, lit_plane: np.ndarray) -> dict:
    """Replace covered blocks' parse output with the single long-match
    sequence found by the LDM pre-pass (native zn_ldm_scan): bytes
    [s, e) of the block equal the bytes `dist` before them, so the block
    encodes as one (ll=s, ml=e-s, off=dist) sequence with the head/tail
    bytes as literals (s=0, e=len for whole-block hits).  spans: (B, 3)
    [dist, s, e); lit_hist: (B, 256) literal histograms of the covered
    blocks' remaining literals; lit_plane: their corrected literal-plane
    rows.  RLE (constant-byte) emission still takes precedence
    downstream."""
    dists = spans[:, 0]
    cov = dists > 0
    cm = jnp.asarray(cov)
    cap = seqs["ll"].shape[1]
    first = jnp.zeros((1, cap), bool).at[0, 0].set(True)
    m = cm[:, None] & first
    dv = jnp.asarray(dists.astype(np.int32))
    sv = jnp.asarray(spans[:, 1].astype(np.int32))
    ev = jnp.asarray(spans[:, 2].astype(np.int32))
    ln = jnp.asarray(lengths.astype(np.int32))
    out = dict(seqs)
    out["ll"] = jnp.where(m, sv[:, None],
                          jnp.where(cm[:, None], 0, seqs["ll"]))
    out["ml"] = jnp.where(m, (ev - sv)[:, None],
                          jnp.where(cm[:, None], 0, seqs["ml"]))
    out["offv"] = jnp.where(m, dv[:, None] + 3,
                            jnp.where(cm[:, None], 0, seqs["offv"]))
    out["n_seq"] = jnp.where(cm, 1, seqs["n_seq"])
    out["last_literals"] = jnp.where(cm, ln - ev, seqs["last_literals"])
    out["lit_count"] = jnp.where(cm, sv + (ln - ev), seqs["lit_count"])
    out["hist"] = jnp.where(cm[:, None],
                            jnp.asarray(lit_hist.astype(np.int32)),
                            seqs["hist"])
    out["literals"] = jnp.where(cm[:, None], jnp.asarray(lit_plane),
                                seqs["literals"])
    return out


def ldm_literal_stats(spans: np.ndarray, blocks, Bp: int, N: int):
    """Host-side literal stats for LDM-covered blocks: (Bp, 3) padded
    spans, per-block literal histograms (Bp, 256), and corrected
    literal-plane rows (Bp, N) holding [block[:s] || block[e:]]."""
    spans_p = np.zeros((Bp, 3), np.int64)
    spans_p[: len(spans)] = spans
    hist = np.zeros((Bp, 256), np.int64)
    plane = np.zeros((Bp, N), np.uint8)
    for i in range(len(spans)):
        d, s, e = spans[i]
        if d <= 0:
            continue
        blk = np.asarray(blocks[i])
        lits = np.concatenate([blk[:s], blk[e:]])
        hist[i] = np.bincount(lits, minlength=256)
        plane[i, : len(lits)] = lits
    return spans_p, hist, plane
