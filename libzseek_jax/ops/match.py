"""LZ77 match finding as a batched device program.

The reference delegates match finding to libzstd's hash chains / LZ4's hash
table — branchy, pointer-chasing scalar code.  The batched formulation
replaces it with data-parallel primitives:

  1. **Nearest previous occurrence** of the 4-byte window at every position
     via a single batched lexicographic sort of (window value, position):
     within a group of equal window values, the sort predecessor is exactly
     the nearest previous position with the same 4 bytes.  This is *exact*
     (no hash collisions, no chain-depth truncation) — strictly stronger than
     the reference's level-3 ZSTD_fast single-probe hash table.

  2. **Match length extension** only at the (compacted) per-segment candidate
     positions, in 4-byte XOR steps — O(max_len/4) vector steps instead of a
     per-byte scalar loop.

  3. **Greedy coverage selection** as one length-NSEG lax.scan whose carry is
     a (B,) vector — the only sequential dependency in the pipeline, shared
     by every frame in the batch.

All shapes are static; rows of the batch are independent blocks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from libzseek_jax.ops import common as C


def nearest_prev_occurrence(x: jnp.ndarray, lengths: jnp.ndarray,
                            window: int = 4) -> jnp.ndarray:
    """cand[b, i] = largest j < i with x[b, j:j+window] == x[b, i:i+window],
    else -1.  window is 4 or 8; positions i > lengths[b]-window get -1.

    A larger window finds rarer (hence usually longer, more
    offset-consistent) matches — the 8-byte variant is what keeps periodic
    data on one stable offset so run merging can chain.
    """
    B, N = x.shape
    v = C.u32_window(x)
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    invalid = (pos > lengths[:, None] - window).astype(jnp.int32)
    # Sort rows by (invalid, value[, value2], position): equal windows become
    # adjacent, invalid positions group at the end and never link valid ones.
    if window == 4:
        keys = (invalid, v, pos)
    else:
        v2 = jnp.pad(v[:, 4:], ((0, 0), (0, 4)))  # bytes i+4..i+7
        keys = (invalid, v, v2, pos)
    sorted_ = jax.lax.sort(keys, num_keys=len(keys))
    idx_s = sorted_[-1]
    inv_s = sorted_[0]
    same = (inv_s[:, 1:] == 0) & (inv_s[:, :-1] == 0)
    for k in sorted_[1:-1]:
        same = same & (k[:, 1:] == k[:, :-1])
    cand_s = jnp.where(same, idx_s[:, :-1], C.INVALID)
    cand_s = jnp.concatenate(
        [jnp.full((B, 1), C.INVALID, dtype=jnp.int32), cand_s], axis=1)
    cand = jnp.zeros((B, N), dtype=jnp.int32)
    cand = C.scatter1_set(cand, idx_s, cand_s)
    return jnp.where(invalid == 0, cand, C.INVALID)


def extend_match_lengths(x: jnp.ndarray, p: jnp.ndarray, q: jnp.ndarray,
                         active: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """Length of the match between positions p and q (< p) per row, in
    [4, max_len], computed in 4-byte strides with an XOR tail fix-up.

    x: (B, N) uint8; p, q, active: (B, K).  Reads may run past the valid
    length into zero padding — callers cap the result.
    """
    v = C.u32_window(x)

    def step(_, state):
        l, alive = state
        a = C.take1(v, p + l)
        b = C.take1(v, q + l)
        d = a ^ b
        full = (d == 0) & alive
        # partial extension: count of matching low-order bytes of the u32
        b0 = (d & 0xFF) == 0
        b1 = (d & 0xFFFF) == 0
        b2 = (d & 0xFFFFFF) == 0
        partial = b0.astype(jnp.int32) + b1.astype(jnp.int32) + b2.astype(jnp.int32)
        l = l + jnp.where(full, 4, jnp.where(alive & (d != 0), partial, 0))
        return l, full

    steps = max(0, (max_len - 4 + 3) // 4)
    l0 = jnp.full(p.shape, 4, dtype=jnp.int32)
    l, _ = jax.lax.fori_loop(0, steps, step, (l0, active))
    return jnp.clip(l, 4, max_len)


def backward_extension(x: jnp.ndarray, p: jnp.ndarray, q: jnp.ndarray,
                       active: jnp.ndarray, max_back: int,
                       min_p: int = 0,
                       min_q: jnp.ndarray | None = None) -> jnp.ndarray:
    """How many bytes before p also match before q (greedy LZ4's backward
    match extension over pending literals).  Returns (B, K) int32 in
    [0, max_back].  min_p keeps the match start out of a context prefix
    (linked blocks); min_q (B,) keeps the reference inside valid history."""
    bk = jnp.zeros(p.shape, dtype=jnp.int32)
    alive = active
    qlim = 0 if min_q is None else min_q[:, None]
    for t in range(1, max_back + 1):
        a = C.take1(x, p - t).astype(jnp.int32)
        b = C.take1(x, q - t).astype(jnp.int32)
        ok = alive & (q - t >= qlim) & (p - t >= min_p) & (a == b)
        bk = bk + ok.astype(jnp.int32)
        alive = ok
    return bk


def _log2i(v: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(v)) for 1 <= v < 2^24 via the float32 exponent."""
    f = jnp.maximum(v, 1).astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127


@partial(jax.jit, static_argnames=("seg_size", "max_len", "max_offset",
                                   "min_tail", "max_back", "end_margin",
                                   "dual", "ctx_len", "window"))
def find_segment_matches(x: jnp.ndarray, lengths: jnp.ndarray, *,
                         seg_size: int = 8, max_len: int = 64,
                         max_offset: int = 65535, min_tail: int = 12,
                         max_back: int = 0, end_margin: int = 5,
                         dual: bool = False, ctx_len: int = 0,
                         min_ref: jnp.ndarray | None = None,
                         window: int = 4):
    """Per-segment match candidates: the earliest valid match start in each
    seg_size-byte segment, with its offset and extended length.

    Returns (p, off, e, has) each (B, NSEG):
      p   = match start position (after backward extension if max_back > 0)
      off = backward distance
      e   = match end (exclusive), capped at lengths - end_margin and
            start + max_len
      has = segment produced a candidate

    min_tail/end_margin encode the LZ4 end-of-block rules (last match starts
    >= 12 bytes before the end, last 5 bytes literal); zstd callers relax
    them (min_tail=4, end_margin=0).

    dual=True adds a second candidate per segment from the nearest previous
    8-byte window and keeps the better of the two by (length, offset cost)
    score: the 4-byte nearest occurrence on repetitive data is often an
    accidental collision at an unstable offset, while the 8-byte candidate
    stays on the true period so adjacent segments share an offset and
    merge_runs can chain them into long sequences.

    ctx_len > 0 runs in linked-block mode: positions [0, ctx_len) are
    history only (the previous block's window) — matches must START at or
    after ctx_len but may reference backward into the context.  min_ref
    (B,) bounds how far back references may reach (first block of a frame
    has no real history below ctx_len).
    """
    B, N = x.shape
    assert N % seg_size == 0
    nseg = N // seg_size
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    segbase = jnp.arange(nseg, dtype=jnp.int32)[None, :] * seg_size
    ref_lim = None if min_ref is None else min_ref[:, None]

    def seg_candidate(window):
        cand = nearest_prev_occurrence(x, lengths, window)
        valid = (cand >= 0) & (pos - cand <= max_offset) & \
            (pos <= lengths[:, None] - min_tail)
        if ctx_len:
            valid = valid & (pos >= ctx_len)
        if ref_lim is not None:
            valid = valid & (cand >= ref_lim)
        vseg = valid.reshape(B, nseg, seg_size)
        has = jnp.any(vseg, axis=2)
        first = jnp.argmax(vseg, axis=2).astype(jnp.int32)
        p = segbase + first
        q = C.take1(cand, p)
        return p, q, has

    p, q, has = seg_candidate(window)
    if dual:
        # Pick the winner BEFORE the expensive extension (the gathers in
        # extend_match_lengths dominate the whole parse, so only one
        # candidate can afford it).  One 4-byte probe bounds the 4-window
        # candidate's promise; the 8-window candidate is >= 8 by
        # construction, and whenever the 4-candidate reaches 8 bytes the
        # nearest-8 occurrence is at most as far away.
        p8, q8, has8 = seg_candidate(8)
        l4p = extend_match_lengths(x, p, q, has, 8)
        score4 = jnp.where(has, 8 * l4p - _log2i(p - q), -(1 << 30))
        score8 = jnp.where(has8, 8 * 8 - _log2i(p8 - q8), -(1 << 30))
        use8 = score8 > score4
        p = jnp.where(use8, p8, p)
        q = jnp.where(use8, q8, q)
        has = has | has8
    l = extend_match_lengths(x, p, q, has, max_len)
    if max_back > 0:
        bk = backward_extension(x, p, q, has, max_back, min_p=ctx_len,
                                min_q=min_ref)
        p = p - bk
        q = q - bk
        l = l + bk
    e = jnp.minimum(p + l, lengths[:, None] - end_margin)
    off = p - q
    has = has & (e - p >= 4)
    return p, off, e, has


def greedy_select(p, off, e, has, lengths, min_tail: int = 12,
                  min_match: int = 4, unroll: int = 4, c0: int = 0):
    """Greedy left-to-right coverage over segments, batched over rows.

    The carry is the per-row cover end c.  A segment's match is selected if
    it still has >= min_match bytes past c (its start is trimmed to c —
    trimming an LZ match start is always valid).  ``unroll`` candidates are
    consumed per scan step, shortening the sequential chain without changing
    the result.  Returns per-segment arrays:
      sel (bool), start, end, off, lit_from (cover end before this match),
    and the final per-row cover end.
    """
    B, nseg = p.shape
    u = unroll
    while nseg % u:
        u //= 2
    tail_limit = lengths - min_tail

    def substep(c, p_k, off_k, e_k, has_k):
        s = jnp.maximum(p_k, c)
        ok = has_k & (e_k - s >= min_match) & (s <= tail_limit)
        new_c = jnp.where(ok, e_k, c)
        return new_c, (ok, s, c)

    def step(c, inp):
        p_k, off_k, e_k, has_k = inp  # each (u, B)
        outs = []
        for t in range(u):
            c, out = substep(c, p_k[t], off_k[t], e_k[t], has_k[t])
            outs.append(out)
        sel = jnp.stack([o[0] for o in outs])
        start = jnp.stack([o[1] for o in outs])
        lit_from = jnp.stack([o[2] for o in outs])
        return c, (sel, start, lit_from)

    def fold(a):
        return jnp.moveaxis(a, 1, 0).reshape(nseg // u, u, B)

    xs = (fold(p), fold(off), fold(e), fold(has))
    c_final, (sel, start, lit_from) = jax.lax.scan(
        step, jnp.full((B,), c0, dtype=jnp.int32), xs)

    def unfold(a):
        return jnp.moveaxis(a.reshape(nseg, B), 0, 1)

    return (unfold(sel), unfold(start), e, off, unfold(lit_from), c_final)


def merge_runs(sel, start, end, off, lit_from):
    """Merge adjacent selected matches that continue seamlessly (previous
    match ends exactly where this one starts, same offset, no literals in
    between) into single long sequences — recovers arbitrarily long matches
    from segment-capped candidates (zero runs, periodic data).

    Returns (is_head, merged_end): sequence heads keep their start/off/
    lit_from; merged_end is the end of the last member of the head's run.
    """
    B, nseg = sel.shape
    seg_idx = jnp.broadcast_to(jnp.arange(nseg, dtype=jnp.int32)[None, :], (B, nseg))
    # index of the previous selected segment (exclusive cummax over sel*idx)
    marked = jnp.where(sel, seg_idx, -1)
    prev_sel = jax.lax.cummax(jnp.pad(marked[:, :-1], ((0, 0), (1, 0)),
                                      constant_values=-1), axis=1)
    prev_end = C.take1(end, jnp.maximum(prev_sel, 0))
    prev_off = C.take1(off, jnp.maximum(prev_sel, 0))
    cont = sel & (prev_sel >= 0) & (prev_end == start) & (prev_off == off)
    is_head = sel & ~cont
    # run id per segment = number of heads at or before it
    run_id = jnp.cumsum(is_head.astype(jnp.int32), axis=1) - 1
    # merged end per run = max end among its members (scatter-max)
    nrun = nseg  # upper bound
    run_id_safe = jnp.where(sel, run_id, nrun)
    ends = jnp.zeros((B, nrun + 1), dtype=jnp.int32)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], run_id_safe.shape)
    ends = ends.at[rows, run_id_safe].max(jnp.where(sel, end, 0), mode="drop")
    merged_end = C.take1(ends, jnp.maximum(run_id, 0))
    return is_head, merged_end
