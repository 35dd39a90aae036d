"""zstd frame decoder: host container parse + batched device decode passes.

The reference decodes a frame with one scalar ZSTD_decompressDCtx call
(/root/reference/src/decompress.c:537).  The batched decomposition (plain
XLA programs; every pass runs on whichever backend JAX selects):

  host   — frame/block headers, literal-section headers, Huffman weight and
           FSE normalized-count table descriptions (tiny, per-block-rare),
           deduplicated into packed device table arrays.
  device — 1. Huffman literal decode: one while_loop whose lanes are ALL
              4-stream segments of ALL compressed-literals blocks in the
              batch; one packed-dtable gather per symbol step.
           2. Sequence decode: interleaved 3-state tANS walk (lanes =
              blocks), reading the bitstream backward; repcodes are carried
              as tagged values so blocks stay independent lanes, and the
              tiny cross-block rep chain is resolved on host afterwards.
           3. Sequence execution: literal scatter + back-reference copy
              chains resolved by pointer doubling, frame-wide (shared shape
              with the LZ4 executor in ops/lz4_decode.py).

Handles every RFC 8878 block/literal/table mode (raw, RLE, compressed,
treeless literals; predefined/RLE/compressed/repeat FSE), so archives
written by stock libzstd (e.g. by the reference library) decode too.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from libzseek_jax.errors import FormatError
from libzseek_jax.format import zstd_frame as zf
from libzseek_jax.ops import common as C
from libzseek_jax.ops import fse
from libzseek_jax.ops import huffman

_REP_TAG = 1 << 20  # tagged rep value: -(k * _REP_TAG + delta) = init_rep[k] - delta


# ---------------------------------------------------------------------------
# host: bitstream + table plumbing
# ---------------------------------------------------------------------------

def _sentinel_bits(stream: bytes) -> int:
    """Total payload bits of a backward FSE/Huffman stream (sentinel 1-bit
    excluded)."""
    if not stream or stream[-1] == 0:
        raise FormatError("corrupt backward bitstream (empty or zero last byte)")
    return 8 * (len(stream) - 1) + stream[-1].bit_length() - 1


def _win32(arr: np.ndarray) -> np.ndarray:
    """(L, SB) uint8 -> (L, SB) uint32 LE windows (zero-padded tail)."""
    a = arr.astype(np.uint32)

    def sh(k):
        return np.pad(a[:, k:], ((0, 0), (0, k)))

    return sh(0) | (sh(1) << 8) | (sh(2) << 16) | (sh(3) << 24)


_HUF_PEEK = 12  # libzstd's HUF_TABLELOG_MAX: accept foreign 12-bit tables


class _HufReg:
    """Deduplicated Huffman decode tables.  Stores only the (256,) weight
    vectors; the full 2^12-entry peek tables are built on the host when
    the lanes are dispatched (packed())."""

    def __init__(self):
        self.ids: dict[bytes, int] = {}
        self.weights: list[np.ndarray] = []
        self.tls: list[int] = []

    def add(self, weights: np.ndarray) -> int:
        key = weights.tobytes()
        if key not in self.ids:
            w = np.zeros(256, np.int32)
            w[: len(weights)] = weights
            total = int(np.sum(np.where(w > 0, 1 << (w - 1), 0)))
            if total <= 0 or total & (total - 1):
                raise FormatError("huffman weight sum is not a power of two")
            tl = total.bit_length() - 1
            if tl > _HUF_PEEK:
                raise FormatError(
                    f"huffman code length {tl} exceeds {_HUF_PEEK}")
            self.ids[key] = len(self.weights)
            self.weights.append(w)
            self.tls.append(tl)
        return self.ids[key]

    def packed(self) -> np.ndarray:
        if not self.weights:
            return np.zeros((1, 1 << _HUF_PEEK), np.int32)
        tabs = []
        for w in self.weights:
            ct = huffman.ctable_from_weights(w)
            dt = huffman.build_dtable(ct)
            tabs.append(np.repeat(dt, 1 << (_HUF_PEEK - ct.max_bits))
                        .astype(np.int32))
        return np.stack(tabs)


class _FseReg:
    """Deduplicated FSE decode tables packed as sym | nb<<8 | base<<16,
    padded to 512 entries."""

    def __init__(self):
        self.ids: dict[tuple, int] = {}
        self.tables: list[np.ndarray] = []
        self.logs: list[int] = []

    def _pack(self, dt: fse.DecodeTable) -> np.ndarray:
        packed = (dt.symbol | (dt.nb_bits << 8) | (dt.new_state << 16))
        out = np.zeros(512, np.int32)
        out[: packed.shape[0]] = packed
        return out

    def add_norm(self, kind: str, norm: np.ndarray, table_log: int) -> int:
        key = (kind, table_log, norm.tobytes())
        if key not in self.ids:
            self.ids[key] = len(self.tables)
            self.tables.append(self._pack(fse.build_decode_table(norm, table_log)))
            self.logs.append(table_log)
        return self.ids[key]

    def add_rle(self, kind: str, symbol: int) -> int:
        key = (kind, "rle", symbol)
        if key not in self.ids:
            self.ids[key] = len(self.tables)
            self.tables.append(self._pack(fse.DecodeTable(
                0, np.array([symbol], np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.int32))))
            self.logs.append(0)
        return self.ids[key]

    def packed(self) -> np.ndarray:
        if not self.tables:
            return np.zeros((1, 512), np.int32)
        return np.stack(self.tables)


_PREDEF = {
    "ll": (zf.LL_DEFAULT_NORM, zf.LL_DEFAULT_LOG),
    "of": (zf.OF_DEFAULT_NORM, zf.OF_DEFAULT_LOG),
    "ml": (zf.ML_DEFAULT_NORM, zf.ML_DEFAULT_LOG),
}
_MAX_SYM = {"ll": zf.MAX_LL_CODE, "of": zf.MAX_OF_CODE, "ml": zf.MAX_ML_CODE}


# ---------------------------------------------------------------------------
# host: container parsing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HufLane:
    stream: bytes
    n_out: int
    tid: int


@dataclasses.dataclass
class _BlockPlan:
    content: int                      # regenerated size of this block
    lit_direct: bytes | None = None   # raw/RLE literal bytes (or whole raw block)
    huf_lanes: list | None = None     # list[_HufLane], decoded -> literal bytes
    n_seq: int = 0
    seq_stream: bytes = b""
    ll_tid: int = 0
    of_tid: int = 0
    ml_tid: int = 0
    ll_tl: int = 0
    of_tl: int = 0
    ml_tl: int = 0


@dataclasses.dataclass
class _FramePlan:
    content_size: int
    blocks: list          # list[_BlockPlan]


def _parse_lit_section(data: bytes, pos: int, frame_state: dict,
                       hufreg: _HufReg):
    """Parse a literals section.  Returns (kind, payload, regen, pos') where
    kind is 'bytes' (payload = literal bytes) or 'huf'
    (payload = list[_HufLane])."""
    b0 = data[pos]
    lit_type = b0 & 3
    size_format = (b0 >> 2) & 3
    if lit_type in (0, 1):  # Raw / RLE
        if size_format in (0, 2):
            regen = b0 >> 3
            pos += 1
        elif size_format == 1:
            regen = (b0 >> 4) | (data[pos + 1] << 4)
            pos += 2
        else:
            regen = (b0 >> 4) | (data[pos + 1] << 4) | (data[pos + 2] << 12)
            pos += 3
        if lit_type == 0:
            payload = data[pos: pos + regen]
            if len(payload) != regen:
                raise FormatError("truncated raw literals")
            return "bytes", payload, regen, pos + regen
        return "bytes", bytes([data[pos]]) * regen, regen, pos + 1
    # Compressed (2) / Treeless (3)
    if size_format == 0:
        v = int.from_bytes(data[pos: pos + 3], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FF, v >> 14, pos + 3, False
    elif size_format == 1:
        v = int.from_bytes(data[pos: pos + 3], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FF, v >> 14, pos + 3, True
    elif size_format == 2:
        v = int.from_bytes(data[pos: pos + 4], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FFF, v >> 18, pos + 4, True
    else:
        v = int.from_bytes(data[pos: pos + 5], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FFFF, v >> 22, pos + 5, True
    end = pos + comp
    if lit_type == 2:
        weights, used = huffman.read_weights(data, pos)
        tid = hufreg.add(weights)
        frame_state["huf_tid"] = tid
        pos += used
    else:
        tid = frame_state.get("huf_tid")
        if tid is None:
            raise FormatError("treeless literals with no previous table")
        frame_state["huf_tid"] = tid
    lanes: list[_HufLane] = []
    if streams4:
        if end - pos < 6:
            raise FormatError("truncated 4-stream jump table")
        s1 = int.from_bytes(data[pos: pos + 2], "little")
        s2 = int.from_bytes(data[pos + 2: pos + 4], "little")
        s3 = int.from_bytes(data[pos + 4: pos + 6], "little")
        pos += 6
        s4 = end - pos - s1 - s2 - s3
        if s4 <= 0:
            raise FormatError("bad 4-stream sizes")
        per = (regen + 3) // 4
        counts = [per, per, per, regen - 3 * per]
        for sz, n_out in zip((s1, s2, s3, s4), counts):
            lanes.append(_HufLane(data[pos: pos + sz], n_out, tid))
            pos += sz
    else:
        lanes.append(_HufLane(data[pos: end], regen, tid))
        pos = end
    return "huf", lanes, regen, end


def _parse_seq_section(data: bytes, pos: int, end: int, frame_state: dict,
                       fsereg: _FseReg):
    """Parse a sequences section.  Returns (_BlockPlan fields dict)."""
    b0 = data[pos]
    if b0 < 128:
        n_seq, pos = b0, pos + 1
    elif b0 < 255:
        n_seq, pos = ((b0 - 128) << 8) | data[pos + 1], pos + 2
    else:
        n_seq = int.from_bytes(data[pos + 1: pos + 3], "little") + 0x7F00
        pos += 3
    if n_seq == 0:
        return dict(n_seq=0)
    modes = data[pos]
    if modes & 3:
        raise FormatError("reserved sequence-section mode bits set")
    pos += 1
    out: dict = dict(n_seq=n_seq)
    for kind, mode in (("ll", (modes >> 6) & 3), ("of", (modes >> 4) & 3),
                       ("ml", (modes >> 2) & 3)):
        if mode == 0:
            norm, tl = _PREDEF[kind]
            tid = fsereg.add_norm(kind, norm, tl)
        elif mode == 1:
            tid = fsereg.add_rle(kind, data[pos])
            tl = 0
            pos += 1
        elif mode == 2:
            norm, tl, used = fse.read_norm_counts(data, pos, _MAX_SYM[kind])
            max_log = {"ll": 9, "of": 8, "ml": 9}[kind]
            if tl > max_log:
                raise FormatError(f"{kind} accuracy log {tl} exceeds {max_log}")
            tid = fsereg.add_norm(kind, norm, tl)
            pos += used
        else:
            prev = frame_state.get(f"fse_{kind}")
            if prev is None:
                raise FormatError("repeat FSE mode with no previous table")
            tid, tl = prev
        frame_state[f"fse_{kind}"] = (tid, tl)
        out[f"{kind}_tid"] = tid
        out[f"{kind}_tl"] = tl
    out["seq_stream"] = data[pos:end]
    return out


def _parse_frame_impl(data: bytes, hufreg: _HufReg, fsereg: _FseReg,
                      expected_size: int | None = None) -> _FramePlan:
    fh = zf.parse_frame_header(data, 0)
    pos = fh.header_size
    blocks: list[_BlockPlan] = []
    frame_state: dict = {}
    while True:
        btype, bsize, last = zf.parse_block_header(data, pos)
        pos += 3
        if btype == 0:  # raw
            blocks.append(_BlockPlan(content=bsize,
                                     lit_direct=data[pos: pos + bsize]))
            pos += bsize
        elif btype == 1:  # RLE
            blocks.append(_BlockPlan(content=bsize,
                                     lit_direct=bytes([data[pos]]) * bsize))
            pos += 1
        else:  # compressed
            end = pos + bsize
            kind, payload, regen, pos = _parse_lit_section(
                data, pos, frame_state, hufreg)
            seq = _parse_seq_section(data, pos, end, frame_state, fsereg)
            bp = _BlockPlan(content=0, **seq)
            if kind == "bytes":
                bp.lit_direct = payload
            else:
                bp.huf_lanes = payload
            bp.content = -1  # resolved after sequence decode
            blocks.append(bp)
            pos = end
        if last:
            break
    cs = fh.content_size
    if cs is None:
        cs = expected_size
    if cs is None:
        raise FormatError("frame without content size needs expected_size")
    return _FramePlan(int(cs), blocks)


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def _read_at(win32u: jnp.ndarray, start: jnp.ndarray, nb: jnp.ndarray):
    """Extract bits [start, start+nb) per lane (nb <= 16, traced).  Bits
    below position 0 read as zero (backward-stream underflow semantics)."""
    s0 = jnp.maximum(start, 0)
    w = C.take1(win32u, s0 >> 3) >> (s0 & 7).astype(jnp.uint32)
    mask = (jnp.uint32(1) << nb.astype(jnp.uint32)) - 1
    v = w & mask
    under = jnp.clip(-start, 0, 31).astype(jnp.uint32)
    return jnp.where(start >= 0, v, (w << under) & mask).astype(jnp.int32)


def _read_wide(win32u, start, nb):
    """Bits [start, start+nb) for nb <= 31 via two 16-bit-max extractions."""
    nb_lo = jnp.minimum(nb, 16)
    nb_hi = nb - nb_lo
    lo = _read_at(win32u, start, nb_lo)
    hi = _read_at(win32u, start + 16, nb_hi)
    return lo | (hi << 16)


@partial(jax.jit, static_argnames=("out_cap", "unroll"))
def huf_decode_lanes(win32u: jnp.ndarray, total_bits: jnp.ndarray,
                     n_out: jnp.ndarray, tid: jnp.ndarray,
                     dtabs: jnp.ndarray, out_cap: int, unroll: int = 8):
    """Decode Huffman lanes (streams) symbol-at-a-time, lanes vectorized
    and `unroll` symbols per loop iteration (the dependent chain per symbol
    is short; loop bookkeeping dominates otherwise).

    win32u: (L, SB) uint32 LE byte windows of each stream; total_bits (L,);
    n_out (L,) symbols to produce; tid (L,) table ids into dtabs
    (T, 2^_HUF_PEEK) packed (nb << 8 | sym).  Returns (syms (L, out_cap)
    uint8, ok (L,))."""
    L = win32u.shape[0]
    flat = dtabs.reshape(-1)
    peek = jnp.full((L,), _HUF_PEEK, jnp.int32)
    u = unroll
    cap = out_cap + (-out_cap) % u

    def cond(state):
        t, pos, out = state
        return (t < cap) & jnp.any(t < n_out)

    def body(state):
        t, pos, out = state
        subs = []
        for k in range(u):
            active = t + k < n_out
            v = _read_at(win32u, pos - _HUF_PEEK, peek)
            ent = jnp.take(flat, tid * (1 << _HUF_PEEK) + v, mode="clip")
            nb = ent >> 8
            subs.append(jnp.where(active, ent & 255, 0).astype(jnp.uint8))
            pos = jnp.where(active, pos - nb, pos)
        block = jnp.stack(subs, axis=1)  # (L, u)
        out = jax.lax.dynamic_update_slice(out, block, (0, t))
        return t + u, pos, out

    out0 = jnp.zeros((L, cap), jnp.uint8)
    t, pos, out = jax.lax.while_loop(
        cond, body, (jnp.int32(0), total_bits, out0))
    return out[:, :out_cap], pos == 0   # exact consumption


@partial(jax.jit, static_argnames=("max_seqs", "unroll"))
def fse_decode_seq_lanes(win32u: jnp.ndarray, total_bits: jnp.ndarray,
                         n_seq: jnp.ndarray,
                         tids: jnp.ndarray, tls: jnp.ndarray,
                         tabs: jnp.ndarray, max_seqs: int, unroll: int = 4):
    """Decode sequence sections, lanes = blocks.

    tids/tls: (L, 3) int32 table ids / logs in order (LL, OF, ML) into tabs
    (T, 512) packed sym | nb<<8 | base<<16.  Repcodes are tagged:
    -(k * _REP_TAG + d) means frame-initial rep k minus d.  Returns
    (ll, ml, off) each (L, max_seqs) int32, rep_final (L, 3), ok (L,)."""
    L = win32u.shape[0]
    flat = tabs.reshape(-1)
    ll_bits_t = jnp.asarray(zf.LL_BITS, jnp.int32)
    ll_base_t = jnp.asarray(zf.LL_BASELINE, jnp.int32)
    ml_bits_t = jnp.asarray(zf.ML_BITS, jnp.int32)
    ml_base_t = jnp.asarray(zf.ML_BASELINE, jnp.int32)

    def ent(kind, state):
        return jnp.take(flat, tids[:, kind] * 512 + state, mode="clip")

    # init states: LL then OF then ML, each table_log bits from the top
    pos = total_bits
    s_ll = _read_at(win32u, pos - tls[:, 0], tls[:, 0])
    pos = pos - tls[:, 0]
    s_of = _read_at(win32u, pos - tls[:, 1], tls[:, 1])
    pos = pos - tls[:, 1]
    s_ml = _read_at(win32u, pos - tls[:, 2], tls[:, 2])
    pos = pos - tls[:, 2]

    r1 = jnp.full((L,), -(1 * _REP_TAG), jnp.int32)
    r2 = jnp.full((L,), -(2 * _REP_TAG), jnp.int32)
    r3 = jnp.full((L,), -(3 * _REP_TAG), jnp.int32)

    u = unroll
    cap = max_seqs + (-max_seqs) % u
    z = jnp.zeros((L, cap), jnp.int32)

    def cond(state):
        t = state[0]
        return (t < cap) & jnp.any(t < n_seq)

    def substep(t, pos, s_ll, s_of, s_ml, r1, r2, r3):
        active = t < n_seq
        e_ll, e_of, e_ml = ent(0, s_ll), ent(1, s_of), ent(2, s_ml)
        llc, ofc, mlc = e_ll & 255, e_of & 255, e_ml & 255
        # extras: OF then ML then LL (backward read of forward LL, ML, OF)
        of_extra = _read_wide(win32u, pos - ofc, ofc)
        pos = jnp.where(active, pos - ofc, pos)
        ofv = (jnp.int32(1) << jnp.minimum(ofc, 30)) + of_extra
        mlb = ml_bits_t[jnp.clip(mlc, 0, zf.MAX_ML_CODE)]
        ml = ml_base_t[jnp.clip(mlc, 0, zf.MAX_ML_CODE)] + \
            _read_at(win32u, pos - mlb, mlb)
        pos = jnp.where(active, pos - mlb, pos)
        llb = ll_bits_t[jnp.clip(llc, 0, zf.MAX_LL_CODE)]
        ll = ll_base_t[jnp.clip(llc, 0, zf.MAX_LL_CODE)] + \
            _read_at(win32u, pos - llb, llb)
        pos = jnp.where(active, pos - llb, pos)
        # repcode resolution (tagged)
        idx = ofv + (ll == 0)
        off = jnp.where(ofv > 3, ofv - 3,
                        jnp.where(idx == 1, r1,
                                  jnp.where(idx == 2, r2,
                                            jnp.where(idx == 3, r3, r1 - 1))))
        n_r1 = off
        n_r2 = jnp.where(ofv > 3, r1, jnp.where(idx == 1, r2, r1))
        n_r3 = jnp.where(ofv > 3, r2,
                         jnp.where(idx == 1, r3,
                                   jnp.where(idx == 2, r3, r2)))
        r1 = jnp.where(active, n_r1, r1)
        r2 = jnp.where(active, n_r2, r2)
        r3 = jnp.where(active, n_r3, r3)
        # state updates (skipped for the last sequence): LL, ML, OF
        upd = active & (t < n_seq - 1)
        nb_ll = (e_ll >> 8) & 255
        s_ll_n = (e_ll >> 16) + _read_at(win32u, pos - nb_ll, nb_ll)
        pos = jnp.where(upd, pos - nb_ll, pos)
        nb_ml = (e_ml >> 8) & 255
        s_ml_n = (e_ml >> 16) + _read_at(win32u, pos - nb_ml, nb_ml)
        pos = jnp.where(upd, pos - nb_ml, pos)
        nb_of = (e_of >> 8) & 255
        s_of_n = (e_of >> 16) + _read_at(win32u, pos - nb_of, nb_of)
        pos = jnp.where(upd, pos - nb_of, pos)
        s_ll = jnp.where(upd, s_ll_n, s_ll)
        s_ml = jnp.where(upd, s_ml_n, s_ml)
        s_of = jnp.where(upd, s_of_n, s_of)
        emit = (jnp.where(active, ll, 0), jnp.where(active, ml, 0),
                jnp.where(active, off, 0))
        return pos, s_ll, s_of, s_ml, r1, r2, r3, emit

    def body(state):
        (t, pos, s_ll, s_of, s_ml, r1, r2, r3, lls, mls, offs) = state
        emits = []
        for k in range(u):
            pos, s_ll, s_of, s_ml, r1, r2, r3, emit = substep(
                t + k, pos, s_ll, s_of, s_ml, r1, r2, r3)
            emits.append(emit)
        lls = jax.lax.dynamic_update_slice(
            lls, jnp.stack([e[0] for e in emits], axis=1), (0, t))
        mls = jax.lax.dynamic_update_slice(
            mls, jnp.stack([e[1] for e in emits], axis=1), (0, t))
        offs = jax.lax.dynamic_update_slice(
            offs, jnp.stack([e[2] for e in emits], axis=1), (0, t))
        return (t + u, pos, s_ll, s_of, s_ml, r1, r2, r3, lls, mls, offs)

    state = (jnp.int32(0), pos, s_ll, s_of, s_ml, r1, r2, r3, z, z, z)
    (t, pos, s_ll, s_of, s_ml, r1, r2, r3, lls, mls, offs) = \
        jax.lax.while_loop(cond, body, state)
    lls, mls, offs = lls[:, :max_seqs], mls[:, :max_seqs], offs[:, :max_seqs]
    rep_final = jnp.stack([r1, r2, r3], axis=1)
    ok = pos == 0   # exact consumption (ADVICE r2)
    return lls, mls, offs, rep_final, ok


def _read_at_rows(win_flat: jnp.ndarray, SB: int, sid: jnp.ndarray,
                  start: jnp.ndarray, nb: jnp.ndarray):
    """_read_at against a flattened (NS, SB) window bank indexed per lane by
    sid — lets many anchor-chunk lanes share one stream's bytes."""
    s0 = jnp.maximum(start, 0)
    idx = sid * SB + jnp.minimum(s0 >> 3, SB - 1)
    w = jnp.take(win_flat, idx, mode="clip") >> (s0 & 7).astype(jnp.uint32)
    mask = (jnp.uint32(1) << nb.astype(jnp.uint32)) - 1
    v = w & mask
    under = jnp.clip(-start, 0, 31).astype(jnp.uint32)
    return jnp.where(start >= 0, v, (w << under) & mask).astype(jnp.int32)


def _read_wide_rows(win_flat, SB, sid, start, nb):
    nb_lo = jnp.minimum(nb, 16)
    nb_hi = nb - nb_lo
    lo = _read_at_rows(win_flat, SB, sid, start, nb_lo)
    hi = _read_at_rows(win_flat, SB, sid, start + 16, nb_hi)
    return lo | (hi << 16)


@partial(jax.jit, static_argnames=("chunk_cap", "unroll"))
def huf_decode_anchored(win_flat: jnp.ndarray, SB: int, lane_sid: jnp.ndarray,
                        lane_bits: jnp.ndarray, lane_n: jnp.ndarray,
                        lane_tid: jnp.ndarray, dtabs: jnp.ndarray,
                        chunk_cap: int, unroll: int = 8):
    """Anchored Huffman decode: every lane is an A-symbol chunk of some
    stream, starting at an exact anchor bit position (format/hints.py) —
    the serial symbol walk shrinks from stream length to chunk length.

    win_flat: (NS*SB,) uint32 flattened stream windows; lane_sid (L,) maps
    lanes to streams; lane_bits (L,) anchor positions; lane_n (L,) symbols
    to produce (<= chunk_cap).  Returns (syms (L, chunk_cap) uint8, ok)."""
    L = lane_sid.shape[0]
    flat = dtabs.reshape(-1)
    peek = jnp.full((L,), _HUF_PEEK, jnp.int32)
    u = unroll
    cap = chunk_cap + (-chunk_cap) % u

    def cond(state):
        t, pos, out = state
        return (t < cap) & jnp.any(t < lane_n)

    def body(state):
        t, pos, out = state
        subs = []
        for k in range(u):
            active = t + k < lane_n
            v = _read_at_rows(win_flat, SB, lane_sid, pos - _HUF_PEEK, peek)
            ent = jnp.take(flat, lane_tid * (1 << _HUF_PEEK) + v, mode="clip")
            nb = ent >> 8
            subs.append(jnp.where(active, ent & 255, 0).astype(jnp.uint8))
            pos = jnp.where(active, pos - nb, pos)
        out = jax.lax.dynamic_update_slice(out, jnp.stack(subs, axis=1),
                                           (0, t))
        return t + u, pos, out

    out0 = jnp.zeros((L, cap), jnp.uint8)
    t, pos, out = jax.lax.while_loop(
        cond, body, (jnp.int32(0), lane_bits, out0))
    return out[:, :chunk_cap], pos >= 0


@partial(jax.jit, static_argnames=("chunk_cap", "unroll"))
def fse_decode_anchored(win_flat: jnp.ndarray, SB: int, lane_bid: jnp.ndarray,
                        lane_bits: jnp.ndarray, lane_n: jnp.ndarray,
                        lane_states: jnp.ndarray, lane_rep1: jnp.ndarray,
                        tids: jnp.ndarray, tabs: jnp.ndarray,
                        chunk_cap: int, unroll: int = 4):
    """Anchored sequence decode: lanes are A-sequence chunks with exact
    (bit position, tANS states, rep1) checkpoints from the encoder.  Only
    valid for streams our encoder produced (predefined tables; repcodes
    restricted to rep1-with-literals), which is what the hints sidecar
    asserts.  lane_states: (L, 3) int32 (LL, OF, ML); tids: (L, 3) table
    ids into tabs (T, 512).  Returns (ll, ml, off) each (L, chunk_cap)."""
    L = lane_bid.shape[0]
    flat = tabs.reshape(-1)
    ll_bits_t = jnp.asarray(zf.LL_BITS, jnp.int32)
    ll_base_t = jnp.asarray(zf.LL_BASELINE, jnp.int32)
    ml_bits_t = jnp.asarray(zf.ML_BITS, jnp.int32)
    ml_base_t = jnp.asarray(zf.ML_BASELINE, jnp.int32)

    def ent(kind, state):
        return jnp.take(flat, tids[:, kind] * 512 + state, mode="clip")

    u = unroll
    cap = chunk_cap + (-chunk_cap) % u
    z = jnp.zeros((L, cap), jnp.int32)

    def cond(state):
        return (state[0] < cap) & jnp.any(state[0] < lane_n)

    def substep(t, pos, s_ll, s_of, s_ml, r1):
        active = t < lane_n
        e_ll, e_of, e_ml = ent(0, s_ll), ent(1, s_of), ent(2, s_ml)
        llc, ofc, mlc = e_ll & 255, e_of & 255, e_ml & 255
        of_extra = _read_wide_rows(win_flat, SB, lane_bid, pos - ofc, ofc)
        pos = jnp.where(active, pos - ofc, pos)
        ofv = (jnp.int32(1) << jnp.minimum(ofc, 30)) + of_extra
        mlb = ml_bits_t[jnp.clip(mlc, 0, zf.MAX_ML_CODE)]
        ml = ml_base_t[jnp.clip(mlc, 0, zf.MAX_ML_CODE)] + \
            _read_at_rows(win_flat, SB, lane_bid, pos - mlb, mlb)
        pos = jnp.where(active, pos - mlb, pos)
        llb = ll_bits_t[jnp.clip(llc, 0, zf.MAX_LL_CODE)]
        ll = ll_base_t[jnp.clip(llc, 0, zf.MAX_LL_CODE)] + \
            _read_at_rows(win_flat, SB, lane_bid, pos - llb, llb)
        pos = jnp.where(active, pos - llb, pos)
        off = jnp.where(ofv > 3, ofv - 3, r1)  # our streams: ofv>3 or rep1
        r1 = jnp.where(active, off, r1)
        upd = active & (t < lane_n - 1)
        nb_ll = (e_ll >> 8) & 255
        s_ll_n = (e_ll >> 16) + _read_at_rows(win_flat, SB, lane_bid,
                                              pos - nb_ll, nb_ll)
        pos = jnp.where(upd, pos - nb_ll, pos)
        nb_ml = (e_ml >> 8) & 255
        s_ml_n = (e_ml >> 16) + _read_at_rows(win_flat, SB, lane_bid,
                                              pos - nb_ml, nb_ml)
        pos = jnp.where(upd, pos - nb_ml, pos)
        nb_of = (e_of >> 8) & 255
        s_of_n = (e_of >> 16) + _read_at_rows(win_flat, SB, lane_bid,
                                              pos - nb_of, nb_of)
        pos = jnp.where(upd, pos - nb_of, pos)
        s_ll = jnp.where(upd, s_ll_n, s_ll)
        s_ml = jnp.where(upd, s_ml_n, s_ml)
        s_of = jnp.where(upd, s_of_n, s_of)
        emit = (jnp.where(active, ll, 0), jnp.where(active, ml, 0),
                jnp.where(active, off, 0))
        return pos, s_ll, s_of, s_ml, r1, emit

    def body(state):
        t, pos, s_ll, s_of, s_ml, r1, lls, mls, offs = state
        emits = []
        for k in range(u):
            pos, s_ll, s_of, s_ml, r1, emit = substep(
                t + k, pos, s_ll, s_of, s_ml, r1)
            emits.append(emit)
        lls = jax.lax.dynamic_update_slice(
            lls, jnp.stack([e[0] for e in emits], axis=1), (0, t))
        mls = jax.lax.dynamic_update_slice(
            mls, jnp.stack([e[1] for e in emits], axis=1), (0, t))
        offs = jax.lax.dynamic_update_slice(
            offs, jnp.stack([e[2] for e in emits], axis=1), (0, t))
        return (t + u, pos, s_ll, s_of, s_ml, r1, lls, mls, offs)

    state = (jnp.int32(0), lane_bits, lane_states[:, 0], lane_states[:, 1],
             lane_states[:, 2], lane_rep1, z, z, z)
    out = jax.lax.while_loop(cond, body, state)
    lls, mls, offs = out[6], out[7], out[8]
    return (lls[:, :chunk_cap], mls[:, :chunk_cap], offs[:, :chunk_cap],
            out[1] >= 0)


@partial(jax.jit, static_argnames=("out_size",))
def execute_sequences(pool: jnp.ndarray, lit_src, lit_len, lit_dst,
                      m_off, m_len, m_dst, out_size: int):
    """Frame-wide LZ sequence execution (literal scatter + pointer-doubled
    back-reference chains).  pool: (B, P) uint8 literal bytes; the six
    sequence arrays are (B, S) int32.  Returns (out (B, out_size), ok)."""
    B, P = pool.shape
    S = lit_src.shape[1]
    F = out_size
    seq_valid = lit_len > 0
    is_lit_src = C.fill_regions(P, lit_src, lit_src + lit_len, seq_valid)
    src_region = C.region_index(P, lit_src, seq_valid)
    lr_rank = jnp.cumsum(seq_valid.astype(jnp.int32), axis=1) - 1
    lit_src_tab = C.scatter1_set(jnp.zeros((B, S), jnp.int32), lr_rank,
                                 lit_src, seq_valid)
    lit_dst_tab = C.scatter1_set(jnp.zeros((B, S), jnp.int32), lr_rank,
                                 lit_dst, seq_valid)
    jpos = jnp.broadcast_to(np.arange(P, dtype=np.int32)[None, :], (B, P))
    ldst = C.take1(lit_dst_tab, src_region) + \
        (jpos - C.take1(lit_src_tab, src_region))
    val_layer = jnp.zeros((B, F), jnp.int32)
    val_layer = C.scatter1_set(val_layer, ldst, pool.astype(jnp.int32),
                               is_lit_src)
    m_valid = m_len > 0
    in_match = C.fill_regions(F, m_dst, m_dst + m_len, m_valid)
    m_region = C.region_index(F, m_dst, m_valid)
    mr_rank = jnp.cumsum(m_valid.astype(jnp.int32), axis=1) - 1
    m_off_tab = C.scatter1_set(jnp.ones((B, S), jnp.int32), mr_rank,
                               m_off, m_valid)
    ipos = jnp.broadcast_to(np.arange(F, dtype=np.int32)[None, :], (B, F))
    ref = ipos - C.take1(m_off_tab, m_region)
    bad = jnp.any(in_match & (ref < 0), axis=1)
    src0 = jnp.where(in_match, jnp.clip(ref, 0, F - 1), ipos)
    rounds = max(1, int(math.ceil(math.log2(max(2, F)))))
    src_final = C.resolve_copy_chains(src0, rounds)
    out = C.take1(val_layer, src_final).astype(jnp.uint8)
    return out, ~bad


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

def _ceil_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _resolve_tags(vals: np.ndarray, reps: np.ndarray) -> np.ndarray:
    """Replace tagged rep values -(k*_REP_TAG + d) with reps[k-1] - d."""
    tagged = vals < 0
    if not tagged.any():
        return vals
    enc = -vals[tagged]
    k = enc // _REP_TAG
    d = enc % _REP_TAG
    out = vals.copy()
    out[tagged] = reps[k - 1] - d
    return out


def _frame_hints_usable(plan: _FramePlan, fh) -> bool:
    """Hints apply only when every compressed block of the frame has them
    (our encoder's output) — mixing anchored and tagged-rep blocks would
    break the cross-block repcode chain."""
    if fh is None:
        return False
    comp_blocks = [bp for bp in plan.blocks if bp.huf_lanes or bp.n_seq > 0]
    if len(fh) != len(plan.blocks):
        return False
    for bp, bh in zip(plan.blocks, fh):
        if not (bp.huf_lanes or bp.n_seq > 0):
            continue
        if bh is None:
            return False
        if bp.huf_lanes and (bh.lit is None or bh.lit.interval <= 0 or
                             len(bh.lit.bitpos) != len(bp.huf_lanes)):
            return False
        if bp.n_seq > 0 and (bh.seq is None or bh.seq.interval <= 0):
            return False
    return True


def _init_seq_states(stream: bytes, tls=(6, 5, 6)):
    """Host-side read of the three initial tANS states.  tls = the block's
    per-stream accuracy logs (LL, OF, ML): an RLE-mode stream has log 0 —
    no initial-state bits and a constant state 0."""
    total = _sentinel_bits(stream)
    val = int.from_bytes(stream, "little")
    pos = total
    states = []
    for log in tls:
        if log:
            states.append((val >> (pos - log)) & ((1 << log) - 1))
            pos -= log
        else:
            states.append(0)
    return pos, tuple(states)



def decode_frames(datas: list[bytes], d_sizes: list[int] | None = None,
                  hints: list | None = None, to_device: bool = False):
    """Decode a batch of zstd frames to their uncompressed bytes.

    hints: optional per-frame decode-anchor lists (format/hints.py) — when
    present and consistent, Huffman/FSE streams decode as anchored chunk
    lanes instead of full-stream serial walks.

    to_device: return per-frame DEVICE uint8 arrays instead of host bytes —
    the decompressed frame never crosses to the host (device-resident frame
    cache / bounded-host-memory pread; the reference's equivalent is the
    stream-and-discard no-cache path, /root/reference/src/decompress.c:
    377-468, whose host footprint is window-bounded)."""
    if not datas:
        return []
    if d_sizes is None:
        d_sizes = [None] * len(datas)
    if hints is None:
        hints = [None] * len(datas)
    hufreg, fsereg = _HufReg(), _FseReg()
    plans = [_parse_frame_impl(d, hufreg, fsereg, sz)
             for d, sz in zip(datas, d_sizes)]

    use_hints = [_frame_hints_usable(p, fh) for p, fh in zip(plans, hints)]
    hint_of_block: dict[int, object] = {}
    anchored: set[int] = set()
    for p, fh, uh in zip(plans, hints, use_hints):
        for bi, bp in enumerate(p.blocks):
            if uh:
                hint_of_block[id(bp)] = fh[bi]
                anchored.add(id(bp))

    # --- device pass A: huffman literal lanes ---
    lanes: list[_HufLane] = []
    for bp in (b for p in plans for b in p.blocks):
        if bp.huf_lanes and id(bp) not in anchored:
            lanes.extend(bp.huf_lanes)
    lit_bytes_of_lane: dict[int, np.ndarray] = {}
    if lanes:
        SB = max(4, _ceil_pow2(max(len(l.stream) for l in lanes) + 4))
        cap = max(1, _ceil_pow2(max(l.n_out for l in lanes)))
        streams = np.zeros((len(lanes), SB), np.uint8)
        tb = np.zeros(len(lanes), np.int32)
        nout = np.zeros(len(lanes), np.int32)
        tid = np.zeros(len(lanes), np.int32)
        for i, l in enumerate(lanes):
            streams[i, : len(l.stream)] = np.frombuffer(l.stream, np.uint8)
            tb[i] = _sentinel_bits(l.stream)
            nout[i] = l.n_out
            tid[i] = l.tid
        syms, ok = huf_decode_lanes(
            jnp.asarray(_win32(streams)), jnp.asarray(tb), jnp.asarray(nout),
            jnp.asarray(tid), jnp.asarray(hufreg.packed()), cap)
        syms = np.asarray(syms)
        if not np.asarray(ok).all():
            raise FormatError("huffman literal stream underflow")
        for i, l in enumerate(lanes):
            lit_bytes_of_lane[id(l)] = syms[i, : l.n_out]

    # --- device pass A': anchored huffman chunks ---
    a_blocks = [bp for p in plans for bp in p.blocks
                if bp.huf_lanes and id(bp) in anchored]
    if a_blocks:
        a_streams: list[_HufLane] = []
        chunks: list[tuple[int, int, int, int]] = []  # (sid, bits, n, tid)
        stream_chunks: list[tuple[int, int]] = []     # (first_chunk, count)
        A = 0
        for bp in a_blocks:
            bh = hint_of_block[id(bp)]
            Ab = bh.lit.interval
            A = max(A, Ab)
            for s, lane in enumerate(bp.huf_lanes):
                sid = len(a_streams)
                a_streams.append(lane)
                first = len(chunks)
                n_chunks = max(1, -(-lane.n_out // Ab))
                for k in range(n_chunks):
                    bits = (_sentinel_bits(lane.stream) if k == 0
                            else bh.lit.bitpos[s][k - 1])
                    n = min(Ab, lane.n_out - k * Ab)
                    chunks.append((sid, bits, n, lane.tid))
                stream_chunks.append((first, n_chunks))
        NS = len(a_streams)
        SB = max(4, _ceil_pow2(max(len(l.stream) for l in a_streams) + 4))
        sbuf = np.zeros((NS, SB), np.uint8)
        for i, l in enumerate(a_streams):
            sbuf[i, : len(l.stream)] = np.frombuffer(l.stream, np.uint8)
        L = _ceil_pow2(len(chunks))
        c_sid = np.zeros(L, np.int32)
        c_bits = np.zeros(L, np.int32)
        c_n = np.zeros(L, np.int32)
        c_tid = np.zeros(L, np.int32)
        for i, (sid, bits, n, tid_) in enumerate(chunks):
            c_sid[i], c_bits[i], c_n[i], c_tid[i] = sid, bits, n, tid_
        syms, ok = huf_decode_anchored(
            jnp.asarray(_win32(sbuf).reshape(-1)), SB, jnp.asarray(c_sid),
            jnp.asarray(c_bits), jnp.asarray(c_n), jnp.asarray(c_tid),
            jnp.asarray(hufreg.packed()), A)
        if not np.asarray(ok)[: len(chunks)].all():
            raise FormatError("anchored huffman stream underflow")
        syms = np.asarray(syms)
        si = 0
        for bp in a_blocks:
            for lane in bp.huf_lanes:
                first, cnt = stream_chunks[si]
                si += 1
                parts = [syms[first + k, : chunks[first + k][2]]
                         for k in range(cnt)]
                lit_bytes_of_lane[id(lane)] = np.concatenate(parts) \
                    if parts else np.zeros(0, np.uint8)

    # --- device pass B: sequence sections ---
    seq_blocks = [bp for p in plans for bp in p.blocks
                  if bp.n_seq > 0 and id(bp) not in anchored]
    seq_results: dict[int, tuple] = {}
    if seq_blocks:
        SB = max(4, _ceil_pow2(max(len(bp.seq_stream) for bp in seq_blocks) + 4))
        smax = max(1, _ceil_pow2(max(bp.n_seq for bp in seq_blocks)))
        L = len(seq_blocks)
        streams = np.zeros((L, SB), np.uint8)
        tb = np.zeros(L, np.int32)
        ns = np.zeros(L, np.int32)
        tids = np.zeros((L, 3), np.int32)
        tls = np.zeros((L, 3), np.int32)
        for i, bp in enumerate(seq_blocks):
            streams[i, : len(bp.seq_stream)] = np.frombuffer(bp.seq_stream,
                                                             np.uint8)
            tb[i] = _sentinel_bits(bp.seq_stream)
            ns[i] = bp.n_seq
            tids[i] = (bp.ll_tid, bp.of_tid, bp.ml_tid)
            tls[i] = (bp.ll_tl, bp.of_tl, bp.ml_tl)
        lls, mls, offs, rep_fin, ok = fse_decode_seq_lanes(
            jnp.asarray(_win32(streams)), jnp.asarray(tb), jnp.asarray(ns),
            jnp.asarray(tids), jnp.asarray(tls),
            jnp.asarray(fsereg.packed()), smax)
        lls, mls, offs = np.asarray(lls), np.asarray(mls), np.asarray(offs)
        rep_fin = np.asarray(rep_fin)
        if not np.asarray(ok).all():
            raise FormatError("sequence bitstream underflow")
        for i, bp in enumerate(seq_blocks):
            seq_results[id(bp)] = (lls[i, : bp.n_seq], mls[i, : bp.n_seq],
                                   offs[i, : bp.n_seq], rep_fin[i])

    # --- device pass B': anchored sequence chunks ---
    sa_blocks = [bp for p in plans for bp in p.blocks
                 if bp.n_seq > 0 and id(bp) in anchored]
    if sa_blocks:
        chunks2: list[tuple] = []       # (bid, bits, n, states, rep1)
        block_chunks: list[tuple[int, int]] = []
        A = 0
        for bi, bp in enumerate(sa_blocks):
            bh = hint_of_block[id(bp)]
            Ab = bh.seq.interval
            A = max(A, Ab)
            btls = (bp.ll_tl, bp.of_tl, bp.ml_tl)
            pos0, st0 = _init_seq_states(bp.seq_stream, btls)
            first = len(chunks2)
            n_chunks = max(1, -(-bp.n_seq // Ab))
            for k in range(n_chunks):
                if k == 0:
                    bits, st, r1 = pos0, st0, 1
                else:
                    bits = bh.seq.bitpos[k - 1]
                    # an RLE stream's state is identically 0 (its hint
                    # slot holds the encoder's internal masked-walk state)
                    st = tuple(v if tl else 0 for v, tl in
                               zip(bh.seq.states[k - 1], btls))
                    r1 = bh.seq.rep1[k - 1] if hasattr(bh.seq, "rep1") else 1
                chunks2.append((bi, bits, min(Ab, bp.n_seq - k * Ab), st, r1))
            block_chunks.append((first, n_chunks))
        NB = len(sa_blocks)
        SB = max(4, _ceil_pow2(max(len(bp.seq_stream)
                                   for bp in sa_blocks) + 4))
        sbuf = np.zeros((NB, SB), np.uint8)
        for i, bp in enumerate(sa_blocks):
            sbuf[i, : len(bp.seq_stream)] = np.frombuffer(bp.seq_stream,
                                                          np.uint8)
        L = _ceil_pow2(len(chunks2))
        c_bid = np.zeros(L, np.int32)
        c_bits = np.zeros(L, np.int32)
        c_n = np.zeros(L, np.int32)
        c_states = np.zeros((L, 3), np.int32)
        c_rep1 = np.ones(L, np.int32)
        c_tids = np.zeros((L, 3), np.int32)
        for i, (bi, bits, n, st, r1) in enumerate(chunks2):
            bp = sa_blocks[bi]
            c_bid[i], c_bits[i], c_n[i] = bi, bits, n
            c_states[i] = st
            c_rep1[i] = r1
            c_tids[i] = (bp.ll_tid, bp.of_tid, bp.ml_tid)
        lls, mls, offs, ok = fse_decode_anchored(
            jnp.asarray(_win32(sbuf).reshape(-1)), SB, jnp.asarray(c_bid),
            jnp.asarray(c_bits), jnp.asarray(c_n), jnp.asarray(c_states),
            jnp.asarray(c_rep1), jnp.asarray(c_tids),
            jnp.asarray(fsereg.packed()), A)
        lls, mls, offs = np.asarray(lls), np.asarray(mls), np.asarray(offs)
        if not np.asarray(ok)[: len(chunks2)].all():
            raise FormatError("anchored sequence stream underflow")
        for bi, bp in enumerate(sa_blocks):
            first, cnt = block_chunks[bi]
            ll = np.concatenate([lls[first + k, : chunks2[first + k][2]]
                                 for k in range(cnt)])
            ml = np.concatenate([mls[first + k, : chunks2[first + k][2]]
                                 for k in range(cnt)])
            off = np.concatenate([offs[first + k, : chunks2[first + k][2]]
                                  for k in range(cnt)])
            seq_results[id(bp)] = (ll, ml, off,
                                   np.array([1, 4, 8], np.int32))

    # --- host: per-block records (lengths + sequences) ---
    def _lit_len(bp):
        if bp.huf_lanes:
            return sum(l.n_out for l in bp.huf_lanes)
        if bp.lit_direct is not None:
            return len(bp.lit_direct)
        return 0

    block_recs = []   # (frame_idx, bp, lit_len, ll, ml, off, content, d_off)
    for fi_, p in enumerate(plans):
        d_off_run = 0
        reps = np.array([1, 4, 8], np.int64)
        for bp in p.blocks:
            ln = _lit_len(bp)
            if bp.n_seq > 0:
                ll, ml, off = seq_results[id(bp)][:3]
                off = _resolve_tags(off.astype(np.int64), reps)
                reps = _resolve_tags(
                    seq_results[id(bp)][3].astype(np.int64), reps)
                if (off <= 0).any():
                    raise FormatError("non-positive match offset")
                covered = int(ll.sum() + ml.sum())
                trailing = ln - int(ll.sum())
                if trailing < 0:
                    raise FormatError("literal pool underrun")
                bp.content = covered + trailing
                b_ll, b_ml = ll, ml
                b_off = off.astype(np.int32)
            else:
                bp.content = ln
                b_ll = b_ml = b_off = np.zeros(0, np.int32)
            block_recs.append((fi_, bp, ln, b_ll, b_ml, b_off, bp.content,
                               d_off_run))
            d_off_run += bp.content
        if d_off_run != p.content_size:
            raise FormatError(
                f"frame regenerated {d_off_run} != declared "
                f"{p.content_size}")

    # --- device pass C: pointer-doubling execution over per-frame pools ---
    frames_exec = []
    rec_i = 0
    for fi_, p in enumerate(plans):
        pool_parts: list[np.ndarray] = []
        lit_src_l, lit_len_l, lit_dst_l = [], [], []
        m_off_l, m_len_l, m_dst_l = [], [], []
        pool_pos = 0
        out_pos = 0
        for bp in p.blocks:
            rec = block_recs[rec_i]
            rec_i += 1
            _, _, ln, b_ll, b_ml, b_off, content, d_off = rec[:8]
            if bp.huf_lanes:
                lits = np.concatenate(
                    [lit_bytes_of_lane[id(l)] for l in bp.huf_lanes])
            elif bp.lit_direct is not None:
                lits = np.frombuffer(bp.lit_direct, np.uint8)
            else:
                lits = np.zeros(0, np.uint8)
            pool_parts.append(lits)
            ns = len(b_ll)
            if ns > 0:
                ll, ml, off = b_ll, b_ml, b_off
                lsrc = pool_pos + np.cumsum(ll) - ll
                ldst = out_pos + np.cumsum(ll + ml) - (ll + ml)
                mdst = ldst + ll
                lit_src_l.append(lsrc)
                lit_len_l.append(ll)
                lit_dst_l.append(ldst)
                m_off_l.append(off)
                m_len_l.append(ml)
                m_dst_l.append(mdst)
                consumed_lits = int(ll.sum())
                covered = int(ll.sum() + ml.sum())
            else:
                consumed_lits = 0
                covered = 0
            trail = content - covered
            if trail > 0:
                lit_src_l.append(np.array([pool_pos + consumed_lits]))
                lit_len_l.append(np.array([trail]))
                lit_dst_l.append(np.array([out_pos + covered]))
                m_off_l.append(np.array([1]))
                m_len_l.append(np.array([0]))
                m_dst_l.append(np.array([out_pos + content]))
            pool_pos += consumed_lits + max(0, trail)
            out_pos += content
        pool = (np.concatenate(pool_parts) if pool_parts
                else np.zeros(0, np.uint8))
        cat = lambda ls: (np.concatenate(ls).astype(np.int32) if ls
                          else np.zeros(0, np.int32))
        frames_exec.append((pool, cat(lit_src_l), cat(lit_len_l),
                            cat(lit_dst_l), cat(m_off_l), cat(m_len_l),
                            cat(m_dst_l), out_pos))

    B = len(frames_exec)
    F = max(1, _ceil_pow2(max(fe[7] for fe in frames_exec)))
    P = max(1, _ceil_pow2(max(len(fe[0]) for fe in frames_exec)))
    S = max(1, _ceil_pow2(max(len(fe[1]) for fe in frames_exec)))
    pool = np.zeros((B, P), np.uint8)
    arrs = [np.zeros((B, S), np.int32) for _ in range(6)]
    for i, fe in enumerate(frames_exec):
        pool[i, : len(fe[0])] = fe[0]
        for k in range(6):
            arrs[k][i, : len(fe[k + 1])] = fe[k + 1]
    out, ok = execute_sequences(jnp.asarray(pool),
                                *[jnp.asarray(a) for a in arrs], F)
    if not np.asarray(ok).all():
        raise FormatError("match offset before frame start")
    if to_device:
        return [out[i, : fe[7]] for i, fe in enumerate(frames_exec)]
    out = np.asarray(out)
    return [out[i, : fe[7]].tobytes() for i, fe in enumerate(frames_exec)]
