"""Huffman coding for zstd literals (RFC 8878 §4.2) — table logic.

Host-side: code-length assignment (package-merge, optimal length-limited),
zstd canonical code values, weight (de)serialization including FSE-compressed
weights.  The per-byte encode/decode bit work runs on device in
zstd_encode/zstd_decode; these tables drive it.

zstd conventions: weight = maxBits + 1 - codeLength for used symbols (0 =
unused); sum of 2^(weight-1) must equal 2^maxBits; the last present symbol's
weight is implied.  Codes are assigned longest-first in symbol order
(HUF_buildCTable's valPerRank scheme).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from libzseek_jax.errors import FormatError
from libzseek_jax.ops import fse

MAX_BITS = 11


def code_lengths(counts: np.ndarray, max_bits: int = MAX_BITS) -> np.ndarray:
    """Optimal length-limited code lengths via package-merge.
    counts: (256,) histogram.  Returns (256,) lengths (0 = unused)."""
    syms = np.nonzero(counts)[0]
    n = len(syms)
    lengths = np.zeros(256, np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    freqs = counts[syms].astype(np.int64)
    # package-merge (Larmore-Hirschberg): list_1 = base;
    # list_j = merge(base, package(list_{j-1})) for j = 2..max_bits;
    # select the 2n-2 cheapest items of list_max_bits — a symbol's code
    # length is its number of inclusions.  Exactly max_bits-1 package
    # steps: one more would admit codes of length max_bits+1.
    base = sorted((int(f), [i]) for i, f in enumerate(freqs))
    lst = list(base)
    for _ in range(max_bits - 1):
        packaged = []
        for k in range(0, len(lst) - 1, 2):
            w = lst[k][0] + lst[k + 1][0]
            packaged.append((w, lst[k][1] + lst[k + 1][1]))
        lst = sorted(packaged + base)
    lcount = np.zeros(n, np.int64)
    for _, symlist in lst[: 2 * (n - 1)]:
        for i in symlist:
            lcount[i] += 1
    lengths[syms] = lcount
    return lengths


def _kraft(lengths: np.ndarray) -> float:
    used = lengths[lengths > 0]
    return float(np.sum(2.0 ** (-used.astype(np.float64))))


@dataclasses.dataclass
class CTable:
    lengths: np.ndarray   # (256,) int32, 0 = unused
    codes: np.ndarray     # (256,) int32
    max_bits: int

    @property
    def weights(self) -> np.ndarray:
        w = np.zeros(256, np.int32)
        used = self.lengths > 0
        w[used] = self.max_bits + 1 - self.lengths[used]
        return w


def _canonical_codes(lengths: np.ndarray) -> CTable:
    """zstd canonical value assignment (HUF_buildCTable valPerRank scheme):
    longest codes first, symbol order within a length."""
    max_used = int(lengths.max())
    nb_per_rank = np.bincount(lengths[lengths > 0], minlength=max_used + 1)
    val_per_rank = np.zeros(max_used + 2, np.int64)
    mn = 0
    for nb in range(max_used, 0, -1):
        val_per_rank[nb] = mn
        mn += int(nb_per_rank[nb])
        mn >>= 1
    codes = np.zeros(256, np.int64)
    cursor = val_per_rank.copy()
    for s in range(256):
        l = lengths[s]
        if l > 0:
            codes[s] = cursor[l]
            cursor[l] += 1
    return CTable(lengths, codes.astype(np.int32), max_used)


def build_ctable(counts: np.ndarray, max_bits: int = MAX_BITS) -> CTable:
    return _canonical_codes(code_lengths(counts, max_bits))


def ctable_from_weights(weights: np.ndarray) -> CTable:
    """Rebuild the canonical code table from decoded weights (read_weights
    output, implied last weight included) — the decode-side counterpart of
    build_ctable, exact per HUF_readDTableX2."""
    weights = np.asarray(weights, np.int32)
    total = int(np.sum(np.where(weights > 0, 1 << (weights - 1), 0)))
    if total <= 0 or total & (total - 1):
        raise FormatError("huffman weight sum is not a power of two")
    max_bits = int(np.log2(total))
    lengths = np.zeros(256, np.int32)
    used = weights > 0
    lengths[: len(weights)][used] = max_bits + 1 - weights[used]
    return _canonical_codes(lengths)


def build_dtable(ct: CTable) -> np.ndarray:
    """(2^max_bits,) int32 decode table: entry = (nb_bits << 8) | symbol,
    indexed by the max_bits-bit MSB-first peek of the backward bitstream."""
    tl = ct.max_bits
    dt = np.zeros(1 << tl, np.int32)
    for s in range(256):
        l = int(ct.lengths[s])
        if l > 0:
            start = int(ct.codes[s]) << (tl - l)
            dt[start: start + (1 << (tl - l))] = (l << 8) | s
    return dt


def write_weights(ct: CTable) -> bytes:
    """Serialize the tree description.  Uses FSE-compressed weights when
    smaller, else direct 4-bit weights (both spec-conformant)."""
    w = ct.weights
    used = np.nonzero(w)[0]
    if len(used) < 2:
        raise FormatError("huffman table needs >= 2 symbols")
    last = int(used[-1])
    weights = w[:last]  # last symbol's weight implied
    direct = _write_weights_direct(weights) if len(weights) <= 127 else None
    try:
        fsec = _write_weights_fse(weights)
        # self-check: the serialized form must read back exactly
        if fsec is not None:
            rt, _ = read_weights(fsec, 0)
            if len(rt) != last + 1 or not np.array_equal(rt, w[: last + 1]):
                fsec = None
    except Exception:
        fsec = None
    if fsec is not None and (direct is None or len(fsec) < len(direct)):
        return fsec
    if direct is None:
        raise FormatError("huffman weights not serializable")
    return direct


def _write_weights_direct(weights: np.ndarray) -> bytes:
    num = len(weights)
    if num > 127:
        raise FormatError("too many huffman weights for direct format")
    out = bytearray([127 + num])
    for i in range(0, num, 2):
        hi = int(weights[i]) << 4
        lo = int(weights[i + 1]) if i + 1 < num else 0
        out.append(hi | lo)
    return bytes(out)


def _write_weights_fse(weights: np.ndarray) -> bytes | None:
    """FSE-compress the weight stream (2 interleaved states, forward read)."""
    counts = np.bincount(weights, minlength=1)
    if np.count_nonzero(counts) < 2 or len(weights) < 2:
        return None
    max_sym = int(np.max(weights))
    table_log = min(6, max(1, int(np.ceil(np.log2(max(2, len(weights)))))))
    norm = normalize_counts(counts[: max_sym + 1], table_log, len(weights))
    if norm is None:
        return None
    et = fse.build_encode_table(norm, table_log)
    desc = fse.write_norm_counts(norm, table_log)
    # encode weights backward with two alternating states (RFC 8878 §4.2.1.2)
    bits: list[tuple[int, int]] = []
    n = len(weights)
    # The decoder alternates states s1, s2, s1, ... producing w[0], w[1], …
    # so symbol k must be encoded into s1 iff k is even.  Encoding runs
    # backward from k = n-3, whose parity depends on n: odd n -> s1 first
    # with s1 <- w[n-1]; even n -> s2 first with the inits swapped.
    if n % 2:
        s1 = fse.init_state(et, int(weights[n - 1]))
        s2 = fse.init_state(et, int(weights[n - 2]))
        turn = 0
    else:
        s2 = fse.init_state(et, int(weights[n - 1]))
        s1 = fse.init_state(et, int(weights[n - 2]))
        turn = 1
    i = n - 3
    while i >= 0:
        sym = int(weights[i])
        st = s1 if turn == 0 else s2
        nb = (st + int(et.delta_nb_bits[sym])) >> 16
        bits.append((st & ((1 << nb) - 1), nb))
        new = int(et.state_table[(st >> nb) + int(et.delta_find_state[sym])])
        if turn == 0:
            s1 = new
        else:
            s2 = new
        turn ^= 1
        i -= 1
    # flush states: state2 then state1 (decoder reads state1 first)
    bits.append((s2 - (1 << table_log) if s2 >= (1 << table_log) else s2,
                 table_log))
    bits.append((s1 - (1 << table_log) if s1 >= (1 << table_log) else s1,
                 table_log))
    payload = _close_bitstream(bits)
    out = desc + payload
    if len(out) >= 128:
        return None
    return bytes([len(out)]) + out


def _close_bitstream(bits: list[tuple[int, int]]) -> bytes:
    """LSB-first packing + 1-sentinel close (BIT_closeCStream)."""
    out = bytearray()
    acc = 0
    nacc = 0
    for v, nb in bits:
        acc |= (v & ((1 << nb) - 1)) << nacc
        nacc += nb
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
    acc |= 1 << nacc  # sentinel
    nacc += 1
    while nacc > 0:
        out.append(acc & 0xFF)
        acc >>= 8
        nacc -= 8
    return bytes(out)


def normalize_counts(counts: np.ndarray, table_log: int, total: int
                     ) -> np.ndarray | None:
    """Scale a histogram to sum to 2^table_log (FSE_normalizeCount-style,
    simplified): every nonzero count stays >= 1; -1 marks scaled-to-zero
    low-probability symbols."""
    table_size = 1 << table_log
    counts = counts.astype(np.int64)
    if total <= 0 or np.count_nonzero(counts) < 1:
        return None
    norm = np.zeros(len(counts), np.int64)
    nz = counts > 0
    scaled = counts[nz].astype(np.float64) * table_size / total
    vals = np.maximum(1, np.round(scaled)).astype(np.int64)
    low = counts[nz] * 3 < (total * 2) // table_size + 1
    norm_nz = np.where(low & (vals <= 1), -1, vals)
    norm[nz] = norm_nz
    # fix the sum to exactly table_size by adjusting the largest entry
    # (-1 low-probability entries occupy one state each; zeros occupy none)
    s = int(np.sum(norm[norm > 0])) + int(np.sum(norm == -1))
    diff = table_size - s
    if diff != 0:
        order = np.argsort(-norm)
        for idx in order:
            if norm[idx] > 0 and norm[idx] + diff >= 1:
                norm[idx] += diff
                diff = 0
                break
        if diff != 0:
            return None
    return norm.astype(np.int32)


def read_weights(data: bytes, offset: int) -> tuple[np.ndarray, int]:
    """Parse a Huffman tree description.  Returns (weights incl. the implied
    last symbol, bytes consumed)."""
    header = data[offset]
    if header >= 128:
        num = header - 127
        weights = np.zeros(num, np.int32)
        for i in range(num):
            b = data[offset + 1 + i // 2]
            weights[i] = (b >> 4) if i % 2 == 0 else (b & 0xF)
        consumed = 1 + (num + 1) // 2
    else:
        comp_size = header
        norm, table_log, used = fse.read_norm_counts(data, offset + 1, 255)
        dt = fse.build_decode_table(norm, table_log)
        stream = data[offset + 1 + used: offset + 1 + comp_size]
        weights = _fse_decode_interleaved(stream, dt)
        consumed = 1 + comp_size
    # implied last weight: complete sum to next power of two
    total = int(np.sum(np.where(weights > 0, 1 << (weights - 1), 0)))
    if total == 0:
        raise FormatError("empty huffman weights")
    max_bits = int(np.ceil(np.log2(total + 1)))
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise FormatError("invalid huffman weight sum")
    last_w = int(np.log2(rest)) + 1
    weights = np.append(weights, np.int32(last_w))
    return weights, consumed


def _fse_decode_interleaved(stream: bytes, dt: fse.DecodeTable) -> np.ndarray:
    """Decode an FSE-compressed huffman-weight stream (2 states, read
    backward from the sentinel)."""
    if not stream:
        raise FormatError("empty FSE weight stream")
    # locate sentinel in last byte
    last = stream[-1]
    if last == 0:
        raise FormatError("corrupt FSE weight stream (zero last byte)")
    total_bits = 8 * len(stream) - 1
    while not (last >> (7 - (8 * len(stream) - total_bits - 1)) & 1):
        total_bits -= 1
    # simpler: highest set bit of last byte
    sentinel = last.bit_length() - 1
    total_bits = 8 * (len(stream) - 1) + sentinel
    pos = total_bits  # bits remaining (read from top)
    val = int.from_bytes(stream, "little")

    def read(nb):
        nonlocal pos
        if nb == 0:
            return 0
        pos -= nb
        if pos < 0:
            # zero-fill past the start (spec: streams are fully consumed;
            # tolerate to mirror lenient decoders)
            return (val << (-pos)) >> 0 & ((1 << nb) - 1) if False else 0
        return (val >> pos) & ((1 << nb) - 1)

    tl = dt.table_log
    s1 = read(tl)
    s2 = read(tl)
    out = []
    while True:
        out.append(int(dt.symbol[s1]))
        nb = int(dt.nb_bits[s1])
        if pos < nb:
            # stream exhausted on state1: flush both
            s1 = int(dt.new_state[s1]) + read(nb)  # reads zeros
            out.append(int(dt.symbol[s2]))
            break
        s1 = int(dt.new_state[s1]) + read(nb)
        out.append(int(dt.symbol[s2]))
        nb = int(dt.nb_bits[s2])
        if pos < nb:
            s2 = int(dt.new_state[s2]) + read(nb)
            out.append(int(dt.symbol[s1]))
            break
        s2 = int(dt.new_state[s2]) + read(nb)
    return np.array(out, np.int32)
