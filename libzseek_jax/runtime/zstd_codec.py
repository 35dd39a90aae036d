"""zstd frame codec: host orchestration + container assembly around the
device pipelines (ops/zstd_encode.py, ops/zstd_decode.py).

Encode flow per batch of frames (rows = independent 128 KiB blocks):
  device: LZ77 parse -> sequences + literals + histograms
  host:   Huffman table build per block (tiny), mode decisions
  device: Huffman 4-stream literal encode; FSE sequence encode (predefined
          distributions)
  host:   section headers + block headers + frame header assembly, with
          raw-literals / raw-block fallbacks so output never expands beyond
          the format's bound.

Output frames are standard zstd frames (single-segment, content size
present), verified against stock libzstd in the test-suite.  Equivalent
reference path: ZSTD_compress2 inside compress_frame_zstd
(/root/reference/src/compress.c:653-702).
"""

from __future__ import annotations

import math
import os
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from libzseek_jax import native
from libzseek_jax.errors import FormatError
from libzseek_jax.format import hints
from libzseek_jax.format import zstd_frame as zf
from libzseek_jax.ops import huffman
from libzseek_jax.ops.zstd_encode import (apply_ldm_override,
                                          compact_payload,
                                          fse_encode_sequences,
                                          huffman_encode_literals,
                                          ldm_literal_stats,
                                          zstd_sequences)

# Block size: the format's 128 KiB maximum.
BLOCK = zf.BLOCK_MAX


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _lit_section_raw(lits: bytes) -> bytes:
    n = len(lits)
    if n < 32:
        head = bytes([(n << 3) | zf.LIT_RAW])
    elif n < 4096:
        head = bytes([((n & 0xF) << 4) | (0b01 << 2) | zf.LIT_RAW, n >> 4])
    else:
        head = bytes([((n & 0xF) << 4) | (0b11 << 2) | zf.LIT_RAW,
                      (n >> 4) & 0xFF, n >> 12])
    return head + lits


def _lit_section_rle(byte: int, n: int) -> bytes:
    if n < 32:
        head = bytes([(n << 3) | zf.LIT_RLE])
    elif n < 4096:
        head = bytes([((n & 0xF) << 4) | (0b01 << 2) | zf.LIT_RLE, n >> 4])
    else:
        head = bytes([((n & 0xF) << 4) | (0b11 << 2) | zf.LIT_RLE,
                      (n >> 4) & 0xFF, n >> 12])
    return head + bytes([byte])


def _lit_section_huff(regen: int, comp: int, payload: bytes) -> bytes:
    """4-stream compressed literals header (Size_Format 01/10/11)."""
    if regen <= 1023 and comp <= 1023:
        v = zf.LIT_COMPRESSED | (0b01 << 2) | (regen << 4) | (comp << 14)
        return v.to_bytes(3, "little") + payload
    if regen <= 16383 and comp <= 16383:
        v = zf.LIT_COMPRESSED | (0b10 << 2) | (regen << 4) | (comp << 18)
        return v.to_bytes(4, "little") + payload
    v = zf.LIT_COMPRESSED | (0b11 << 2) | (regen << 4) | (comp << 22)
    return v.to_bytes(5, "little") + payload


def _nbseq_header(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([(n >> 8) + 128, n & 0xFF])
    return bytes([255]) + (n - 0x7F00).to_bytes(2, "little")


LIT_ANCHOR_INTERVAL = 512
SEQ_ANCHOR_INTERVAL = 128


class ZstdCodec:
    """zstd seekable-frame codec (batched device encode pipeline; decode in
    ops/zstd_decode.py).  When collect_hints is on (default), compression
    also produces per-block decode anchors (format/hints.py) that the
    Writer publishes in a skippable sidecar frame, enabling the anchored
    parallel decode paths."""

    name = "zstd"
    supports_hints = True
    supports_device_frames = True

    def __init__(self, level: int = 3, max_batch_blocks: int = 64,
                 collect_hints: bool = True, workers: int | None = None):
        self.level = level
        # N workers = N devices (SURVEY.md §2 parallelism inventory):
        # batches round-robin over the first `workers` devices — frames are
        # independent compression units, so scale-out needs no collectives;
        # the ordered fetch in the finish step is the reference's
        # drain-in-order analog (/root/reference/src/compress.c:294-333)
        self._devices = None
        self._rr = 0
        # parse batches that ran on each device, keyed by device id
        self.device_batches: Counter = Counter()
        if workers and workers > 1:
            devs = jax.devices()
            if len(devs) > 1:
                self._devices = devs[: min(workers, len(devs))]
        # level knob maps to candidate granularity / extension length,
        # the analog of zstd's level-indexed search parameters
        self.seg_size = 8 if level <= 1 else 4
        self.max_len = 32 if level <= 1 else 48
        self.max_batch_blocks = max_batch_blocks
        self.collect_hints = collect_hints
        self.block = BLOCK

    # --- compress ---

    def compress_frames(self, frames: list[bytes | memoryview],
                        return_hints: bool = False):
        stream = self.begin_stream(return_hints=True)
        groups = stream.submit(frames) + stream.finish()
        out, out_hints = [], []
        for fr_out, fh in groups:
            out.extend(fr_out)
            out_hints.extend(fh)
        return (out, out_hints) if return_hints else out

    def begin_stream(self, return_hints: bool = False, depth: int = 4):
        """Open a streaming compression session: `submit(frames)` dispatches
        a frame group into the device pipeline and returns any OLDER groups
        that completed, `finish()` drains the rest.  Groups complete in
        submission order, so callers can write results straight to a sink.
        This keeps the upload/parse of group k+2 in flight while group k+1
        is on the device and group k is being assembled on the host — the
        single-batch pipeline inside compress_frames cannot overlap across
        Writer flushes."""
        return _ZstdStream(self, return_hints, depth)

    def _frame_spans(self, frames):
        spans = []
        for fi, fr in enumerate(frames):
            n = len(fr)
            if n == 0:
                continue
            for s in range(0, n, self.block):
                spans.append((fi, s, min(self.block, n - s)))
        return spans

    def _assemble_frames(self, frames, spans, block_payloads, block_hints):
        out = []
        out_hints = []
        cursor = 0
        for fi, fr in enumerate(frames):
            n = len(fr)
            head = zf.build_frame_header(n, single_segment=True)
            body = bytearray(head)
            fhints = []
            nblocks = math.ceil(n / self.block)
            if n == 0:
                body += zf.build_block_header(zf.BLOCK_RAW, 0, last=True)
                fhints.append(None)
            for b in range(nblocks):
                fi2, s, sz = spans[cursor]
                assert fi2 == fi
                payload = block_payloads[cursor]
                bh = block_hints[cursor]
                cursor += 1
                last = b == nblocks - 1
                if isinstance(payload, tuple):   # ("rle", byte)
                    body += zf.build_block_header(zf.BLOCK_RLE, sz, last)
                    body += bytes([payload[1]])
                    fhints.append(None)
                elif payload is None or len(payload) >= sz:
                    body += zf.build_block_header(zf.BLOCK_RAW, sz, last)
                    body += bytes(fr[s: s + sz])
                    fhints.append(None)
                else:
                    body += zf.build_block_header(
                        zf.BLOCK_COMPRESSED, len(payload), last)
                    body += payload
                    fhints.append(bh)
            out.append(bytes(body))
            out_hints.append(fhints)
        return out, out_hints

    def _put(self, x: np.ndarray):
        """Upload a batch: to the default device, or with workers > 1 to
        the next device in round-robin order.  A committed batch carries
        every downstream op (and the small uncommitted operands) with it."""
        if self._devices is None:
            return jnp.asarray(x)
        dev = self._devices[self._rr % len(self._devices)]
        self._rr += 1
        return jax.device_put(x, dev)

    def _dispatch_parse(self, blocks: list[np.ndarray],
                        first_flags: list[bool] | None = None):
        """Stage 1 (async): upload the batch and dispatch the LZ77 parse.
        The batch is padded to a power-of-two row count so every archive
        size reuses a handful of compiled shapes.

        first_flags[i] marks block i as the first block of its frame: the
        long-distance pre-pass must not match across frame starts."""
        B = len(blocks)
        Bp = max(8, 1 << max(0, (B - 1).bit_length()))
        N = self.block
        X = np.zeros((Bp, N), np.uint8)
        lens = np.zeros((Bp,), np.int32)
        frame_base = np.full((Bp,), -1, np.int64)
        fb = 0
        for i, blk in enumerate(blocks):
            X[i, : len(blk)] = blk
            lens[i] = len(blk)
            first = (first_flags is None or first_flags[i] or i == 0
                     or len(blocks[i - 1]) < N)
            if first:
                fb = i * N
            frame_base[i] = fb
        # long-distance pre-pass (host, native): whole- or part-block
        # matches beyond the parse window become single long-match
        # sequences
        ldm = None
        if os.environ.get("ZN_LDM", "auto") != "off":
            d = native.ldm_scan(X[:B].reshape(-1), B, N, frame_base[:B],
                                lens[:B], 1 << 17)
            if d is not None and (d[:, 0] > 0).any():
                ldm = ldm_literal_stats(d, blocks, Bp, N)
        seqs = zstd_sequences(self._put(X), jnp.asarray(lens),
                              seg_size=self.seg_size, max_len=self.max_len)
        self.device_batches[next(iter(seqs["n_seq"].devices())).id] += 1
        if ldm is not None:
            seqs = apply_ldm_override(seqs, ldm[0], lens, ldm[1], ldm[2])
        return seqs, lens[:B], self._pack_small(seqs)

    @staticmethod
    def _pack_small(seqs):
        """Bundle the small parse outputs into one device array and start
        its device->host transfer immediately, so it overlaps the uploads
        and parses of later batches."""
        packed = jnp.concatenate([
            seqs["hist"].reshape(-1), seqs["lit_count"], seqs["n_seq"],
            seqs["const"]])
        packed.copy_to_host_async()
        return packed

    def _finish_blocks(self, staged):
        """Stage 2: fetch parse results, build tables, run the entropy
        stage, assemble block payloads + hints."""
        seqs, lens, packed_dev = staged
        B = lens.shape[0]           # real blocks; device arrays are padded
        Bp = seqs["n_seq"].shape[0]
        # the packed small-array transfer was started at dispatch time
        # (_pack_small); this wait usually returns immediately in steady
        # state
        packed = np.asarray(packed_dev)
        hist = packed[: Bp * 256].reshape(Bp, 256)[:B]
        lit_count = packed[Bp * 256: Bp * 256 + Bp][:B]
        n_seq = packed[Bp * 256 + Bp: Bp * 256 + 2 * Bp][:B]
        const = packed[Bp * 256 + 2 * Bp:][:B]
        nmax = int(n_seq.max()) if B else 0
        smax = max(16, 1 << max(0, (nmax - 1)).bit_length())
        smax = min(smax, seqs["ll"].shape[1])
        modes, trees, ests, code_vals, code_bits = self._decide_modes(
            hist, lit_count, n_seq, lens, Bp, const=const)
        ent = self._entropy_xla(seqs, lens, lit_count, n_seq, modes,
                                trees, ests, code_vals, code_bits, smax)
        return self._assemble(B, lens, lit_count, n_seq, hist, trees, ent,
                              const=const)

    def _decide_modes(self, hist, lit_count, n_seq, lens, Bp, const=None):
        """Per-block literal-section mode decisions + Huffman tables.

        modes: "none" | "rle" | "raw" | "huf" | "skip" | "rleblock"
        ("skip" = the block is certain to be stored raw, so no streams are
        emitted at all).  The huf-vs-raw choice is final only after the
        exact stream sizes are known (_entropy_xla)."""
        B = len(lens)
        code_vals = np.zeros((Bp, 256), np.int32)
        code_bits = np.zeros((Bp, 256), np.int32)
        trees: list[bytes | None] = [None] * B
        modes: list[str] = ["raw"] * B
        ests: list[int] = [0] * B
        if native.have_native():
            n_lengths, n_codes, n_trees, _mb = native.huf_build_batch(
                hist.astype(np.uint32))
        else:
            n_lengths = n_codes = n_trees = None
        for i in range(B):
            lc = int(lit_count[i])
            blen = int(lens[i])
            nz = np.count_nonzero(hist[i])
            if const is not None and blen > 4 and const[i] >= 0:
                modes[i] = "rleblock"   # whole block = one repeated byte
                continue
            if lc == 0:
                modes[i] = "none"
                continue
            if nz == 1:
                modes[i] = "rle"
                continue
            if lc < 64:
                ests[i] = lc + 8
                continue  # raw literals
            if n_trees is not None:
                tree, lengths, codes = n_trees[i], n_lengths[i], n_codes[i]
                if tree is None:
                    ests[i] = lc + 8
                    continue
            else:
                ct = huffman.build_ctable(hist[i])
                try:
                    tree = huffman.write_weights(ct)
                except FormatError:
                    ests[i] = lc + 8
                    continue
                lengths, codes = ct.lengths, ct.codes
            est_bits = int(np.sum(hist[i] * lengths))
            stream_bound = est_bits // 8 + 8   # per-stream sentinel/rounding
            if stream_bound + len(tree) + 6 >= lc:
                ests[i] = lc + 8
                continue
            trees[i] = tree
            modes[i] = "huf"
            ests[i] = stream_bound
            code_vals[i] = codes
            code_bits[i] = lengths
        # rows that stayed raw-literals and whose minimal payload already
        # reaches the block size are certain to be stored as raw blocks —
        # skip emitting any streams for them
        for i in range(B):
            if modes[i] != "raw":
                continue
            lc = int(lit_count[i])
            raw_hdr = 1 if lc < 32 else (2 if lc < 4096 else 3)
            if lc > 0 and raw_hdr + lc + 1 >= int(lens[i]):
                modes[i] = "skip"
                ests[i] = 0
        return modes, trees, ests, code_vals, code_bits

    def _fetch_payload(self, Bp, streams, lit_bytes_dev, seq_stream,
                       seq_bytes_dev, cap_words, anchors):
        """compact_payload + one bundled device->host transfer.  anchors is
        a list of device arrays appended to the metadata section.  Returns
        (flat payload bytes, base_w, lw_w, host copies of the anchors)."""
        flat, base_w, lw_w = compact_payload(
            streams, lit_bytes_dev, seq_stream, seq_bytes_dev, cap_words)
        meta_parts = [base_w, lw_w] + [a.reshape(-1) for a in anchors]
        meta_len = sum(int(np.prod(p.shape)) for p in meta_parts)
        fetched = np.asarray(jnp.concatenate(
            meta_parts + [jax.lax.bitcast_convert_type(flat, jnp.int32)]))
        meta = fetched[:meta_len]
        flat_bytes = fetched[meta_len:].view(np.uint8)
        base_w = meta[:Bp]
        lw_w = meta[Bp: 2 * Bp]
        rest = meta[2 * Bp:]
        outs = []
        pos = 0
        for a in anchors:
            na = int(np.prod(a.shape))
            outs.append(rest[pos: pos + na].reshape(a.shape))
            pos += na
        return flat_bytes, base_w, lw_w, outs

    def _entropy_xla(self, seqs, lens, lit_count, n_seq, modes, trees,
                     ests, code_vals, code_bits, smax):
        """Huffman literal + FSE sequence emission, one compacted fetch."""
        B = len(lens)
        Bp = seqs["n_seq"].shape[0]
        N = self.block
        # Rows already decided non-Huffman (raw/RLE/none) are masked out of
        # the literal kernel — they would otherwise inflate lcap to the
        # block size (incompressible rows) and the packing cost with it.
        huf_counts = np.where(np.array([m == "huf" for m in modes]),
                              lit_count, 0)
        lit_count_dev = np.zeros((Bp,), np.int32)
        lit_count_dev[:B] = huf_counts
        lmax = int(huf_counts.max()) if B else 0
        lcap = min(N, max(128, 1 << max(0, (lmax - 1)).bit_length()))
        lit_cap = _ceil_to(lcap + 64, 128)
        hout = huffman_encode_literals(
            jax.lax.slice_in_dim(seqs["literals"], 0, lcap, axis=1),
            jnp.asarray(lit_count_dev),
            jnp.asarray(code_vals), jnp.asarray(code_bits), lit_cap,
            anchor_interval=LIT_ANCHOR_INTERVAL if self.collect_hints else 0,
            return_words=True)
        streams, sizes4_dev = hout[0], hout[1]
        seq_cap = _ceil_to(min(N // 2, 11 * smax) + 64, 128)
        fout = fse_encode_sequences(
            jax.lax.slice_in_dim(seqs["ll"], 0, smax, axis=1),
            jax.lax.slice_in_dim(seqs["ml"], 0, smax, axis=1),
            jax.lax.slice_in_dim(seqs["offv"], 0, smax, axis=1),
            seqs["n_seq"], seq_cap, smax=smax,
            anchor_interval=SEQ_ANCHOR_INTERVAL if self.collect_hints else 0,
            return_words=True)
        seq_stream, seq_sizes_dev = fout[0], fout[1]
        huf_mask = np.zeros((Bp,), np.int32)
        huf_mask[:B] = [m == "huf" for m in modes]
        lit_bytes_dev = jnp.sum(sizes4_dev, axis=1) * jnp.asarray(huf_mask)
        # + 256 B/row: compact_payload pads each row's lit and seq
        # sections to whole 128-B tiles (tile-granular gather)
        cap_bytes = sum(e + 16 for e in ests) + \
            int(np.sum(n_seq.astype(np.int64) * 9 + 12)) + 256 + 256 * Bp
        cap_words = max(1024, 1 << int(cap_bytes // 4).bit_length())
        anchors = [sizes4_dev.reshape(-1), seq_sizes_dev]
        if self.collect_hints:
            anchors += [hout[2], fout[2][0], fout[2][1], fout[2][2]]
        flat_bytes, base_w, lw_w, outs = self._fetch_payload(
            Bp, streams, lit_bytes_dev, seq_stream, seq_sizes_dev,
            cap_words, anchors)
        sizes4 = outs[0].reshape(Bp, 4)
        seq_sizes = outs[1]
        if B:
            need = int(base_w[B - 1] + lw_w[B - 1] +
                       (int(seq_sizes[B - 1]) + 3) // 4)
            assert need <= cap_words, \
                f"payload compaction overflow: {need} > {cap_words}"
        if self.collect_hints:
            lit_anchors, sa_bits, sa_states, sa_rep1 = outs[2:6]
        else:
            lit_anchors = sa_bits = sa_states = sa_rep1 = None
        # exact huf->raw fallback from the fetched sizes, then fetch
        # bytes for rows that need them on host (raw payloads)
        for i in range(B):
            if modes[i] != "huf":
                continue
            lc = int(lit_count[i])
            payload_len = len(trees[i]) + 6 + int(sizes4[i].sum())
            hdr = 3 if (lc <= 1023 and payload_len <= 1023) else \
                4 if (lc <= 16383 and payload_len <= 16383) else 5
            raw_hdr = 1 if lc < 32 else (2 if lc < 4096 else 3)
            if hdr + payload_len >= raw_hdr + lc:
                modes[i] = "raw"
                trees[i] = None
        need_rows = [i for i in range(B)
                     if modes[i] == "raw" and lit_count[i] > 0]
        lit_rows: dict[int, np.ndarray] = {}
        if need_rows:
            picked = np.asarray(seqs["literals"][jnp.asarray(need_rows)])
            lit_rows = {r: picked[k][: int(lit_count[r])]
                        for k, r in enumerate(need_rows)}
        rep23 = np.asarray(jnp.sum(
            ((seqs["offv"] == 2) | (seqs["offv"] == 3)).astype(jnp.int32),
            axis=1))
        return dict(sizes4=sizes4, seq_sizes=seq_sizes,
                    flat_bytes=flat_bytes, base_w=base_w, lw_w=lw_w,
                    lit_anchors=lit_anchors, sa_bits=sa_bits,
                    sa_states=sa_states, sa_rep1=sa_rep1, lit_rows=lit_rows,
                    modes=modes, rep23=rep23)

    def _assemble(self, B, lens, lit_count, n_seq, hist, trees, ent,
                  const=None):
        """Build per-block payloads + decode hints from fetched streams."""
        sizes4 = ent["sizes4"]
        seq_sizes = ent["seq_sizes"]
        flat_bytes = ent["flat_bytes"]
        base_w = ent["base_w"]
        lw_w = ent["lw_w"]
        lit_anchors = ent["lit_anchors"]
        sa_bits, sa_states, sa_rep1 = (ent["sa_bits"], ent["sa_states"],
                                       ent["sa_rep1"])
        lit_rows = ent["lit_rows"]
        modes = ent["modes"]
        out: list[bytes | None] = []
        out_h: list[object | None] = []
        for i in range(B):
            lc = int(lit_count[i])
            if modes[i] == "skip":
                out.append(None)
                out_h.append(None)
                continue
            if modes[i] == "rleblock":
                out.append(("rle", int(const[i])))
                out_h.append(None)
                continue
            lit_h = None
            if modes[i] == "none":
                lit_sec = _lit_section_raw(b"")
            elif modes[i] == "rle":
                lit_sec = _lit_section_rle(int(np.argmax(hist[i])), lc)
            elif modes[i] == "huf":
                jump = b"".join(int(sizes4[i, k]).to_bytes(2, "little")
                                for k in range(3))
                lo = 4 * int(base_w[i])
                payload = trees[i] + jump + \
                    flat_bytes[lo: lo + int(sizes4[i].sum())].tobytes()
                lit_sec = _lit_section_huff(lc, len(payload), payload)
                if lit_anchors is not None:
                    sA = LIT_ANCHOR_INTERVAL
                    s123 = (lc + 3) >> 2
                    cnts = [s123, s123, s123, lc - 3 * s123]
                    per = []
                    for s4 in range(4):
                        na = max(0, -(-cnts[s4] // sA) - 1)
                        per.append(lit_anchors[i, s4, :na].tolist())
                    lit_h = hints.StreamAnchors(sA, per)
            else:
                lits = lit_rows[i].tobytes() if i in lit_rows else b""
                lit_sec = _lit_section_raw(lits)
            ns = int(n_seq[i])
            seq_sec = _nbseq_header(ns)
            seq_h = None
            rep23 = ent["rep23"]
            if ns > 0:
                # compression-modes byte: predefined LL/OF/ML tables
                seq_sec += b"\x00"
                lo = 4 * int(base_w[i] + lw_w[i])
                seq_sec += flat_bytes[lo: lo + int(seq_sizes[i])].tobytes()
                if sa_bits is not None and not rep23[i]:
                    sA = SEQ_ANCHOR_INTERVAL
                    na = max(0, -(-ns // sA) - 1)
                    seq_h = hints.SeqAnchors(
                        sA, sa_bits[i, :na].tolist(),
                        sa_states[i, :na].tolist(),
                        sa_rep1[i, :na].tolist())
            payload = lit_sec + seq_sec
            out.append(payload if len(payload) < int(lens[i]) else None)
            out_h.append(hints.BlockHints(lit_h, seq_h)
                         if (lit_h or seq_h) else None)
        return out, out_h

    # --- decompress ---

    def decompress_frame(self, data: bytes, d_size: int,
                         frame_hints=None) -> bytes:
        return self.decompress_frames([data], [d_size], [frame_hints])[0]

    def decompress_frames(self, datas: list[bytes], d_sizes: list[int],
                          frame_hints: list | None = None,
                          to_device: bool = False) -> list[bytes]:
        from libzseek_jax.ops.zstd_decode import decode_frames
        return decode_frames(datas, d_sizes, hints=frame_hints,
                             to_device=to_device)


class _ZstdStream:
    """Streaming compression session (see ZstdCodec.begin_stream).

    Groups of frames move through a global FIFO of device batches; at most
    `depth` batches stay in flight, older ones are finished (fetched +
    assembled) as new ones are submitted, so device compute, both transfer
    directions and host assembly overlap continuously across Writer
    flushes."""

    def __init__(self, codec: ZstdCodec, return_hints: bool, depth: int):
        self._codec = codec
        self._return_hints = return_hints
        self._depth = max(1, depth)
        self._groups = deque()
        self._inflight = 0
        # one worker thread runs the finish chain (blocking fetches, table
        # build, entropy dispatch, assembly) so the main thread keeps
        # uploading/dispatching later batches: the transfers of batch k
        # then overlap the uploads of batch k+1.  A single worker keeps
        # batches finishing in FIFO order.
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="zseek-finish")

    def submit(self, frames):
        codec = self._codec
        frames = list(frames)
        spans = codec._frame_spans(frames)
        g = {"frames": frames, "spans": spans, "batches": deque(),
             "payloads": {}, "bhints": {}}
        for lo in range(0, len(spans), codec.max_batch_blocks):
            chunk = spans[lo: lo + codec.max_batch_blocks]
            st = codec._dispatch_parse(
                [np.frombuffer(frames[fi], np.uint8, sz, s)
                 for fi, s, sz in chunk],
                first_flags=[s == 0 for _, s, _ in chunk])
            g["batches"].append(
                (lo, self._pool.submit(codec._finish_blocks, st)))
            self._inflight += 1
        self._groups.append(g)
        return self._drain(self._depth)

    def finish(self):
        out = self._drain(0)
        self._pool.shutdown(wait=True)
        return out

    def _drain(self, depth: int):
        codec = self._codec
        while self._inflight > depth:
            g = next(gr for gr in self._groups if gr["batches"])
            lo0, fut = g["batches"].popleft()
            payloads, bhints = fut.result()
            for i, (p, bh) in enumerate(zip(payloads, bhints)):
                g["payloads"][lo0 + i] = p
                g["bhints"][lo0 + i] = bh
            self._inflight -= 1
        done = []
        while self._groups and not self._groups[0]["batches"]:
            g = self._groups.popleft()
            done.append(codec._assemble_frames(
                g["frames"], g["spans"], g["payloads"], g["bhints"]))
        return done
