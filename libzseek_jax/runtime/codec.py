"""Frame codecs: tie the batched block programs to the container formats.

A codec turns whole zseek frames (the unit of random access and of data
parallelism) into container bytes and back.  The reference delegates this to
libzstd/liblz4 scalar calls per frame (/root/reference/src/compress.c:653-
786, src/decompress.c:377-683); here every frame in a batch — and every
64 KiB block within — is one row of a single batched device program.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from libzseek_jax.errors import FormatError
from libzseek_jax.format import lz4f
from libzseek_jax.ops.lz4_decode import lz4_decode_frames
from libzseek_jax.ops.lz4_encode import lz4_encode_blocks

BLOCK = 1 << 16  # 64 KiB blocks, like the reference writer


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class LZ4Codec:
    """LZ4F frames with 64 KiB blocks — linked by default, like the
    reference's LZ4F_compressFrame defaults (/root/reference/src/compress.c:
    204-207 sets only autoFlush + block size; blockMode stays linked).

    Linked blocks keep full batch parallelism: each row carries the previous
    block's 64 KiB window as a context prefix, so matches reach across block
    boundaries without any cross-row dependency.

    level maps to match-candidate granularity (finer = better ratio,
    more sequential scan steps), the analog of LZ4's acceleration knob:
    negative levels take 8-byte segments, the rest 4-byte ones.
    """

    name = "lz4"
    supports_device_frames = True

    def __init__(self, level: int = 0, max_batch_blocks: int = 128,
                 block_independent: bool = False,
                 workers: int | None = None):
        self.level = level
        self.seg_size = 8 if level < 0 else 4
        self.max_batch_blocks = max_batch_blocks
        self.block_independent = block_independent
        # N workers = N devices: batches round-robin across devices (see
        # ZstdCodec; frames/blocks are independent, no collectives needed)
        self._devices = None
        self._rr = 0
        if workers and workers > 1:
            devs = jax.devices()
            if len(devs) > 1:
                self._devices = devs[: min(workers, len(devs))]

    def _put(self, arr):
        if self._devices is None:
            return jnp.asarray(arr)
        dev = self._devices[self._rr % len(self._devices)]
        self._rr += 1
        return jax.device_put(arr, dev)

    # --- compress ---

    @staticmethod
    def _frame_spans(frames):
        spans = []  # (frame_idx, start, size)
        for fi, fr in enumerate(frames):
            n = len(fr)
            for s in range(0, n, BLOCK):
                spans.append((fi, s, min(BLOCK, n - s)))
        return spans

    def _assemble_frames(self, frames, spans, comp_payloads):
        """Per block choose compressed vs stored, build LZ4F containers."""
        out_frames = []
        cursor = 0
        for fi, fr in enumerate(frames):
            n = len(fr)
            nblocks = math.ceil(n / BLOCK) if n else 0
            blocks = []
            for b in range(nblocks):
                fidx, s, sz = spans[cursor]
                assert fidx == fi
                payload = comp_payloads[cursor]
                cursor += 1
                if payload is None or len(payload) >= sz:
                    # incompressible: store raw from the host's bytes
                    blocks.append((bytes(fr[s: s + sz]), True))
                else:
                    blocks.append((payload, False))
            out_frames.append(lz4f.assemble_frame(
                blocks, n, block_independent=self.block_independent))
        return out_frames

    def begin_stream(self, return_hints: bool = False, depth: int = 4):
        """Streaming compression session, same contract as
        ZstdCodec.begin_stream: submit(frames) -> completed older groups,
        finish() drains.  A worker thread runs the blocking fetches so the
        caller keeps uploading later batches (LZ4 produces no hints; each
        group returns (frames, [None]*n))."""
        return _LZ4Stream(self, depth)

    def compress_frames(self, frames: list[bytes | memoryview]) -> list[bytes]:
        """Compress a list of frames; returns LZ4F container bytes per frame."""
        if not frames:
            return []
        stream = self.begin_stream()
        groups = stream.submit(frames) + stream.finish()
        out = []
        for fr_out, _ in groups:
            out.extend(fr_out)
        return out

    def _dispatch_batch(self, frames, chunk, ctx):
        """Upload one block batch and dispatch its encode (async)."""
        B = len(chunk)
        # pad rows to a power of two: every archive size then reuses a
        # handful of compiled shapes
        Bp = max(8, 1 << max(0, (B - 1).bit_length()))
        X = np.zeros((Bp, ctx + BLOCK), np.uint8)
        lens = np.zeros((Bp,), np.int32)
        min_ref = np.zeros((Bp,), np.int32)
        for i, (fi, s, sz) in enumerate(chunk):
            X[i, ctx: ctx + sz] = np.frombuffer(frames[fi], np.uint8, sz, s)
            lens[i] = ctx + sz
            if ctx:
                clen = min(BLOCK, s)  # window available in this frame
                if clen:
                    X[i, ctx - clen: ctx] = np.frombuffer(
                        frames[fi], np.uint8, clen, s - clen)
                min_ref[i] = ctx - clen
        out, olens = lz4_encode_blocks(
            self._put(X), jnp.asarray(lens),
            seg_size=self.seg_size, ctx_len=ctx,
            min_ref=jnp.asarray(min_ref))
        return Bp, out, olens

    def _finish_batch(self, B, staged) -> list[bytes]:
        """Fetch one batch's results -> per-block payload bytes."""
        _, out, olens = staged
        out = np.asarray(out)[:B]
        olens = np.asarray(olens)[:B]
        return [out[i, : olens[i]].tobytes() for i in range(B)]

    # --- decompress ---

    def decompress_frame(self, data: bytes, d_size: int) -> bytes:
        """Decode one LZ4F frame (linked or independent) of known
        decompressed size."""
        out = self.decompress_frames([data], [d_size])
        return out[0]

    def _decompress_frames_host(self, datas, d_sizes):
        """Native host decode (zn_lz4_decode): LZ4 has no entropy stage,
        so expanding the compressed bytes the host already holds is pure
        memcpy work.  The device decoder remains the path for
        device-resident frames (to_device).  Returns None when the native
        library is absent (callers fall back)."""
        import os
        from libzseek_jax import native
        if not native.have_native() or \
                os.environ.get("ZN_LZ4_HOST_DECODE", "auto") == "off":
            return None
        out = []
        for data, d in zip(datas, d_sizes):
            info = lz4f.parse_frame_header(data)
            blocks, _ = lz4f.parse_blocks(data, info, info.header_size)
            buf = np.empty(d, np.uint8)
            base = 0
            src = np.frombuffer(data, np.uint8)
            for blk in blocks:
                if blk.uncompressed:
                    buf[base: base + blk.size] = \
                        src[blk.offset: blk.offset + blk.size]
                    base += blk.size
                else:
                    lo = base if info.block_independent else 0
                    n = native.lz4_block_decode(
                        src[blk.offset: blk.offset + blk.size], buf,
                        base, lo)
                    if n < 0:
                        raise FormatError("corrupt LZ4 block")
                    base += n
            if base != d:
                raise FormatError(
                    f"LZ4 frame regenerated {base} != declared {d}")
            out.append(buf.tobytes())
        return out

    def decompress_frames(self, datas: list[bytes], d_sizes: list[int],
                          to_device: bool = False) -> list[bytes]:
        """Decode a batch of LZ4F frames.  Host delivery uses the native
        block decoder; the device path serves to_device (device-resident
        frame cache) and environments without the native library.  Frames
        are grouped by padded geometry so each group is one kernel
        call."""
        if not to_device:
            res = self._decompress_frames_host(datas, d_sizes)
            if res is not None:
                return res
        parsed = []
        for data in datas:
            info = lz4f.parse_frame_header(data)
            blocks, end = lz4f.parse_blocks(data, info, info.header_size)
            parsed.append((info, blocks))
        results: list[bytes | None] = [None] * len(datas)
        # group by (K, M, F, linked) for static shapes
        groups: dict[tuple, list[int]] = {}
        for i, ((info, blocks), d) in enumerate(zip(parsed, d_sizes)):
            K = max(1, len(blocks))
            Kp = 1 << max(0, (K - 1)).bit_length()
            M = _ceil_to(max((b.size for b in blocks), default=1), 1 << 12)
            F = _ceil_to(max(d, 1), BLOCK)
            key = (Kp, M, F, not parsed[i][0].block_independent)
            groups.setdefault(key, []).append(i)
        for (Kp, M, F, linked), idxs in groups.items():
            B = len(idxs)
            comp = np.zeros((B, Kp, M), np.uint8)
            clens = np.zeros((B, Kp), np.int32)
            unc = np.zeros((B, Kp), bool)
            for r, i in enumerate(idxs):
                info, blocks = parsed[i]
                for k, blk in enumerate(blocks):
                    comp[r, k, : blk.size] = np.frombuffer(
                        datas[i], np.uint8, blk.size, blk.offset)
                    clens[r, k] = blk.size
                    unc[r, k] = blk.uncompressed
            out, out_lens, ok = lz4_decode_frames(
                jnp.asarray(comp), jnp.asarray(clens), jnp.asarray(unc),
                F, linked=linked)
            out_dev = out
            if not to_device:
                out = np.asarray(out)
            out_lens = np.asarray(out_lens)
            ok = np.asarray(ok)
            for r, i in enumerate(idxs):
                if not ok[r]:
                    raise FormatError(f"corrupt LZ4 frame (index {i})")
                if out_lens[r] != d_sizes[i]:
                    raise FormatError(
                        f"LZ4 frame decoded to {out_lens[r]} bytes, "
                        f"expected {d_sizes[i]}")
                results[i] = (out_dev[r, : int(out_lens[r])] if to_device
                              else out[r, : out_lens[r]].tobytes())
        return results  # type: ignore[return-value]


class _LZ4Stream:
    """Streaming LZ4 compression session (see LZ4Codec.begin_stream).
    Same shape as zstd_codec._ZstdStream: batches flow through a
    single-worker pipeline so the fetches of batch k overlap the uploads
    of batch k+1; groups complete in submission order."""

    def __init__(self, codec: LZ4Codec, depth: int):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        self._codec = codec
        self._depth = max(1, depth)
        self._groups = deque()
        self._inflight = 0
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="zseek-lz4")

    def submit(self, frames):
        from collections import deque
        codec = self._codec
        frames = list(frames)
        ctx = 0 if codec.block_independent else BLOCK
        spans = codec._frame_spans(frames)
        g = {"frames": frames, "spans": spans, "batches": deque(),
             "payloads": {}}
        for lo in range(0, len(spans), codec.max_batch_blocks):
            chunk = spans[lo: lo + codec.max_batch_blocks]
            st = codec._dispatch_batch(frames, chunk, ctx)
            g["batches"].append(
                (lo, self._pool.submit(codec._finish_batch, len(chunk),
                                       st)))
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
            for i, payload in enumerate(fut.result()):
                g["payloads"][lo0 + i] = payload
            self._inflight -= 1
        done = []
        while self._groups and not self._groups[0]["batches"]:
            g = self._groups.popleft()
            payloads = [g["payloads"][i] for i in range(len(g["spans"]))]
            out = codec._assemble_frames(g["frames"], g["spans"], payloads)
            done.append((out, [None] * len(g["frames"])))
        return done
