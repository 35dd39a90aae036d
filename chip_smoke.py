"""Smoke test of the seekable zstd/LZ4 write and pread path on one GPU.

Run from the repository root, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # phases A-G on one card
    python3 chip_smoke.py --cards 4  # only the 4-card workers phase

It builds the native host runtime (make -C libzseek_jax/native), prints
the card (nvidia-smi name and power limit), the JAX version, device kind
and count, the compile-cache path and whether stock libzstd/liblz4
loaded, then drives the public Writer/Reader entry points:

  A. zstd write: 256 MiB of mixed_corpus in 1 MiB writes, level 3, 1 MiB
     frames; stock libzstd must decode the whole archive to the input.
  B. 2,000 zipfian (theta 0.99) 4 KiB preads with a 64-frame cache, each
     compared with the input, then one full sequential pread.
  C. one device-resident decode batch of 64 frames (decode_frames with
     to_device=True, through Reader.prefetch), compared on the host.
  D. a foreign archive: 32 MiB written by stock libzstd at level 19 (long
     offsets, libzstd's own block layouts), read back through Reader.
  E. LZ4: 64 MiB of linked-block frames, decoded by stock liblz4, plus
     200 preads.
  F. backend identity: the first 8 MiB of A and the frozen source corpus
     compressed on the CPU device and on the GPU must be byte-identical.
  G. per-stage compiled memory and warm time of the parse, literal
     encode, FSE encode and decode-pass programs at 64 x 128 KiB blocks.

With --cards N it runs only the workers phase: 1 GiB through
Writer(workers=N) and Writer(workers=1) in this one process; every card
must have parsed batches, and the two archives must be byte-identical
and decode through stock libzstd.

Times printed here are smoke numbers, not benchmark metrics; each line
that carries a time names the card it ran on.  Any failure raises, and
the script then exits non-zero.  The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Without a GPU it exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MiB = 1 << 20
SOURCE_CORPUS = os.path.join(ROOT, "bench_results", "corpus_source_r5.bin")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_name() -> str:
    """'<name>, <power limit>' as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_native() -> None:
    """Build libzseek_native.so from the committed zn.cc and load it: a
    chip run must not silently time the pure-Python fallbacks."""
    subprocess.run(["make", "-C", os.path.join(ROOT, "libzseek_jax",
                                               "native")], check=True)
    from libzseek_jax import native
    check(native.have_native(), "libzseek_native.so did not load")


def make_data(seed: int, n: int) -> bytes:
    from libzseek_jax.testing.corpus import mixed_corpus
    return mixed_corpus(np.random.default_rng(seed), n).tobytes()


def write_archive(data: bytes, codec="zstd", *, level=None,
                  frame: int = MiB, workers: int = 1):
    """Write `data` through Writer in frame-sized write calls, frames of
    min_frame_size `frame`; returns (archive bytes, seconds, WriterStats)."""
    from libzseek_jax.runtime.writer import Writer
    buf = io.BytesIO()
    t0 = time.perf_counter()
    w = Writer(buf, codec=codec, level=level, min_frame_size=frame,
               workers=workers)
    for pos in range(0, len(data), frame):
        w.write(data[pos: pos + frame])
    st = w.close()
    return buf.getvalue(), time.perf_counter() - t0, st


def phase_a_zstd_write(data: bytes, frame: int = MiB) -> tuple[bytes, dict]:
    from libzseek_jax.testing import golden
    arc, dt, st = write_archive(data, "zstd", level=3, frame=frame)
    check(golden.zstd_decompress(arc) == data,
          "A: stock libzstd did not decode the archive to the input")
    return arc, {"bytes_in": len(data), "bytes_out": len(arc),
                 "ratio": len(data) / len(arc), "frames": st.frames,
                 "wall_s": dt, "MiB_per_s": len(data) / MiB / dt}


def zipf_offsets(rng, total: int, n: int, size: int, theta: float = 0.99):
    """n zipfian(theta) read offsets over the size-aligned pages of
    [0, total): page ranks are drawn by popularity, then scattered over
    the address space by a fixed random permutation."""
    pages = max(1, total // size)
    w = 1.0 / np.arange(1, pages + 1, dtype=np.float64) ** theta
    ranks = rng.choice(pages, n, p=w / w.sum())
    return rng.permutation(pages)[ranks] * size


def phase_b_reads(arc: bytes, data: bytes, n_reads: int = 2000,
                  size: int = 4096, cache_frames: int = 64,
                  seed: int = 0) -> dict:
    from libzseek_jax.runtime.reader import Reader
    r = Reader(arc, cache_frames=cache_frames)
    lat = []
    for off in zipf_offsets(np.random.default_rng(seed), len(data),
                            n_reads, size):
        off = int(off)
        t0 = time.perf_counter()
        got = r.pread_full(size, off)
        lat.append(time.perf_counter() - t0)
        check(got == data[off: off + size], f"B: pread at {off} differs")
    st = r.stats()
    hit_rate = st.cache_hits / max(1, st.cache_hits + st.cache_misses)
    t0 = time.perf_counter()
    full = Reader(arc, cache_frames=cache_frames).pread_full(len(data), 0)
    dt = time.perf_counter() - t0
    check(full == data, "B: sequential pread_full differs")
    return {"reads": n_reads, "hit_rate": hit_rate,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p99_ms": 1e3 * float(np.percentile(lat, 99)),
            "seq_wall_s": dt, "seq_MiB_per_s": len(data) / MiB / dt}


def phase_c_device_decode(arc: bytes, data: bytes,
                          n_frames: int = 64) -> dict:
    """Reader.prefetch with device_cache=True decodes the frames in one
    decode_frames(..., to_device=True) batch into the device frame cache;
    every frame is then read back from that cache and compared."""
    from libzseek_jax.runtime.reader import Reader
    r = Reader(arc, cache_frames=n_frames, device_cache=True)
    tab = r.seek_table
    step = max(1, tab.num_frames // n_frames)
    idxs = list(range(0, tab.num_frames, step))[:n_frames]
    offs = [tab.frame_d_offset(i) for i in idxs]
    t0 = time.perf_counter()
    r.prefetch(offs)
    hits0 = r.stats().cache_hits
    nbytes = 0
    for i, off in zip(idxs, offs):
        n = tab.frame_d_size(i)
        check(r.pread(n, off) == data[off: off + n], f"C: frame {i} differs")
        nbytes += n
    dt = time.perf_counter() - t0
    check(r.stats().cache_hits - hits0 == len(idxs),
          "C: a frame was not served from the device cache")
    return {"frames": len(idxs), "bytes": nbytes, "wall_s": dt,
            "MiB_per_s": nbytes / MiB / dt}


def _foreign_data(seed: int, n: int, frame: int) -> bytes:
    """Text-like frames whose second half repeats the first half with
    sparse edits: matches at distances of half a frame."""
    from libzseek_jax.testing.corpus import text_corpus
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n // frame):
        half = text_corpus(rng, frame // 2)
        twin = half.copy()
        twin[rng.integers(0, len(twin), len(twin) // 512)] = ord("#")
        parts += [half, twin]
    return np.concatenate(parts).tobytes()


def phase_d_foreign(seed: int, total: int = 32 * MiB,
                    frame: int = 4 * MiB) -> dict:
    from concurrent.futures import ThreadPoolExecutor
    from libzseek_jax.format.seek_table import FrameLog
    from libzseek_jax.runtime.reader import Reader
    from libzseek_jax.testing import golden
    data = _foreign_data(seed, total, frame)
    frames = [data[i: i + frame] for i in range(0, len(data), frame)]
    with ThreadPoolExecutor(8) as ex:   # ctypes releases the GIL
        comp = list(ex.map(lambda f: golden.zstd_compress(
            f, level=19, strategy=None), frames))
    log = FrameLog()
    for c, f in zip(comp, frames):
        log.log_frame(len(c), len(f))
    arc = b"".join(comp) + log.serialize()
    t0 = time.perf_counter()
    got = Reader(arc).pread_full(len(data), 0)
    dt = time.perf_counter() - t0
    check(got == data, "D: foreign level-19 archive read back differs")
    return {"bytes": len(data), "frames": len(frames),
            "ratio": len(data) / len(arc), "read_wall_s": dt,
            "MiB_per_s": len(data) / MiB / dt}


def phase_e_lz4(data: bytes, n_reads: int = 200, size: int = 4096,
                frame: int = MiB, seed: int = 0) -> dict:
    from libzseek_jax.runtime.reader import Reader
    from libzseek_jax.testing import golden
    arc, dt, st = write_archive(data, "lz4", frame=frame)
    check(bytes(golden.lz4f_decompress(arc)) == data,
          "E: stock liblz4 did not decode the archive to the input")
    r = Reader(arc)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for off in rng.integers(0, len(data) - size, n_reads):
        off = int(off)
        check(r.pread_full(size, off) == data[off: off + size],
              f"E: lz4 pread at {off} differs")
    return {"bytes_in": len(data), "ratio": len(data) / len(arc),
            "frames": st.frames, "write_wall_s": dt,
            "write_MiB_per_s": len(data) / MiB / dt, "reads": n_reads,
            "reads_wall_s": time.perf_counter() - t0}


@contextmanager
def default_device(dev):
    """Run everything, the codec's worker thread included, on `dev`."""
    import jax
    old = jax.config.jax_default_device
    jax.config.update("jax_default_device", dev)
    try:
        yield
    finally:
        jax.config.update("jax_default_device", old)


def phase_f_identity(data: bytes, frame: int = MiB) -> dict:
    import jax
    with open(SOURCE_CORPUS, "rb") as f:
        source = f.read()
    cpu = jax.devices("cpu")[0]
    out = {}
    for name, d in (("mixed", data), ("source", source)):
        with default_device(cpu):
            a_cpu = write_archive(d, "zstd", level=3, frame=frame)[0]
        a_dev = write_archive(d, "zstd", level=3, frame=frame)[0]
        check(a_cpu == a_dev, f"F: {name}: CPU and {jax.devices()[0]} "
              "archives differ")
        out[name] = {"bytes_in": len(d), "bytes_out": len(a_dev)}
    return out


@contextmanager
def record_first_calls(module, names):
    """Swap module.<name> for a wrapper that keeps the arguments of its
    first call, so a stage can be compiled and timed alone with the exact
    inputs the real path gave it."""
    calls = {}
    orig = {n: getattr(module, n) for n in names}

    def wrap(n, f):
        def g(*a, **k):
            calls.setdefault(n, (f, a, k))
            return f(*a, **k)
        return g

    for n in names:
        setattr(module, n, wrap(n, orig[n]))
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(module, n, f)


def _stage_report(fn, args, kwargs, reps: int = 3) -> dict:
    import jax
    mem = fn.lower(*args, **kwargs).compile().memory_analysis()
    jax.block_until_ready(fn(*args, **kwargs))        # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args, **kwargs))
    dt = (time.perf_counter() - t0) / reps
    stats = jax.devices()[0].memory_stats()
    shapes = [getattr(a, "shape", None) for a in args
              if hasattr(a, "shape")]
    return {"warm_ms": 1e3 * dt,
            "arg_shapes": [list(s) for s in shapes[:2]],
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
            "output_bytes": getattr(mem, "output_size_in_bytes", None),
            "peak_bytes_in_use": (stats or {}).get("peak_bytes_in_use")}


def phase_g_stages(data: bytes, n_blocks: int = 64) -> dict:
    """Compress and decode n_blocks 128 KiB blocks with each stage's first
    call recorded, then compile and time every stage alone.  The batch is
    the frozen source corpus (structured text: thousands of sequences per
    block, so the FSE and sequence-decode loops run at full length) plus
    1 MiB frames taken evenly across `data` (every corpus regime)."""
    from libzseek_jax.ops import zstd_decode
    from libzseek_jax.runtime import zstd_codec
    blk = zstd_codec.BLOCK
    with open(SOURCE_CORPUS, "rb") as f:
        frames = [f.read()]
    left = n_blocks * blk - -(-len(frames[0]) // blk) * blk
    stride = max(MiB, (len(data) // max(1, left // MiB)) // MiB * MiB)
    for i in range(-(-left // MiB)):
        frames.append(data[i * stride: i * stride + min(MiB, left - i * MiB)])
    enc = ("zstd_sequences", "huffman_encode_literals",
           "fse_encode_sequences")
    dec = ("huf_decode_lanes", "fse_decode_seq_lanes", "huf_decode_anchored",
           "fse_decode_anchored", "execute_sequences")
    codec = zstd_codec.ZstdCodec(level=3, max_batch_blocks=n_blocks)
    with record_first_calls(zstd_codec, enc) as ecalls:
        comp, fh = codec.compress_frames(frames, return_hints=True)
    sizes = [len(f) for f in frames]
    with record_first_calls(zstd_decode, dec) as dcalls:
        plain = zstd_decode.decode_frames(comp, sizes)
        anchored = zstd_decode.decode_frames(comp, sizes, hints=fh)
    check(plain == frames and anchored == frames,
          "G: stage-recording decode differs from the input")
    calls = {**ecalls, **dcalls}
    check(set(calls) == set(enc + dec), f"G: stages not reached: "
          f"{sorted(set(enc + dec) - set(calls))}")
    return {n: _stage_report(*calls[n]) for n in enc + dec}


def phase_cards(data: bytes, cards: int, frame: int = MiB) -> dict:
    """Writer(workers=cards) vs Writer(workers=1) on the same input."""
    import jax
    from libzseek_jax.runtime.zstd_codec import ZstdCodec
    from libzseek_jax.testing import golden
    devs = jax.devices()[:cards]
    check(len(devs) == cards, f"--cards {cards}: only {len(devs)} devices")
    codec = ZstdCodec(level=3, workers=cards)
    arc_n, dt_n, _ = write_archive(data, codec, frame=frame)
    arc_1, dt_1, _ = write_archive(data, "zstd", level=3, frame=frame)
    per_card = {d.id: codec.device_batches[d.id] for d in devs}
    check(set(codec.device_batches) == set(per_card)
          and all(v > 0 for v in per_card.values()),
          f"cards: batches per device {dict(codec.device_batches)}")
    check(arc_n == arc_1, "cards: workers archive differs from workers=1")
    check(golden.zstd_decompress(arc_n) == data,
          "cards: stock libzstd did not decode the workers archive")
    return {"bytes_in": len(data), "bytes_out": len(arc_n),
            "batches_per_device": per_card,
            f"workers{cards}_wall_s": dt_n,
            f"workers{cards}_MiB_per_s": len(data) / MiB / dt_n,
            "workers1_wall_s": dt_1,
            "workers1_MiB_per_s": len(data) / MiB / dt_1}


def report(name: str, res: dict, card: str) -> None:
    print(f"phase {name} [{card}]: {json.dumps(res)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=0,
                    help="run only the N-card workers phase")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    build_native()
    from libzseek_jax.testing import golden
    from libzseek_jax.utils.compile_cache import enable_compile_cache
    card = card_name()
    print(card)
    print(f"jax {jax.__version__}: platform={dev.platform} "
          f"kind={dev.device_kind} count={len(jax.devices())}")
    print(f"compile cache: {enable_compile_cache()}")
    print(f"golden libzstd={golden.have_zstd()} liblz4={golden.have_lz4()}",
          flush=True)
    check(golden.have_zstd() and golden.have_lz4(),
          "stock libzstd/liblz4 did not load")

    if args.cards:
        report(f"cards{args.cards}",
               phase_cards(make_data(args.seed, 1024 * MiB), args.cards),
               card)
    else:
        data = make_data(args.seed, 256 * MiB)
        arc, res = phase_a_zstd_write(data)
        report("A zstd write", res, card)
        report("B reads", phase_b_reads(arc, data, seed=args.seed), card)
        report("C device decode", phase_c_device_decode(arc, data), card)
        report("D foreign archive", phase_d_foreign(args.seed + 1), card)
        report("E lz4", phase_e_lz4(data[: 64 * MiB], seed=args.seed), card)
        report("F backend identity", phase_f_identity(data[: 8 * MiB]),
               card)
        report("G stages", phase_g_stages(data), card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
