"""Dissect the structured-text ratio gap (VERDICT r4 #2): walk the zstd
block/section headers of OUR output and stock libzstd's at the reference
config on the frozen source corpus, reporting per-side literal bytes,
sequence counts, and section byte budgets — no entropy decode needed.

Also dumps our parse's sequence-field stats (ml/offset/rep histograms)
straight from the device parse for the same data.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libzseek_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from libzseek_jax.runtime.zstd_codec import ZstdCodec
from libzseek_jax.testing import golden


def walk(frame: bytes):
    """-> totals dict over all blocks of one frame."""
    pos = 0
    magic = int.from_bytes(frame[0:4], "little")
    assert magic == 0xFD2FB528, hex(magic)
    fhd = frame[4]
    pos = 5
    fcs_code = fhd >> 6
    single_seg = (fhd >> 5) & 1
    if fhd & 3:
        pos += 4 if (fhd & 3) == 2 else (1 if (fhd & 3) == 1 else 8)
    if not single_seg:
        pos += 1
    pos += [0 if not single_seg else 1, 2, 4, 8][fcs_code] \
        if (fcs_code or single_seg) else 0
    tot = dict(blocks=0, raw_blocks=0, rle_blocks=0, lit_regen=0,
               lit_comp=0, lit_raw=0, lit_rle=0, nseq=0, seq_bytes=0,
               lit_tree=0)
    while pos < len(frame):
        bh = int.from_bytes(frame[pos: pos + 3], "little")
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        pos += 3
        tot["blocks"] += 1
        if btype == 0:
            tot["raw_blocks"] += 1
            pos += bsize
        elif btype == 1:
            tot["rle_blocks"] += 1
            pos += 1
        else:
            end = pos + bsize
            b0 = frame[pos]
            lt = b0 & 3
            sf = (b0 >> 2) & 3
            if lt in (0, 1):                      # raw / rle literals
                if sf in (0, 2):
                    rs, hl = b0 >> 3, 1
                elif sf == 1:
                    rs = (b0 >> 4) | (frame[pos + 1] << 4)
                    hl = 2
                else:
                    rs = ((b0 >> 4) | (frame[pos + 1] << 4)
                          | (frame[pos + 2] << 12))
                    hl = 3
                cs = rs if lt == 0 else 1
                tot["lit_raw" if lt == 0 else "lit_rle"] += rs
            else:                                  # compressed
                if sf == 0:
                    v = int.from_bytes(frame[pos: pos + 3], "little")
                    rs = (v >> 4) & 0x3FF
                    cs = (v >> 14) & 0x3FF
                    hl = 3
                elif sf == 1:
                    v = int.from_bytes(frame[pos: pos + 3], "little")
                    rs = (v >> 4) & 0x3FF
                    cs = (v >> 14) & 0x3FF
                    hl = 3
                elif sf == 2:
                    v = int.from_bytes(frame[pos: pos + 4], "little")
                    rs = (v >> 4) & 0x3FFF
                    cs = (v >> 18) & 0x3FFF
                    hl = 4
                else:
                    v = int.from_bytes(frame[pos: pos + 5], "little")
                    rs = (v >> 4) & 0x3FFFF
                    cs = (v >> 22) & 0x3FFFF
                    hl = 5
                tot["lit_comp"] += cs
                tot["lit_regen"] += rs
            spos = pos + hl + cs
            nb = frame[spos]
            if nb < 128:
                nseq, sl = nb, 1
            elif nb < 255:
                nseq = ((nb - 128) << 8) + frame[spos + 1]
                sl = 2
            else:
                nseq = int.from_bytes(frame[spos + 1: spos + 3],
                                      "little") + 0x7F00
                sl = 3
            tot["nseq"] += nseq
            tot["seq_bytes"] += end - (spos + sl)
            tot["lit_tree"] += hl
            pos = end
        if last:
            break
    return tot


def main():
    from tools.source_ratio import corpus
    data = corpus(8)
    codec = ZstdCodec(level=int(os.environ.get("LV", "3")))
    ours = b"".join(codec.compress_frames([data]))
    ref = golden.zstd_compress(data, level=int(os.environ.get("LV", "3")))
    for name, frame in (("ours", ours), ("ref-fast", ref)):
        t = walk(frame)
        print(f"{name:>9}: {len(frame):>8} B  blocks {t['blocks']:>3} "
              f"(raw {t['raw_blocks']}) lit_comp {t['lit_comp']:>7} "
              f"(regen {t['lit_regen']:>7}) lit_raw {t['lit_raw']:>6} "
              f"nseq {t['nseq']:>6} seq_bytes {t['seq_bytes']:>7} "
              f"bits/seq {8 * t['seq_bytes'] / max(t['nseq'], 1):.2f}")


if __name__ == "__main__":
    main()
