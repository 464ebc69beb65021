"""BAI (BAM index) parsing.

The reference loads (or builds) the BAI for every worker's region iterator
(extract.c:291, sam_index_load). This engine decodes the BAM once and serves
window queries from memory, so the BAI is not on the hot path; it is parsed
for validation/parity (presence check mirrors extract.c:1048-1057) and to
support future streaming fetches on huge inputs.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass
class BaiRef:
    bins: dict  # bin_id -> list[(chunk_beg, chunk_end)] virtual offsets
    intervals: list  # 16kb linear index of virtual offsets


class BaiFile:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path} is not a BAI index")
        (n_ref,) = struct.unpack_from("<i", data, 4)
        p = 8
        self.refs: list[BaiRef] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, p)
            p += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, p)
                p += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, p)
                    p += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, p)
            p += 4
            intervals = list(struct.unpack_from(f"<{n_intv}Q", data, p))
            p += 8 * n_intv
            self.refs.append(BaiRef(bins, intervals))

    def min_voffset(self, tid: int, start: int) -> int:
        """Smallest virtual offset that may contain reads at/after `start`."""
        ref = self.refs[tid]
        win = start >> 14
        for v in ref.intervals[win:]:
            if v:
                return v
        return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """UCSC binning scheme: all bins overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAM spec)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class _BaiAccumulator:
    """Shared BAI bin/linear-index accumulator (UCSC binning + 16kb linear
    windows + the 37450 metadata pseudo-bin), fed record-by-record by both
    the in-memory and the streaming index writer."""

    def __init__(self, n_ref: int):
        self.n_ref = n_ref
        self.bins: list[dict] = [{} for _ in range(n_ref)]
        self.linear: list[dict] = [{} for _ in range(n_ref)]
        self.span: list[list] = [[None, None] for _ in range(n_ref)]
        self.counts = [[0, 0] for _ in range(n_ref)]

    def add(self, tid: int, beg: int, end: int, unmapped: bool,
            v0: int, v1: int) -> None:
        self.counts[tid][1 if unmapped else 0] += 1
        sp = self.span[tid]
        if sp[0] is None or v0 < sp[0]:
            sp[0] = v0
        if sp[1] is None or v1 > sp[1]:
            sp[1] = v1
        b = reg2bin(beg, max(end, beg + 1))
        chunks = self.bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == v0:
            chunks[-1] = (chunks[-1][0], v1)
        else:
            chunks.append((v0, v1))
        lin = self.linear[tid]
        for w in range(beg >> 14, ((max(end, beg + 1) - 1) >> 14) + 1):
            cur = lin.get(w)
            if cur is None or v0 < cur:
                lin[w] = v0

    def write(self, path: str, n_no_coor: int) -> None:
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", self.n_ref)
        for tid in range(self.n_ref):
            bins, span, counts = self.bins[tid], self.span[tid], self.counts[tid]
            n_bin = len(bins) + (1 if span[0] is not None else 0)
            out += struct.pack("<i", n_bin)
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for c0, c1 in chunks:
                    out += struct.pack("<QQ", c0, c1)
            if span[0] is not None:
                # metadata pseudo-bin (37450): [off_beg, off_end], [mapped, unmapped]
                out += struct.pack("<Ii", 37450, 2)
                out += struct.pack("<QQ", span[0], span[1])
                out += struct.pack("<QQ", counts[0], counts[1])
            if self.linear[tid]:
                n_intv = max(self.linear[tid]) + 1
                vals = []
                prev = 0
                for w in range(n_intv):
                    prev = self.linear[tid].get(w, prev)
                    vals.append(prev)
                out += struct.pack("<i", n_intv)
                out += struct.pack(f"<{n_intv}Q", *vals)
            else:
                out += struct.pack("<i", 0)
        out += struct.pack("<Q", n_no_coor)
        with open(path, "wb") as fh:
            fh.write(bytes(out))


def build_bai(bamfile, path: str) -> None:
    """Build a BAI index for a decoded BamFile (bam_index_build parity,
    extract.c:1050). Uses the BGZF block map to produce the records'
    virtual offsets."""
    import bisect
    import os

    reader = bamfile._reader
    blocks = reader._blocks
    uoffsets = [b.uoffset for b in blocks]
    total_u = len(reader.data)
    file_size = os.path.getsize(bamfile.path)

    def voffset(flat: int) -> int:
        if flat >= total_u:
            # htslib's tell at true EOF: compressed file size, offset 0
            return file_size << 16
        i = bisect.bisect_right(uoffsets, flat) - 1
        b = blocks[i]
        return (b.coffset << 16) | (flat - b.uoffset)

    acc = _BaiAccumulator(bamfile.header.n_targets)
    n_no_coor = 0
    offs = bamfile.record_offsets
    for i in range(bamfile.n_reads):
        tid = int(bamfile.tid[i])
        beg = int(bamfile.pos[i])
        if tid < 0 or beg < 0:
            n_no_coor += 1
            continue
        acc.add(tid, beg, int(bamfile.endpos[i]), bool(bamfile.flag[i] & 0x4),
                voffset(int(offs[i])), voffset(int(offs[i + 1])))
    acc.write(path, n_no_coor)


def build_bai_streaming(bam_path: str, out_path: str) -> None:
    """Build a BAI with O(chunk) memory: sequential record-aligned chunks
    of the flat stream (BGZFBlockIndex, no whole-file inflation), decoded
    per chunk (native decoder when built), records fed to the shared
    accumulator. This is how streaming mode indexes a huge BAM that
    arrives without a .bai."""
    import os
    import numpy as np
    from .bgzf import BGZFBlockIndex
    from .bam import parse_bam_header_flat, SegmentSoA
    from . import native

    blocks = BGZFBlockIndex(bam_path)
    header, first = parse_bam_header_flat(blocks)
    file_size = os.path.getsize(bam_path)
    acc = _BaiAccumulator(header.n_targets)
    n_no_coor = 0

    def voffset(flat: int) -> int:
        if flat >= blocks.usize:
            return file_size << 16
        i = int(np.searchsorted(blocks.uoffsets, flat, side="right")) - 1
        return (int(blocks.coffsets[i]) << 16) | (flat - int(blocks.uoffsets[i]))

    pos = first
    chunk_size = 32 << 20
    while pos < blocks.usize:
        buf = blocks.read_flat_range(pos, pos + chunk_size)
        p = 0
        n = len(buf)
        while p + 4 <= n:
            (bs,) = struct.unpack_from("<i", buf, p)
            if p + 4 + bs > n:
                break
            p += 4 + bs
        if p == 0:
            if pos + n >= blocks.usize:
                raise ValueError(f"truncated final BAM record in {bam_path}")
            chunk_size *= 2
            continue
        chunk = bytes(buf[:p])
        dec = native.bam_decode(chunk, 0) if native.available() else None
        if dec is not None:
            tids, poss = dec["tid"], dec["pos"]
            ends, flags, offs = dec["endpos"], dec["flag"], dec["record_offsets"]
        else:
            seg = SegmentSoA(header, chunk, 0)
            tids, poss = seg.tid, seg.pos
            ends, flags, offs = seg.endpos, seg.flag, seg.record_offsets
        for i in range(len(tids)):
            tid = int(tids[i])
            beg = int(poss[i])
            if tid < 0 or beg < 0:
                n_no_coor += 1
                continue
            acc.add(tid, beg, int(ends[i]), bool(flags[i] & 0x4),
                    voffset(pos + int(offs[i])), voffset(pos + int(offs[i + 1])))
        pos += p
    acc.write(out_path, n_no_coor)
