"""CSI (coordinate-sorted index) support — read and build.

The reference loads indexes through htslib's sam_index_load
(extract.c:291, 1048), which transparently accepts `.csi` next to the
BAM. CSI generalizes BAI's fixed 14/5 binning to a configurable
(min_shift, depth), lifting BAI's 2^29 coordinate ceiling — required for
contigs longer than 512 Mb (wheat, some assemblies) and emitted by
default by several pipelines. This module mirrors io/bai.py's role: the
index feeds StreamingBamFile's per-window seeks; in-memory decodes don't
need it.

Layout (CSIv1): magic "CSI\\x01", min_shift i32, depth i32, l_aux i32 +
aux bytes, n_ref i32; per ref: n_bin i32, then per bin: bin u32,
loff u64 (virtual offset of the first overlapping record), n_chunk i32,
(beg,end) u64 chunk pairs; trailing n_no_coor u64. The whole stream is
BGZF-compressed on disk (like htslib's). The metadata pseudo-bin id is
bin_limit+1 (37450 at 14/5 — the BAI convention)."""
from __future__ import annotations

import struct
from dataclasses import dataclass

CSI_MAGIC = b"CSI\x01"
BAI_MAX_POS = 1 << 29  # beyond this BAI's 14/5 binning cannot represent


def reg2bin_depth(beg: int, end: int, min_shift: int = 14,
                  depth: int = 5) -> int:
    """Smallest bin containing [beg, end) under (min_shift, depth) binning
    (CSIv1 / SAM spec reg2bin generalization)."""
    end -= 1
    l, s = depth, min_shift
    t = ((1 << (3 * depth)) - 1) // 7
    while l > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        l -= 1
        s += 3
        t -= 1 << (3 * l)
    return 0


def depth_for_length(max_len: int, min_shift: int = 14) -> int:
    """Smallest depth whose deepest level covers coordinates up to
    max_len (htslib picks n_lvls the same way)."""
    depth = 5
    while max_len > (1 << (min_shift + 3 * depth)):
        depth += 1
    return depth


def _bin_interval(b: int, min_shift: int, depth: int):
    """[beg, end) genome interval of bin id `b`."""
    level = depth
    t = ((1 << (3 * depth)) - 1) // 7
    while level > 0 and b < t:
        level -= 1
        t -= 1 << (3 * level)
    shift = min_shift + 3 * (depth - level)
    return (b - t) << shift, ((b - t) + 1) << shift


@dataclass
class CsiRef:
    bins: dict  # bin_id -> (loff, [(chunk_beg, chunk_end), ...])
    # suffix-min seek table: ends[i] ascending bin-interval ends,
    # minbeg[i] = min chunk beg over bins with interval end >= ends[i]
    ends: list
    minbeg: list


class CsiFile:
    """Parsed .csi. Exposes the same min_voffset(tid, start) surface as
    BaiFile so StreamingBamFile can use either index."""

    def __init__(self, path: str):
        data = _read_maybe_bgzf(path)
        if data[:4] != CSI_MAGIC:
            raise ValueError(f"{path} is not a CSI index")
        self.min_shift, self.depth, l_aux = struct.unpack_from("<iii", data, 4)
        p = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", data, p)
        p += 4
        bin_limit = ((1 << (3 * (self.depth + 1))) - 1) // 7
        self.refs: list[CsiRef] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, p)
            p += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, loff, n_chunk = struct.unpack_from("<IQi", data, p)
                p += 16
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, p)
                    p += 16
                    chunks.append((beg, end))
                bins[bin_id] = (loff, chunks)
            self.refs.append(self._finish_ref(bins, bin_limit))

    def _finish_ref(self, bins: dict, bin_limit: int) -> CsiRef:
        ivs = []
        for b, (_loff, chunks) in bins.items():
            if b > bin_limit or not chunks:
                continue  # metadata pseudo-bin
            _beg, end = _bin_interval(b, self.min_shift, self.depth)
            ivs.append((end, min(c0 for c0, _c1 in chunks)))
        ivs.sort()
        ends, minbeg = [], []
        cur = None
        for end, mb in reversed(ivs):
            cur = mb if cur is None else min(cur, mb)
            ends.append(end)
            minbeg.append(cur)
        ends.reverse()
        minbeg.reverse()
        return CsiRef(bins, ends, minbeg)

    def min_voffset(self, tid: int, start: int) -> int:
        """Smallest virtual offset that may contain records overlapping
        [start, inf): min chunk beg over every bin whose interval extends
        past `start` (covers long records spanning in from earlier bins —
        the role BAI's linear index plays)."""
        import bisect

        ref = self.refs[tid]
        i = bisect.bisect_right(ref.ends, start)
        if i >= len(ref.ends):
            return 0
        return ref.minbeg[i]


def _read_maybe_bgzf(path: str) -> bytes:
    with open(path, "rb") as fh:
        head = fh.read(2)
    if head == b"\x1f\x8b":
        from .bgzf import BGZFReader

        return bytes(BGZFReader(path).data)
    with open(path, "rb") as fh:
        return fh.read()


class _CsiAccumulator:
    """Per-bin chunk/loff accumulator under (min_shift, depth) binning,
    fed record-by-record (the CSI twin of bai._BaiAccumulator)."""

    def __init__(self, n_ref: int, min_shift: int, depth: int):
        self.n_ref = n_ref
        self.min_shift = min_shift
        self.depth = depth
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
        b = reg2bin_depth(beg, max(end, beg + 1), self.min_shift, self.depth)
        chunks = self.bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == v0:
            chunks[-1] = (chunks[-1][0], v1)
        else:
            chunks.append((v0, v1))
        # min_shift-window linear map -> per-bin loff at write time
        lin = self.linear[tid]
        for w in range(beg >> self.min_shift,
                       ((max(end, beg + 1) - 1) >> self.min_shift) + 1):
            cur = lin.get(w)
            if cur is None or v0 < cur:
                lin[w] = v0

    def write(self, path: str, n_no_coor: int) -> None:
        bin_limit = ((1 << (3 * (self.depth + 1))) - 1) // 7
        out = bytearray(CSI_MAGIC)
        out += struct.pack("<iii", self.min_shift, self.depth, 0)
        out += struct.pack("<i", self.n_ref)
        for tid in range(self.n_ref):
            bins = self.bins[tid]
            span, counts = self.span[tid], self.counts[tid]
            lin = self.linear[tid]
            lin_keys = sorted(lin)
            n_bin = len(bins) + (1 if span[0] is not None else 0)
            out += struct.pack("<i", n_bin)
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                bbeg, _bend = _bin_interval(bin_id, self.min_shift,
                                            self.depth)
                # loff: first linear window value at/after the bin start
                import bisect

                w = bbeg >> self.min_shift
                i = bisect.bisect_left(lin_keys, w)
                loff = lin[lin_keys[i]] if i < len(lin_keys) else 0
                out += struct.pack("<IQi", bin_id, loff, len(chunks))
                for c0, c1 in chunks:
                    out += struct.pack("<QQ", c0, c1)
            if span[0] is not None:
                out += struct.pack("<IQi", bin_limit + 1, 0, 2)
                out += struct.pack("<QQ", span[0], span[1])
                out += struct.pack("<QQ", counts[0], counts[1])
        out += struct.pack("<Q", n_no_coor)
        _write_bgzf(path, bytes(out))


def _write_bgzf(path: str, payload: bytes) -> None:
    """BGZF-frame the index stream (htslib writes .csi through bgzf)."""
    import zlib

    with open(path, "wb") as fh:
        for off in range(0, len(payload) + 1, 0xFF00):
            block = payload[off : off + 0xFF00]
            if not block and off:
                break
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            comp = co.compress(block) + co.flush()
            # block = 18 header bytes (incl. XLEN=6 extra) + comp + 8 tail
            bsize = len(comp) + 25
            fh.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff")
            fh.write(struct.pack("<HBBH", 6, 66, 67, 2))
            fh.write(struct.pack("<H", bsize))
            fh.write(comp)
            fh.write(struct.pack("<II", zlib.crc32(block) & 0xFFFFFFFF,
                                 len(block)))
        # EOF marker block
        fh.write(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))


def csi_params_for(header) -> tuple[int, int]:
    max_len = max([1] + list(getattr(header, "lengths", []) or []))
    return 14, depth_for_length(max_len)


def build_csi(bamfile, path: str, min_shift: int | None = None,
              depth: int | None = None) -> None:
    """Build a .csi for a decoded BamFile (the CSI twin of bai.build_bai;
    depth auto-sized to the longest contig)."""
    import bisect
    import os

    if min_shift is None or depth is None:
        ms, dp = csi_params_for(bamfile.header)
        min_shift = ms if min_shift is None else min_shift
        depth = dp if depth is None else depth
    reader = bamfile._reader
    blocks = reader._blocks
    uoffsets = [b.uoffset for b in blocks]
    total_u = len(reader.data)
    file_size = os.path.getsize(bamfile.path)

    def voffset(flat: int) -> int:
        if flat >= total_u:
            return file_size << 16
        i = bisect.bisect_right(uoffsets, flat) - 1
        b = blocks[i]
        return (b.coffset << 16) | (flat - b.uoffset)

    acc = _CsiAccumulator(bamfile.header.n_targets, min_shift, depth)
    n_no_coor = 0
    offs = bamfile.record_offsets
    for i in range(bamfile.n_reads):
        tid = int(bamfile.tid[i])
        beg = int(bamfile.pos[i])
        if tid < 0 or beg < 0:
            n_no_coor += 1
            continue
        acc.add(tid, beg, int(bamfile.endpos[i]),
                bool(bamfile.flag[i] & 0x4),
                voffset(int(offs[i])), voffset(int(offs[i + 1])))
    acc.write(path, n_no_coor)


def build_csi_streaming(bam_path: str, out_path: str) -> None:
    """Build a .csi with O(chunk) memory (the CSI twin of
    bai.build_bai_streaming — same chunked walk, generalized binning)."""
    import os
    import numpy as np
    from .bgzf import BGZFBlockIndex
    from .bam import parse_bam_header_flat, SegmentSoA
    from . import native

    blocks = BGZFBlockIndex(bam_path)
    header, first = parse_bam_header_flat(blocks)
    min_shift, depth = csi_params_for(header)
    file_size = os.path.getsize(bam_path)
    acc = _CsiAccumulator(header.n_targets, min_shift, depth)
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
