"""BAM container decoder → structure-of-arrays tensor batches.

Replaces htslib's sam_read1/bam_mplp machinery (the reference's L1/L3 layers,
extract.c:283-295, common.c:407) with a host-side decode into fixed-width
numpy arrays ready to ship to the device:

- per-read scalars: FLAG, tid, pos, MAPQ, l_qseq, endpos, mate info, XG / NH
  auxiliary tags (getStrand, common.c:84-116, uses XG; filter_func,
  common.c:421-427, uses NH);
- per-base ragged arrays (concatenated + offsets): 4-bit base codes, phred
  quals, and CIGAR-expanded reference positions — the tensor form of
  calculate_positions() (overlaps.c:27-52): M/=/X bases carry their reference
  coordinate, I/S bases carry -1.

`ReadBatch.pad()` turns any subset of reads into [N, L] padded tensors for the
device pipeline.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BGZFReader

# BAM 4-bit base codes (bam_seqi): 1=A 2=C 4=G 8=T 15=N
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 1, 2, 4, 8, 15

_CIGAR_CONSUME_READ = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)  # MIDNSHP=X
_CIGAR_CONSUME_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)
_CIGAR_IS_ALIGNED = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], dtype=bool)  # M,=,X


@dataclass
class BamHeader:
    text: str
    names: list[str]
    lengths: list[int]

    @property
    def n_targets(self) -> int:
        return len(self.names)

    def name2id(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            return -1


@dataclass
class ReadBatch:
    """Padded structure-of-arrays view over N reads (device-ready)."""

    qname: list
    flag: np.ndarray       # [N] uint16
    tid: np.ndarray        # [N] int32
    pos: np.ndarray        # [N] int64
    mapq: np.ndarray       # [N] uint8
    l_qseq: np.ndarray     # [N] int32
    endpos: np.ndarray     # [N] int64
    mtid: np.ndarray       # [N] int32
    mpos: np.ndarray       # [N] int64
    xg: np.ndarray         # [N] int8: 0 absent/other, 1 'C', 2 'G'
    nh: np.ndarray         # [N] int32: -1 absent
    seq: np.ndarray        # [N, L] uint8 4-bit codes, 0 beyond l_qseq
    qual: np.ndarray       # [N, L] uint8, 0 beyond l_qseq
    refpos: np.ndarray     # [N, L] int32, -1 for I/S bases, -2 beyond l_qseq
    qname_hash: np.ndarray | None = None  # [N] uint64 (see qname_hashes)

    @property
    def n(self) -> int:
        return len(self.flag)

    @property
    def width(self) -> int:
        return self.seq.shape[1] if self.n else 0


class AlignmentSoA:
    """Query/batch interface over decoded SoA alignment arrays.

    Shared by BamFile and CramFile (io/cram.py); subclasses must populate
    header, qname, flag, tid, pos, mapq, l_qseq, endpos, mtid, mpos, xg, nh,
    offsets, seq_flat, qual_flat, refpos_flat, cigar_offsets, cigar_flat and
    call _finalize_order().
    """

    def _finalize_order(self) -> None:
        # Coordinate-sorted processing order (stable: preserves file order at
        # equal positions, matching the htslib iterator's delivery order).
        key = self.tid.astype(np.int64) * (1 << 40) + self.pos
        self.order = np.argsort(key, kind="stable")

    def qname_hashes(self) -> np.ndarray:
        """Cached per-read uint64 qname hash (vectorized over the native
        blob; Python-hash fallback for list-backed decodes). Used by the
        mate-pairing fast path; collisions are verified byte-exactly there."""
        cached = getattr(self, "_qname_hash_all", None)
        if cached is None:
            qn = self.qname
            if isinstance(qn, QnameView):
                cached = qn.hashes()
            else:
                cached = np.fromiter((hash(q) for q in qn), np.int64,
                                     len(qn)).astype(np.uint64)
            self._qname_hash_all = cached
        return cached


    @property
    def n_reads(self) -> int:
        return len(self.flag)

    # ----------------------------------------------------------------- queries

    def overlapping(self, tid: int, start: int, end: int) -> np.ndarray:
        """Indices (in sorted order) of reads overlapping [start, end) on tid.

        Mirrors sam_itr_queryi semantics: a read overlaps if pos < end and
        endpos > start.
        """
        mask = (self.tid == tid) & (self.pos < end) & (self.endpos > start)
        idx = np.nonzero(mask)[0]
        key = self.pos[idx]
        # stable order by position then original file order
        return idx[np.argsort(key, kind="stable")]

    def batch(self, idx: np.ndarray, width: int | None = None) -> ReadBatch:
        """Materialize a padded ReadBatch for the given read indices.

        The ragged→padded copy is a single vectorized [N, L] gather over the
        flat SoA arrays (no per-read Python loop)."""
        idx = np.asarray(idx, dtype=np.int64)
        nreads = len(idx)
        lq = self.l_qseq[idx] if nreads else np.zeros(0, np.int32)
        L = int(width) if width is not None else (int(lq.max()) if nreads else 0)
        nat = None
        if nreads and L and self.seq_flat.size:
            from . import native

            nat = native.pad_batch(self.offsets, idx, self.seq_flat,
                                   self.qual_flat, self.refpos_flat, L)
        if nat is not None:
            seq, qual, refpos = nat
        elif nreads and L and self.seq_flat.size:
            starts = self.offsets[idx].astype(np.int64)
            lens = (self.offsets[idx + 1] - self.offsets[idx]).astype(np.int64)
            cols = np.arange(L, dtype=np.int64)
            valid = cols[None, :] < lens[:, None]
            src = np.where(valid, starts[:, None] + cols[None, :], 0)
            seq = np.where(valid, self.seq_flat[src], 0).astype(np.uint8, copy=False)
            qual = np.where(valid, self.qual_flat[src], 0).astype(np.uint8, copy=False)
            refpos = np.where(valid, self.refpos_flat[src], -2)
        else:
            seq = np.zeros((nreads, L), dtype=np.uint8)
            qual = np.zeros((nreads, L), dtype=np.uint8)
            refpos = np.full((nreads, L), -2, dtype=np.int32)
        return ReadBatch(
            qname=QnameSubset(self.qname, idx),
            qname_hash=self.qname_hashes()[idx],
            flag=self.flag[idx],
            tid=self.tid[idx],
            pos=self.pos[idx],
            mapq=self.mapq[idx],
            l_qseq=self.l_qseq[idx],
            endpos=self.endpos[idx],
            mtid=self.mtid[idx],
            mpos=self.mpos[idx],
            xg=self.xg[idx],
            nh=self.nh[idx],
            seq=seq,
            qual=qual,
            refpos=refpos,
        )


    def window_soa(self, tid: int, start: int, end: int):
        """Per-window record view. In-memory files serve every window from
        the whole-file SoA; StreamingBamFile returns a freshly decoded
        SegmentSoA covering exactly the reads that can touch the window."""
        return self

    def cigar(self, i: int) -> np.ndarray:
        """Raw CIGAR ops for read i (uint32 op-words, htslib encoding)."""
        return self.cigar_flat[self.cigar_offsets[i] : self.cigar_offsets[i + 1]]

    def read_arrays(self, i: int):
        """(seq_codes, quals, refpos) ragged views for read i."""
        o0, o1 = self.offsets[i], self.offsets[i + 1]
        return self.seq_flat[o0:o1], self.qual_flat[o0:o1], self.refpos_flat[o0:o1]


class BamFile(AlignmentSoA):
    """Whole-file BAM decoder with coordinate-stable ordering.

    Decodes every record once into ragged SoA arrays; window queries
    (`overlapping(tid, start, end)`) are then pure numpy range filters —
    replacing per-chunk BAI iterator re-opens (extract.c:379) with a single
    decode pass.
    """

    def __init__(self, path: str, raw: bool = False):
        self.path = path
        if raw:
            # Uncompressed BAM ("BAM\x01" with no BGZF framing): hts_open
            # accepts these, so open_alignment routes them here.
            with open(path, "rb") as fh:
                data = fh.read()
            self._reader = None
        else:
            reader = BGZFReader(path)
            self._reader = reader
            data = reader.data
        if data[:4] != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        text = data[8 : 8 + l_text].split(b"\x00", 1)[0].decode()
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", data, p)[0]
        p += 4
        names, lengths = [], []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, p)[0]
            p += 4
            names.append(data[p : p + l_name - 1].decode())
            p += l_name
            lengths.append(struct.unpack_from("<i", data, p)[0])
            p += 4
        self.header = BamHeader(text, names, lengths)
        self._decode_records(data, p)

    # ------------------------------------------------------------------ decode

    def _decode_records(self, data: bytes, p: int) -> None:
        from . import native

        nat = native.bam_decode(data, p) if native.available() else None
        if nat is not None:
            self.flag = nat["flag"]
            self.tid = nat["tid"]
            self.pos = nat["pos"]
            self.mapq = nat["mapq"]
            self.l_qseq = nat["l_qseq"]
            self.endpos = nat["endpos"]
            self.mtid = nat["mtid"]
            self.mpos = nat["mpos"]
            self.xg = nat["xg"]
            self.nh = nat["nh"]
            self.offsets = nat["offsets"]
            self.seq_flat = nat["seq_flat"]
            self.qual_flat = nat["qual_flat"]
            self.refpos_flat = nat["refpos_flat"]
            self.cigar_offsets = nat["cigar_offsets"]
            self.cigar_flat = nat["cigar_flat"]
            self.record_offsets = nat["record_offsets"]
            self.qname = QnameView(nat["qname_blob"].tobytes(),
                                   nat["qname_offsets"])
            self._finalize_order()
            return
        self._decode_records_py(data, p)

    def _decode_records_py(self, data: bytes, p: int) -> None:
        qnames: list[str] = []
        flags, tids, poss, mapqs, lqs = [], [], [], [], []
        mtids, mposs, endposs, xgs, nhs = [], [], [], [], []
        seq_parts, qual_parts, refpos_parts = [], [], []
        cigar_parts = []
        cigar_offsets = [0]
        cigar_total = 0
        offsets = [0]
        total = 0
        n = len(data)
        nib_lut = _nibble_lut()

        rec_offsets: list[int] = []
        while p < n:
            rec_offsets.append(p)
            (block_size,) = struct.unpack_from("<i", data, p)
            rec_end = p + 4 + block_size
            (refID, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             next_refID, next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data, p + 4)
            q = p + 4 + 32
            qname = data[q : q + l_read_name - 1].decode()
            q += l_read_name
            cigar = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=q)
            q += 4 * n_cigar
            nbytes = (l_seq + 1) // 2
            seq_packed = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=q)
            q += nbytes
            qual = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=q).copy()
            q += l_seq
            want_cg = (n_cigar == 2
                       and int(cigar[0]) == ((l_seq << 4) | 4)
                       and (int(cigar[1]) & 0xF) == 3)
            xg, nh, cg = _scan_tags(data, q, rec_end, want_cg=want_cg)
            if want_cg and cg is not None and len(cg):
                # long-CIGAR fallback (SAM spec §4.2.2 / htslib bam_read1):
                # a kSmN sentinel CIGAR with the real ops in the CG:B,I tag
                # (>65535 ops cannot fit the 16-bit n_cigar field)
                cigar = cg

            seq = nib_lut[seq_packed].reshape(-1)[:l_seq].copy()
            refpos, endpos = _expand_cigar(cigar, pos, l_seq)

            qnames.append(qname)
            flags.append(flag)
            tids.append(refID)
            poss.append(pos)
            mapqs.append(mapq)
            lqs.append(l_seq)
            mtids.append(next_refID)
            mposs.append(next_pos)
            endposs.append(endpos)
            xgs.append(xg)
            nhs.append(nh)
            seq_parts.append(seq)
            qual_parts.append(qual)
            refpos_parts.append(refpos)
            cigar_parts.append(cigar)
            cigar_total += len(cigar)
            cigar_offsets.append(cigar_total)
            total += l_seq
            offsets.append(total)
            p = rec_end

        self.qname = qnames
        self.flag = np.asarray(flags, dtype=np.uint16)
        self.tid = np.asarray(tids, dtype=np.int32)
        self.pos = np.asarray(poss, dtype=np.int64)
        self.mapq = np.asarray(mapqs, dtype=np.uint8)
        self.l_qseq = np.asarray(lqs, dtype=np.int32)
        self.mtid = np.asarray(mtids, dtype=np.int32)
        self.mpos = np.asarray(mposs, dtype=np.int64)
        self.endpos = np.asarray(endposs, dtype=np.int64)
        self.xg = np.asarray(xgs, dtype=np.int8)
        self.nh = np.asarray(nhs, dtype=np.int32)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.seq_flat = np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8)
        self.qual_flat = np.concatenate(qual_parts) if qual_parts else np.zeros(0, np.uint8)
        self.refpos_flat = (
            np.concatenate(refpos_parts) if refpos_parts else np.zeros(0, np.int32)
        )
        self.cigar_offsets = np.asarray(cigar_offsets, dtype=np.int64)
        self.cigar_flat = (
            np.concatenate(cigar_parts) if cigar_parts else np.zeros(0, np.uint32)
        )
        self.record_offsets = np.asarray(rec_offsets + [n], dtype=np.int64)

        self._finalize_order()


def parse_bam_header_flat(blocks) -> tuple[BamHeader, int]:
    """Parse the BAM header from a BGZFBlockIndex without inflating the
    whole stream. Returns (header, flat offset of the first record)."""
    head = blocks.read_flat_range(0, 1 << 16)
    if head[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    l_text = struct.unpack_from("<i", head, 4)[0]
    need = 8 + l_text + (1 << 20)
    if len(head) < min(need, blocks.usize):
        head = blocks.read_flat_range(0, need)
    text = head[8 : 8 + l_text].split(b"\x00", 1)[0].decode()
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", head, p)[0]
    p += 4
    names, lengths = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", head, p)[0]
        p += 4
        names.append(head[p : p + l_name - 1].decode())
        p += l_name
        lengths.append(struct.unpack_from("<i", head, p)[0])
        p += 4
    return BamHeader(text, names, lengths), p


class SegmentSoA(BamFile):
    """A decoded slice of a BAM's record stream (streaming mode's per-window
    view). Reuses BamFile's decode/query machinery on an in-memory byte
    range; never touches the filesystem."""

    def __init__(self, header: BamHeader, data: bytes, p: int = 0):
        self.path = None
        self.header = header
        self._decode_records(data, p)


class StreamingBamFile:
    """BAI-indexed windowed BAM reader for inputs too large to decode whole.

    The in-memory BamFile inflates and decodes the entire file up front —
    fast for test-sized inputs, but a 100 GB production BAM would need
    several hundred GB of RAM. This class scans only the BGZF block tables
    (io/bgzf.BGZFBlockIndex), requires the .bai, and decodes per window:
    window_soa(tid, start, end) seeks to the linear index's minimum virtual
    offset (the reference's per-worker sam_itr_queryi, extract.c:379),
    walks record headers until the first record starting at/after `end`
    (coordinate-sorted input), and decodes exactly that byte range into a
    SegmentSoA. Memory is O(reads overlapping one window).

    Enabled by open_alignment for files over MDTPU_STREAM_THRESHOLD bytes
    (default 4 GiB) with an index present, or always with MDTPU_STREAM=1.
    """

    streaming = True

    def __init__(self, path: str):
        from .bgzf import BGZFBlockIndex
        from .bai import BaiFile
        import os

        self.path = path
        self.blocks = BGZFBlockIndex(path)
        self.header, self._first_rec_flat = parse_bam_header_flat(self.blocks)
        cands = [path + ".bai", path.rsplit(".", 1)[0] + ".bai",
                 path + ".csi", path.rsplit(".", 1)[0] + ".csi"]
        idx = next((c for c in cands if os.path.exists(c)), None)
        if idx is None:
            raise FileNotFoundError(
                f"streaming mode needs an index next to {path} (.bai/.csi)"
            )
        if idx.endswith(".csi"):
            # sam_index_load accepts .csi transparently (extract.c:291);
            # CsiFile exposes the same min_voffset surface
            from .csi import CsiFile

            self.bai = CsiFile(idx)
        else:
            self.bai = BaiFile(idx)
        # last inflated byte range, reused by the next (usually adjacent)
        # window so shared BGZF blocks are not re-inflated. Stored as ONE
        # tuple so concurrent -@ workers read/replace it atomically.
        self._cache = (-1, b"")

    @property
    def n_reads(self) -> int:
        return 0  # unknown without a full pass; used only for stats

    def window_soa(self, tid: int, start: int, end: int) -> SegmentSoA:
        v = self.bai.min_voffset(tid, max(start, 0))
        flat0 = (self.blocks.voffset_to_flat(v) if v else self._first_rec_flat)
        CHUNK = 8 << 20
        # Serve the head of this window from the previous window's inflated
        # bytes when the ranges overlap (adjacent windows share the
        # boundary-spanning reads' blocks; re-inflating them dominated the
        # per-window cost for small windows).
        c_flat0, c_buf = self._cache
        if 0 <= c_flat0 <= flat0 < c_flat0 + len(c_buf):
            buf = c_buf[flat0 - c_flat0 :]
        else:
            buf = b""
        p = 0
        cut = None
        while cut is None:
            while p + 36 <= len(buf):
                (bs,) = struct.unpack_from("<i", buf, p)
                if p + 4 + bs > len(buf):
                    break
                refid, pos = struct.unpack_from("<ii", buf, p + 4)
                if refid == -1 or refid > tid or (refid == tid and pos >= end):
                    cut = p
                    break
                p += 4 + bs
            if cut is not None:
                break
            nxt = self.blocks.read_flat_range(flat0 + len(buf),
                                              flat0 + len(buf) + CHUNK)
            if not nxt:
                cut = p  # EOF: everything walked is complete records
                break
            buf += nxt
            # the walk resumes at p over the extended buffer
        self._cache = (flat0, buf)
        return SegmentSoA(self.header, buf[:cut], 0)


class QnameView:
    """Lazy read-name accessor over the native decoder's blob (avoids
    materializing millions of Python strings up front). Also provides the
    vectorized name hashing/equality the mate-pairing fast path uses
    (ops.semantics.pair_mates): no Python string ever materializes on the
    per-window hot path."""

    def __init__(self, blob: bytes, offsets: np.ndarray):
        self._blob = blob
        self._off = np.asarray(offsets, dtype=np.int64)
        self._arr = np.frombuffer(blob, dtype=np.uint8)
        self._hashes = None

    def __len__(self) -> int:
        return len(self._off) - 1

    def __getitem__(self, i: int) -> str:
        return self._blob[self._off[i] : self._off[i + 1] - 1].decode()

    def padded(self, rows: np.ndarray):
        """[len(rows), maxlen] zero-padded name bytes + name lengths.
        Names cannot contain NUL, so (bytes, length) identifies a name."""
        rows = np.asarray(rows, dtype=np.int64)
        starts = self._off[rows]
        lens = self._off[rows + 1] - starts - 1  # strip the trailing NUL
        m = int(lens.max()) if len(lens) else 0
        col = np.arange(m, dtype=np.int64)[None, :]
        valid = col < lens[:, None]
        # add+clip then mask: dramatically cheaper than np.where on the
        # broadcast int64 index (the clamp only redirects masked lanes).
        src = starts[:, None] + col
        np.minimum(src, self._arr.size - 1, out=src)
        return np.where(valid, self._arr[src], 0), lens

    def hashes(self) -> np.ndarray:
        """Per-name uint64 FNV-1a (length-mixed), one column pass per name
        byte — the whole file hashes in a handful of [N]-vector ops."""
        if self._hashes is None:
            n = len(self)
            if n == 0:
                self._hashes = np.zeros(0, np.uint64)
                return self._hashes
            padded, lens = self.padded(np.arange(n, dtype=np.int64))
            h = np.full(n, 0xCBF29CE484222325, np.uint64)
            prime = np.uint64(0x100000001B3)
            for c in range(padded.shape[1]):
                h = (h ^ padded[:, c].astype(np.uint64)) * prime
            self._hashes = (h ^ lens.astype(np.uint64)) * prime
        return self._hashes

    def verify_equal(self, a_rows, b_rows) -> np.ndarray:
        """Vectorized byte equality of name pairs (collision check for the
        hash-grouped mate pairing)."""
        pa, la = self.padded(a_rows)
        pb, lb = self.padded(b_rows)
        w = max(pa.shape[1], pb.shape[1])
        if pa.shape[1] != w:
            pa = np.pad(pa, ((0, 0), (0, w - pa.shape[1])))
        if pb.shape[1] != w:
            pb = np.pad(pb, ((0, 0), (0, w - pb.shape[1])))
        return (la == lb) & (pa == pb).all(axis=1)


class QnameSubset:
    """Row-subset view over a parent qname container (QnameView or list),
    preserving lazy access plus the vectorized pair-verify hook."""

    def __init__(self, parent, idx: np.ndarray):
        self._parent = parent
        self._idx = np.asarray(idx, dtype=np.int64)

    def __len__(self) -> int:
        return len(self._idx)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self._parent[int(self._idx[i])]
        return QnameSubset(self._parent, self._idx[np.asarray(i)])

    def __iter__(self):
        for r in self._idx:
            yield self._parent[int(r)]

    def verify_equal(self, a, b) -> np.ndarray:
        ra = self._idx[np.asarray(a, dtype=np.int64)]
        rb = self._idx[np.asarray(b, dtype=np.int64)]
        p = self._parent
        if isinstance(p, QnameView):
            return p.verify_equal(ra, rb)
        return np.array([p[int(x)] == p[int(y)] for x, y in zip(ra, rb)],
                        dtype=bool)


def _nibble_lut() -> np.ndarray:
    """256 → (hi, lo) nibble pairs for unpacking packed 4-bit sequences."""
    lut = np.zeros((256, 2), dtype=np.uint8)
    v = np.arange(256, dtype=np.uint16)
    lut[:, 0] = (v >> 4).astype(np.uint8)
    lut[:, 1] = (v & 0xF).astype(np.uint8)
    return lut


def _expand_cigar(cigar: np.ndarray, pos: int, l_seq: int):
    """CIGAR → per-read-base reference positions + endpos.

    Tensor form of calculate_positions() (overlaps.c:27-52): aligned bases
    (M/=/X) get their 0-based reference coordinate; I/S bases get -1; D/N
    advance the reference cursor without producing read bases; H/P produce
    nothing.
    """
    if len(cigar) == 0:
        return np.full(l_seq, -1, dtype=np.int32), pos + 1
    ops = (cigar & 0xF).astype(np.int64)
    lens = (cigar >> 4).astype(np.int64)
    ref_len = int(lens[_CIGAR_CONSUME_REF[ops]].sum())
    endpos = pos + ref_len if ref_len > 0 else pos + 1
    op_per_step = np.repeat(ops, lens)
    ref_consume = _CIGAR_CONSUME_REF[op_per_step]
    read_consume = _CIGAR_CONSUME_READ[op_per_step]
    refpos_stream = pos + np.cumsum(ref_consume) - ref_consume
    aligned = _CIGAR_IS_ALIGNED[op_per_step]
    per_step_refpos = np.where(aligned, refpos_stream, -1)
    refpos = per_step_refpos[read_consume].astype(np.int32)
    if len(refpos) != l_seq:
        # Malformed CIGAR/SEQ combination; pad conservatively with -1.
        out = np.full(l_seq, -1, dtype=np.int32)
        out[: min(l_seq, len(refpos))] = refpos[:l_seq]
        refpos = out
    return refpos, endpos


def _scan_tags(data: bytes, p: int, end: int, want_cg: bool = False):
    """Walk BAM aux tags; return (xg_code, nh_value, cg_cigar).

    cg_cigar: the CG:B,I long-CIGAR array (uint32 op-words) when
    `want_cg` (the record carried the kSmN sentinel), else None.

    xg_code follows getStrand (common.c:86-88): only a value whose first
    character is 'C' or 'G' counts (Bismark's XG:Z:CT/GA both qualify via
    their first letter); anything else behaves as absent.
    """
    xg = 0
    nh = -1
    cg = None
    while p + 3 <= end:
        tag = data[p : p + 2]
        typ = data[p + 2 : p + 3]
        p += 3
        if typ in b"AcC":
            val = data[p]
            p += 1
            size = 0
        elif typ in b"sS":
            (val,) = struct.unpack_from("<H" if typ == b"S" else "<h", data, p)
            p += 2
        elif typ in b"iI":
            (val,) = struct.unpack_from("<I" if typ == b"I" else "<i", data, p)
            p += 4
        elif typ == b"f":
            (val,) = struct.unpack_from("<f", data, p)
            p += 4
        elif typ in b"ZH":
            z = data.index(b"\x00", p)
            val = data[p:z]
            p = z + 1
        elif typ == b"B":
            sub = data[p : p + 1]
            (cnt,) = struct.unpack_from("<i", data, p + 1)
            esz = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}[sub]
            val = None
            if want_cg and tag == b"CG" and sub == b"I":
                cg = np.frombuffer(data, dtype="<u4", count=cnt,
                                   offset=p + 5)
            p += 5 + esz * cnt
        else:
            break  # unknown tag type; stop scanning
        if tag == b"XG" and typ == b"Z":
            first = val[:1]
            if first == b"C":
                xg = 1
            elif first == b"G":
                xg = 2
        elif tag == b"NH" and typ in b"cCsSiI":
            nh = int(val)
    return xg, nh, cg
