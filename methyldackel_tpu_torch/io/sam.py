"""SAM text input.

The reference binary accepts SAM because htslib's `hts_open` auto-detects
it (its own docs say BAM/CRAM, main.c:31, but
`MethylDackel extract ref.fa aln.sam` works) — parity requires the same.
This parses the text format into the shared
AlignmentSoA layout (io/bam.py), so every engine and subcommand works on
SAM unchanged.

Restrictions mirror the pipeline's needs: coordinate-sorted input (like
BAM/CRAM), @SQ-declared reference names. Unknown RNAMEs raise. Gzipped
SAM (.sam.gz) is accepted via the gzip module.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

from .bam import AlignmentSoA, BamHeader, _expand_cigar

_CIGAR_OPS = "MIDNSHP=X"
_OP2CODE = {c: i for i, c in enumerate(_CIGAR_OPS)}

# ASCII base → BAM 4-bit code: the CRAM reader's table plus SAM's U→T
from .cram import _ASCII2CODE

_SEQ_CODE = _ASCII2CODE.copy()
_SEQ_CODE[ord("u")] = 8  # U → T (RNA-style SAM)
_SEQ_CODE[ord("U")] = 8


def _parse_cigar(s: str) -> np.ndarray:
    if s == "*":
        return np.zeros(0, np.uint32)
    out = []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            op = _OP2CODE.get(ch)
            if op is None:
                raise ValueError(f"sam: bad CIGAR op {ch!r} in {s!r}")
            out.append((num << 4) | op)
            num = 0
    return np.asarray(out, np.uint32)


class SamFile(AlignmentSoA):
    """Whole-file SAM decoder sharing BamFile's SoA/query interface."""

    def __init__(self, path: str):
        self.path = path
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as fh:
            lines = fh.read().splitlines()
        hdr_lines = []
        names: list[str] = []
        lengths: list[int] = []
        body_start = 0
        for i, line in enumerate(lines):
            if not line.startswith("@"):
                body_start = i
                break
            hdr_lines.append(line)
            if line.startswith("@SQ"):
                sn, ln = None, 0
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        sn = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                if sn is not None:
                    names.append(sn)
                    lengths.append(ln)
            body_start = i + 1
        self.header = BamHeader("\n".join(hdr_lines) + ("\n" if hdr_lines
                                                        else ""),
                                names, lengths)
        name2id = {n: i for i, n in enumerate(names)}

        qnames: list[str] = []
        flags, tids, poss, mapqs, lqs = [], [], [], [], []
        mtids, mposs, endposs, xgs, nhs = [], [], [], [], []
        seq_parts, qual_parts, refpos_parts, cigar_parts = [], [], [], []
        cigar_offsets = [0]
        offsets = [0]
        total = cig_total = 0
        for line in lines[body_start:]:
            if not line or line.startswith("@"):
                continue
            f = line.split("\t")
            if len(f) < 11:
                raise ValueError(f"sam: truncated alignment line: {line[:60]!r}")
            qname, flag, rname, pos1, mapq, cig, rnext, pnext = (
                f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5], f[6],
                int(f[7]))
            seq_s, qual_s = f[9], f[10]
            if rname == "*":
                tid = -1
            else:
                tid = name2id.get(rname)
                if tid is None:
                    raise ValueError(f"sam: RNAME {rname!r} not in any @SQ line")
            if rnext == "*":
                mtid = -1
            elif rnext == "=":
                mtid = tid
            else:
                mtid = name2id.get(rnext, -1)
            if seq_s == "*":
                seq = np.zeros(0, np.uint8)
                l_seq = 0
            else:
                seq = _SEQ_CODE[np.frombuffer(seq_s.encode(), np.uint8)]
                l_seq = len(seq)
            if qual_s == "*" or l_seq == 0:
                qual = np.full(l_seq, 0xFF, np.uint8)
            else:
                qual = (np.frombuffer(qual_s.encode(), np.uint8)
                        - np.uint8(33))
                if len(qual) != l_seq:
                    raise ValueError(
                        f"sam: SEQ/QUAL length mismatch for {qname}")
            cigar = _parse_cigar(cig)
            pos = pos1 - 1
            refpos, endpos = _expand_cigar(cigar, pos, l_seq)
            xg = 0
            nh = 1
            for tag in f[11:]:
                if tag.startswith("XG:Z:"):
                    v = tag[5:]
                    xg = 1 if v == "CT" else (2 if v == "GA" else 0)
                elif tag.startswith("NH:i:"):
                    nh = int(tag[5:])
            qnames.append(qname)
            flags.append(flag)
            tids.append(tid)
            poss.append(pos)
            mapqs.append(mapq)
            lqs.append(l_seq)
            mtids.append(mtid)
            mposs.append(pnext - 1)
            endposs.append(endpos)
            xgs.append(xg)
            nhs.append(nh)
            seq_parts.append(seq)
            qual_parts.append(qual)
            refpos_parts.append(refpos)
            cigar_parts.append(cigar)
            cig_total += len(cigar)
            cigar_offsets.append(cig_total)
            total += l_seq
            offsets.append(total)

        n = len(flags)
        self.qname = qnames
        self.flag = np.asarray(flags, np.uint16)
        self.tid = np.asarray(tids, np.int32)
        self.pos = np.asarray(poss, np.int64)
        self.mapq = np.asarray(mapqs, np.uint8)
        self.l_qseq = np.asarray(lqs, np.int32)
        self.mtid = np.asarray(mtids, np.int32)
        self.mpos = np.asarray(mposs, np.int64)
        self.endpos = np.asarray(endposs, np.int64)
        self.xg = np.asarray(xgs, np.int8)
        self.nh = np.asarray(nhs, np.int32)
        self.offsets = np.asarray(offsets, np.int64)
        self.seq_flat = (np.concatenate(seq_parts) if seq_parts
                         else np.zeros(0, np.uint8))
        self.qual_flat = (np.concatenate(qual_parts) if qual_parts
                          else np.zeros(0, np.uint8))
        self.refpos_flat = (np.concatenate(refpos_parts) if refpos_parts
                            else np.zeros(0, np.int32))
        self.cigar_offsets = np.asarray(cigar_offsets, np.int64)
        self.cigar_flat = (np.concatenate(cigar_parts) if cigar_parts
                           else np.zeros(0, np.uint32))
        self._finalize_order()
