"""BED region subsystem (reference bed.c).

parse_bed mirrors parseBED (bed.c:90-237): gzip-capable, skips comments and
track/browser lines, resolves contig names against the BAM header, clamps end
to target_len+1, optionally reads the strand column (keepStrand), then sorts.
Queries mirror spanOverlapsBED / posOverlapsBED / readStrandOverlapsBED
(bed.c:22-64) including the resumable index semantics the chunk scheduler
depends on.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np


@dataclass
class BedRegions:
    tid: np.ndarray     # [n] int32
    start: np.ndarray   # [n] int64
    end: np.ndarray     # [n] int64
    strand: np.ndarray  # [n] int8: 0 '.', 1 '+', 2 '-'

    @property
    def n(self) -> int:
        return len(self.tid)


def parse_bed(path: str, header, keep_strand: bool) -> BedRegions | None:
    opener = gzip.open if _is_gzip(path) else open
    tids, starts, ends, strands = [], [], [], []
    name_to_id = {name: i for i, name in enumerate(header.names)}
    try:
        with opener(path, "rt") as fh:
            for lnum, line in enumerate(fh, 1):
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                fields = line.split()
                chrom = fields[0]
                tid = name_to_id.get(chrom, -1)
                if tid == -1:
                    if chrom in ("track", "browser"):
                        continue
                    raise ValueError(f"Couldn't properly parse line number {lnum} in {path}.")
                if len(fields) < 3:
                    raise ValueError(f"Line {lnum} of {path} is malformed.")
                start = int(fields[1])
                end = int(fields[2])
                if start >= end:
                    raise ValueError(
                        f"The position on line {lnum} of {path} is incorrect ({start} >= {end})."
                    )
                start = max(start, 0)
                end = min(end, header.lengths[tid] + 1)
                strand = 0
                if keep_strand and len(fields) >= 6:
                    if fields[5] == "+":
                        strand = 1
                    elif fields[5] == "-":
                        strand = 2
                tids.append(tid)
                starts.append(start)
                ends.append(end)
                strands.append(strand)
    except OSError:
        return None
    regions = BedRegions(
        tid=np.asarray(tids, np.int32),
        start=np.asarray(starts, np.int64),
        end=np.asarray(ends, np.int64),
        strand=np.asarray(strands, np.int8),
    )
    order = np.lexsort((regions.strand, regions.end, regions.start, regions.tid))
    return BedRegions(
        regions.tid[order], regions.start[order], regions.end[order], regions.strand[order]
    )


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


def lower_bound(regs: BedRegions, tid: int, pos: int) -> int:
    """Smallest region index worth scanning for any span/position >= pos on
    tid. Regions are sorted by (tid, start) (sortBED, bed.c:66-85); within a
    tid the running max of `end` is monotone, so every region before the
    returned index has tid < `tid`, or end <= pos — neither can overlap
    [pos, ...). A forward scan (spanOverlapsBED / posOverlapsBED semantics)
    started here returns the same results as one started at 0 or at any
    sequential resumable index, which makes per-window scans order-free and
    lets windows be processed in parallel."""
    n = regs.n
    if n == 0:
        return 0
    cm = getattr(regs, "_cummax_end", None)
    if cm is None:
        cm = np.empty(n, dtype=np.int64)
        lo = 0
        while lo < n:
            hi = int(np.searchsorted(regs.tid, regs.tid[lo], side="right"))
            cm[lo:hi] = np.maximum.accumulate(regs.end[lo:hi])
            lo = hi
        regs._cummax_end = cm
    lo = int(np.searchsorted(regs.tid, tid, side="left"))
    hi = int(np.searchsorted(regs.tid, tid, side="right"))
    j = lo + int(np.searchsorted(cm[lo:hi], pos, side="right"))
    # span_overlaps_bed probes regs[idx] unconditionally (bed.c:28); keep the
    # index in range — the extra region is scanned, not matched.
    return min(j, n - 1)


def _compare_regions(tid0, start0, end0, tid1, start1, end1) -> int:
    """compareRegions (bed.c:11-16): <0 before, >0 after, 0 overlap."""
    if tid0 != tid1:
        return tid0 - tid1
    if start0 < start1 and end0 >= start1:
        return 0
    if start0 >= start1 and start0 < end1:
        return 0
    return start0 - start1


def span_overlaps_bed(tid: int, start: int, end: int, regs: BedRegions, idx: int):
    """spanOverlapsBED (bed.c:22-41). Returns (result, new_idx):
    1 overlap, 0 none here, -1 past the end of the BED file."""
    if _compare_regions(regs.tid[idx], regs.start[idx], regs.end[idx] - 1, tid, start, end) == 0:
        return 1, idx
    rv = -1
    for i in range(idx, regs.n):
        rv = _compare_regions(regs.tid[i], regs.start[i], regs.end[i] - 1, tid, start, end)
        if rv >= 0:
            idx = i
            rv = 0 if rv >= 1 else 1
            break
    if rv < 0:
        rv = -1
    return rv, idx


def pos_overlaps_bed(tid: int, pos: int, regs: BedRegions, idx: int) -> int:
    """posOverlapsBED (bed.c:46-53): -1 advance region, 0 no, 1 yes."""
    if idx >= regs.n:
        return 0
    if tid != regs.tid[idx]:
        return -1 if regs.tid[idx] < tid else 0
    if pos >= regs.end[idx]:
        return -1
    if pos < regs.start[idx]:
        return 0
    return 1


def read_strand_overlaps_bed(strand: int, region_strand: int) -> bool:
    """readStrandOverlapsBED (bed.c:56-64) with a precomputed read strand."""
    if region_strand:
        if region_strand == 1 and strand in (1, 3):
            return True
        if region_strand == 2 and strand in (2, 4):
            return True
        return False
    return True
