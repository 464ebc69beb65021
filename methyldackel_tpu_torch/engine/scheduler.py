"""Genome-window scheduler.

Replaces the reference's mutex-guarded global cursor (main.c:7-15 +
extract.c:326-350) with a deterministic window generator: windows are the
exact (tid, start, end) triples the reference's threads would claim, in
ticket order, including the CpG/CHG-safe boundary adjustment
(adjustBounds, common.c:466-493). Downstream, windows are processed as
data-parallel batches (the device analogue of N pthreads), and output is
naturally in genome order — no output tickets needed.
"""
from __future__ import annotations

import numpy as np

REF_C, REF_G = ord("C"), ord("G")

UINT32_MAX = 0xFFFFFFFF


def adjust_bounds(fasta, name: str, local_pos: int, local_end: int):
    """adjustBounds (common.c:466-493): nudge end right so a CpG/CHG is never
    split across windows; returns (pos, end)."""
    end = local_end + 1
    start = local_end - 1 if local_end > 0 else 0
    seq = fasta.fetch(name, start, end)
    if seq is not None:
        seqlen = len(seq)
        if seqlen > 1:
            if seqlen > 2 and seq[0] == REF_C and seq[2] == REF_G:
                local_end += 2
            elif seq[1] == REF_G:
                local_end += 1
    if local_pos > local_end:
        local_pos, local_end = local_end, local_pos
    return local_pos, local_end


def windows(header, fasta, chunk_size: int, global_tid: int = 0,
            global_pos: int = 0, global_end: int = 0, adjust: bool = True):
    """Yield (tid, start, end) exactly as the worker claim loop would
    (extract.c:326-350 / MBias.c:112-135; perRead uses adjust=False,
    perRead.c:133-156)."""
    n_targets = header.n_targets
    while True:
        local_tid = global_tid
        local_pos = global_pos
        local_end = local_pos + chunk_size
        if local_tid >= n_targets:
            break
        if global_end and local_end > global_end:
            local_end = global_end
        if adjust:
            local_pos, local_end = adjust_bounds(
                fasta, header.names[local_tid], local_pos, local_end
            )
        global_pos = local_end
        if global_end > 0 and global_pos >= global_end:
            # Past the requested region: make the cursor terminal.
            global_tid = UINT32_MAX
        if local_tid < n_targets and global_tid != UINT32_MAX:
            if global_pos >= header.lengths[local_tid]:
                local_end = header.lengths[local_tid]
                global_tid += 1
                global_pos = 0
        if local_tid >= n_targets:
            break
        if global_end and local_pos >= global_end:
            break
        yield local_tid, local_pos, local_end


def parse_region(reg: str, header):
    """hts_parse_reg + name lookup (extract.c:1441-1468).

    Returns (tid, start, end) with end==0 meaning "to contig end"; raises
    ValueError on an unknown contig."""
    # hts_parse_reg: NAME[:START[-END]] with commas allowed in numbers
    name = reg
    start = 0
    end = 0
    if ":" in reg:
        name, _, rng = reg.rpartition(":")
        rng = rng.replace(",", "")
        if "-" in rng:
            s, _, e = rng.partition("-")
            start = int(s) - 1 if s else 0
            end = int(e) if e else 0
        elif rng:
            start = int(rng) - 1
            end = start + 1
        if start < 0:
            start = 0
    tid = header.name2id(name)
    if tid == -1:
        # hts_parse_reg would have split at the last ':'; the whole string
        # may itself be a contig name
        tid = header.name2id(reg)
        if tid != -1:
            return tid, 0, 0
        raise ValueError(f"{reg} did not match a known chromosome/contig name!")
    g_pos = start if start > 0 else 0
    g_end = end if end > 0 else 0
    if g_end > header.lengths[tid]:
        g_end = header.lengths[tid]
    return tid, g_pos, g_end
