"""The extract engine: window pipeline + byte-compatible emission.

Drives the full reference call stack (SURVEY §3.1) as a deterministic
sequence of data-parallel window computations:

  windows (scheduler) → read filter/trim (ops.semantics) → mate-overlap
  arbitration → 4-channel pileup scatter-add → variant exclusion / context
  merging / formatting (this module).

The per-window compute step is pluggable: the default host backend runs the
exact numpy semantics; the device backend (parallel.device) runs the same
math through the hand-written CUDA kernels of ops/ and is tested equal.
Counterpart of methyldackel_tpu/engine/extract.py, the multi-host window
shards included (parallel/distributed.py). Output is identical to the
reference binary byte-for-byte on its own test fixtures.
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..io import native
from ..io.bam import BamFile
from ..io.cram import CramFile, open_alignment
from ..io.fasta import FastaFile
from ..io import bed as bedio
from ..ops import semantics as sem
from . import formats
from .scheduler import windows, parse_region

REF_C, REF_G = ord("C"), ord("G")


@dataclass
class BedState:
    filter_idx: int = 0  # mplp_data.bedIdx (filter_func's resumable index)
    col_idx: int = 0     # extractCalls' local bedIdx (chunk + column checks)


@dataclass
class LastCall:
    """struct lastCall (extract.c:28-31); tid -1 = empty."""
    tid: int = -1
    pos: int = 0
    nmethyl: int = 0
    nunmethyl: int = 0


@dataclass
class WindowResult:
    lines: tuple  # (cpg, chg, chh) lists of strings
    n_variant_positions: int


def bed_coverage(bed, tid: int, start: int, end: int, col_idx: int):
    """Per-position coverage/strand for [start, end) following the
    posOverlapsBED walk semantics (bed.c:46-53): position p is covered by
    the first region (scanning forward) whose end > p, iff p >= its start.
    Returns (covered[W] bool, rstrand[W] int8, new_col_idx)."""
    W = end - start
    covered = np.zeros(W, dtype=bool)
    rstrand = np.zeros(W, dtype=np.int8)
    idx = col_idx
    frontier = start
    while idx < bed.n and frontier < end:
        rtid = int(bed.tid[idx])
        if rtid < tid:
            idx += 1
            continue
        if rtid > tid:
            break
        rend = int(bed.end[idx])
        if rend <= frontier:
            idx += 1
            continue
        lo = max(int(bed.start[idx]), frontier, start)
        hi = min(rend, end)
        if lo < hi:
            covered[lo - start : hi - start] = True
            rstrand[lo - start : hi - start] = bed.strand[idx]
        frontier = rend
        idx += 1
    # Advance the persisted index the way the column walk would after the
    # final column of this window (monotone; under-advance is self-healing).
    new_idx = col_idx
    while new_idx < bed.n and (
        bed.tid[new_idx] < tid or (bed.tid[new_idx] == tid and bed.end[new_idx] <= end - 1)
    ):
        new_idx += 1
    return covered, rstrand, new_idx


def prepare_window_reads(cfg, bam, batch, strand_arr, tid, bed_state,
                         ref_window, win_offset):
    """filter_func stages (common.c:407-463) for one window's reads:
    flag gates, BED span prefilter, conversion efficiency, trimming.
    Mutates batch.seq/batch.qual (trimming). Returns keep mask."""
    keep, patched_flag = sem.filter_reads(cfg, batch, strand_arr,
                                          getattr(cfg, "_mapp_by_tid", None))
    batch.flag = patched_flag

    if cfg.bed is not None:
        # Sequential span checks with the persistent filter index; a -1
        # result ends the iterator (filter_func rv<0), dropping the read and
        # everything after it.
        for i in range(batch.n):
            if not keep[i]:
                continue
            overlap, bed_state.filter_idx = bedio.span_overlaps_bed(
                int(batch.tid[i]), int(batch.pos[i]), int(batch.endpos[i]),
                cfg.bed, bed_state.filter_idx,
            )
            if overlap == 0:
                keep[i] = False
            elif overlap < 0:
                keep[i:] = False
                break

    if cfg.minConversionEfficiency > 0.0:
        eff = sem.conversion_efficiency(
            batch.seq, batch.qual, batch.refpos, strand_arr,
            ref_window, win_offset, cfg.minPhred,
        )
        keep &= eff >= np.float32(cfg.minConversionEfficiency)

    # Trimming runs unconditionally in the C (the bounds array pointer is
    # always truthy, common.c:458-459); zero bounds are a no-op.
    sem.trim_alignment(batch.seq, batch.qual, batch.l_qseq, strand_arr,
                       batch.flag, cfg.bounds)
    sem.trim_absolute(batch.seq, batch.qual, batch.l_qseq, strand_arr,
                      batch.flag, cfg.absoluteBounds)
    return keep


def compute_window_counters_host(cfg, batch, strand_arr, keep, ref_window,
                                 win_offset, win_start, win_end, rstrand=None):
    """Host (numpy) window compute: overlap arbitration + 4-channel pileup."""
    kidx = np.nonzero(keep)[0]
    if len(kidx) == 0:
        return np.zeros((win_end - win_start, 4), dtype=np.uint32)
    if len(kidx) == batch.n:
        # keep-all window: views instead of ~100 MB fancy-index copies
        # (arbitration mutates qual only, so only qual is copied)
        seq = batch.seq
        qual = batch.qual.copy()
        refpos = batch.refpos
    else:
        seq = batch.seq[kidx]
        qual = batch.qual[kidx]
        refpos = batch.refpos[kidx]
    st = strand_arr[kidx]
    a_idx, b_idx = sem.pair_mates_batch(batch, kidx)
    a_idx, b_idx = sem.touching_pairs(batch.pos[kidx], batch.endpos[kidx],
                                      a_idx, b_idx)
    fb = native.arbitrate(seq, qual, refpos, st, a_idx, b_idx)
    if fb is None:
        sem.arbitrate_overlaps(seq, qual, refpos, st, a_idx, b_idx)
    elif len(fb):
        # indel/clipped pairs: the exact per-pair path (the native kernel
        # only handles gapless mates)
        sem._arbitrate_pairs_loop(seq, qual, refpos, st,
                                  np.asarray(a_idx)[fb], np.asarray(b_idx)[fb])
    if rstrand is not None:
        # BED strand column: per-base inclusion via the region covering the
        # base's column (readStrandOverlapsBED, bed.c:56-64).
        safe = np.clip(refpos - win_start, 0, win_end - win_start - 1)
        rs = rstrand[safe]
        odd = (st.astype(np.int64) & 1)[:, None] == 1
        keep_base = (rs == 0) | ((rs == 1) & odd) | ((rs == 2) & ~odd)
    else:
        keep_base = np.ones(seq.shape, dtype=bool)
    out = native.pileup_channels(seq, qual, refpos, st, keep_base, ref_window,
                                 win_offset, win_start, win_end, cfg.minPhred)
    if out is not None:
        return out
    return sem.pileup_channels(seq, qual, refpos, st, keep_base, ref_window,
                               win_offset, win_start, win_end, cfg.minPhred)


def emit_window(cfg, chrom: str, tid: int, win_start: int, win_end: int,
                win_offset: int, ref_window: np.ndarray,
                counters: np.ndarray, covered) -> WindowResult:
    """The write phase of extractCalls (extract.c:407-510): context
    classification, variant exclusion, merging, blanks, formatting."""
    seqlen = len(ref_window)
    ctype, cdir = sem.classify_context(ref_window)
    lines = ([], [], [])
    n_variant = 0

    # Candidate positions (window-relative)
    wlen = win_end - win_start
    base_idx = np.arange(wlen) + (win_start - win_offset)
    base_idx = base_idx[base_idx < seqlen]
    ct = ctype[base_idx]
    cd = cdir[base_idx]
    keep_vec = np.array([cfg.keepCpG, cfg.keepCHG, cfg.keepCHH, 0], dtype=bool)
    ctx_kept = keep_vec[ct]

    # Fast vectorized writer for the common case: plain per-C output, no
    # context merging, no cytosine report, no BED coverage filter. Counter
    # channels stay uint32 window-wide (per-column depths are far below
    # 2^31, so sums can't wrap); only the emitted rows are widened.
    if not cfg.cytosine_report and not cfg.merge and covered is None:
        nm_v = counters[: len(base_idx), 0]
        nu_v = counters[: len(base_idx), 1]
        cov_v = nm_v + nu_v
        emit = ctx_kept & (cov_v > 0)
        if cfg.minOppositeDepth > 0:
            noff_v = counters[: len(base_idx), 2].astype(np.int64)
            nvar_v = counters[: len(base_idx), 3].astype(np.int64)
            with np.errstate(invalid="ignore", divide="ignore"):
                frac = np.where(noff_v > 0, nvar_v / np.maximum(noff_v, 1), 0.0)
            variant_mask = (noff_v >= cfg.minOppositeDepth) & (frac >= cfg.maxVariantFrac)
            has_data = counters[: len(base_idx)].any(axis=1)
            emit &= ~variant_mask
            n_variant = int((ctx_kept & variant_mask & has_data).sum())
        if cfg.minDepth > 1:
            emit &= cov_v >= cfg.minDepth
        if cfg.counts:
            # --counts layout (extract.c:60-63): chrom, start, end, coverage.
            for t in range(3):
                if not keep_vec[t]:
                    continue
                w = np.nonzero(emit & (ct == t))[0]
                if len(w) == 0:
                    continue
                cov = nm_v[w] + nu_v[w]
                pos_t = win_start + w
                rows = native.format_bedgraph(chrom, pos_t, pos_t + 1, cov)
                if rows is None:
                    rows = "".join(
                        f"{chrom}\t{p}\t{p + 1}\t{c}\n"
                        for p, c in zip(pos_t.tolist(), cov.tolist())
                    )
                lines[t].append(rows)
            return WindowResult(lines, n_variant)
        if (cfg.fraction or cfg.logit or cfg.methylKit):
            for t in range(3):
                if not keep_vec[t]:
                    continue
                w = np.nonzero(emit & (ct == t))[0]
                if len(w) == 0:
                    continue
                nm_t = nm_v[w].astype(np.int64)
                nu_t = nu_v[w].astype(np.int64)
                pos_t = win_start + w
                rows = None
                if cfg.methylKit:
                    base_t = ref_window[w + (win_start - win_offset)]
                    strand_f = (base_t == REF_C) | (base_t == ord("c"))
                    rows = native.format_methylkit(chrom, pos_t + 1, strand_f,
                                                   nm_t, nu_t)
                else:
                    # fraction / logit values in float64, exactly writeCall's
                    # double math (extract.c:57-67)
                    p = nm_t / (nm_t + nu_t)
                    if cfg.logit:
                        with np.errstate(divide="ignore"):
                            # log(1.0 - p), NOT log1p(-p): must match the
                            # C's double expression bit-for-bit
                            val = np.where(p <= 0.0, -np.inf, np.log(p)) - \
                                  np.where(p >= 1.0, -np.inf, np.log(1.0 - p))
                    else:
                        val = p
                    rows = native.format_float_rows(chrom, pos_t, pos_t + 1, val)
                if rows is None:
                    rows = "".join(
                        filter(None, (
                            formats.write_call(
                                cfg, chrom, int(pw), 1, int(m), int(u),
                                int(ref_window[int(wi) + (win_start - win_offset)]),
                                None, None)
                            for pw, m, u, wi in zip(pos_t, nm_t, nu_t, w))))
                lines[t].append(rows)
            return WindowResult(lines, n_variant)
        # Default bedGraph: batch-format each context's rows in one pass
        # (Python-level np-scalar indexing per row is ~3x slower). The C's
        # (int)(100.0*m/(m+u)) is float64 division + trunc, reproduced
        # bit-for-bit below (extract.c:50).
        for t in range(3):
            if not keep_vec[t]:
                continue
            w = np.nonzero(emit & (ct == t))[0]
            if len(w) == 0:
                continue
            nm_t = nm_v[w]
            nu_t = nu_v[w]
            pct = np.trunc(100.0 * nm_t / (nm_t + nu_t)).astype(np.int64)
            pos_t = win_start + w
            rows = native.format_bedgraph(chrom, pos_t, pos_t + 1, pct,
                                          nm_t, nu_t)
            if rows is None:
                rows = "".join(
                    f"{chrom}\t{p}\t{p + 1}\t{v}\t{m}\t{u}\n"
                    for p, v, m, u in zip(pos_t.tolist(), pct.tolist(),
                                          nm_t.tolist(), nu_t.tolist())
                )
            lines[t].append(rows)
        return WindowResult(lines, n_variant)

    if cfg.cytosine_report:
        lines0, n_variant = _emit_cytosine_vectorized(
            cfg, chrom, win_start, win_offset, ref_window, ctype, cdir,
            base_idx, ct, cd, ctx_kept, counters, covered)
        return WindowResult((lines0, [], []), n_variant)

    has_data = counters[: len(base_idx)].any(axis=1)
    candidates = np.nonzero(ctx_kept & has_data)[0]

    last_cpg = LastCall()
    last_chg = LastCall()
    merge = cfg.merge

    for w in candidates:
        pos = win_start + int(w)
        t = int(ct[w])
        direction = int(cd[w])
        base = int(ref_window[w + (win_start - win_offset)])
        uncovered = covered is not None and not covered[w]
        if uncovered and not cfg.cytosine_report:
            continue
        if uncovered:
            # BED-uncovered columns are skipped entirely in the C
            # (extract.c:403-404) and only surface later as writeBlank
            # zero-coverage rows; no variant/merge logic runs for them.
            nm = nu = 0
        else:
            nm, nu, noff, nvar = (int(x) for x in counters[w])

            # Variant-site exclusion (extract.c:444-459)
            if (cfg.minOppositeDepth > 0 and noff >= cfg.minOppositeDepth
                    and nvar / noff >= cfg.maxVariantFrac):
                n_variant += 1
                if merge:
                    if (t == sem.CTX_CPG and last_cpg.tid == tid
                            and last_cpg.pos == pos - 1 and base == REF_G):
                        last_cpg.nmethyl = 0
                        last_cpg.nunmethyl = 0
                    elif (t == sem.CTX_CHG and last_chg.tid == tid
                            and last_chg.pos == pos - 2 and base == REF_G):
                        last_chg.nmethyl = 0
                        last_chg.nunmethyl = 0
                if cfg.cytosine_report:
                    nm = nu = 0  # reported as a zero-coverage blank
                else:
                    continue
        if nm + nu == 0 and not cfg.cytosine_report:
            continue

        if not merge or t == sem.CTX_CHH:
            if cfg.cytosine_report:
                context = {sem.CTX_CPG: "G", sem.CTX_CHG: "HG", sem.CTX_CHH: "HH"}[t]
                tnc = formats.TRI_NUCLEOTIDE_CONTEXTS[
                    formats.tri_nuc_context(ref_window, w + (win_start - win_offset),
                                            seqlen, direction)
                ]
                line = formats.write_call(cfg, chrom, pos, 1, nm, nu, base, context, tnc)
                if line:
                    lines[0].append(line)
            else:
                line = formats.write_call(cfg, chrom, pos, 1, nm, nu, base, None, None)
                if line:
                    lines[t].append(line)
        else:
            if t == sem.CTX_CPG:
                if base == REF_G:
                    pos -= 1
                _process_last(lines[0], cfg, last_cpg, chrom, tid, pos, 2, nm, nu)
            else:
                if base == REF_G:
                    pos -= 2
                _process_last(lines[1], cfg, last_chg, chrom, tid, pos, 3, nm, nu)

    # Flush pending merged calls (extract.c:496-507)
    if merge:
        if cfg.keepCpG and last_cpg.tid != -1:
            line = formats.write_call(cfg, chrom, last_cpg.pos, 2,
                                      last_cpg.nmethyl, last_cpg.nunmethyl,
                                      REF_C, None, None)
            if line:
                lines[0].append(line)
        if cfg.keepCHG and last_chg.tid != -1:
            line = formats.write_call(cfg, chrom, last_chg.pos, 3,
                                      last_chg.nmethyl, last_chg.nunmethyl,
                                      REF_C, None, None)
            if line:
                lines[1].append(line)
    return WindowResult(lines, n_variant)


_COL_CODE = np.full(256, 4, np.int8)
for _b, _v in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3)):
    _COL_CODE[_b] = _v
_RC_COL_CODE = np.full(256, 4, np.int8)  # revcomp then code
for _b, _v in ((ord("A"), 3), (ord("C"), 2), (ord("G"), 1), (ord("T"), 0)):
    _RC_COL_CODE[_b] = _v


def _emit_cytosine_vectorized(cfg, chrom, win_start, win_offset, ref_window,
                              ctype, cdir, base_idx, ct, cd, ctx_kept,
                              counters, covered):
    """Vectorized cytosine_report writer: every kept-context position in the
    window gets a line; variant-excluded and BED-uncovered positions report
    zero coverage (the writeBlank behavior, extract.c:182-205, 444-459)."""
    n = len(base_idx)
    seqlen = len(ref_window)
    nm = counters[:n, 0].astype(np.int64)
    nu = counters[:n, 1].astype(np.int64)
    noff = counters[:n, 2].astype(np.int64)
    nvar = counters[:n, 3].astype(np.int64)
    variant = np.zeros(n, dtype=bool)
    if cfg.minOppositeDepth > 0:
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = np.where(noff > 0, nvar / np.maximum(noff, 1), 0.0)
        variant = (noff >= cfg.minOppositeDepth) & (frac >= cfg.maxVariantFrac)
    zero = variant.copy()
    if covered is not None:
        zero |= ~covered[:n]
    nm = np.where(zero, 0, nm)
    nu = np.where(zero, 0, nu)
    n_variant = int((ctx_kept & variant & (covered[:n] if covered is not None
                                           else True)).sum())

    emit = np.nonzero(ctx_kept)[0]
    if len(emit) == 0:
        return [], n_variant
    widx = base_idx[emit]
    d = cd[emit].astype(np.int64)
    # trinucleotide context (getTriNucContext, extract.c:120-180)
    last_idx = widx + 2 * d
    last_oob = ((d > 0) & (widx + 2 >= seqlen)) | ((d < 0) & (widx <= 1))
    last_b = ref_window[np.clip(last_idx, 0, seqlen - 1)]
    col = np.where(d > 0, _COL_CODE[last_b], _RC_COL_CODE[last_b])
    col = np.where(last_oob, 4, col)
    mid_idx = widx + d
    mid_oob = ((d > 0) & (widx + 1 >= seqlen)) | ((d < 0) & (widx == 0))
    mid_b = ref_window[np.clip(mid_idx, 0, seqlen - 1)]
    row = np.where(d > 0, _COL_CODE[mid_b], _RC_COL_CODE[mid_b])
    row = np.where(mid_oob, 4, row)
    tnc_idx = (5 * row + col).astype(np.int64)

    ctv = ct[emit]
    pos1 = win_start + emit + 1
    rows = native.format_cytosine(chrom, pos1, d, nm[emit], nu[emit],
                                  ctv, tnc_idx)
    if rows is not None:
        return [rows], n_variant
    ctx_names = {sem.CTX_CPG: "CG", sem.CTX_CHG: "CHG", sem.CTX_CHH: "CHH"}
    strands = np.where(d > 0, "+", "-")
    tnc_tab = formats.TRI_NUCLEOTIDE_CONTEXTS
    lines = [
        f"{chrom}\t{p}\t{s}\t{m}\t{u}\t{ctx_names[t]}\t{tnc_tab[x]}\n"
        for p, s, m, u, t, x in zip(pos1, strands, nm[emit], nu[emit], ctv, tnc_idx)
    ]
    return lines, n_variant


def _process_last(out: list, cfg, last: LastCall, chrom: str, tid: int,
                  pos: int, width: int, nm: int, nu: int) -> None:
    """processLast (extract.c:207-222)."""
    if last.tid == tid and last.pos == pos:
        line = formats.write_call(cfg, chrom, pos, width,
                                  nm + last.nmethyl, nu + last.nunmethyl,
                                  REF_C, None, None)
        if line:
            out.append(line)
        last.tid = -1
    else:
        if last.tid != -1:
            line = formats.write_call(cfg, chrom, last.pos, width,
                                      last.nmethyl, last.nunmethyl,
                                      REF_C, None, None)
            if line:
                out.append(line)
        last.tid = tid
        last.pos = pos
        last.nmethyl = nm
        last.nunmethyl = nu


def ensure_bam_index(bam: BamFile, path: str) -> None:
    """Missing-index recovery parity (extract.c:1048-1057): if no .bai is
    present next to the BAM, announce and build one."""
    import os

    from ..io.cram import StreamingCramFile
    from ..io.sam import SamFile

    if isinstance(bam, (CramFile, StreamingCramFile, SamFile)):
        return  # CRAM indexes by .crai/container scan; SAM needs no index
    if getattr(bam, "_reader", None) is None:
        return  # raw (uncompressed) BAM: no BGZF voffsets, none needed
    cands = [path + ".bai", os.path.splitext(path)[0] + ".bai",
             path + ".csi", os.path.splitext(path)[0] + ".csi"]
    if any(os.path.exists(c) for c in cands):
        return  # sam_index_load parity: .bai or .csi both satisfy it
    sys.stderr.write(f"Couldn't load the index for {path}, will attempt to build it.\n")
    from ..io.bai import build_bai
    from ..io.csi import BAI_MAX_POS, build_csi

    try:
        if max([0] + list(bam.header.lengths or [])) > BAI_MAX_POS:
            # BAI's 14/5 binning cannot represent coordinates >= 2^29;
            # build a CSI instead (htslib's bam_index_build does the same)
            build_csi(bam, cands[2])
        else:
            build_bai(bam, cands[0])
    except OSError:
        sys.stderr.write(f"Couldn't build the index for {path}! File corrupted?\n")
        raise


def run_extract(cfg, out_streams, compute_backend=None) -> int:
    """Full extract pipeline. out_streams: (cpg, chg, chh) file objects (any
    may be None; cytosine_report uses slot 0). Returns the number of
    variant-excluded positions (extract.c:1489)."""
    from ..utils.profiling import STATS, trace

    fasta = FastaFile(cfg.FastaName)
    with STATS.timer("decode"):
        bam = open_alignment(cfg.BAMName, fasta,
                             prefer_stream=compute_backend is not None)
    ensure_bam_index(bam, cfg.BAMName)
    hdr = bam.header
    STATS.count("reads_decoded", bam.n_reads)
    compute = compute_backend or compute_window_counters_host

    g_tid, g_pos, g_end = 0, 0, 0
    if cfg.reg:
        g_tid, g_pos, g_end = parse_region(cfg.reg, hdr)
    if cfg.bedName and cfg.bed is None:
        cfg.bed = bedio.parse_bed(cfg.bedName, hdr, cfg.keepStrand)
        if cfg.bed is None:
            raise RuntimeError("There was an error while reading in your BED file!")
        print(f"Parsed {cfg.bed.n} regions in {cfg.bedName}", file=sys.stderr)

    if cfg.filterMappability and cfg.mappability:
        # Map BAM tids onto the mappability track's name-keyed bit arrays
        # (getMappabilityValue's name lookup, common.c:213-223).
        cfg._mapp_by_tid = {t: cfg.mappability.get(n) for t, n in enumerate(hdr.names)}

    n_variant_positions = 0
    # The reference's -@ worker pool (extract.c:1479-1484): windows are
    # independent tasks (BED scans start from an order-free lower bound,
    # io/bed.lower_bound) whose results drain strictly in genome order —
    # the ticket-ordered flush (extract.c:514-535) without the spinning.
    # Device dispatch is NOT serialized: the backend queues its launches
    # on its own device stream, so worker threads
    # overlap host prep (decode/filter/trim/pairing) and transfers of
    # upcoming windows with in-flight device compute; MDTPU_SERIAL_DEVICE=1
    # restores the old one-at-a-time behavior for debugging.
    import os as _os

    compute_lock = (threading.Lock()
                    if compute_backend is not None
                    and _os.environ.get("MDTPU_SERIAL_DEVICE") == "1"
                    else None)

    dispatch_fn = getattr(compute, "dispatch", None)

    # Device backends: one program per run. (a) pad every window batch to
    # the file-global max read length so window-local maxima don't mint new
    # (L, Lq, ...) shape buckets; (b) pre-warm the canonical program in the
    # background so the per-process executable load overlaps decode/prep
    # (a backend without a .prewarm, as the CUDA one, skips this).
    global_L = None
    prewarm_fn = getattr(compute, "prewarm", None)
    if dispatch_fn is not None:
        lq_all = getattr(bam, "l_qseq", None)
        if lq_all is not None and len(lq_all):
            global_L = int(np.max(lq_all))
            if global_L > 256:
                # a single long read would otherwise force EVERY window's
                # batch over the v3 fast path's L cap (it bails at L > 256)
                # and onto the slow dense path; long-read windows can mint
                # their own (rare) shape buckets instead
                global_L = None
        # Tiny inputs finish before a background compile could ever help,
        # and a prewarm thread still inside a device call when the process
        # exits can abort it. Skip the prewarm entirely below a read-count
        # floor.
        prewarm_min = int(_os.environ.get("MDTPU_PREWARM_MIN_READS",
                                          "200000"))
        _nr = getattr(bam, "n_reads", None)
        _known_small = _nr is not None and 0 < int(_nr) < prewarm_min
        if prewarm_fn is not None and global_L and not _known_small \
                and _os.environ.get("MDTPU_PREWARM", "1") != "0":
            # expected reads per window ≈ n_reads * (chunk + L) / genome
            glen = max(1, sum(getattr(hdr, "lengths", []) or [1]))
            est = int(bam.n_reads * min(1.0, (cfg.chunkSize + global_L)
                                        / glen))
            # A reference sample lets the prewarm seed the readback
            # shape-bucket floor to this genome's context density (the
            # candidate-compacted readback's size is genome-dependent).
            ref_sample = None
            try:
                names = getattr(hdr, "names", []) or []
                lens = getattr(hdr, "lengths", []) or []
                if names and lens:
                    ref_sample = fasta.fetch(
                        names[0], 0, min(int(lens[0]), 1 << 20))
            except Exception:
                ref_sample = None
            _prewarm_th = threading.Thread(target=prewarm_fn,
                                           args=(global_L, est, ref_sample),
                                           daemon=True)
            _prewarm_th.start()
        else:
            _prewarm_th = None
    else:
        _prewarm_th = None

    def prep_window(tid, lpos, lend, view=None):
        """Host-side prep for one window (no compute/dispatch): BED gate,
        reference fetch, batch materialization, read filter/trim. Returns
        None (window skipped) or (name, tid, lpos, lend, lpos2,
        ref_window, covered, batch, strand_arr, keep, rstrand).
        `view` is an optionally prefetched window_soa (decode overlap)."""
        name = hdr.names[tid]
        bed_state = BedState()
        if cfg.bed is not None:
            bed_state.filter_idx = bed_state.col_idx = bedio.lower_bound(
                cfg.bed, tid, lpos
            )
            ok, bed_state.col_idx = bedio.span_overlaps_bed(
                tid, lpos, lend, cfg.bed, bed_state.col_idx
            )
            if ok != 1:
                return None
        lpos2 = lpos - 2 if lpos > 1 else 0
        ref_window = fasta.fetch(name, lpos2, lend + 10)
        if ref_window is None or len(ref_window) == 0:
            print(
                f"faidx_fetch_seq returned -2 while trying to fetch the sequence "
                f"for tid {name}:{lpos2}-{lend}!",
                file=sys.stderr,
            )
            print("Note that the output will be truncated!", file=sys.stderr)
            return None

        with STATS.timer("window_prepare"):
            with STATS.timer("prep_view"):
                if view is None:
                    view = bam.window_soa(tid, lpos, lend)
            with STATS.timer("prep_batch"):
                idx = view.overlapping(tid, lpos, lend)
                batch = view.batch(idx, width=global_L)
            with STATS.timer("prep_filter"):
                strand_arr = sem.strand(batch.flag, batch.xg)
                keep = prepare_window_reads(cfg, bam, batch, strand_arr,
                                            tid, bed_state, ref_window,
                                            lpos2)

        covered = rstrand = None
        if cfg.bed is not None:
            covered, rstrand, bed_state.col_idx = bed_coverage(
                cfg.bed, tid, lpos, lend, bed_state.col_idx
            )

        STATS.count("windows")
        STATS.count("reads_processed", int(keep.sum()))
        return (name, tid, lpos, lend, lpos2, ref_window, covered,
                batch, strand_arr, keep, rstrand)

    def start_window(tid, lpos, lend, view=None):
        """prep_window + compute/dispatch. Returns None (window skipped)
        or an opaque state for finish_window."""
        p = prep_window(tid, lpos, lend, view=view)
        if p is None:
            return None
        (name, tid, lpos, lend, lpos2, ref_window, covered,
         batch, strand_arr, keep, rstrand) = p
        with STATS.timer("window_dispatch"), trace("window_dispatch"):
            if compute_lock is not None:
                with compute_lock:
                    handle = compute(cfg, batch, strand_arr, keep, ref_window,
                                     lpos2, lpos, lend, rstrand)
            elif dispatch_fn is not None:
                handle = dispatch_fn(cfg, batch, strand_arr, keep, ref_window,
                                     lpos2, lpos, lend, rstrand)
            else:
                handle = compute(cfg, batch, strand_arr, keep, ref_window,
                                 lpos2, lpos, lend, rstrand)
        return (name, tid, lpos, lend, lpos2, ref_window, covered, handle)

    def finish_window(state):
        (name, tid, lpos, lend, lpos2, ref_window, covered, handle) = state
        with STATS.timer("window_compute"), trace("window_compute"):
            counters = handle.get() if hasattr(handle, "get") else handle
        with STATS.timer("window_emit"):
            return emit_window(cfg, name, tid, lpos, lend, lpos2, ref_window,
                               np.asarray(counters), covered)

    def process_window(tid, lpos, lend):
        state = start_window(tid, lpos, lend)
        return None if state is None else finish_window(state)

    # Multi-host sharding of the genome cursor: host h owns every
    # window w with w % n_hosts == h; rows land in per-window shard files
    # reassembled in window order (parallel/distributed.py) — the
    # multi-host analogue of the ticket-ordered flush (extract.c:514-535).
    host_id = int(getattr(cfg, "hostId", 0) or 0)
    n_hosts = max(1, int(getattr(cfg, "nHosts", 1) or 1))
    out_paths = getattr(cfg, "out_paths", None) or [None, None, None]

    def drain(widx, result):
        nonlocal n_variant_positions
        if result is None:
            return
        n_variant_positions += result.n_variant_positions
        if n_hosts == 1:
            for slot in range(3):
                if result.lines[slot] and out_streams[slot] is not None:
                    out_streams[slot].write("".join(result.lines[slot]))
            return
        texts = {}
        for slot in range(3):
            if result.lines[slot] and out_paths[slot]:
                texts.setdefault(out_paths[slot], []).append(
                    "".join(result.lines[slot]))
        for path, chunks in texts.items():
            with open(f"{path}.h{host_id}.w{widx}", "w") as fh:
                fh.write("".join(chunks))

    win_iter = enumerate(windows(hdr, fasta, cfg.chunkSize, g_tid, g_pos, g_end))
    if n_hosts > 1:
        win_iter = ((i, w) for i, w in win_iter if i % n_hosts == host_id)
    n_threads = max(1, int(getattr(cfg, "nThreads", 1) or 1))
    # Depth: deep enough that host prep keeps flowing through the one-time
    # per-process executable load (~20 s) of the first window's program;
    # each in-flight window holds ~10 MB (dispatch releases the batch).
    pipeline_depth = max(1, int(_os.environ.get("MDTPU_PIPELINE", "6") or 1))
    if dispatch_fn is not None and compute_lock is None \
            and pipeline_depth > 1:
        # Device-engine scheduler (all -@ counts): an ADAPTIVE hybrid
        # pipeline over two byte-identical lanes.
        #
        # - The MAIN thread assigns each prefetched window to a lane by
        #   expected completion time, preps device-lane windows and
        #   dispatches them K at a time through dispatch_group (one
        #   program + one readback per K windows amortizes the
        #   fixed per-launch and per-readback costs).
        # - MDTPU_GETTERS drain threads perform the readbacks + emit
        #   concurrently.
        # - A decode-prefetch thread overlaps BAM decode with everything.
        # - MDTPU_STEAL host-compute workers (default: min(-@, cores-1))
        #   run their windows through the exact host engine (native
        #   kernels, GIL-released) — the byte-identical second lane
        #   (replaces the -@ pthread pool of extract.c:1479-1484).
        #
        # Lane choice is ADAPTIVE: per-lane service rates
        # are estimated from a sliding window of completion timestamps and
        # each window goes to the lane with the smaller (backlog+1)/rate.
        # This is what makes the engine win in BOTH of this host's CPU
        # phases: in slow-CPU phases the device lane eats the
        # queue; in fast-CPU phases the native host lane does, and the
        # device only takes what it can service competitively — the
        # previous fixed split handed the device lane 2/3 of the windows
        # regardless, capping fast-phase throughput well below the pure
        # host engine. Bootstrap seeds one K-window probe group to the
        # device (its rate is unknowable until something drains — and the
        # first drain may sit behind the backend's one-time start-up,
        # during which the host lane keeps the whole box busy);
        # afterwards a periodic cross-probe keeps both estimates fresh so
        # mid-run phase drift flips the split back.
        #
        # A producer-assigned sequence number + reorder buffer keeps
        # output genome-ordered and the streams single-writer no matter
        # which lane computed a window.
        import queue as _queue
        from collections import deque as _deque

        group_fn = getattr(compute, "dispatch_group", None)
        group_k = max(1, int(_os.environ.get("MDTPU_BATCH_WINDOWS", "4")
                             or 1))
        if group_fn is None:
            group_k = 1
        pipeline_depth = max(pipeline_depth, 2 * group_k)
        n_getters = max(1, int(_os.environ.get("MDTPU_GETTERS", "2") or 1))
        ncores = _os.cpu_count() or 1
        steal_env = _os.environ.get("MDTPU_STEAL")
        n_steal = (max(0, int(steal_env)) if steal_env is not None
                   else min(n_threads, max(0, ncores - 1)))

        # Materialize the window list so the tail guard knows how many
        # windows remain (pure arithmetic + 3-base boundary peeks; ~3k
        # entries for a human genome).
        _win_list = list(win_iter)
        win_iter = iter(_win_list)
        n_windows_total = len(_win_list)

        q: "_queue.Queue" = _queue.Queue(maxsize=pipeline_depth)
        pf_q: "_queue.Queue" = _queue.Queue(maxsize=group_k + 2)
        # one slot of lookahead beyond the worker count, so a worker that
        # finishes while main is busy (inline compute, group dispatch)
        # always finds its next window queued
        steal_q: "_queue.Queue" = _queue.Queue(maxsize=max(2, n_steal + 1))
        failure = []
        emit_lock = threading.Lock()
        pending: dict = {}
        next_emit = [0]
        pf_stop = []

        # --- adaptive lane accounting (completions drive assignment) ---
        # Service rate per lane = 1 / EWMA of BUSY inter-completion
        # intervals: each completion contributes (now - previous
        # completion-or-busy-start of that lane), so idle gaps never count
        # and a K-window group draining as one burst contributes one real
        # dispatch-to-drain interval plus K-1 small ones — a throughput
        # estimate, not a latency one.
        lane_lock = threading.Lock()
        lane = {"dev_inflight": 0, "steal_inflight": 0, "dev_assigned": 0,
                "steal_assigned": 0, "steal_since_dev": 0,
                "dev_since_steal": 0, "dev_ewma": None, "steal_ewma": None,
                "dev_busy_t": None, "steal_busy_t": None, "dev_lat": None}
        dev_assign_t: dict = {}   # seq_no -> assign time (device lane)
        probe_every = max(8, 2 * group_k)
        _EWMA_A = 0.3

        def decide(remaining=None):
            """Throughput-first lane choice. The host (steal) lane is kept
            saturated — its capacity is the baseline the pure-host engine
            would have — and the device pipeline takes the OVERFLOW while
            its backlog stays within ~2 round trips. (A pure expected-
            completion-time rule starves the device: the steal queue caps
            its own backlog, so its ETA can never exceed a couple of
            service times while the device always carries a full pipeline
            latency.) A tail guard keeps the last few windows off the
            device so a short file never ends waiting out one more
            dispatch+readback the host lane could have finished sooner.
            Periodic cross-probes keep both rate estimates tracking this
            host's CPU-phase drift."""
            if n_steal == 0:
                return "dev"
            with lane_lock:
                if lane["steal_assigned"] < n_steal:
                    return "steal"    # seed the steal workers FIRST (they
                    # start instantly; the device probe needs prep+dispatch)
                if lane["dev_assigned"] < min(2, group_k):
                    # bootstrap probe: TWO windows (one early flush, padded
                    # to the group shape) — enough for rate + latency
                    # estimates without handing a short file's worth of
                    # windows to an unproven lane — and never at the cost
                    # of an idle steal worker. BUT the bootstrap must not
                    # stall forever: when the steal lane keeps pace with
                    # decode its queue never backs up, steal_inflight never
                    # reaches the threshold, and the device would idle for
                    # the whole run on half-probed estimates (observed on a
                    # 17-window streaming soak: 1 device window in 48 s).
                    # The probe cadence override finishes the bootstrap.
                    if lane["steal_since_dev"] >= probe_every:
                        return "dev"
                    if lane["steal_inflight"] < 2 * n_steal:
                        return "steal"
                    return "dev"
                ed, es = lane["dev_ewma"], lane["steal_ewma"]
                lat = lane["dev_lat"]
                if lane["steal_since_dev"] >= probe_every:
                    return "dev"      # rate-refresh probe
                if lane["dev_since_steal"] >= probe_every:
                    return "steal"
                if ed is not None and es is not None and lat is not None \
                        and remaining is not None:
                    guard = min(8, max(2, int(lat / max(es, 1e-3))))
                    if remaining <= guard:
                        return "steal"
                if lane["steal_inflight"] <= n_steal:
                    return "steal"    # a worker (or its next slot) is free
                if ed is None:
                    # device still warming/loading: only the probe rides it
                    return "dev" if lane["dev_inflight"] == 0 else "steal"
                cap = 2 * max(lat if lat is not None else ed, group_k * ed)
                if lane["dev_inflight"] * ed <= cap:
                    return "dev"      # overflow into the device pipeline
                return "steal"

        def note_assign(which, seq_no=None):
            now = time.perf_counter()
            with lane_lock:
                if lane[f"{which}_inflight"] == 0:
                    lane[f"{which}_busy_t"] = now
                lane[f"{which}_inflight"] += 1
                lane[f"{which}_assigned"] += 1
                if which == "dev":
                    lane["steal_since_dev"] = 0
                    lane["dev_since_steal"] += 1
                    if seq_no is not None:
                        dev_assign_t[seq_no] = now
                else:
                    lane["dev_since_steal"] = 0
                    lane["steal_since_dev"] += 1

        def note_done(which, seq_no=None):
            now = time.perf_counter()
            with lane_lock:
                lane[f"{which}_inflight"] -= 1
                t0 = lane[f"{which}_busy_t"]
                lane[f"{which}_busy_t"] = (now if lane[f"{which}_inflight"]
                                           else None)
                if t0 is not None:
                    dt = max(now - t0, 1e-4)
                    e = lane[f"{which}_ewma"]
                    lane[f"{which}_ewma"] = (dt if e is None
                                             else (1 - _EWMA_A) * e
                                             + _EWMA_A * dt)
                if which == "dev" and seq_no is not None:
                    ta = dev_assign_t.pop(seq_no, None)
                    if ta is not None:
                        la = now - ta
                        e = lane["dev_lat"]
                        lane["dev_lat"] = (la if e is None
                                           else (1 - _EWMA_A) * e
                                           + _EWMA_A * la)

        def note_cancel(which, seq_no=None):  # skipped before any compute
            with lane_lock:
                lane[f"{which}_inflight"] -= 1
                if which == "dev" and seq_no is not None:
                    dev_assign_t.pop(seq_no, None)

        def post(seq_no, widx, result):
            with emit_lock:
                pending[seq_no] = (widx, result)
                while next_emit[0] in pending:
                    jj, rr = pending.pop(next_emit[0])
                    drain(jj, rr)
                    next_emit[0] += 1

        def repost_shutdown(qq):
            # Non-blocking propagation: if the queue is full (a producer
            # refilled the slot before we could), DROP an item to make
            # room — we are shutting down (or failing) and unprocessed
            # items are moot. A blocking put here deadlocked
            # MDTPU_GETTERS=1 shutdown.
            while True:
                try:
                    qq.put_nowait(None)
                    return
                except _queue.Full:
                    try:
                        qq.get_nowait()
                    except _queue.Empty:
                        pass

        def drain_loop():
            while True:
                item = q.get()
                if item is None:
                    repost_shutdown(q)  # propagate to sibling getters
                    return
                seq_no, widx, s = item
                try:
                    post(seq_no, widx, finish_window(s))
                    note_done("dev", seq_no)
                except BaseException as exc:  # noqa: BLE001 — rethrown below
                    failure.append(exc)
                    repost_shutdown(q)
                    return

        def run_steal_item(item):
            """Host-lane service of one window (steal workers AND the main
            thread under backpressure — work conservation)."""
            seq_no, widx, (tid, lpos, lend), view = item
            p = prep_window(tid, lpos, lend, view=view)
            if p is None:
                note_cancel("steal")
                post(seq_no, widx, None)
                return
            (name, tid2, lp, le, lpos2, ref_window, covered,
             batch, strand_arr, keep, rstrand) = p
            with STATS.timer("window_compute_steal"):
                counters = compute_window_counters_host(
                    cfg, batch, strand_arr, keep, ref_window,
                    lpos2, lp, le, rstrand)
            with STATS.timer("window_emit"):
                res = emit_window(cfg, name, tid2, lp, le, lpos2,
                                  ref_window, np.asarray(counters),
                                  covered)
            STATS.count("windows_host_steal")
            post(seq_no, widx, res)
            note_done("steal")

        def steal_loop():
            while True:
                item = steal_q.get()
                if item is None:
                    repost_shutdown(steal_q)  # propagate to siblings
                    return
                try:
                    run_steal_item(item)
                except BaseException as exc:  # noqa: BLE001 — rethrown below
                    failure.append(exc)
                    repost_shutdown(steal_q)
                    return

        def prefetch_loop():
            nonlocal _prewarm_th
            seq_no = 0
            try:
                first = True
                for widx, (tid, lpos, lend) in win_iter:
                    view = bam.window_soa(tid, lpos, lend)
                    if first:
                        first = False
                        if _prewarm_th is None and prewarm_fn is not None \
                                and _os.environ.get("MDTPU_PREWARM", "1") \
                                != "0":
                            # streaming ingest: no file-global l_qseq, so
                            # size the pre-warm from the first window
                            lqv = getattr(view, "l_qseq", None)
                            if lqv is not None and len(lqv):
                                L0 = int(np.max(lqv))
                                _prewarm_th = threading.Thread(
                                    target=prewarm_fn,
                                    args=(L0, len(lqv)),
                                    daemon=True)
                                _prewarm_th.start()
                    while not pf_stop and not failure:
                        try:
                            pf_q.put((seq_no, widx, (tid, lpos, lend),
                                      view), timeout=0.5)
                            seq_no += 1
                            break
                        except _queue.Full:
                            continue
                    if pf_stop or failure:
                        return
            except BaseException as exc:  # noqa: BLE001 — rethrown below
                failure.append(exc)
            finally:
                while not pf_stop:
                    try:
                        pf_q.put(None, timeout=0.5)
                        return
                    except _queue.Full:
                        continue

        getters = [threading.Thread(target=drain_loop, daemon=True)
                   for _ in range(n_getters)]
        stealers = [threading.Thread(target=steal_loop, daemon=True)
                    for _ in range(n_steal)]
        for th in (*getters, *stealers):
            th.start()
        pf_th = threading.Thread(target=prefetch_loop, daemon=True)
        pf_th.start()

        pgroup: list = []  # [(seq_no, widx, prep)] awaiting dispatch

        def flush_group():
            if not pgroup or failure:
                pgroup.clear()
                return
            grp = list(pgroup)
            pgroup.clear()
            with STATS.timer("window_dispatch"), trace("window_dispatch"):
                # SINGLE-window flushes (probe, decode-bound early flush,
                # stream tail) ride the SAME padded group program as full
                # groups, so a probe never meets a program of its own.
                if group_fn is not None:
                    items = [(p[7], p[8], p[9], p[5], p[4], p[2], p[3],
                              p[10]) for (_s, _w, p) in grp]
                    handles = group_fn(cfg, items, pad_to=group_k)
                else:
                    handles = [dispatch_fn(cfg, p[7], p[8], p[9], p[5],
                                           p[4], p[2], p[3], p[10])
                               for (_s, _w, p) in grp]
            for (seq_no, widx, p), h in zip(grp, handles):
                state = (p[0], p[1], p[2], p[3], p[4], p[5], p[6], h)
                while not failure:
                    try:
                        q.put((seq_no, widx, state), timeout=0.5)
                        break
                    except _queue.Full:
                        continue

        try:
            while True:
                if failure:
                    break
                if pgroup:
                    try:
                        got = pf_q.get(timeout=0.2)
                    except _queue.Empty:
                        # decode-bound phase: don't sit on prepped windows
                        flush_group()
                        continue
                else:
                    got = pf_q.get()
                if got is None:
                    break
                seq_no, widx, w, view = got
                remaining = (n_windows_total - seq_no - 1
                             if n_windows_total is not None else None)
                placed = False
                full_hits = 0
                while not placed and not failure:
                    if decide(remaining) == "steal":
                        try:
                            steal_q.put(got, timeout=0.2)
                            note_assign("steal")
                            placed = True
                            continue
                        except _queue.Full:
                            # steal lane saturated: keep the device fed,
                            # then (work conservation) serve the window on
                            # THIS thread instead of idling on a full queue
                            full_hits += 1
                            if pgroup:
                                flush_group()
                                continue
                            if full_hits >= 2:
                                note_assign("steal")
                                run_steal_item(got)
                                placed = True
                            continue
                    note_assign("dev", seq_no)
                    p = prep_window(*w, view=view)
                    if p is None:
                        note_cancel("dev", seq_no)
                        post(seq_no, widx, None)
                    else:
                        pgroup.append((seq_no, widx, p))
                        # the FIRST group flushes at 2 windows (padded to
                        # the full group shape) so the probe round-trips —
                        # and the rate/latency estimates exist — sooner
                        flush_at = (2 if lane["dev_ewma"] is None
                                    else group_k)
                        if len(pgroup) >= min(flush_at, group_k):
                            flush_group()
                    placed = True
            flush_group()
            # Stream ended: help the steal workers finish their backlog
            # instead of idling (the sentinel goes in AFTER these items, in
            # the finally block, so nothing is lost).
            while not failure:
                try:
                    item = steal_q.get_nowait()
                except _queue.Empty:
                    break
                run_steal_item(item)
        finally:
            pf_stop.append(True)
            if failure:
                # Unblock the producer: drop whatever remains (the run is
                # aborting).
                while True:
                    try:
                        pf_q.get_nowait()
                    except _queue.Empty:
                        break
            pf_th.join(timeout=60)
            # Steal workers drain their own queue; a single reposted
            # sentinel walks through all of them.
            while any(th.is_alive() for th in stealers):
                try:
                    steal_q.put(None, timeout=0.5)
                    break
                except _queue.Full:
                    continue
            for th in stealers:
                th.join()
            while any(th.is_alive() for th in getters):
                try:
                    q.put(None, timeout=0.5)
                    break
                except _queue.Full:
                    continue
            for th in getters:
                th.join()
        if failure:
            raise failure[0]
        assert failure or len(pending) == 0
    elif n_threads == 1:
        for i, (tid, lpos, lend) in win_iter:
            drain(i, process_window(tid, lpos, lend))
    else:
        from concurrent.futures import ThreadPoolExecutor
        from collections import deque

        # Device backends under -@ N: workers do host prep + dispatch only;
        # the main thread performs the ordered readback + emit (the -@ N
        # generalization of the -@ 1 drain pipeline — workers blocking in
        # device_get wasted their prep slots). Host backends keep compute
        # in the workers (that IS their parallel work).
        if dispatch_fn is not None and compute_lock is None:
            work, complete = start_window, (
                lambda st: None if st is None else finish_window(st))
        else:
            work, complete = process_window, (lambda res: res)

        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            inflight = deque()
            for i, w in win_iter:
                while len(inflight) >= 2 * n_threads:
                    j, fut = inflight.popleft()
                    drain(j, complete(fut.result()))
                inflight.append((i, pool.submit(work, *w)))
            while inflight:
                j, fut = inflight.popleft()
                drain(j, complete(fut.result()))
    if n_hosts > 1:
        for s in out_streams:
            if s is not None:
                s.flush()
        from ..parallel.distributed import barrier_and_merge

        barrier_and_merge([p for p in dict.fromkeys(out_paths) if p])
    if _prewarm_th is not None:
        # A backend's prewarm only enqueues (fire-and-forget), so this
        # join is short; a daemon thread must not die inside a device call.
        _prewarm_th.join(timeout=120)
    STATS.report()
    return n_variant_positions
