"""mbias subcommand: per-read-cycle methylation bias (MBias.c).

The per-thread strandMeth counters + post-join merge of the reference
(MBias.c:57-230, 541-552) become a single [4 strands, 2 reads, 2 states,
max_cycle] counter tensor accumulated across genome windows — the window
accumulation is associative, so the per-window deltas merge in any order.
Deliberately no mate-overlap arbitration (MBias.c:160).
Counterpart of methyldackel_tpu/engine/mbias.py, the multi-host counter
shards included (parallel/distributed.py).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..config import Config, c_atoi, c_atof, parse_bounds
from ..io.bam import BamFile
from ..io.cram import open_alignment
from ..io.fasta import FastaFile
from ..io import bed as bedio
from ..ops import semantics as sem
from .extract import BedState, prepare_window_reads, bed_coverage
from .scheduler import windows, parse_region
from . import svg


def compute_mbias(cfg, bam, fasta, g_tid=0, g_pos=0, g_end=0, device=None):
    """Run the window loop and return (the merged [4,2,2,L] uint64
    counters, the device backend or None for the host engine). ``device``
    None selects the backend by MDTPU_ENGINE; "cpu" or "cuda" builds it
    there.

    With -@ > 1 windows run on a thread pool; the per-window counter deltas
    are associative uint64 adds, so the merge is order-free — the form the
    reference's per-thread strandMeth merge takes here (MBias.c:541-552)."""
    hdr = bam.header
    # Counters grow to the longest read cycle seen, window by window — the
    # reference's growStrandMeth (MBias.c:16-40); nothing needs a whole-file
    # scan, so streaming inputs work too.
    counters = np.zeros((4, 2, 2, 0), dtype=np.uint64)
    keep_ctx = (cfg.keepCpG, cfg.keepCHG, cfg.keepCHH)
    if device is None:
        from ..parallel import select_mbias_backend

        device_compute = select_mbias_backend(cfg)
    else:
        from ..parallel.device import make_mbias_backend

        device_compute = make_mbias_backend(cfg, device)

    def grown(base, L):
        if L <= base.shape[3]:
            return base
        out = np.zeros(base.shape[:3] + (L,), dtype=base.dtype)
        out[..., : base.shape[3]] = base
        return out

    def process_window(tid, lpos, lend):
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
        # mbias fetches [localPos, localEnd] closed with no left slack
        # (MBias.c:147), unlike extract's localPos-2 .. +10 window.
        ref_window = fasta.fetch(name, lpos, lend)
        if ref_window is None or len(ref_window) == 0:
            sys.stderr.write(
                f"faidx_fetch_seq returned -2 while trying to fetch the sequence "
                f"for tid {name}:{lpos}-{lend}!\nNote that the output will be truncated!\n"
            )
            return StopIteration

        view = bam.window_soa(tid, lpos, lend)
        idx = view.overlapping(tid, lpos, lend)
        batch = view.batch(idx)
        strand_arr = sem.strand(batch.flag, batch.xg)
        keep = prepare_window_reads(cfg, bam, batch, strand_arr, tid, bed_state,
                                    ref_window, lpos)
        kidx = np.nonzero(keep)[0]
        if not len(kidx):
            return None
        seq = batch.seq[kidx]
        qual = batch.qual[kidx]
        refpos = batch.refpos[kidx]
        st = strand_arr[kidx]
        flag = batch.flag[kidx]

        keep_base = np.ones(seq.shape, dtype=bool)
        if cfg.bed is not None:
            covered, rstrand, bed_state.col_idx = bed_coverage(
                cfg.bed, tid, lpos, lend, bed_state.col_idx
            )
            safe = np.clip(refpos - lpos, 0, lend - lpos - 1)
            keep_base &= covered[safe]
            rs = rstrand[safe]
            odd = (st.astype(np.int64) & 1)[:, None] == 1
            keep_base &= (rs == 0) | ((rs == 1) & odd) | ((rs == 2) & ~odd)

        wl = int(batch.l_qseq[kidx].max())
        if device_compute is not None:
            return device_compute(seq, qual, refpos, st, flag, keep_base,
                                  ref_window, lpos, lpos, lend, keep_ctx, wl,
                                  pos=batch.pos[kidx],
                                  lq=batch.l_qseq[kidx])
        return sem.mbias_counters(
            seq, qual, refpos, st, flag, keep_base, ref_window, lpos,
            lpos, lend, keep_ctx, cfg.minPhred, wl,
        )

    # Multi-host: host h computes the counter sum over its window residue
    # class; the cross-host merge is the same associative add (the
    # multi-host form of the reference's per-thread strandMeth merge,
    # MBias.c:541-552).
    host_id = int(getattr(cfg, "hostId", 0) or 0)
    n_hosts = max(1, int(getattr(cfg, "nHosts", 1) or 1))
    win_iter = windows(hdr, fasta, cfg.chunkSize, g_tid, g_pos, g_end)
    if n_hosts > 1:
        win_iter = (w for i, w in enumerate(win_iter) if i % n_hosts == host_id)
    n_threads = max(1, int(getattr(cfg, "nThreads", 1) or 1))
    if n_threads == 1:
        for w in win_iter:
            delta = process_window(*w)
            if delta is StopIteration:
                return counters, device_compute
            if delta is not None:
                counters = grown(counters, delta.shape[3])
                counters[..., : delta.shape[3]] += delta
        return counters, device_compute
    from concurrent.futures import ThreadPoolExecutor
    from collections import deque

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        inflight = deque()

        def drain_one():
            delta = inflight.popleft().result()
            if delta is StopIteration:
                return False
            if delta is not None:
                counters_acc(delta)
            return True

        def counters_acc(delta):
            nonlocal counters
            counters = grown(counters, delta.shape[3])
            counters[..., : delta.shape[3]] += delta

        for w in win_iter:
            while len(inflight) >= 2 * n_threads:
                if not drain_one():
                    return counters, device_compute
            inflight.append(pool.submit(process_window, *w))
        while inflight:
            if not drain_one():
                return counters, device_compute
    return counters, device_compute


def counters_to_strandmeths(counters: np.ndarray):
    """Split the merged tensor into per-strand StrandMeth views with the
    reference's `l` semantics (highest used cycle + 1, MBias.c:212)."""
    meths = []
    for s in range(4):
        c = counters[s]
        nz = np.nonzero(c.sum(axis=(0, 1)))[0]
        l = int(nz[-1]) + 1 if len(nz) else 0
        meths.append(svg.StrandMeth(c, l))
    return meths


_MBIAS_LOPTS = [
    ("noCpG", 0, 1), ("CHG", 0, 2), ("CHH", 0, 3), ("keepDupes", 0, 4),
    ("keepSingleton", 0, 5), ("keepDiscordant", 0, 6), ("txt", 0, 7),
    ("noSVG", 0, 8), ("nOT", 1, 9), ("nOB", 1, 10), ("nCTOT", 1, 11),
    ("nCTOB", 1, 12), ("chunkSize", 1, 13), ("keepStrand", 0, 14),
    ("minConversionEfficiency", 1, 15), ("ignoreNH", 0, 16),
    ("ignoreFlags", 1, "F"), ("requireFlags", 1, "R"), ("help", 0, "h"),
    ("version", 0, "v"),
]


def mbias_usage():
    """Full option docs, mirroring MBias.c:232-302 in this tool's words."""
    sys.stderr.write(
        "\nUsage: methyldackel-tpu-torch mbias [OPTIONS] <ref.fa> <sorted_alignments.bam> "
        "<output.prefix>\n"
        "\n"
        "Plot per-read-cycle methylation (one SVG per strand) and suggest\n"
        "--OT/--OB/--CTOT/--CTOB inclusion bounds for extract.\n"
        "\n"
        "Options:\n"
        " -q INT           Minimum MAPQ for an alignment to be used (default 10).\n"
        " -p INT           Minimum base Phred score for a call (default 5, must be >0).\n"
        " -D INT           Maximum per-base depth (accepted for compatibility).\n"
        " -r STR           Restrict processing to this region.\n"
        " -l FILE          BED file of regions to include.\n"
        " --keepStrand     With -l, honor the BED strand column (column 6); -r may\n"
        "                  further restrict the -l regions.\n"
        " -@ INT           Worker threads (default 1).\n"
        " --chunkSize INT  Genome span per work unit (default 1000000, >= 1).\n"
        " --keepDupes      Use alignments flagged as duplicates.\n"
        " --keepSingleton  Use paired alignments whose mate did not align.\n"
        " --keepDiscordant Use paired alignments lacking the properly-paired bit.\n"
        " -F, --ignoreFlags INT   Skip alignments with any of these FLAG bits\n"
        "                  (default 0xF00: secondary/QC-fail/duplicate/supplementary).\n"
        " -R, --requireFlags INT  Keep only alignments with ALL of these bits\n"
        "                  (default 0).\n"
        " --ignoreNH       Do not treat NH>1 alignments as multimappers.\n"
        " --minConversionEfficiency F  Minimum per-read non-CpG conversion\n"
        "                  efficiency to keep a read (default 0.0, max 1.0).\n"
        " --txt            Print 1-based tab-separated counters to stdout (for R\n"
        "                  or manual plotting).\n"
        " --noSVG          Skip the SVG files (implies --txt; no output prefix\n"
        "                  needed).\n"
        " --noCpG          Exclude CpG-context calls from the counters.\n"
        " --CHG            Include CHG-context calls.\n"
        " --CHH            Include CHH-context calls.\n"
        " --nOT A,B,C,D    Always trim this many bases from each read end (1-based\n"
        "                  from the ends; left,right of read #1 then read #2; 0 =\n"
        "                  the alignment end itself). E.g. --nOT 5,10,0,0 on a\n"
        "                  100 bp read #1 keeps bases 5..90.\n"
        " --nOB/--nCTOT/--nCTOB A,B,C,D  Same, for the original-bottom and the\n"
        "                  two complementary strands.\n"
        " --version        Print the version and exit.\n"
    )


def mbias(argv, device=None):
    """The mbias subcommand. ``device`` None selects the backend by
    MDTPU_ENGINE (``cuda``, the default, ``mesh`` or ``host``); "cpu" or "cuda"
    builds the device backend there. Returns (rc, backend)."""
    from ..cli import getopt_long, GetoptError, print_version

    cfg = Config()
    SVG, txt = 1, 0
    try:
        opts, pos = getopt_long(argv, "hvq:p:r:l:D:F:@:", _MBIAS_LOPTS)
    except GetoptError as e:
        sys.stderr.write(f"Invalid option '{e}'\n")
        mbias_usage()
        return 1, None
    for key, val in opts:
        if key == "h":
            mbias_usage()
            return 0, None
        elif key == "v":
            print_version()
            return 0, None
        elif key == "D":
            pass
        elif key == "r":
            cfg.reg = val
        elif key == "l":
            cfg.bedName = val
        elif key == 1:
            cfg.keepCpG = 0
        elif key == 2:
            cfg.keepCHG = 1
        elif key == 3:
            cfg.keepCHH = 1
        elif key == 4:
            cfg.keepDupes = 1
        elif key == 5:
            cfg.keepSingleton = 1
        elif key == 6:
            cfg.keepDiscordant = 1
        elif key == 7:
            txt = 1
        elif key == 8:
            SVG = 0
            txt = 1
        elif key in (9, 10, 11, 12):
            parse_bounds(val, cfg.absoluteBounds, key - 9)
        elif key == 13:
            cfg.chunkSize = c_atoi(val)
            if cfg.chunkSize < 1:
                sys.stderr.write("Error: The chunk size must be at least 1!\n")
                return 1, None
        elif key == 14:
            cfg.keepStrand = 1
        elif key == 15:
            cfg.minConversionEfficiency = c_atof(val)
        elif key == 16:
            cfg.ignoreNH = 1
        elif key == "F":
            cfg.ignoreFlags = c_atoi(val)
        elif key == "R":
            cfg.requireFlags = c_atoi(val)
        elif key == "q":
            cfg.minMapq = c_atoi(val)
        elif key == "p":
            cfg.minPhred = c_atoi(val)
        elif key == "@":
            cfg.nThreads = c_atoi(val)

    if not argv:
        mbias_usage()
        return 0, None
    if (SVG and len(pos) != 3) or (not SVG and len(pos) < 2):
        sys.stderr.write(
            "You must supply a reference genome in fasta format, an input BAM "
            "file, and an output prefix!!!\n"
        )
        mbias_usage()
        return -1, None
    if cfg.minPhred < 1:
        sys.stderr.write(
            f"-p {cfg.minPhred} is invalid. resetting to 1, which is the lowest possible value.\n"
        )
        cfg.minPhred = 1
    if cfg.minMapq < 0:
        sys.stderr.write(
            f"-q {cfg.minMapq} is invalid. Resetting to 0, which is the lowest possible value.\n"
        )
        cfg.minMapq = 0
    if not (cfg.keepCpG + cfg.keepCHG + cfg.keepCHH):
        sys.stderr.write(
            "You haven't specified any metrics to output!\nEither don't use the "
            "--noCpG option or specify --CHG and/or --CHH.\n"
        )
        return -1, None

    cfg.FastaName = pos[0]
    cfg.BAMName = pos[1]
    opref = pos[2] if SVG else None

    fasta = FastaFile(cfg.FastaName)
    bam = open_alignment(cfg.BAMName, fasta)
    hdr = bam.header
    g_tid = g_pos = g_end = 0
    if cfg.reg:
        g_tid, g_pos, g_end = parse_region(cfg.reg, hdr)
    if cfg.bedName:
        cfg.bed = bedio.parse_bed(cfg.bedName, hdr, cfg.keepStrand)
        if cfg.bed is None:
            sys.stderr.write("There was an error while reading in your BED file!\n")
            return 1, None
        sys.stderr.write(f"Parsed {cfg.bed.n} regions in {cfg.bedName}\n")

    from ..parallel.distributed import _live, host_role

    host_id, n_hosts = host_role()
    shard_base = (opref or cfg.BAMName) + ".mbias_counters"
    backend = None
    if os.environ.get("MDTPU_MBIAS_FINALIZE"):
        # Finalize an env-simulated multi-host run: rerun the same command
        # with MDTPU_MBIAS_FINALIZE=1 once every host has written its
        # counter shard — the full option context is on the command line.
        counters = _sum_counter_shards(shard_base)
        if counters is None:
            sys.stderr.write(f"No counter shards found at {shard_base}.h*.npy\n")
            return 1, None
    else:
        cfg.hostId, cfg.nHosts = host_id, n_hosts
        counters, backend = compute_mbias(cfg, bam, fasta, g_tid, g_pos,
                                          g_end, device)
        if n_hosts > 1:
            np.save(f"{shard_base}.h{host_id}.npy", counters)
            if not _live():
                sys.stderr.write(
                    f"host {host_id}/{n_hosts}: wrote {shard_base}.h{host_id}.npy; "
                    "rerun with MDTPU_MBIAS_FINALIZE=1 to merge and render\n"
                )
                return 0, backend
            import torch.distributed as dist

            dist.barrier()
            if host_id != 0:
                return 0, backend
            counters = _sum_counter_shards(shard_base)
    meths = counters_to_strandmeths(counters)
    if SVG:
        svg.make_svgs(opref, meths, cfg.keepCpG + 2 * cfg.keepCHG + 4 * cfg.keepCHH)
    if txt:
        svg.make_txt(meths)
    return 0, backend


def _sum_counter_shards(shard_base: str):
    """Sum every {shard_base}.h*.npy counter shard (growing to the longest
    cycle axis) and remove them. Returns None if no shards exist."""
    import glob

    paths = sorted(glob.glob(glob.escape(shard_base) + ".h*.npy"))
    if not paths:
        return None
    total = np.zeros((4, 2, 2, 0), dtype=np.uint64)
    for p in paths:
        c = np.load(p)
        if c.shape[3] > total.shape[3]:
            grown = np.zeros(total.shape[:3] + (c.shape[3],), dtype=np.uint64)
            grown[..., : total.shape[3]] = total
            total = grown
        total[..., : c.shape[3]] += c.astype(np.uint64)
        os.unlink(p)
    return total


def mbias_main(argv, device=None) -> int:
    return mbias(argv, device)[0]
