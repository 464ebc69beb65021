"""perRead subcommand: per-read CpG methylation summary (perRead.c).

processRead (perRead.c:37-94) is reproduced as a faithful state machine,
including its quirk: a base failing the phred gate advances the cursor and
the NEXT base is then evaluated in the same iteration WITHOUT a quality
re-check (perRead.c:59-63). The device backend tallies the rows without a
sub-phred base from packed codes and leaves the others to this exact walker.
Counterpart of methyldackel_tpu/engine/perread.py, the multi-host window
shards included (parallel/distributed.py).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..config import Config, c_atoi
from ..io.bam import BamFile
from ..io.cram import open_alignment
from ..io.fasta import FastaFile
from ..io import bed as bedio
from ..ops import semantics as sem
from .scheduler import windows, parse_region
from .extract import BedState

BASE_C, BASE_G, BASE_T, BASE_A = 2, 4, 8, 1


def _cigar_type(op: int) -> int:
    """bam_cigar_type: bit0 consumes query, bit1 consumes reference."""
    return (0x3C1A7 >> (op * 2)) & 3  # MIDNSHP=X → 3,1,2,2,1,0,0,3,3


def process_read(cfg, seq_codes, quals, cigar, read_pos0, strand, ref_window,
                 seq_start, seq_len):
    """processRead (perRead.c:37-94): returns (nmethyl, nunmethyl)."""
    n_meth = n_unmeth = 0
    read_position = 0
    mapped_position = read_pos0
    op_number = 0
    op_offset = 0
    n_cigar = len(cigar)
    l_qseq = len(seq_codes)
    ops = [(int(c) & 0xF) for c in cigar]
    lens = [(int(c) >> 4) for c in cigar]

    while read_position < l_qseq and op_number < n_cigar:
        if op_offset >= lens[op_number]:
            op_offset = 0
            op_number += 1
            if op_number >= n_cigar:
                break  # the C reads past the CIGAR here; we stop cleanly
        t = _cigar_type(ops[op_number])
        if t & 2:
            if t & 1:  # M/=/X
                if quals[read_position] < cfg.minPhred:
                    mapped_position += 1
                    read_position += 1
                    op_offset += 1
                    if read_position >= l_qseq:
                        break  # C would read past the sequence; stop cleanly
                widx = mapped_position - seq_start
                direction = 0
                if 0 <= widx < seq_len:
                    b = ref_window[widx]
                    if b == ord("C"):
                        if widx + 1 < seq_len and ref_window[widx + 1] == ord("G"):
                            direction = 1
                    elif b == ord("G"):
                        if widx > 0 and ref_window[widx - 1] == ord("C"):
                            direction = -1
                if direction:
                    base = int(seq_codes[read_position])
                    if direction == 1 and (strand & 1) == 1:
                        if base == BASE_C:
                            n_meth += 1
                        elif base == BASE_T:
                            n_unmeth += 1
                    elif direction == -1 and (strand & 1) == 0:
                        if base == BASE_G:
                            n_meth += 1
                        elif base == BASE_A:
                            n_unmeth += 1
                mapped_position += 1
                read_position += 1
                op_offset += 1
            else:  # D/N
                mapped_position += lens[op_number]
                op_number += 1
                op_offset = 0
        elif t & 1:  # I/S
            read_position += lens[op_number]
            op_number += 1
            op_offset = 0
        else:  # H/P/B
            op_offset = 0
            op_number += 1
    return n_meth, n_unmeth


def process_reads_gapless(cfg, seq, qual, pos, lq, strand, ref_window,
                          seq_start, seq_len):
    """Vectorized processRead for reads whose CIGAR consumes query and
    reference 1:1 (no I/S/D/N; H/P are no-ops in the walker). Reproduces
    the low-qual quirk exactly: from cursor j, qual[j] < minPhred evaluates
    position j+1 WITHOUT a quality re-check and the next cursor is j+2
    (perRead.c:59-63); the chain is stepped for all reads at once.
    Returns (n_meth[N], n_unmeth[N])."""
    N, L = seq.shape
    lq = np.asarray(lq, np.int64)
    pos = np.asarray(pos, np.int64)
    rw = np.asarray(ref_window)
    is_c = rw == ord("C")
    is_g = rw == ord("G")
    nxt_g = np.zeros(len(rw), bool)
    nxt_g[:-1] = is_g[1:]
    prv_c = np.zeros(len(rw), bool)
    prv_c[1:] = is_c[:-1]
    dirv = np.where(is_c & nxt_g, np.int8(1),
                    np.where(is_g & prv_c, np.int8(-1), np.int8(0)))

    nm = np.zeros(N, np.int64)
    nu = np.zeros(N, np.int64)
    odd = (np.asarray(strand, np.int64) & 1) == 1
    rows = np.arange(N)
    cursor = np.zeros(N, np.int64)
    active = cursor < lq
    min_phred = cfg.minPhred
    while active.any():
        j = np.clip(cursor, 0, L - 1)
        lowq = active & (qual[rows, j] < min_phred)
        e = np.where(lowq, cursor + 1, cursor)
        evaluate = active & (e < lq)  # low-qual at the last base: break, no eval
        ec = np.clip(e, 0, L - 1)
        widx = pos + e - seq_start
        inw = evaluate & (widx >= 0) & (widx < seq_len)
        d = np.zeros(N, np.int8)
        d[inw] = dirv[widx[inw]]
        base = seq[rows, ec]
        top = (d == 1) & odd
        bot = (d == -1) & ~odd
        nm += (top & (base == BASE_C)) | (bot & (base == BASE_G))
        nu += (top & (base == BASE_T)) | (bot & (base == BASE_A))
        cursor = np.where(active, np.where(lowq, cursor + 2, cursor + 1), cursor)
        active = cursor < lq
    return nm, nu


def _has_indel_clip(bam, idx):
    """Per-read: CIGAR contains I/D/N/S (op codes 1-4) — those reads take
    the exact scalar walker. Vectorized over the flat CIGAR array: a prefix
    sum of per-op hits turns each read's any() into two lookups."""
    cached = getattr(bam, "_indel_clip_rows", None)
    if cached is None:
        ops = bam.cigar_flat & 0xF
        hit = np.concatenate([[0], np.cumsum((ops >= 1) & (ops <= 4),
                                             dtype=np.int64)])
        co = bam.cigar_offsets
        cached = hit[co[1:]] > hit[co[:-1]]
        try:
            # whole-file SoA objects serve every window; compute once
            bam._indel_clip_rows = cached
        except AttributeError:
            pass
    return cached[np.asarray(idx)]


def add_read(qname: str, chrom: str, pos: int, n_meth: int, n_unmeth: int) -> str:
    """addRead (perRead.c:16-35) — note the literal '0.0' for empty reads."""
    if n_meth + n_unmeth > 0:
        pct = 100.0 * n_meth / (n_meth + n_unmeth)
        return f"{qname}\t{chrom}\t{pos}\t{pct:.6f}\t{n_meth + n_unmeth}\n"
    return f"{qname}\t{chrom}\t{pos}\t0.0\t{n_meth + n_unmeth}\n"


def run_perread(cfg, out, device=None):
    """The window loop of perRead, rows written to ``out`` in genome order.
    ``device`` None selects the backend by MDTPU_ENGINE; "cpu" or "cuda"
    builds it there. Returns the device backend (None: the host engine)."""
    if device is None:
        from ..parallel import select_perread_backend

        device_walker = select_perread_backend(cfg)
    else:
        from ..parallel.device import make_perread_backend

        device_walker = make_perread_backend(cfg, device)
    dispatch_fn = getattr(device_walker, "dispatch", None)
    fasta = FastaFile(cfg.FastaName)
    bam = open_alignment(cfg.BAMName, fasta)
    hdr = bam.header
    g_tid = g_pos = g_end = 0
    if cfg.reg:
        g_tid, g_pos, g_end = parse_region(cfg.reg, hdr)
    if cfg.bedName and cfg.bed is None:
        cfg.bed = bedio.parse_bed(cfg.bedName, hdr, cfg.keepStrand)
        if cfg.bed is None:
            raise RuntimeError("There was an error while reading in your BED file!")
        sys.stderr.write(f"Parsed {cfg.bed.n} regions in {cfg.bedName}\n")
    def process_window(tid, lpos, lend):
        name = hdr.names[tid]
        if cfg.bed is not None:
            start_idx = bedio.lower_bound(cfg.bed, tid, lpos)
            ok, _ = bedio.span_overlaps_bed(tid, lpos, lend, cfg.bed, start_idx)
            if ok != 1:
                return None
        lpos2 = lpos - 2 if lpos > 1 else 0
        # 10 kb right slack (perRead.c:186); longer-spanning reads are wrong
        # by design in the reference too.
        ref_window = fasta.fetch(name, lpos2, lend + 10000)
        if ref_window is None:
            return None
        seq_len = len(ref_window)

        view = bam.window_soa(tid, lpos, lend)
        mask = (view.tid == tid) & (view.pos >= lpos) & (view.pos < lend)
        idx = np.nonzero(mask)[0]
        idx = idx[np.argsort(view.pos[idx], kind="stable")]
        # Flag/MAPQ gates, vectorized (perRead.c:188-195: inline, not
        # filter_func — note requireFlags/ignoreFlags semantics match).
        flags = view.flag[idx].astype(np.int64)
        keep = np.ones(len(idx), bool)
        if cfg.requireFlags:
            keep &= (flags & cfg.requireFlags) == cfg.requireFlags
        if cfg.ignoreFlags:
            keep &= (flags & cfg.ignoreFlags) == 0
        keep &= view.mapq[idx] >= cfg.minMapq
        idx = idx[keep]
        if not len(idx):
            return []
        strands = sem.strand(view.flag[idx], view.xg[idx])
        # Indel-free reads take the vectorized chain walker; the rest run
        # the exact scalar state machine.
        hard = _has_indel_clip(view, idx)
        nm = np.zeros(len(idx), np.int64)
        nu = np.zeros(len(idx), np.int64)
        fin = None
        sub = None
        if (~hard).any():
            sub = np.nonzero(~hard)[0]
            batch = view.batch(idx[sub])
            if dispatch_fn is not None:
                # overlap this window's device reduce + readback with the
                # caller's decode/pack of later windows
                fin = dispatch_fn(
                    batch.seq, batch.qual, batch.pos, batch.l_qseq,
                    strands[sub], ref_window, lpos2, seq_len)
            elif device_walker is not None:
                nm[sub], nu[sub] = device_walker(
                    batch.seq, batch.qual, batch.pos, batch.l_qseq,
                    strands[sub], ref_window, lpos2, seq_len)
            else:
                nm[sub], nu[sub] = process_reads_gapless(
                    cfg, batch.seq, batch.qual, batch.pos, batch.l_qseq,
                    strands[sub], ref_window, lpos2, seq_len)

        def finalize():
            if fin is not None:
                nm[sub], nu[sub] = fin()
            for k in np.nonzero(hard)[0]:
                i = idx[k]
                seq_codes, quals, _ = view.read_arrays(i)
                nm[k], nu[k] = process_read(cfg, seq_codes, quals,
                                            view.cigar(i), int(view.pos[i]),
                                            int(strands[k]), ref_window,
                                            lpos2, seq_len)
            return [add_read(view.qname[i], name, int(view.pos[i]),
                             int(nm[k]), int(nu[k]))
                    for k, i in enumerate(idx)]

        return finalize if fin is not None else finalize()

    # perRead's scheduler claims windows WITHOUT the CpG/CHG boundary
    # adjustment (perRead.c:133-156 has no adjustBounds call); with -@ > 1
    # windows run on a thread pool and drain in genome order (the
    # ticket-ordered flush, perRead.c:201-212). With multiple hosts, host h
    # owns windows w % n == h and rows land in per-window shard files
    # (parallel/distributed.py merge_shards reassembles in window order).
    host_id = int(getattr(cfg, "hostId", 0) or 0)
    n_hosts = max(1, int(getattr(cfg, "nHosts", 1) or 1))
    out_path = getattr(cfg, "out_path", None)

    def emit(widx, lines):
        if callable(lines):
            lines = lines()  # deferred device readback + row formatting
        if not lines:
            return
        if n_hosts == 1:
            out.write("".join(lines))
        else:
            with open(f"{out_path}.h{host_id}.w{widx}", "w") as fh:
                fh.write("".join(lines))

    win_iter = enumerate(windows(hdr, fasta, cfg.chunkSize, g_tid, g_pos,
                                 g_end, adjust=False))
    if n_hosts > 1:
        win_iter = ((i, w) for i, w in win_iter if i % n_hosts == host_id)
    n_threads = max(1, int(getattr(cfg, "nThreads", 1) or 1))
    if n_threads == 1:
        if dispatch_fn is not None:
            # keep a few windows' device reductions in flight so host
            # decode/pack of window w+1..w+D overlaps window w's readback
            from collections import deque as _deque

            depth = max(1, int(os.environ.get("MDTPU_PIPELINE", "6") or 1))
            inflight: "_deque" = _deque()
            for i, w in win_iter:
                while len(inflight) >= depth:
                    j, res = inflight.popleft()
                    emit(j, res)
                inflight.append((i, process_window(*w)))
            while inflight:
                j, res = inflight.popleft()
                emit(j, res)
        else:
            for i, w in win_iter:
                emit(i, process_window(*w))
    else:
        from concurrent.futures import ThreadPoolExecutor
        from collections import deque

        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            inflight = deque()
            for i, w in win_iter:
                while len(inflight) >= 2 * n_threads:
                    j, fut = inflight.popleft()
                    emit(j, fut.result())
                inflight.append((i, pool.submit(process_window, *w)))
            while inflight:
                j, fut = inflight.popleft()
                emit(j, fut.result())
    if n_hosts > 1:
        if out is not None:
            out.flush()
        from ..parallel.distributed import barrier_and_merge

        barrier_and_merge([out_path])
    return device_walker


_PERREAD_LOPTS = [
    ("help", 0, "h"), ("version", 0, "v"), ("chunkSize", 1, 19),
    ("keepStrand", 0, 20), ("ignoreFlags", 1, "F"), ("requireFlags", 1, "R"),
]


def perread_usage():
    """Full option docs, mirroring perRead.c:225-273 in this tool's words.
    (--ignoreNH appears in the reference's usage text but is absent from
    its getopt table and unused by its filter, so it is not accepted here
    either.)"""
    sys.stderr.write(
        "\nUsage: methyldackel-tpu-torch perRead [OPTIONS] <ref.fa> <input>\n"
        "\n"
        "Compute the average CpG methylation level of each read. The output is\n"
        "tab-separated with columns: read name, chromosome, position, CpG\n"
        "methylation (%), number of informative bases.\n"
        "\n"
        "Arguments:\n"
        "  ref.fa    Reference genome in (faidx-indexed) fasta format.\n"
        "  input     A sorted (and ideally indexed) BAM or CRAM file.\n"
        "\n"
        "Options:\n"
        " -q INT     Minimum MAPQ for an alignment to be used (default 10).\n"
        " -p INT     Minimum base Phred score for a call (default 5, must be >0).\n"
        " -r STR     Restrict processing to this region.\n"
        " -l FILE    BED file of regions to include.\n"
        " --keepStrand  With -l, honor the BED strand column (column 6); -r may\n"
        "            further restrict the -l regions.\n"
        " -o STR     Output file name [stdout].\n"
        " -F, --ignoreFlags INT   Skip alignments sharing ANY bit with this value\n"
        "            (default 0: every read is output).\n"
        " -R, --requireFlags INT  Keep only alignments with ALL of these bits\n"
        "            (like samtools -f; default 0).\n"
        " -@ INT     Worker threads (default 1).\n"
        " --chunkSize INT  Genome span per work unit (default 1000000, >= 1).\n"
        " --version  Print the version and exit.\n"
    )


def perread(argv, device=None):
    """The perRead subcommand. ``device`` None selects the backend by
    MDTPU_ENGINE (``cuda``, the default, ``mesh`` or ``host``); "cpu" or "cuda"
    builds the device backend there. Returns (rc, backend)."""
    from ..cli import getopt_long, GetoptError, print_version
    from ..config import perread_defaults

    cfg = perread_defaults()
    ofile = None
    oname = None
    try:
        opts, pos = getopt_long(argv, "hvq:p:o:@:r:l:F:R:", _PERREAD_LOPTS)
    except GetoptError as e:
        sys.stderr.write(f"Invalid option '{e}'\n")
        perread_usage()
        return 1, None
    for key, val in opts:
        if key == "h":
            perread_usage()
            return 0, None
        elif key == "v":
            print_version()
            return 0, None
        elif key == "o":
            oname = val
        elif key == "q":
            cfg.minMapq = c_atoi(val)
        elif key == "p":
            cfg.minPhred = c_atoi(val)
        elif key == "@":
            cfg.nThreads = c_atoi(val)
        elif key == "r":
            cfg.reg = val
        elif key == "l":
            cfg.bedName = val
        elif key == "F":
            cfg.ignoreFlags = c_atoi(val)
        elif key == "R":
            cfg.requireFlags = c_atoi(val)
        elif key == 19:
            cfg.chunkSize = c_atoi(val)
            if cfg.chunkSize < 1:
                sys.stderr.write("Error: The chunk size must be at least 1!\n")
                return 1, None
        elif key == 20:
            cfg.keepStrand = 1

    if not argv:
        perread_usage()
        return 0, None
    if len(pos) != 2:
        sys.stderr.write(
            "You must supply a reference genome in fasta format and a BAM or CRAM file\n"
        )
        perread_usage()
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

    cfg.FastaName = pos[0]
    cfg.BAMName = pos[1]
    from ..parallel.distributed import host_role

    cfg.hostId, cfg.nHosts = host_role()
    cfg.out_path = oname
    if cfg.nHosts > 1 and oname is None:
        sys.stderr.write("Multi-host perRead requires -o (stdout cannot be sharded)\n")
        return 1, None
    if oname is not None and (cfg.nHosts == 1 or cfg.hostId == 0):
        try:
            ofile = open(oname, "w")
        except OSError:
            sys.stderr.write(f"Couldn't open {oname} for writing\n")
            return 2, None
    out = ofile if oname is not None else sys.stdout
    try:
        backend = run_perread(cfg, out, device)
    finally:
        if ofile:
            ofile.close()
    return 0, backend


def perread_main(argv, device=None) -> int:
    return perread(argv, device)[0]
