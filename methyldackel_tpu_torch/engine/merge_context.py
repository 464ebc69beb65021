"""mergeContext subcommand: collapse per-C bedGraph rows into per-CpG/CHG
rows (mergeContext.c). Streaming, single pass, with the reference's exact
pairing rule: two consecutive rows merge only when they map onto the same
merged interval (MergeOrPrint, mergeContext.c:29-55)."""
from __future__ import annotations

import sys

from ..io.fasta import FastaFile
from . import formats


class _Last:
    __slots__ = ("chrom", "start", "end", "nmethyl", "nunmethyl")

    def __init__(self):
        self.chrom = None
        self.start = 0
        self.end = 0
        self.nmethyl = 0
        self.nunmethyl = 0


def get_context(fasta: FastaFile, chrom: str, pos: int):
    """getContext (mergeContext.c:57-95): (type, width) with type 0 CpG,
    1 CHG, 2 CHH/other, 3 unknown chromosome."""
    length = fasta.seq_len(chrom)
    width = 0
    start = pos - 2 if pos > 2 else 0
    end = pos + 2 if pos + 2 < length else length - 1
    seq = fasta.fetch(chrom, start, end)
    if seq is None or length < 0:
        return 3, width
    i = pos - start
    base = chr(seq[i]).upper() if i < len(seq) else "N"
    rv = 2
    if base == "C":
        if end - pos:
            if i + 1 < len(seq) and chr(seq[i + 1]).upper() == "G":
                width = 2
                rv = 0
            elif end - pos == 2:
                if i + 2 < len(seq) and chr(seq[i + 2]).upper() == "G":
                    width = 3
                    rv = 1
    else:
        # the reference asserts base is C or G here (mergeContext.c:79)
        if pos - start:
            if chr(seq[i - 1]).upper() == "C":
                width = -2
                rv = 0
            elif pos - start == 2:
                if chr(seq[i - 2]).upper() == "C":
                    width = -3
                    rv = 1
    return rv, width


def _merge_or_print(out, last: _Last, chrom: str, start: int, width: int,
                    nmethyl: int, nunmethyl: int) -> None:
    if width > 0:
        end = start + width
    else:
        end = start + 1
        start = end + width
    if last.chrom is not None and last.chrom == chrom and last.start == start and last.end == end:
        out.write(formats.merge_context_record(chrom, start, end,
                                               nmethyl + last.nmethyl,
                                               nunmethyl + last.nunmethyl))
        last.chrom = None
    else:
        if last.chrom is not None:
            out.write(formats.merge_context_record(last.chrom, last.start, last.end,
                                                   last.nmethyl, last.nunmethyl))
        last.chrom = chrom
        last.start = start
        last.end = end
        last.nmethyl = nmethyl
        last.nunmethyl = nunmethyl


def _classify_chunk(fasta: FastaFile, chroms, starts):
    """Vectorized getContext over a chunk of rows: interior positions
    (pos > 2 and pos+2 < contig length — the fetch window is full 5-mer,
    i == 2, end-pos == pos-start == 2) classify with four array compares
    per same-chrom run; contig-edge rows and unknown chroms go through the
    scalar get_context. Returns (typ[n] int8, width[n] int64)."""
    import numpy as np

    C, G = ord("C"), ord("G")
    n = len(starts)
    typs = np.empty(n, np.int8)
    widths = np.zeros(n, np.int64)
    i = 0
    while i < n:
        c = chroms[i]
        j = i
        while j < n and chroms[j] == c:
            j += 1
        ln = fasta.seq_len(c)
        if ln < 0:
            typs[i:j] = 3
        else:
            R = fasta._full(c)
            p = starts[i:j]
            t = np.full(j - i, 2, np.int8)
            w = np.zeros(j - i, np.int64)
            interior = (p > 2) & (p + 2 < ln)
            pi = p[interior]
            base = R[pi]
            isc = base == C
            cpg_c = isc & (R[pi + 1] == G)
            chg_c = isc & ~cpg_c & (R[pi + 2] == G)
            cpg_g = ~isc & (R[pi - 1] == C)
            chg_g = ~isc & ~cpg_g & (R[pi - 2] == C)
            ti = np.full(len(pi), 2, np.int8)
            wi = np.zeros(len(pi), np.int64)
            ti[cpg_c] = 0
            wi[cpg_c] = 2
            ti[chg_c] = 1
            wi[chg_c] = 3
            ti[cpg_g] = 0
            wi[cpg_g] = -2
            ti[chg_g] = 1
            wi[chg_g] = -3
            t[interior] = ti
            w[interior] = wi
            for k in np.nonzero(~interior)[0]:
                t[k], w[k] = get_context(fasta, c, int(p[k]))
            typs[i:j] = t
            widths[i:j] = w
        i = j
    return typs, widths


def merge_context(infile, fasta: FastaFile, out) -> None:
    """mergeContext (mergeContext.c:97-158), classification vectorized in
    200k-row chunks; the sequential pairing state machine is unchanged."""
    import numpy as np
    from itertools import islice

    last_cpg = _Last()
    last_chg = _Last()
    CHUNK = 200_000
    while True:
        lines = list(islice(infile, CHUNK))
        if not lines:
            break
        rows = []
        for line in lines:
            line = line.rstrip("\n")
            if not line or line.startswith("track"):
                continue
            f = line.split("\t")
            rows.append((f[0], int(f[1]), int(f[2]), int(f[4]), int(f[5])))
        if not rows:
            continue
        chroms = [r[0] for r in rows]
        starts = np.fromiter((r[1] for r in rows), np.int64, len(rows))
        typs, widths = _classify_chunk(fasta, chroms, starts)
        if _emit_rows(out, rows, typs, widths, last_cpg, last_chg):
            break  # unknown chromosome: the C breaks, then still flushes
    for last in (last_cpg, last_chg):
        if last.chrom is not None:
            out.write(formats.merge_context_record(last.chrom, last.start, last.end,
                                                   last.nmethyl, last.nunmethyl))


def _emit_rows(out, rows, typs, widths, last_cpg, last_chg) -> bool:
    for (chrom, start, end, nmethyl, nunmethyl), typ, width in zip(rows, typs, widths):
        typ = int(typ)
        width = int(width)
        if typ == 0:
            _merge_or_print(out, last_cpg, chrom, start, width, nmethyl, nunmethyl)
        elif typ == 1:
            _merge_or_print(out, last_chg, chrom, start, width, nmethyl, nunmethyl)
        elif typ == 2:
            out.write(formats.merge_context_record(chrom, start, end, nmethyl, nunmethyl))
        else:
            sys.stderr.write(f"[mergeContext] Error, {chrom} is an unknown chromosome name!\n")
            return True
    return False


def merge_context_usage():
    """Full option docs (mergeContext.c:160-177 surface)."""
    sys.stderr.write(
        "\nUsage: methyldackel-tpu mergeContext [OPTIONS] <ref.fa> <input>\n"
        "\n"
        "Merge single-cytosine methylation metrics into per-CpG/CHG metrics.\n"
        "The input must be coordinate sorted; it may mix sequence contexts,\n"
        "though the merged result can then come out unsorted.\n"
        "\n"
        "Arguments:\n"
        "  ref.fa    Reference genome in (faidx-indexed) fasta format.\n"
        "  input     A bedGraph such as extract produces; '-' reads a pipe.\n"
        "\n"
        "Options:\n"
        "  -o STR    Output file name [stdout].\n"
        "  --version Print the version and exit.\n"
    )


def merge_context_main(argv) -> int:
    from ..cli import getopt_long, GetoptError, print_version

    ofile = None
    try:
        opts, pos = getopt_long(argv, "hvo:", [("help", 0, "h"), ("version", 0, "v")])
    except GetoptError as e:
        sys.stderr.write(f"Invalid option '{e}'\n")
        merge_context_usage()
        return 1
    for key, val in opts:
        if key == "h":
            merge_context_usage()
            return 0
        if key == "v":
            print_version()
            return 0
        if key == "o":
            try:
                ofile = open(val, "w")
            except OSError:
                sys.stderr.write(f"Couldn't open {val} for writing\n")
                return 2
    if not argv:
        merge_context_usage()
        return 0
    if len(pos) != 2:
        sys.stderr.write(
            "You must supply a reference genome in fasta format and an input bedGraph files\n"
        )
        merge_context_usage()
        return -1
    try:
        fasta = FastaFile(pos[0])
    except OSError:
        sys.stderr.write(f"Couldn't open the index for {pos[0]}!\n")
        merge_context_usage()
        return -2
    if pos[1] == "-":
        infile = sys.stdin
    else:
        try:
            infile = open(pos[1])
        except OSError:
            sys.stderr.write(f"Couldn't open {pos[1]} for reading!\n")
            return -3
    out = ofile or sys.stdout
    out.write('track type="bedGraph" description="merged Methylation metrics"\n')
    merge_context(infile, fasta, out)
    if infile is not sys.stdin:
        infile.close()
    if ofile:
        ofile.close()
    return 0
