"""Output formatting, byte-compatible with the reference writers.

- write_call ← writeCall (extract.c:39-99): the six output formats.
- tri_nuc_context ← getTriNucContext (extract.c:120-180) + the 25-entry
  table (extract.c:33-37).
- header_line ← printHeader (extract.c:562-569).
- output_name ← the file naming block (extract.c:1353-1439).

All float formatting goes through printf-equivalent Python format specs
(C %f == Python :.6f, C %6.2f == Python :6.2f); the percent truncation is
C's (int) cast, i.e. trunc toward zero.
"""
from __future__ import annotations

import math

import numpy as np

TRI_NUCLEOTIDE_CONTEXTS = [
    "CAA", "CAC", "CAG", "CAT", "CAN",
    "CCA", "CCC", "CCG", "CCT", "CCN",
    "CGA", "CGC", "CGG", "CGT", "CGN",
    "CTA", "CTC", "CTG", "CTT", "CTN",
    "CNA", "CNC", "CNG", "CNT", "CNN",
]

_REVCOMP = {ord("A"): "T", ord("C"): "G", ord("G"): "C", ord("T"): "A"}
_COL = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}
_ROW = {ord("A"): 0, ord("C"): 5, ord("G"): 10, ord("T"): 15}


def tri_nuc_context(seq: np.ndarray, offset: int, seqlen: int, direction: int) -> int:
    """getTriNucContext (extract.c:120-180). seq is uppercased ASCII."""
    rv = 0
    # last base (column)
    if (direction > 0 and offset + 2 >= seqlen) or (direction < 0 and offset <= 1):
        rv = 4
    else:
        b = int(seq[offset + 2 * direction])
        if direction < 0:
            b = ord(_REVCOMP.get(b, "N"))
        rv = _COL.get(b, 4)
    # middle base
    if (direction > 0 and offset + 1 >= seqlen) or (direction < 0 and offset == 0):
        rv += 20
    else:
        b = int(seq[offset + direction])
        if direction < 0:
            b = ord(_REVCOMP.get(b, "N"))
        rv += _ROW.get(b, 20)
    return rv


def logit(p: float) -> float:
    """log(p) - log(1-p) with C math.h edge behavior (extract.c:23-25)."""
    lp = -math.inf if p <= 0.0 else math.log(p)
    lq = -math.inf if p >= 1.0 else math.log(1.0 - p)
    return lp - lq


def fmt_float(x: float) -> str:
    """C printf %f."""
    if math.isinf(x):
        return "-inf" if x < 0 else "inf"
    if math.isnan(x):
        return "nan" if not math.copysign(1.0, x) < 0 else "-nan"
    return f"{x:.6f}"


def write_call(cfg, chrom: str, pos: int, width: int, nmethyl: int,
               nunmethyl: int, base: int, context: str | None,
               tnc: str | None) -> str | None:
    """writeCall (extract.c:39-99): one output line, or None if suppressed
    by minDepth."""
    if nmethyl + nunmethyl < cfg.minDepth and not cfg.cytosine_report:
        return None
    if not (cfg.fraction or cfg.logit or cfg.counts or cfg.methylKit or cfg.cytosine_report):
        pct = int(100.0 * nmethyl / (nmethyl + nunmethyl))
        return f"{chrom}\t{pos}\t{pos + width}\t{pct}\t{nmethyl}\t{nunmethyl}\n"
    if cfg.fraction:
        return f"{chrom}\t{pos}\t{pos + width}\t{fmt_float(nmethyl / (nmethyl + nunmethyl))}\n"
    if cfg.counts:
        return f"{chrom}\t{pos}\t{pos + width}\t{nmethyl + nunmethyl}\n"
    if cfg.logit:
        return f"{chrom}\t{pos}\t{pos + width}\t{fmt_float(logit(nmethyl / (nmethyl + nunmethyl)))}\n"
    if cfg.methylKit:
        strand_ch = "F" if base in (ord("C"), ord("c")) else "R"
        cov = nmethyl + nunmethyl
        freq_c = 100.0 * nmethyl / cov
        freq_t = 100.0 * nunmethyl / cov
        return (f"{chrom}.{pos + 1}\t{chrom}\t{pos + 1}\t{strand_ch}\t{cov}"
                f"\t{freq_c:6.2f}\t{freq_t:6.2f}\n")
    # cytosine_report
    strand_ch = "+" if base in (ord("C"), ord("c")) else "-"
    return (f"{chrom}\t{pos + 1}\t{strand_ch}\t{nmethyl}\t{nunmethyl}"
            f"\tC{context}\t{tnc}\n")


def header_line(cfg, context: str, opref: str) -> str:
    """printHeader (extract.c:562-569)."""
    s = f'track type="bedGraph" description="{opref} {context}'
    if cfg.merge:
        s += " merged"
    if cfg.fraction:
        s += ' methylation fractions"\n'
    elif cfg.counts:
        s += ' methylation counts"\n'
    elif cfg.logit:
        s += ' logit transformed methylation fractions"\n'
    else:
        s += ' methylation levels"\n'
    return s


METHYLKIT_HEADER = "chrBase\tchr\tbase\tstrand\tcoverage\tfreqC\tfreqT\n"


def output_name(cfg, opref: str, context: str) -> str:
    """File naming (extract.c:1353-1439)."""
    if cfg.cytosine_report:
        return f"{opref}.cytosine_report.txt"
    if cfg.fraction:
        return f"{opref}_{context}.meth.bedGraph"
    if cfg.counts:
        return f"{opref}_{context}.counts.bedGraph"
    if cfg.logit:
        return f"{opref}_{context}.logit.bedGraph"
    if cfg.methylKit:
        return f"{opref}_{context}.methylKit"
    return f"{opref}_{context}.bedGraph"


def merge_context_record(chrom: str, start: int, end: int, nmethyl: int,
                         nunmethyl: int) -> str:
    """printRecord (mergeContext.c:23-27)."""
    pct = int(100.0 * nmethyl / (nmethyl + nunmethyl))
    return f"{chrom}\t{start}\t{end}\t{pct}\t{nmethyl}\t{nunmethyl}\n"
