"""Configuration layer (reference L5: the Config struct, MethylDackel.h:90-126).

One dataclass carries every knob; per-subcommand defaults mirror
extract.c:714-753, MBias.c:312-328, perRead.c:283-295. CLI numeric parsing
reproduces C's atoi/atof semantics (leading-prefix parse, 0 on garbage) —
this is observable behavior: the reference test-suite passes
`--ignoreFlags 0xD00`, which atoi parses as 0 (tests/test.py:68).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field


def c_atoi(s: str) -> int:
    """C atoi: optional sign + leading decimal digits; 0 otherwise."""
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def c_atof(s: str) -> float:
    """C atof: leading floating-point prefix; 0.0 otherwise."""
    m = re.match(r"\s*([+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?)", s)
    return float(m.group(1)) if m else 0.0


def parse_bounds(s: str, vals: list[int], mult: int) -> None:
    """parseBounds (common.c:11-43): fill vals[4*mult : 4*mult+4] from
    "A,B,C,D"; any invalid/negative token aborts the whole assignment."""
    parts = s.split(",")
    staged = []
    for i in range(4):
        if i >= len(parts):
            import sys
            print(f"Invalid bounds string, {s}", file=sys.stderr)
            return
        m = re.match(r"\s*([+-]?\d+)", parts[i])
        v = int(m.group(1)) if m else -1
        if v < 0:
            import sys
            print(f"Invalid bounds string, {s}", file=sys.stderr)
            # the C writes values parsed so far before bailing
            for j, sv in enumerate(staged):
                vals[4 * mult + j] = sv
            return
        staged.append(v)
    for j, sv in enumerate(staged):
        vals[4 * mult + j] = sv


@dataclass
class Config:
    # context toggles
    keepCpG: int = 1
    keepCHG: int = 0
    keepCHH: int = 0
    # quality thresholds
    minMapq: int = 10
    minPhred: int = 5
    minDepth: int = 1
    # read-class policy
    keepDupes: int = 0
    keepSingleton: int = 0
    keepDiscordant: int = 0
    ignoreFlags: int = 0xF00
    requireFlags: int = 0
    ignoreNH: int = 0
    # output modes
    merge: int = 0
    methylKit: int = 0
    fraction: int = 0
    counts: int = 0
    logit: int = 0
    cytosine_report: int = 0
    # variant exclusion
    minOppositeDepth: int = 0
    maxVariantFrac: float = 0.0
    # conversion efficiency
    minConversionEfficiency: float = 0.0
    # region / BED
    reg: str | None = None
    bedName: str | None = None
    bed: object = None
    keepStrand: int = 0
    # mappability
    BWName: str | None = None
    BBMName: str | None = None
    outBBMName: str | None = None
    outputBB: int = 0
    filterMappability: int = 0
    mappabilityCutoff: float = 0.01
    minMappableBases: int = 15
    noBAM: int = 0
    chromNames: list = field(default_factory=list)
    chromLengths: list = field(default_factory=list)
    mappability: object = None  # dict: chrom name -> per-base bool array
    # trimming bounds: 4 strands x (r1 left, r1 right, r2 left, r2 right)
    bounds: list = field(default_factory=lambda: [0] * 16)
    absoluteBounds: list = field(default_factory=lambda: [0] * 16)
    # scheduling
    nThreads: int = 1
    chunkSize: int = 1_000_000
    # inputs
    FastaName: str | None = None
    BAMName: str | None = None

    def any_bounds(self) -> bool:
        return any(self.bounds)

    def any_absolute_bounds(self) -> bool:
        return any(self.absoluteBounds)


def extract_defaults() -> Config:
    return Config()


def mbias_defaults() -> Config:
    return Config()


def perread_defaults() -> Config:
    # perRead.c:292: ignoreFlags defaults to 0 (all reads kept)
    return Config(ignoreFlags=0)
