"""Command line of the port: ``python -m methyldackel_tpu_torch.cli
<extract|mbias|mergeContext|perRead> ...``, the option surface of ``methyldackel_tpu/cli.py``
(whose getopt work-alike, option tables, usage text and mappability loaders
are copied here).

``extract`` runs the port's ``engine.extract.run_extract`` with the port's
backend (``MDTPU_ENGINE``: ``cuda``, the default, ``mesh`` or ``host``; see
``parallel.select_backend``). ``mbias`` (``engine.mbias``) and ``perRead``
(``engine.perread``) pick their backends under the same rule.
``mergeContext`` is host-only.
"""
from __future__ import annotations

import os
import sys

from . import REFERENCE_VERSION, __version__
from .config import Config, c_atof, c_atoi, parse_bounds
from .engine import formats


def print_version():
    print(f"{REFERENCE_VERSION} (methyldackel_tpu_torch {__version__})")


# ----------------------------------------------------------------- getopt

class GetoptError(Exception):
    pass


def getopt_long(args, optstring, longopts):
    """A getopt_long work-alike (GNU permutation, long-option abbreviation).

    Yields (opt, optarg) pairs; returns the positional arguments.
    longopts: list of (name, has_arg, key).
    """
    short_has_arg = {}
    i = 0
    while i < len(optstring):
        c = optstring[i]
        has = i + 1 < len(optstring) and optstring[i + 1] == ":"
        short_has_arg[c] = has
        i += 2 if has else 1

    out = []
    positionals = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--":
            positionals.extend(args[i + 1 :])
            break
        if a.startswith("--"):
            name, eq, val = a[2:].partition("=")
            matches = [lo for lo in longopts if lo[0] == name]
            if not matches:
                matches = [lo for lo in longopts if lo[0].startswith(name)]
            if len(matches) != 1:
                raise GetoptError(a)
            lname, has_arg, key = matches[0]
            if has_arg:
                if eq:
                    out.append((key, val))
                else:
                    i += 1
                    if i >= len(args):
                        raise GetoptError(a)
                    out.append((key, args[i]))
            else:
                out.append((key, None))
        elif a.startswith("-") and a != "-":
            j = 1
            while j < len(a):
                c = a[j]
                if c not in short_has_arg:
                    raise GetoptError(a)
                if short_has_arg[c]:
                    if j + 1 < len(a):
                        out.append((c, a[j + 1 :]))
                    else:
                        i += 1
                        if i >= len(args):
                            raise GetoptError(a)
                        out.append((c, args[i]))
                    break
                out.append((c, None))
                j += 1
        else:
            positionals.append(a)
        i += 1
    return out, positionals


# ----------------------------------------------------------------- extract

_EXTRACT_LOPTS = [
    ("opref", 1, "o"), ("fraction", 0, "f!"), ("counts", 0, "c!"),
    ("logit", 0, "m!"), ("minDepth", 1, "d"), ("noCpG", 0, 1), ("CHG", 0, 2),
    ("CHH", 0, 3), ("keepDupes", 0, 4), ("keepSingleton", 0, 5),
    ("keepDiscordant", 0, 6), ("OT", 1, 7), ("OB", 1, 8), ("CTOT", 1, 9),
    ("CTOB", 1, 10), ("mergeContext", 0, 11), ("methylKit", 0, 12),
    ("nOT", 1, 13), ("nOB", 1, 14), ("nCTOT", 1, 15), ("nCTOB", 1, 16),
    ("minOppositeDepth", 1, 17), ("maxVariantFrac", 1, 18),
    ("chunkSize", 1, 19), ("keepStrand", 0, 20), ("cytosine_report", 0, 21),
    ("minConversionEfficiency", 1, 22), ("ignoreNH", 0, 23),
    ("ignoreFlags", 1, "F"), ("requireFlags", 1, "R"), ("help", 0, "h"),
    ("version", 0, "v"), ("mappability", 1, "M"),
    ("mappabilityThreshold", 1, "t"), ("minMappableBases", 1, "b"),
    ("outputBBMFile", 1, "O"), ("outputBBMFileName", 1, "N"),
    ("mappabilityBBM", 1, "B"),
]


def extract_usage():
    """Full option docs, mirroring the reference's surface
    (extract.c:571-704) in this tool's own words."""
    sys.stderr.write(
        "\nUsage: methyldackel-tpu-torch extract [OPTIONS] <ref.fa> <sorted_alignments.bam>\n"
        "\n"
        "Extract per-cytosine methylation metrics from a coordinate-sorted,\n"
        "indexed BAM or CRAM file of bisulfite-sequencing alignments.\n"
        "\n"
        "Options:\n"
        " -q INT           Minimum MAPQ for an alignment to be used (default 10).\n"
        " -p INT           Minimum base Phred score for a call (default 5, must be >0).\n"
        " -D INT           Ignored; accepted for backward compatibility.\n"
        " -d INT           Minimum per-position depth required before a site is\n"
        "                  reported; with --mergeContext the threshold applies to\n"
        "                  the merged CpG/CHG unit (default 1).\n"
        " -r STR           Restrict extraction to this region (chrom[:start-end]).\n"
        " -l FILE          BED file of regions to include.\n"
        " --keepStrand     With -l, honor the BED strand column (column 6): a '+'\n"
        "                  region reports only top-strand metrics, '-' only bottom.\n"
        "                  -r may further restrict the -l regions.\n"
        " -M, --mappability FILE        bigWig mappability track for read filtering.\n"
        " -t, --mappabilityThreshold F  Mappability value above which a base counts\n"
        "                  as mappable (default 0.01).\n"
        " -b, --minMappableBases INT    Mappable bases required in a read (or its\n"
        "                  mate's assumed span) to keep the pair (default 15).\n"
        " -O, --outputBBMFile           Also write a Binary Bismap (.bbm) cache next\n"
        "                  to the -M bigWig (no effect without -M).\n"
        " -N, --outputBBMFileName FILE  Write the .bbm cache to this exact path\n"
        "                  (no effect without -M).\n"
        " -B, --mappabilityBB FILE      Load mappability from a .bbm file instead\n"
        "                  of a bigWig.\n"
        " -@ INT           Worker threads (default 1).\n"
        " --chunkSize INT  Genome span processed per work unit (default 1000000;\n"
        "                  must be >= 1).\n"
        " --mergeContext   Collapse the per-C metrics of each CpG (or CHG) into a\n"
        "                  single merged entry.\n"
        " -o, --opref STR  Output prefix; metrics land in STR_CpG.bedGraph etc.\n"
        " --keepDupes      Use alignments flagged as PCR/optical duplicates (clears\n"
        "                  0x400 from --ignoreFlags).\n"
        " --keepSingleton  Use paired alignments whose mate did not align.\n"
        " --keepDiscordant Use paired alignments lacking the properly-paired bit\n"
        "                  (what counts as concordant is the aligner's decision).\n"
        " -F, --ignoreFlags INT   Skip alignments carrying any of these FLAG bits.\n"
        "                  Default 0xF00 (secondary 0x100, QC-fail 0x200,\n"
        "                  duplicate 0x400, supplementary 0x800).\n"
        " -R, --requireFlags INT  Keep only alignments carrying ALL of these FLAG\n"
        "                  bits (like samtools -f; default 0 keeps everything).\n"
        " --noCpG          Suppress CpG-context output.\n"
        " --CHG            Emit CHG-context output.\n"
        " --CHH            Emit CHH-context output.\n"
        " --fraction       Emit only the methylated fraction per position\n"
        "                  (.meth.bedGraph).\n"
        " --counts         Emit only the raw base counts per position\n"
        "                  (.counts.bedGraph).\n"
        " --logit          Emit only logit(M/(M+U)) per position (.logit.bedGraph).\n"
        " --ignoreNH       Do not treat NH>1 alignments as multimappers (by\n"
        "                  default they are skipped).\n"
        " --minOppositeDepth INT  Enable variant-site exclusion: minimum coverage\n"
        "                  on the strand opposite a C before checking for A/T/C\n"
        "                  bases there; 0 (default) disables. -p/-q gate those\n"
        "                  bases too. Under --mergeContext a merged site is\n"
        "                  dropped if either of its Cs would be.\n"
        " --maxVariantFrac F      Fraction of opposite-strand A/T/C calls at or\n"
        "                  above which the position is treated as a variant and\n"
        "                  excluded (default 0.0). See --minOppositeDepth.\n"
        " --minConversionEfficiency F  Minimum per-read non-CpG conversion\n"
        "                  efficiency to keep a read (default 0.0, max 1.0).\n"
        "                  Strongly discouraged without a compelling reason.\n"
        " --methylKit      methylKit-format output; incompatible with\n"
        "                  --mergeContext, --fraction and --counts.\n"
        " --cytosine_report  Bismark-style exhaustive per-C report (1-based\n"
        "                  position, strand, meth/unmeth counts, CG/CHG/CHH,\n"
        "                  trinucleotide context) covering every C, including\n"
        "                  zero-coverage ones, in one .cytosine_report.txt file.\n"
        "                  Incompatible with --fraction/--counts/--methylKit/\n"
        "                  --mergeContext.\n"
        " --OT A,B,C,D     Inclusion window for calls on original-top-strand\n"
        "                  alignments: 1-based read positions A..B on read #1 and\n"
        "                  C..D on read #2; a 0 bound means the corresponding\n"
        "                  alignment end. E.g. --OT 5,0,0,0 drops the first 4\n"
        "                  bases of read #1. Use the mbias plots to choose values.\n"
        " --OB/--CTOT/--CTOB A,B,C,D   Same, for the original-bottom and the two\n"
        "                  complementary strands.\n"
        " --nOT A,B,C,D    Always trim this many bases from each read end\n"
        "                  (left,right on read #1, then read #2), regardless of\n"
        "                  alignment length — for reads already trimmed to\n"
        "                  varying lengths.\n"
        " --nOB/--nCTOT/--nCTOB A,B,C,D  Same, for the other strands.\n"
        " --version        Print the version and exit.\n"
        "\nNote that --fraction, --counts, and --logit are mutually exclusive!\n"
    )


# getopt keys that set a Config field (extract.c's option switch)
_SET_CONST = {1: ("keepCpG", 0), 2: ("keepCHG", 1), 3: ("keepCHH", 1),
              4: ("keepDupes", 1), 5: ("keepSingleton", 1),
              6: ("keepDiscordant", 1), 11: ("merge", 1),
              12: ("methylKit", 1), 20: ("keepStrand", 1),
              21: ("cytosine_report", 1), 23: ("ignoreNH", 1),
              # the short -m/-f/-c consume (and ignore) an argument
              "m!": ("logit", 1), "m": ("logit", 1),
              "f!": ("fraction", 1), "f": ("fraction", 1),
              "c!": ("counts", 1), "c": ("counts", 1)}
_SET_INT = {17: "minOppositeDepth", "b": "minMappableBases",
            "F": "ignoreFlags", "R": "requireFlags", "q": "minMapq",
            "p": "minPhred", "@": "nThreads"}
_SET_FLOAT = {18: "maxVariantFrac", 22: "minConversionEfficiency",
              "t": "mappabilityCutoff"}
_SET_STR = {"r": "reg", "l": "bedName", "M": "BWName", "B": "BBMName"}


def _parse_extract(argv):
    """Returns (rc, None, None, None) when the run ends here, else
    (None, cfg, opref, positionals). Messages and codes are the
    reference's (extract.c)."""
    cfg = Config()
    opref = None
    try:
        opts, pos = getopt_long(
            argv, "hvq:p:r:l:o:D:f:c:m:d:F:R:@:M:t:b:ON:B:", _EXTRACT_LOPTS)
    except GetoptError as e:
        sys.stderr.write(f"Invalid option '{e}'\n")
        extract_usage()
        return 1, None, None, None
    for key, val in opts:
        if key == "h":
            extract_usage()
            return 0, None, None, None
        if key == "v":
            print_version()
            return 0, None, None, None
        if key in _SET_CONST:
            name, value = _SET_CONST[key]
            setattr(cfg, name, value)
        elif key in _SET_INT:
            setattr(cfg, _SET_INT[key], c_atoi(val))
        elif key in _SET_FLOAT:
            setattr(cfg, _SET_FLOAT[key], c_atof(val))
        elif key in _SET_STR:
            setattr(cfg, _SET_STR[key], val)
        elif key == "o":
            opref = val
        elif key == "d":
            cfg.minDepth = c_atoi(val)
            if cfg.minDepth < 1:
                sys.stderr.write("Error, the minimum depth must be at least 1!\n")
                return 1, None, None, None
        elif key in (7, 8, 9, 10):
            parse_bounds(val, cfg.bounds, key - 7)
        elif key in (13, 14, 15, 16):
            parse_bounds(val, cfg.absoluteBounds, key - 13)
        elif key == 19:
            cfg.chunkSize = c_atoi(val)
            if cfg.chunkSize < 1:
                sys.stderr.write("Error: The chunk size must be at least 1!\n")
                return 1, None, None, None
        elif key == "O":
            cfg.outBBMName = None
            cfg.outputBB = 1
        elif key == "N":
            cfg.outBBMName = val + ".bbm"
            cfg.outputBB = 1
        # "D" is accepted and ignored (backward compatibility)

    if cfg.outputBB and not cfg.outBBMName and cfg.BWName:
        base = cfg.BWName.rsplit(".", 1)[0] if "." in cfg.BWName else cfg.BWName
        cfg.outBBMName = base + ".bbm"
    if cfg.outputBB and not cfg.BWName:
        sys.stderr.write("You must specify a bigWig file when attempting to "
                         "create a BBM file!\n")
        extract_usage()
        return -1, None, None, None
    if not argv:
        extract_usage()
        return 0, None, None, None
    if len(pos) < 2:
        if not cfg.outputBB:
            sys.stderr.write("You must supply a reference genome in fasta "
                             "format and an input BAM file!!!\n")
            extract_usage()
            return -1, None, None, None
        cfg.noBAM = 1

    if cfg.minPhred < 1:
        sys.stderr.write(f"-p {cfg.minPhred} is invalid. resetting to 1, which "
                         "is the lowest possible value.\n")
        cfg.minPhred = 1
    if cfg.minMapq < 0:
        sys.stderr.write(f"-q {cfg.minMapq} is invalid. Resetting to 0, which "
                         "is the lowest possible value.\n")
        cfg.minMapq = 0
    if cfg.keepDupes > 0 and (cfg.ignoreFlags & 0x400):
        cfg.ignoreFlags -= 0x400
    if cfg.fraction + cfg.counts + cfg.logit + cfg.methylKit \
            + cfg.cytosine_report > 1:
        sys.stderr.write(
            "More than one of --fraction, --counts, --methylKit, "
            "--cytosine_report and --logit were specified. These are "
            "mutually exclusive.\n")
        extract_usage()
        return 1, None, None, None
    if cfg.methylKit + cfg.merge == 2:
        sys.stderr.write("--mergeContext and --methylKit are mutually exclusive.\n")
        extract_usage()
        return 1, None, None, None
    if cfg.cytosine_report + cfg.merge == 2:
        sys.stderr.write("--mergeContext and --cytosine_report are mutually "
                         "exclusive.\n")
        extract_usage()
        return 1, None, None, None
    if not (cfg.keepCpG + cfg.keepCHG + cfg.keepCHH):
        sys.stderr.write(
            "You haven't specified any metrics to output!\nEither don't use "
            "the --noCpG option or specify --CHG and/or --CHH.\n")
        return -1, None, None, None
    if not cfg.noBAM:
        cfg.FastaName = pos[0]
        cfg.BAMName = pos[1]
    return None, cfg, opref, pos


def extract(argv, device=None):
    """Run ``extract``; returns (rc, backend). ``device`` ("cuda" or
    "cpu") builds the port's backend on that device (the mesh backend under
    MDTPU_ENGINE=mesh); None selects it from MDTPU_ENGINE. In a multi-host
    job (``parallel.distributed.host_role``) only host 0 creates the final
    files and their headers; every host writes per-window shards that
    reassemble in window order."""
    rc, cfg, opref, pos = _parse_extract(argv)
    if rc is not None:
        return rc, None
    if cfg.BWName:
        rc = _load_bigwig_mappability(cfg)
        if rc is not None:
            return rc, None
        if cfg.noBAM:
            return 0, None
    if cfg.BBMName:
        rc = _load_bbm_mappability(cfg)
        if rc is not None:
            return rc, None

    from .parallel.distributed import host_role

    cfg.hostId, cfg.nHosts = host_role()
    if opref is None:
        opref = pos[1].rsplit(".", 1)[0] if "." in pos[1] else pos[1]
        sys.stderr.write(f"writing to prefix:'{opref}'\n")
    streams = [None, None, None]
    opened = []
    cfg.out_paths = [None, None, None]
    if cfg.cytosine_report:
        path = formats.output_name(cfg, opref, "")
        cfg.out_paths = [path, path, path]
        if cfg.hostId == 0:
            f = open(path, "w")
            streams = [f, f, f]
            opened.append(f)
    else:
        for slot, (keep, ctx) in enumerate(
                [(cfg.keepCpG, "CpG"), (cfg.keepCHG, "CHG"),
                 (cfg.keepCHH, "CHH")]):
            if not keep:
                continue
            path = formats.output_name(cfg, opref, ctx)
            cfg.out_paths[slot] = path
            if cfg.hostId != 0:
                continue
            f = open(path, "w")
            f.write(formats.METHYLKIT_HEADER if cfg.methylKit
                    else formats.header_line(cfg, ctx, opref))
            streams[slot] = f
            opened.append(f)

    from .engine.extract import run_extract

    if device is None:
        from .parallel import select_backend

        backend = select_backend(cfg)
    elif os.environ.get("MDTPU_ENGINE") == "mesh":
        from .parallel.mesh import make_mesh_backend

        backend = make_mesh_backend(cfg, device=device)
    else:
        from .parallel.device import make_device_backend

        backend = make_device_backend(cfg, device)
    try:
        n_variant = run_extract(cfg, streams, compute_backend=backend)
    finally:
        for f in opened:
            f.close()
    if n_variant:
        print(f"{n_variant} positions were excluded due to likely being "
              "variants.")
    return 0, backend


def extract_main(argv, device=None) -> int:
    return extract(argv, device)[0]


def _load_bigwig_mappability(cfg):
    from .io.bigwig import BigWigFile
    from .io.bbm import quantize, write_bbm

    try:
        bw = BigWigFile(cfg.BWName)
    except (OSError, ValueError):
        sys.stderr.write(f"Couldn't open {cfg.BWName} for reading!\n")
        return -4
    cfg.filterMappability = 1
    sys.stderr.write(f"loading mappability data from {cfg.BWName}\n")
    cutoff = int(cfg.mappabilityCutoff * 100.0 * 1e9) / 1e9  # float compare below
    cfg.mappability = {}
    cfg.chromNames = list(bw.names)
    cfg.chromLengths = list(bw.lengths)
    qvals = []
    for name in bw.names:
        q = quantize(bw.values(name))
        qvals.append(q)
        cfg.mappability[name] = q >= (cfg.mappabilityCutoff * 100.0)
    if cfg.outBBMName:
        sys.stderr.write(f"writing .bbm file to {cfg.outBBMName}\n")
        try:
            write_bbm(cfg.outBBMName, bw.names, bw.lengths, qvals)
        except OSError:
            sys.stderr.write(
                f"Couldn't open {cfg.outBBMName} for writing! Insufficient permissions?\n"
            )
            return -7
    return None


def _load_bbm_mappability(cfg):
    from .io.bbm import read_bbm, MalformedBBM

    try:
        names, lengths, values = read_bbm(cfg.BBMName)
    except FileNotFoundError:
        sys.stderr.write(f"Couldn't open {cfg.BBMName} for reading!\n")
        return -8
    except MalformedBBM as e:
        if "version" in str(e):
            sys.stderr.write(f"fatal: {cfg.BBMName} has wrong BBM version or is malformed\n")
            return -10
        print("fatal: malformed BBM file")
        return -9
    cfg.filterMappability = 1
    sys.stderr.write(f"loading mappability data from {cfg.BBMName}\n")
    cfg.chromNames = names
    cfg.chromLengths = lengths
    cfg.mappability = {
        n: v >= (cfg.mappabilityCutoff * 100.0) for n, v in zip(names, values)
    }
    return None


def usage_main():
    sys.stderr.write(
        "methyldackel-tpu-torch: the PyTorch/CUDA port of methyldackel-tpu, a "
        "tool for\nprocessing bisulfite sequencing alignments.\n"
        f"Version: {REFERENCE_VERSION} (methyldackel_tpu_torch {__version__})\n"
        "Usage: methyldackel-tpu-torch <command> [options]\n\n"
        "Commands:\n"
        "    mbias    Determine the position-dependent methylation bias in a dataset,\n"
        "             producing diagnostic SVG images.\n"
        "    extract  Extract methylation metrics from an alignment file in BAM/CRAM\n"
        "             format.\n"
        "    mergeContext   Combine single Cytosine metrics into per-CpG/CHG metrics.\n"
        "    perRead  Generate a per-read methylation summary.\n"
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        usage_main()
        return 0
    cmd = argv[0]
    if cmd in ("-v", "--version"):
        print_version()
        return 0
    if cmd == "extract":
        return extract_main(argv[1:])
    if cmd == "mbias":
        from .engine.mbias import mbias_main

        return mbias_main(argv[1:])
    if cmd == "mergeContext":
        from .engine.merge_context import merge_context_main

        return merge_context_main(argv[1:])
    if cmd == "perRead":
        from .engine.perread import perread_main

        return perread_main(argv[1:])
    sys.stderr.write("Unknown command!\n")
    usage_main()
    return -1


if __name__ == "__main__":
    sys.exit(main())
