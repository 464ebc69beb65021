"""Command line of the port: ``python -m methyldackel_tpu_torch.cli
<extract|mergeContext> ...``, the option surface of ``methyldackel_tpu.cli``.

``extract`` parses with the reference's getopt tables and runs the
reference's ``run_extract`` with the port's backend (``MDTPU_ENGINE``:
``cuda``, ``host`` or ``auto``; see ``parallel.select_backend``).
``mergeContext`` is host-only and runs the reference's. ``mbias`` and
``perRead`` are not ported yet.
"""
from __future__ import annotations

import sys

from methyldackel_tpu.cli import (_EXTRACT_LOPTS, GetoptError,
                                  _load_bbm_mappability,
                                  _load_bigwig_mappability, extract_usage,
                                  getopt_long, print_version)
from methyldackel_tpu.config import Config, c_atof, c_atoi, parse_bounds
from methyldackel_tpu.engine import formats

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
    reference's (methyldackel_tpu/cli.py extract_main)."""
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
    "cpu") builds the port's backend on that device; None selects it from
    MDTPU_ENGINE. One host only: multi-host runs are a later slice."""
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

    cfg.hostId, cfg.nHosts = 0, 1
    if opref is None:
        opref = pos[1].rsplit(".", 1)[0] if "." in pos[1] else pos[1]
        sys.stderr.write(f"writing to prefix:'{opref}'\n")
    streams = [None, None, None]
    opened = []
    cfg.out_paths = [None, None, None]
    if cfg.cytosine_report:
        path = formats.output_name(cfg, opref, "")
        cfg.out_paths = [path, path, path]
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
            f = open(path, "w")
            f.write(formats.METHYLKIT_HEADER if cfg.methylKit
                    else formats.header_line(cfg, ctx, opref))
            streams[slot] = f
            opened.append(f)

    from methyldackel_tpu.engine.extract import run_extract

    if device is None:
        from .parallel import select_backend

        backend = select_backend(cfg)
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


def usage_main():
    sys.stderr.write(
        "methyldackel-tpu-torch: the PyTorch/CUDA port of methyldackel-tpu.\n"
        "Usage: methyldackel-tpu-torch <command> [options]\n\n"
        "Commands:\n"
        "    extract  Extract methylation metrics from an alignment file in "
        "BAM/CRAM\n             format.\n"
        "    mergeContext   Combine single Cytosine metrics into per-CpG/CHG "
        "metrics.\n"
        "    mbias, perRead  Not ported yet: use methyldackel-tpu.\n")


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
    if cmd == "mergeContext":
        from methyldackel_tpu.engine.merge_context import merge_context_main

        return merge_context_main(argv[1:])
    if cmd in ("mbias", "perRead"):
        sys.stderr.write(f"{cmd} is not ported to methyldackel_tpu_torch yet; "
                         "run it with methyldackel-tpu.\n")
        return 2
    sys.stderr.write("Unknown command!\n")
    usage_main()
    return -1


if __name__ == "__main__":
    sys.exit(main())
