from .bgzf import BGZFReader, bgzf_decompress
from .bam import BamFile, ReadBatch
from .cram import CramFile, bam_to_cram, open_alignment
from .fasta import FastaFile
from .bed import BedRegions, parse_bed
from .bbm import read_bbm, write_bbm
from .bigwig import BigWigFile

__all__ = [
    "BGZFReader", "bgzf_decompress", "BamFile", "ReadBatch", "CramFile",
    "bam_to_cram", "open_alignment", "FastaFile",
    "BedRegions", "parse_bed", "read_bbm", "write_bbm", "BigWigFile",
]
