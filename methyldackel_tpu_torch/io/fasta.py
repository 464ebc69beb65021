"""Indexed FASTA access (htslib faidx equivalent).

The reference calls fai_load/faidx_fetch_seq throughout (extract.c:381,
common.c:477, mergeContext.c:62). This module parses (or builds and
persists) the .fai index and serves 0-based *closed*-interval fetches with
the same clamping semantics as faidx_fetch_seq: end is clamped to the
contig's last base, a start beyond the contig yields an empty sequence.

Like htslib's faidx (extract.c:381 via fai_load), BGZF-compressed FASTA
(.fa.gz written by bgzip) is read transparently: blocks are located via a
header-only scan (io/bgzf.BGZFBlockIndex — the .gzi's role) and only the
byte ranges a fetch needs are inflated.

Memory model: plaintext files are memory-mapped (no heap copy of the
genome); per-chromosome uppercased arrays are cached one at a time —
window processing walks the genome in order, so residency is bounded by
the largest contig instead of 2x the whole genome.

Sequences are returned as uint8 ASCII arrays (uppercased on load; every
consumer in the reference compares case-insensitively).
"""
from __future__ import annotations

import os

import numpy as np


class FastaFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            magic = fh.read(2)
        self._bgzf = magic == b"\x1f\x8b"
        if self._bgzf:
            from .bgzf import BGZFBlockIndex

            self._blocks = BGZFBlockIndex(path)
            self._mm = None
        else:
            self._blocks = None
            self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        fai = path + ".fai"
        if os.path.exists(fai):
            self._index = self._parse_fai(fai)
        else:
            self._index = self._build_index()
            # Persist the index next to the FASTA when possible (fai_load
            # behavior); stay silent if the directory is read-only.
            try:
                with open(fai, "w") as fh:
                    for name, (ln, off, lb, lw) in self._index.items():
                        fh.write(f"{name}\t{ln}\t{off}\t{lb}\t{lw}\n")
            except OSError:
                pass
        # Single-slot chromosome cache: windowed consumers walk contigs in
        # order, so one uppercased contig bounds residency. Stored as ONE
        # tuple so concurrent -@ workers read/replace it atomically.
        self._cache: tuple[str | None, np.ndarray | None] = (None, None)

    # ---- raw (possibly compressed) byte access

    def _read_range(self, off: int, size: int) -> np.ndarray:
        if self._bgzf:
            return np.frombuffer(
                self._blocks.read_flat_range(off, off + size), dtype=np.uint8)
        return np.asarray(self._mm[off : off + size])

    def _raw_size(self) -> int:
        return self._blocks.usize if self._bgzf else len(self._mm)

    @staticmethod
    def _parse_fai(path: str) -> dict:
        index: dict[str, tuple[int, int, int, int]] = {}
        with open(path) as fh:
            for line in fh:
                if not line.strip():
                    continue
                name, ln, off, lb, lw = line.split("\t")[:5]
                index[name] = (int(ln), int(off), int(lb), int(lw))
        return index

    def _build_index(self) -> dict:
        index: dict[str, tuple[int, int, int, int]] = {}
        # One transient pass over the (inflated) text; released afterwards.
        data = self._read_range(0, self._raw_size()).tobytes()
        pos = 0
        n = len(data)
        while pos < n:
            if data[pos : pos + 1] != b">":
                raise ValueError(f"{self.path}: malformed FASTA at offset {pos}")
            eol = data.index(b"\n", pos)
            header = data[pos + 1 : eol].split()
            name = header[0].decode() if header else ""
            seq_off = eol + 1
            # Determine line geometry from the first sequence line.
            line_end = data.find(b"\n", seq_off)
            if line_end == -1:
                line_end = n
            linebases = line_end - seq_off
            linewidth = linebases + 1
            # Count sequence length until next '>' or EOF.
            nxt = data.find(b">", seq_off)
            seq_block = data[seq_off : nxt if nxt != -1 else n]
            length = len(seq_block) - seq_block.count(b"\n") - seq_block.count(b"\r")
            index[name] = (length, seq_off, linebases or 1, linewidth)
            pos = nxt if nxt != -1 else n
        return index

    @property
    def names(self) -> list[str]:
        return list(self._index.keys())

    def seq_len(self, name: str) -> int:
        """faidx_seq_len: -1 for unknown contigs (mergeContext.c:58)."""
        if name not in self._index:
            return -1
        return self._index[name][0]

    def _full(self, name: str) -> np.ndarray:
        cname, carr = self._cache
        if cname == name:
            return carr
        ln, off, lb, lw = self._index[name]
        nlines = (ln + lb - 1) // lb
        raw = self._read_range(off, min(nlines * lw, self._raw_size() - off))
        pad = (-len(raw)) % lw
        if pad:
            raw = np.concatenate([raw, np.full(pad, ord("\n"), np.uint8)])
        arr = raw.reshape(-1, lw)[:, :lb].reshape(-1)[:ln]
        # Uppercase ASCII letters (case-insensitive consumers everywhere).
        arr = np.where((arr >= ord("a")) & (arr <= ord("z")), arr - 32,
                       arr).astype(np.uint8)
        self._cache = (name, arr)
        return arr

    def fetch(self, name: str, start: int, end: int) -> np.ndarray | None:
        """faidx_fetch_seq: 0-based, fully closed [start, end].

        Returns None for an unknown contig (seqlen<0 path) and an empty array
        when start is past the contig end.
        """
        if name not in self._index:
            return None
        ln = self._index[name][0]
        if start < 0:
            start = 0
        if end >= ln:
            end = ln - 1
        if start > end:
            return np.zeros(0, dtype=np.uint8)
        return self._full(name)[start : end + 1]
