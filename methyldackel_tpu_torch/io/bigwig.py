"""bigWig reader (libBigWig replacement for the mappability path).

The reference links libBigWig and uses exactly three capabilities
(extract.c:1066-1233): the chromosome list (names + lengths), and
bwGetValues(..., includeNA=1) over whole chromosomes → one float per base
with NaN for uncovered positions. This module implements that subset of the
bigWig format from its specification: common header, chromosome B+ tree,
R-tree index traversal, and zlib-compressed data sections of all three item
types (bedGraph / varStep / fixedStep).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0


class BigWigFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            self._data = fh.read()
        d = self._data
        (magic,) = struct.unpack_from("<I", d, 0)
        if magic != BIGWIG_MAGIC:
            raise ValueError(f"{path} is not a bigWig file")
        (self.version, self.zoom_levels) = struct.unpack_from("<HH", d, 4)
        (self.chrom_tree_offset, self.full_data_offset, self.full_index_offset) = (
            struct.unpack_from("<QQQ", d, 8)
        )
        (self.field_count, self.defined_field_count) = struct.unpack_from("<HH", d, 32)
        (self.uncompress_buf_size,) = struct.unpack_from("<I", d, 52)
        self.names: list[str] = []
        self.lengths: list[int] = []
        self._chrom_ids: dict[int, int] = {}  # chromId -> index in names
        self._parse_chrom_tree()
        self._blocks = self._collect_blocks()

    # -------------------------------------------------------- chromosome tree

    def _parse_chrom_tree(self) -> None:
        d = self._data
        off = self.chrom_tree_offset
        (magic, _block_size, key_size, _val_size) = struct.unpack_from("<IIII", d, off)
        if magic != CHROM_TREE_MAGIC:
            raise ValueError("bad chromosome B+ tree magic")
        entries: list[tuple[int, str, int]] = []

        def walk(node_off: int) -> None:
            is_leaf, _res, count = struct.unpack_from("<BBH", d, node_off)
            p = node_off + 4
            if is_leaf:
                for _ in range(count):
                    key = d[p : p + key_size].split(b"\x00", 1)[0].decode()
                    chrom_id, chrom_size = struct.unpack_from("<II", d, p + key_size)
                    entries.append((chrom_id, key, chrom_size))
                    p += key_size + 8
            else:
                children = []
                for _ in range(count):
                    (child,) = struct.unpack_from("<Q", d, p + key_size)
                    children.append(child)
                    p += key_size + 8
                for child in children:
                    walk(child)

        walk(off + 32)
        entries.sort(key=lambda e: e[0])
        for chrom_id, name, size in entries:
            self._chrom_ids[chrom_id] = len(self.names)
            self.names.append(name)
            self.lengths.append(size)

    # ------------------------------------------------------------ R-tree index

    def _collect_blocks(self) -> list[tuple[int, int, int, int, int]]:
        """All leaf data blocks: (chromIxStart, baseStart, chromIxEnd, offset, size)."""
        d = self._data
        off = self.full_index_offset
        (magic,) = struct.unpack_from("<I", d, off)
        if magic != RTREE_MAGIC:
            raise ValueError("bad R-tree magic")
        blocks: list[tuple[int, int, int, int, int]] = []

        def walk(node_off: int) -> None:
            is_leaf, _res, count = struct.unpack_from("<BBH", d, node_off)
            p = node_off + 4
            if is_leaf:
                for _ in range(count):
                    s_ix, _s_base, _e_ix, _e_base, data_off, data_size = struct.unpack_from(
                        "<IIIIQQ", d, p
                    )
                    blocks.append((s_ix, _s_base, _e_ix, data_off, data_size))
                    p += 32
            else:
                children = []
                for _ in range(count):
                    _s_ix, _s, _e, _eb, child = struct.unpack_from("<IIIIQ", d, p)
                    children.append(child)
                    p += 24
                for child in children:
                    walk(child)

        walk(off + 48)
        return blocks

    # ------------------------------------------------------------------ values

    def values(self, name: str) -> np.ndarray:
        """Per-base float32 values for a whole chromosome, NaN where uncovered
        (bwGetValues with includeNA, extract.c:1123).

        Reference-scale path: only this chromosome's leaf blocks are touched
        (R-tree chrom-range prefilter), and every section's intervals are
        filled with one vectorized run-expansion instead of a per-interval
        Python loop — a whole-genome Bismap track loads in seconds."""
        idx = self.names.index(name)
        chrom_id = next(cid for cid, i in self._chrom_ids.items() if i == idx)
        out = np.full(self.lengths[idx], np.nan, dtype=np.float32)
        d = self._data
        n_out = len(out)

        def fill(starts, lens, vals):
            """out[starts[i] : starts[i]+lens[i]] = vals[i], in order (later
            intervals win), clamped to the chromosome."""
            starts = starts.astype(np.int64)
            lens = np.minimum(lens.astype(np.int64), n_out - starts)
            keep = (lens > 0) & (starts >= 0) & (starts < n_out)
            starts, lens, vals = starts[keep], lens[keep], vals[keep]
            if not len(starts):
                return
            tot = int(lens.sum())
            run0 = np.repeat(starts - np.concatenate(
                [[0], np.cumsum(lens[:-1])]), lens)
            pos = run0 + np.arange(tot, dtype=np.int64)
            out[pos] = np.repeat(vals, lens)

        for s_ix, _sb, e_ix, off, size in self._blocks:
            if not (s_ix <= chrom_id <= e_ix):
                continue
            raw = d[off : off + size]
            if self.uncompress_buf_size > 0:
                raw = zlib.decompress(raw)
            (cid, c_start, _c_end, step, span, typ, _res, count) = struct.unpack_from(
                "<IIIIIBBH", raw, 0
            )
            if cid != chrom_id:
                continue
            p = 24
            if typ == 1:  # bedGraph
                arr = np.frombuffer(raw, dtype="<u4,<u4,<f4", count=count, offset=p)
                fill(arr["f0"], arr["f1"].astype(np.int64) - arr["f0"], arr["f2"])
            elif typ == 2:  # varStep
                arr = np.frombuffer(raw, dtype="<u4,<f4", count=count, offset=p)
                fill(arr["f0"], np.full(count, span, np.int64), arr["f1"])
            elif typ == 3:  # fixedStep
                vals = np.frombuffer(raw, dtype="<f4", count=count, offset=p)
                starts = c_start + np.arange(count, dtype=np.int64) * step
                fill(starts, np.full(count, span, np.int64), vals)
            else:
                raise ValueError(f"unknown bigWig section type {typ}")
        return out
