"""BGZF (blocked gzip) reader.

BGZF is the block-compressed gzip variant used by BAM/BCF/tabix: a series of
gzip members, each carrying a BC extra subfield with the compressed block size
(BSIZE), so that 64-bit "virtual offsets" (coffset << 16 | uoffset) can address
any byte. The reference relies on htslib for this; here it is implemented from
the format spec directly, with an optional native C++ fast path
(csrc/bgzf_native.cpp) for multi-block parallel inflation.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _iter_block_offsets(data: bytes):
    """Yield (compressed_offset, block_size, isize) for each BGZF block."""
    off = 0
    n = len(data)
    while off < n:
        if data[off : off + 2] != b"\x1f\x8b":
            raise ValueError(f"not a BGZF/gzip block at offset {off}")
        flg = data[off + 3]
        if not flg & 4:  # FEXTRA required for BGZF
            raise ValueError("gzip member without FEXTRA: not BGZF")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        extra = data[off + 12 : off + 12 + xlen]
        bsize = None
        p = 0
        while p + 4 <= len(extra):
            si1, si2 = extra[p], extra[p + 1]
            slen = struct.unpack_from("<H", extra, p + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, p + 4)[0] + 1
            p += 4 + slen
        if bsize is None:
            raise ValueError("BGZF BC subfield missing")
        isize = struct.unpack_from("<I", data, off + bsize - 4)[0]
        yield off, bsize, isize
        off += bsize


def _inflate_block(data: bytes, off: int, bsize: int, xlen: int | None = None) -> bytes:
    if xlen is None:
        xlen = struct.unpack_from("<H", data, off + 10)[0]
    cdata = data[off + 12 + xlen : off + bsize - 8]
    return zlib.decompress(cdata, -15)


def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a whole in-memory BGZF stream (native path if available)."""
    from . import native

    if native.available():
        return native.bgzf_decompress(data)
    out = []
    for off, bsize, _isize in _iter_block_offsets(data):
        out.append(_inflate_block(data, off, bsize))
    return b"".join(out)


@dataclass
class _BlockIndexEntry:
    coffset: int  # compressed offset of the block in the file
    uoffset: int  # uncompressed offset of the block's first byte


class BGZFReader:
    """Random-access reader over a BGZF file.

    Decompresses the full stream once (these files are streamed end-to-end by
    the engine anyway) and keeps the compressed->uncompressed block map so BAI
    virtual file offsets (htslib-style: coffset << 16 | within-block offset)
    can be translated to flat offsets.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            raw = fh.read()
        self._blocks: list[_BlockIndexEntry] = []
        self._coffset_to_uoffset: dict[int, int] = {}
        uoff = 0
        offsets = []
        for off, bsize, isize in _iter_block_offsets(raw):
            self._blocks.append(_BlockIndexEntry(off, uoff))
            self._coffset_to_uoffset[off] = uoff
            offsets.append((off, bsize))
            uoff += isize
        self.data = bgzf_decompress(raw)
        if len(self.data) != uoff:
            raise ValueError("BGZF ISIZE bookkeeping mismatch")

    def voffset_to_flat(self, voffset: int) -> int:
        """Translate an htslib virtual offset into a flat uncompressed offset."""
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        try:
            return self._coffset_to_uoffset[coffset] + within
        except KeyError:
            raise ValueError(f"virtual offset {voffset:#x} does not address a block start")


class BGZFBlockIndex:
    """Header-only BGZF scan + random-access inflation.

    Unlike BGZFReader (which inflates the whole stream up front), this scans
    only the 18-byte block headers and trailers in one buffered sequential
    pass — O(file) IO, O(n_blocks) memory — and inflates just the blocks a
    `read_flat_range` asks for. This is the streaming-mode substrate: a
    100 GB BAM costs ~25 MB of block tables, not hundreds of GB of inflated
    bytes (the in-memory BamFile's model, fine for small inputs)."""

    CHUNK = 8 << 20

    def __init__(self, path: str):
        import numpy as np

        self.path = path
        coffs, isizes = [], []
        with open(path, "rb") as fh:
            buf = b""
            base = 0  # file offset of buf[0]
            off = 0   # absolute file offset of next block
            while True:
                # ensure the whole block [off, off+bsize) is in buf
                if off - base + 18 > len(buf):
                    buf = buf[off - base :]
                    base = off
                    more = fh.read(self.CHUNK)
                    if not more and not buf:
                        break
                    buf += more
                    if len(buf) < 18:
                        if len(buf) == 0:
                            break
                        raise ValueError("truncated BGZF block header")
                p = off - base
                if buf[p : p + 2] != b"\x1f\x8b":
                    raise ValueError(f"not a BGZF block at offset {off}")
                xlen = struct.unpack_from("<H", buf, p + 10)[0]
                # find BSIZE in the extra field
                if p + 12 + xlen > len(buf):
                    buf = buf[p:]
                    base = off
                    buf += fh.read(self.CHUNK)
                    p = 0
                extra = buf[p + 12 : p + 12 + xlen]
                bsize = None
                q = 0
                while q + 4 <= len(extra):
                    if extra[q] == 66 and extra[q + 1] == 67:
                        bsize = struct.unpack_from("<H", extra, q + 4)[0] + 1
                        break
                    q += 4 + struct.unpack_from("<H", extra, q + 2)[0]
                if bsize is None:
                    raise ValueError("BGZF BC subfield missing")
                while p + bsize > len(buf):
                    buf = buf[p:]
                    base = off
                    p = 0
                    more = fh.read(self.CHUNK)
                    if not more:
                        raise ValueError("truncated BGZF block")
                    buf += more
                isize = struct.unpack_from("<I", buf, p + bsize - 4)[0]
                coffs.append(off)
                isizes.append(isize)
                off += bsize
        self.coffsets = np.array(coffs + [off], dtype=np.int64)
        self.uoffsets = np.zeros(len(isizes) + 1, dtype=np.int64)
        np.cumsum(np.array(isizes, dtype=np.int64), out=self.uoffsets[1:])
        self.usize = int(self.uoffsets[-1])

    def voffset_to_flat(self, voffset: int) -> int:
        import numpy as np

        coffset = voffset >> 16
        i = int(np.searchsorted(self.coffsets, coffset))
        if i >= len(self.coffsets) or self.coffsets[i] != coffset:
            raise ValueError(f"virtual offset {voffset:#x} does not address a block start")
        return int(self.uoffsets[i]) + (voffset & 0xFFFF)

    def read_flat_range(self, ustart: int, uend: int) -> bytes:
        """Inflate and return flat bytes [ustart, uend) (clamped to EOF)."""
        import numpy as np

        uend = min(uend, self.usize)
        if ustart >= uend:
            return b""
        lo = int(np.searchsorted(self.uoffsets, ustart, side="right")) - 1
        hi = int(np.searchsorted(self.uoffsets, uend, side="left"))
        with open(self.path, "rb") as fh:
            fh.seek(int(self.coffsets[lo]))
            raw = fh.read(int(self.coffsets[hi] - self.coffsets[lo]))
        flat = bgzf_decompress(raw)
        s = ustart - int(self.uoffsets[lo])
        return flat[s : s + (uend - ustart)]
