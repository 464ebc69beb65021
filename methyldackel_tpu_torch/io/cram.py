"""CRAM 3.0/3.1 container decoder + writer (no htslib).

The reference accepts "a BAM or CRAM file" everywhere it reads alignments
(MethylDackel.h:80, main.c:31, perRead.c:240) and gets CRAM support for free
from htslib. This module is this framework's own CRAM 3.0 implementation:

- `CramFile` decodes a whole CRAM into the same structure-of-arrays tensor
  layout as `BamFile` (io/bam.py) — it subclasses `AlignmentSoA`, so every
  downstream consumer (engine/extract.py window batching, perRead walker,
  mbias counters) works on CRAM input unchanged.
- `bam_to_cram()` converts a decoded BAM to CRAM (reference-based feature
  encoding); it is how test fixtures are produced in this htslib-free
  environment, and doubles as a standalone converter.
- `write_crai()` emits the .crai index (gzipped text) alongside.

Implemented surface (CRAM 3.0):
- ITF8/LTF8 varints, container/block structure, CRC32 verification.
- Block compression methods: raw, gzip, bzip2, lzma, rANS4x8 order 0/1
  (io/rans4x8.py); CRAM 3.1 adds rANS Nx16 (io/ransnx16.py), adaptive
  arithmetic (io/arith.py), fqzcomp quality (io/fqzcomp.py) and the name
  tokeniser (io/tok3.py) — the full method 0-8 table.
- Encodings: EXTERNAL, HUFFMAN (canonical, incl. the 0-bit constant form),
  BETA, GAMMA, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP. GOLOMB/SUBEXP are not
  implemented (htslib never writes them) and raise.
- Record decode: BF/CF/RI/RL/AP(delta)/RG/RN, detached mates (MF/NS/NP/TS),
  downstream mates (NF) with pair resolution, TD tag dictionary + per-tag
  byte arrays (XG/NH extracted, everything else skipped), mapped-read
  feature reconstruction (B X I D i S H P N b q Q) against the reference
  (substitution-matrix decode) or a slice-embedded reference, unmapped
  reads via BA.
- Multi-ref containers (ref id -2 + RI), unmapped containers (ref id -1).

Quality scores absent (`*`, no CF preserve flag and no qual features) decode
as 0xFF per htslib convention.
"""
from __future__ import annotations

import struct
import zlib
import bz2
import lzma
import gzip as gzip_mod

import numpy as np

from . import arith
from . import fqzcomp
from . import rans4x8
from . import ransnx16
from . import tok3
from .bam import AlignmentSoA, BamHeader, _expand_cigar
from .fasta import FastaFile

CRAM_MAGIC = b"CRAM"

# block compression methods (3.0: 0-4; 3.1 adds 5-8)
RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
RANSNX16, ARITH, FQZCOMP, TOK3 = 5, 6, 7, 8
# block content types
FILE_HEADER, COMPRESSION_HEADER, SLICE_HEADER, EXTERNAL_DATA, CORE_DATA = 0, 1, 2, 4, 5
# encodings
E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, \
    E_BETA, E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = 0, 1, 2, 3, 4, 5, 6, 7, 8, 9

# CF (CRAM record) flags
CF_QUAL = 0x1        # quality scores stored as array
CF_DETACHED = 0x2    # mate info stored explicitly
CF_MATE_DOWNSTREAM = 0x4  # NF gives distance to mate in this slice
# MF (mate flags)
MF_MATE_REVERSE = 0x1
MF_MATE_UNMAPPED = 0x2

EOF_POSITION = 4542278  # 0x454F46, "EOF": alignment start of the EOF container

_INT_SERIES = {"BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
               "NF", "TL", "FN", "FP", "DL", "RS", "PD", "HC", "MQ"}
_BYTE_SERIES = {"BA", "QS", "BS", "FC"}
_ARRAY_SERIES = {"RN", "IN", "SC", "BB", "QQ"}

# 4-bit BAM base code → ASCII, and back
_CODE2ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_ASCII2CODE = np.zeros(256, dtype=np.uint8)
for _i, _ch in enumerate(b"=ACMGRSVTWYHKDBN"):
    _ASCII2CODE[_ch] = _i
    _ASCII2CODE[_ch + 32] = _i  # lowercase
_ASCII2CODE[ord("n")] = 15

# reference base → substitution-matrix row (A C G T else N)
_REFROW = np.full(256, 4, dtype=np.int8)
for _i, _ch in enumerate(b"ACGT"):
    _REFROW[_ch] = _i
    _REFROW[_ch + 32] = _i
_ROWBASE = b"ACGTN"


def _row_targets(row: int) -> bytes:
    """The 4 substitution targets for a reference-base row, in ACGTN order."""
    return bytes(b for i, b in enumerate(_ROWBASE) if i != row)


# ------------------------------------------------------------------- varints

def read_itf8(buf, p):
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[p + 1], p + 2
    if b0 < 0xE0:
        return ((b0 & 0x1F) << 16) | (buf[p + 1] << 8) | buf[p + 2], p + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
                | buf[p + 3]), p + 4
    v = (((b0 & 0x0F) << 28) | (buf[p + 1] << 20) | (buf[p + 2] << 12)
         | (buf[p + 3] << 4) | (buf[p + 4] & 0x0F))
    return v, p + 5


def read_itf8_signed(buf, p):
    v, p = read_itf8(buf, p)
    if v >= 1 << 31:
        v -= 1 << 32
    return v, p


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def read_ltf8(buf, p):
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    # n extra bytes beyond the count implied by the prefix
    nbytes = n + 1
    v = b0 & (0x7F >> n)
    if nbytes == 8:  # 0xFF prefix: 8 following bytes, prefix carries no bits
        v = 0
    for i in range(nbytes):
        v = (v << 8) | buf[p + 1 + i]
    if v >= 1 << 63:
        v -= 1 << 64
    return v, p + 1 + nbytes


def write_ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    for n in range(1, 8):
        # prefix byte: n leading ones; carries 7-n payload bits
        if v < 1 << (7 - n + 8 * n):
            prefix = (0xFF << (8 - n)) & 0xFF
            payload_bits = 7 - n
            top = v >> (8 * n)
            out = [prefix | top]
            for i in range(n - 1, -1, -1):
                out.append((v >> (8 * i)) & 0xFF)
            return bytes(out)
    out = [0xFF]
    for i in range(7, -1, -1):
        out.append((v >> (8 * i)) & 0xFF)
    return bytes(out)


def _read_array_itf8(buf, p):
    n, p = read_itf8(buf, p)
    vals = []
    for _ in range(n):
        v, p = read_itf8_signed(buf, p)
        vals.append(v)
    return vals, p


def _write_array_itf8(vals) -> bytes:
    out = bytearray(write_itf8(len(vals)))
    for v in vals:
        out += write_itf8(v)
    return bytes(out)


# ------------------------------------------------------------------- blocks

def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == RAW:
        return data
    if method == GZIP:
        return zlib.decompress(data, 15 + 32)
    if method == BZIP2:
        return bz2.decompress(data)
    if method == LZMA:
        return lzma.decompress(data)
    if method == RANS:
        return rans4x8.uncompress(data)
    if method == RANSNX16:
        return ransnx16.uncompress(data, raw_size)
    if method == ARITH:
        return arith.uncompress(data, raw_size)
    if method == FQZCOMP:
        return fqzcomp.uncompress(data, raw_size)
    if method == TOK3:
        return tok3.uncompress(data, raw_size)
    raise ValueError(f"cram: unsupported block compression method {method}")


def _compress(method: int, data: bytes) -> bytes:
    if method == RAW:
        return data
    if method == GZIP:
        co = zlib.compressobj(6, zlib.DEFLATED, 31)
        return co.compress(data) + co.flush()
    if method == BZIP2:
        return bz2.compress(data)
    if method == LZMA:
        return lzma.compress(data)
    if method == RANS:
        order = 1 if len(data) >= 1024 else 0
        return rans4x8.compress(data, order)
    if method == RANSNX16:
        flags = ransnx16.ORDER1 if len(data) >= 1024 else 0
        return ransnx16.compress(data, flags)
    if method == ARITH:
        flags = arith.ORDER1 if len(data) >= 1024 else 0
        return arith.compress(data, flags)
    if method == FQZCOMP:
        return fqzcomp.compress(data)
    if method == TOK3:
        return tok3.compress(data)
    raise ValueError(f"cram: unsupported block compression method {method}")


class Block:
    __slots__ = ("method", "ctype", "cid", "data")

    def __init__(self, ctype, cid, data, method=RAW):
        self.method = method
        self.ctype = ctype
        self.cid = cid
        self.data = data


def _read_block(buf: bytes, p: int) -> tuple[Block, int]:
    start = p
    method = buf[p]
    ctype = buf[p + 1]
    p += 2
    cid, p = read_itf8_signed(buf, p)
    comp_size, p = read_itf8(buf, p)
    raw_size, p = read_itf8(buf, p)
    data = buf[p : p + comp_size]
    p += comp_size
    (crc,) = struct.unpack_from("<I", buf, p)
    if crc != (zlib.crc32(buf[start:p]) & 0xFFFFFFFF):
        raise ValueError("cram: block CRC mismatch")
    p += 4
    raw = _decompress(method, bytes(data), raw_size)
    if len(raw) != raw_size:
        raise ValueError(f"cram: block raw size {len(raw)} != declared {raw_size}")
    return Block(ctype, cid, raw, method), p


def _write_block(blk: Block) -> bytes:
    comp = _compress(blk.method, blk.data)
    if len(comp) >= len(blk.data) and blk.method != RAW:
        # store incompressible payloads raw
        method, comp = RAW, blk.data
    else:
        method = blk.method
    out = bytearray([method, blk.ctype])
    out += write_itf8(blk.cid)
    out += write_itf8(len(comp))
    out += write_itf8(len(blk.data))
    out += comp
    out += struct.pack("<I", zlib.crc32(bytes(out)) & 0xFFFFFFFF)
    return bytes(out)


# -------------------------------------------------------------- bit streams

class _BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("data", "byte", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.byte = 0
        self.bit = 7

    def read_bit(self) -> int:
        b = (self.data[self.byte] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.byte += 1
        else:
            self.bit -= 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


class _BitWriter:
    __slots__ = ("out", "cur", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((v >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def getvalue(self) -> bytes:
        if self.nbits:
            return bytes(self.out) + bytes([self.cur << (8 - self.nbits)])
        return bytes(self.out)


class _Ext:
    """Shared sequential cursor over one external block's bytes."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_itf8(self) -> int:
        v, self.pos = read_itf8_signed(self.data, self.pos)
        return v

    def read_byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read_bytes(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def read_until(self, stop: int) -> bytes:
        end = self.data.index(stop, self.pos)
        b = self.data[self.pos : end]
        self.pos = end + 1
        return b


# ---------------------------------------------------------------- encodings

def _parse_encoding(buf: bytes, p: int):
    codec, p = read_itf8(buf, p)
    nbytes, p = read_itf8(buf, p)
    params = buf[p : p + nbytes]
    return (codec, params), p + nbytes


def _encoding_bytes(codec: int, params: bytes) -> bytes:
    return write_itf8(codec) + write_itf8(len(params)) + params


class _Codec:
    """Decoder for one data series; kind ∈ {'int', 'byte', 'bytes'}."""

    def __init__(self, spec, kind, externals, core):
        codec, params = spec
        self.kind = kind
        self.codec = codec
        self.core = core
        if codec == E_EXTERNAL:
            cid, _ = read_itf8_signed(params, 0)
            self.ext = externals[cid]
        elif codec == E_HUFFMAN:
            p = 0
            alphabet, p = _read_array_itf8(params, p)
            lengths, p = _read_array_itf8(params, p)
            self.alphabet = alphabet
            self.lengths = lengths
            if len(alphabet) == 1 and lengths[0] == 0:
                self.const = alphabet[0]
            else:
                self.const = None
                # canonical codes: stable sort by length, incrementing values
                order = sorted(range(len(alphabet)), key=lambda i: lengths[i])
                table = {}
                code = 0
                prev_len = lengths[order[0]]
                for i in order:
                    code <<= lengths[i] - prev_len
                    prev_len = lengths[i]
                    table[(lengths[i], code)] = alphabet[i]
                    code += 1
                self.table = table
                self.max_len = max(lengths)
        elif codec == E_BETA:
            p = 0
            self.offset, p = read_itf8_signed(params, p)
            self.nbits, p = read_itf8(params, p)
        elif codec == E_GAMMA:
            self.offset, _ = read_itf8_signed(params, 0)
        elif codec == E_BYTE_ARRAY_LEN:
            len_spec, p = _parse_encoding(params, 0)
            val_spec, p = _parse_encoding(params, p)
            self.len_codec = _Codec(len_spec, "int", externals, core)
            self.val_codec = _Codec(val_spec, "byte", externals, core)
        elif codec == E_BYTE_ARRAY_STOP:
            self.stop = params[0]
            cid, _ = read_itf8_signed(params, 1)
            self.ext = externals[cid]
        elif codec == E_NULL:
            pass
        else:
            raise ValueError(f"cram: unsupported encoding codec {codec}")

    # one value (int or byte)
    def get(self):
        c = self.codec
        if c == E_EXTERNAL:
            return self.ext.read_itf8() if self.kind == "int" else self.ext.read_byte()
        if c == E_HUFFMAN:
            if self.const is not None:
                return self.const
            ln = 0
            code = 0
            while ln <= self.max_len:
                code = (code << 1) | self.core.read_bit()
                ln += 1
                v = self.table.get((ln, code))
                if v is not None:
                    return v
            raise ValueError("cram: bad huffman code")
        if c == E_BETA:
            return self.core.read_bits(self.nbits) - self.offset
        if c == E_GAMMA:
            nz = 0
            while self.core.read_bit() == 0:
                nz += 1
            v = 1 << nz
            if nz:
                v |= self.core.read_bits(nz)
            return v - self.offset
        if c == E_NULL:
            return 0
        raise ValueError(f"cram: encoding {c} cannot produce a scalar")

    # a byte array
    def get_array(self):
        c = self.codec
        if c == E_BYTE_ARRAY_LEN:
            n = self.len_codec.get()
            if self.val_codec.codec == E_EXTERNAL:
                return self.val_codec.ext.read_bytes(n)
            return bytes(self.val_codec.get() for _ in range(n))
        if c == E_BYTE_ARRAY_STOP:
            return self.ext.read_until(self.stop)
        if c == E_EXTERNAL:
            raise ValueError("cram: EXTERNAL byte array needs explicit length")
        raise ValueError(f"cram: encoding {c} cannot produce a byte array")

    def get_n(self, n: int) -> bytes:
        """Read exactly n bytes (for QS/BA runs of known length)."""
        if self.codec == E_EXTERNAL:
            return self.ext.read_bytes(n)
        return bytes(self.get() for _ in range(n))


# ------------------------------------------------------- compression header

class CompressionHeader:
    def __init__(self, buf: bytes):
        p = 0
        # preservation map
        _size, p = read_itf8(buf, p)
        nkeys, p = read_itf8(buf, p)
        self.read_names_included = True
        self.ap_delta = True
        self.reference_required = True
        self.sub_matrix = bytes([0x1B] * 5)
        self.tag_dict: list[list[tuple[bytes, int]]] = [[]]
        for _ in range(nkeys):
            key = buf[p : p + 2].decode()
            p += 2
            if key == "RN":
                self.read_names_included = bool(buf[p]); p += 1
            elif key == "AP":
                self.ap_delta = bool(buf[p]); p += 1
            elif key == "RR":
                self.reference_required = bool(buf[p]); p += 1
            elif key == "SM":
                self.sub_matrix = bytes(buf[p : p + 5]); p += 5
            elif key == "TD":
                n, p = read_itf8(buf, p)
                blob = bytes(buf[p : p + n]); p += n
                self.tag_dict = _parse_tag_dict(blob)
            else:
                raise ValueError(f"cram: unknown preservation key {key}")
        # data series encodings
        _size, p = read_itf8(buf, p)
        nkeys, p = read_itf8(buf, p)
        self.series: dict[str, tuple] = {}
        for _ in range(nkeys):
            key = buf[p : p + 2].decode()
            p += 2
            spec, p = _parse_encoding(buf, p)
            self.series[key] = spec
        # tag encodings
        _size, p = read_itf8(buf, p)
        nkeys, p = read_itf8(buf, p)
        self.tag_series: dict[int, tuple] = {}
        for _ in range(nkeys):
            keyval, p = read_itf8(buf, p)
            spec, p = _parse_encoding(buf, p)
            self.tag_series[keyval] = spec

        # substitution decode table: row → code → ASCII base
        self.sub_decode = np.zeros((5, 4), dtype=np.uint8)
        for row in range(5):
            targets = _row_targets(row)
            byte = self.sub_matrix[row]
            for t in range(4):
                code = (byte >> (6 - 2 * t)) & 3
                self.sub_decode[row, code] = targets[t]


def _parse_tag_dict(blob: bytes) -> list[list[tuple[bytes, int]]]:
    """TD: \\0-terminated lines of (tag1, tag2, type) triplets."""
    lines = blob.split(b"\x00")[:-1] if blob else [b""]
    out = []
    for line in lines:
        entries = []
        for i in range(0, len(line), 3):
            tag = line[i : i + 2]
            typ = line[i + 2]
            key = (tag[0] << 16) | (tag[1] << 8) | typ
            entries.append((tag, typ, key))
        out.append(entries)
    if not out:
        out = [[]]
    return out


# ------------------------------------------------------------------ decoder

class CramFile(AlignmentSoA):
    """Whole-file CRAM 3.0 decoder to the BamFile-compatible SoA layout.

    `fasta` may be a FastaFile, a path, or None (required unless every
    container is unmapped/embedded-ref/RR=false).
    """

    def __init__(self, path: str, fasta=None):
        self.path = path
        if isinstance(fasta, str):
            fasta = FastaFile(fasta)
        self._fasta = fasta
        with open(path, "rb") as fh:
            buf = fh.read()
        if buf[:4] != CRAM_MAGIC:
            raise ValueError(f"{path} is not a CRAM file")
        major, minor = buf[4], buf[5]
        # 3.0 and 3.1 share the container layout; 3.1 adds block codecs
        # 5-8 (rANS Nx16 supported; others error actionably in _decompress).
        if major != 3 or minor > 1:
            raise ValueError(
                f"cram: unsupported version {major}.{minor} (this reader "
                f"supports CRAM 3.0 and 3.1)")
        p = 26  # magic + version + 20-byte file id
        self._records: list[dict] = []
        first = True
        while p < len(buf):
            p, is_eof = self._read_container(buf, p, first)
            first = False
            if is_eof:
                break
        self._assemble()

    # ---- containers

    def _read_container(self, buf: bytes, p: int, first: bool):
        hdr_start = p
        (length,) = struct.unpack_from("<i", buf, p)
        p += 4
        ref_id, p = read_itf8_signed(buf, p)
        start, p = read_itf8_signed(buf, p)
        span, p = read_itf8_signed(buf, p)
        n_records, p = read_itf8(buf, p)
        _counter, p = read_ltf8(buf, p)
        _bases, p = read_ltf8(buf, p)
        n_blocks, p = read_itf8(buf, p)
        _landmarks, p = _read_array_itf8(buf, p)
        (crc,) = struct.unpack_from("<I", buf, p)
        if crc != (zlib.crc32(buf[hdr_start:p]) & 0xFFFFFFFF):
            raise ValueError("cram: container header CRC mismatch")
        p += 4
        data_end = p + length

        if ref_id == -1 and start == EOF_POSITION and n_records == 0:
            return data_end, True
        if first:
            # file-header container: one block with int32 length + SAM text
            blk, _ = _read_block(buf, p)
            if blk.ctype != FILE_HEADER:
                raise ValueError("cram: first container lacks file header block")
            (tlen,) = struct.unpack_from("<i", blk.data, 0)
            text = blk.data[4 : 4 + tlen].decode()
            self.header = _header_from_sam_text(text)
            return data_end, False
        if n_records == 0:
            return data_end, False

        comp_blk, p = _read_block(buf, p)
        if comp_blk.ctype != COMPRESSION_HEADER:
            raise ValueError("cram: expected compression header block")
        ch = CompressionHeader(comp_blk.data)
        while p < data_end:
            p = self._read_slice(buf, p, ch, ref_id)
        return data_end, False

    def _read_slice(self, buf: bytes, p: int, ch: CompressionHeader,
                    container_ref: int) -> int:
        shdr, p = _read_block(buf, p)
        if shdr.ctype != SLICE_HEADER:
            raise ValueError("cram: expected slice header block")
        d = shdr.data
        q = 0
        ref_id, q = read_itf8_signed(d, q)
        aln_start, q = read_itf8_signed(d, q)
        aln_span, q = read_itf8_signed(d, q)
        n_records, q = read_itf8(d, q)
        _counter, q = read_ltf8(d, q)
        n_blocks, q = read_itf8(d, q)
        _cids, q = _read_array_itf8(d, q)
        embed_ref_cid, q = read_itf8_signed(d, q)
        # 16-byte reference md5 + optional tags follow; not needed

        core = None
        externals: dict[int, _Ext] = {}
        embedded_ref = None
        for _ in range(n_blocks):
            blk, p = _read_block(buf, p)
            if blk.ctype == CORE_DATA:
                core = _BitReader(blk.data)
            elif blk.ctype == EXTERNAL_DATA:
                externals[blk.cid] = _Ext(blk.data)
                if blk.cid == embed_ref_cid:
                    embedded_ref = np.frombuffer(blk.data, dtype=np.uint8)
            else:
                raise ValueError(f"cram: unexpected block type {blk.ctype} in slice")
        self._decode_slice(ch, core, externals, ref_id, aln_start, n_records,
                           embedded_ref)
        return p

    # ---- records

    def _decode_slice(self, ch, core, externals, slice_ref, slice_start,
                      n_records, embedded_ref):
        dec: dict[str, _Codec] = {}
        for key, spec in ch.series.items():
            kind = ("int" if key in _INT_SERIES
                    else "byte" if key in _BYTE_SERIES else "bytes")
            dec[key] = _Codec(spec, kind, externals, core)
        tag_dec = {key: _Codec(spec, "bytes", externals, core)
                   for key, spec in ch.tag_series.items()}

        def series(key):
            c = dec.get(key)
            if c is None:
                raise ValueError(f"cram: data series {key} required but not encoded")
            return c

        recs = self._records
        base = len(recs)
        last_ap = slice_start
        multi_ref = slice_ref == -2
        ref_cache: dict[int, np.ndarray] = {}

        def ref_for(tid):
            if embedded_ref is not None:
                return embedded_ref, slice_start - 1  # offset of ref[0]
            if tid in ref_cache:
                return ref_cache[tid], 0
            if self._fasta is None:
                if ch.reference_required:
                    raise ValueError("cram: reference required but no FASTA given")
                arr = None
            else:
                name = self.header.names[tid]
                arr = self._fasta.fetch(name, 0, self.header.lengths[tid] - 1)
                if arr is None and ch.reference_required:
                    raise ValueError(
                        f"cram: contig {name} not found in the reference FASTA "
                        "(sequence cannot be reconstructed)")
            ref_cache[tid] = arr
            return arr, 0

        for i in range(n_records):
            bf = series("BF").get()
            cf = series("CF").get()
            tid = series("RI").get() if multi_ref else slice_ref
            rl = series("RL").get()
            if ch.ap_delta:
                ap = last_ap + series("AP").get()
                last_ap = ap
            else:
                ap = series("AP").get()
            series("RG").get()
            qname = None
            if ch.read_names_included:
                qname = series("RN").get_array().decode()
            mf = 0
            mtid, mpos = -1, -1
            nf = -1
            if cf & CF_DETACHED:
                mf = series("MF").get()
                if not ch.read_names_included:
                    qname = series("RN").get_array().decode()
                mtid = series("NS").get()
                mpos = series("NP").get() - 1
                series("TS").get()
                if mf & MF_MATE_REVERSE:
                    bf |= 0x20
                if mf & MF_MATE_UNMAPPED:
                    bf |= 0x8
            elif cf & CF_MATE_DOWNSTREAM:
                nf = series("NF").get()
            tl = series("TL").get()
            xg, nh = 0, -1
            for tag, typ, key in ch.tag_dict[tl]:
                val = tag_dec[key].get_array()
                if tag == b"XG" and typ == ord("Z"):
                    first = val[:1]
                    if first == b"C":
                        xg = 1
                    elif first == b"G":
                        xg = 2
                elif tag == b"NH" and typ in b"cCsSiI":
                    nh = _decode_int_tag(typ, val)

            pos = ap - 1
            if not (bf & 0x4):
                seq, qual, cigar, mq = self._decode_mapped(
                    ch, series, dec, rl, pos, tid, ref_for, cf)
            else:
                # unmapped: verbatim bases, no features/MQ (mapq decodes as 0,
                # the htslib convention for unmapped CRAM records)
                seq = bytearray(series("BA").get_n(rl))
                mq = 0
                if cf & CF_QUAL:
                    qual = bytearray(series("QS").get_n(rl))
                else:
                    qual = bytearray(b"\xff" * rl)
                cigar = np.zeros(0, dtype=np.uint32)
            recs.append({
                "qname": qname if qname is not None else f"q{base + i}",
                "flag": bf & 0xFFFF, "tid": tid, "pos": pos, "mapq": mq,
                "l_qseq": rl, "mtid": mtid, "mpos": mpos,
                "xg": xg, "nh": nh, "seq_ascii": bytes(seq),
                "qual": bytes(qual), "cigar": cigar, "nf": nf,
            })
        # resolve downstream mates within this slice
        for i in range(base, len(recs)):
            r = recs[i]
            nf = r.pop("nf")
            if nf < 0:
                continue
            j = i + nf + 1
            m = recs[j]
            r["mtid"], r["mpos"] = m["tid"], m["pos"]
            m["mtid"], m["mpos"] = r["tid"], r["pos"]
            if m["flag"] & 0x10:
                r["flag"] |= 0x20
            if m["flag"] & 0x4:
                r["flag"] |= 0x8
            if r["flag"] & 0x10:
                m["flag"] |= 0x20
            if r["flag"] & 0x4:
                m["flag"] |= 0x8
            m["qname"] = r["qname"]

    def _decode_mapped(self, ch, series, dec, rl, pos, tid, ref_for, cf):
        seq = bytearray(rl)
        qual = bytearray(rl)
        have_qual = bool(cf & CF_QUAL)
        ref, ref_off = ref_for(tid)
        nfeat = series("FN").get()
        cigar_ops: list[tuple[int, int]] = []  # (op, len); op per BAM encoding
        rpos = 1            # 1-based read cursor
        ref_cursor = pos    # 0-based reference cursor
        fpos = 0

        def emit_match(n):
            nonlocal rpos, ref_cursor
            if n <= 0:
                return
            if ref is None:
                seq[rpos - 1 : rpos - 1 + n] = b"N" * n
            else:
                lo = ref_cursor - ref_off
                chunk = ref[lo : lo + n]
                s = bytes(chunk).upper()
                if len(s) < n:
                    s = s + b"N" * (n - len(s))
                seq[rpos - 1 : rpos - 1 + n] = s
            cigar_ops.append((0, n))
            rpos += n
            ref_cursor += n

        for _ in range(nfeat):
            fc = series("FC").get()
            fpos += series("FP").get()
            emit_match(fpos - rpos)
            c = chr(fc)
            if c == "B":
                seq[rpos - 1] = series("BA").get()
                q = series("QS").get()
                if not have_qual:
                    qual[rpos - 1] = q
                cigar_ops.append((0, 1))
                rpos += 1
                ref_cursor += 1
            elif c == "X":
                code = series("BS").get()
                if ref is None:
                    rb_row = 4
                else:
                    lo = ref_cursor - ref_off
                    rb = int(ref[lo]) if 0 <= lo < len(ref) else ord("N")
                    rb_row = int(_REFROW[rb])
                seq[rpos - 1] = int(ch.sub_decode[rb_row, code])
                cigar_ops.append((0, 1))
                rpos += 1
                ref_cursor += 1
            elif c == "I":
                ins = series("IN").get_array()
                seq[rpos - 1 : rpos - 1 + len(ins)] = ins
                cigar_ops.append((1, len(ins)))
                rpos += len(ins)
            elif c == "i":
                seq[rpos - 1] = series("BA").get()
                cigar_ops.append((1, 1))
                rpos += 1
            elif c == "D":
                n = series("DL").get()
                cigar_ops.append((2, n))
                ref_cursor += n
            elif c == "N":
                n = series("RS").get()
                cigar_ops.append((3, n))
                ref_cursor += n
            elif c == "S":
                sc = series("SC").get_array()
                seq[rpos - 1 : rpos - 1 + len(sc)] = sc
                cigar_ops.append((4, len(sc)))
                rpos += len(sc)
            elif c == "H":
                cigar_ops.append((5, series("HC").get()))
            elif c == "P":
                cigar_ops.append((6, series("PD").get()))
            elif c == "b":
                bb = series("BB").get_array()
                seq[rpos - 1 : rpos - 1 + len(bb)] = bb
                cigar_ops.append((0, len(bb)))
                rpos += len(bb)
                ref_cursor += len(bb)
            elif c == "q":
                qq = series("QQ").get_array()
                if not have_qual:
                    qual[rpos - 1 : rpos - 1 + len(qq)] = qq
            elif c == "Q":
                q = series("QS").get()
                if not have_qual:
                    qual[rpos - 1] = q
            else:
                raise ValueError(f"cram: unknown feature code {c!r}")
        emit_match(rl - rpos + 1)
        mq = series("MQ").get()
        if have_qual:
            qual[:] = series("QS").get_n(rl)
        elif not any(qual):
            qual = bytearray(b"\xff" * rl)

        # merge adjacent same-op cigar runs, drop zero-length
        merged: list[tuple[int, int]] = []
        for op, n in cigar_ops:
            if n == 0:
                continue
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + n)
            else:
                merged.append((op, n))
        cigar = np.array([(n << 4) | op for op, n in merged], dtype=np.uint32)
        return seq, qual, cigar, mq

    # ---- SoA assembly

    def _assemble(self):
        recs = self._records
        n = len(recs)
        self.qname = [r["qname"] for r in recs]
        self.flag = np.array([r["flag"] for r in recs], dtype=np.uint16)
        self.tid = np.array([r["tid"] for r in recs], dtype=np.int32)
        self.pos = np.array([r["pos"] for r in recs], dtype=np.int64)
        self.mapq = np.array([r["mapq"] for r in recs], dtype=np.uint8)
        self.l_qseq = np.array([r["l_qseq"] for r in recs], dtype=np.int32)
        self.mtid = np.array([r["mtid"] for r in recs], dtype=np.int32)
        self.mpos = np.array([r["mpos"] for r in recs], dtype=np.int64)
        self.xg = np.array([r["xg"] for r in recs], dtype=np.int8)
        self.nh = np.array([r["nh"] for r in recs], dtype=np.int32)
        endpos = np.zeros(n, dtype=np.int64)
        offsets = np.zeros(n + 1, dtype=np.int64)
        seq_parts, qual_parts, refpos_parts, cigar_parts = [], [], [], []
        cigar_offsets = [0]
        ctotal = 0
        for i, r in enumerate(recs):
            seq_parts.append(_ASCII2CODE[np.frombuffer(r["seq_ascii"], dtype=np.uint8)])
            qual_parts.append(np.frombuffer(r["qual"], dtype=np.uint8))
            rp, ep = _expand_cigar(r["cigar"], r["pos"], r["l_qseq"])
            refpos_parts.append(rp)
            endpos[i] = ep
            offsets[i + 1] = offsets[i] + r["l_qseq"]
            cigar_parts.append(r["cigar"])
            ctotal += len(r["cigar"])
            cigar_offsets.append(ctotal)
        self.endpos = endpos
        self.offsets = offsets
        self.seq_flat = (np.concatenate(seq_parts) if seq_parts
                         else np.zeros(0, np.uint8))
        self.qual_flat = (np.concatenate(qual_parts) if qual_parts
                          else np.zeros(0, np.uint8))
        self.refpos_flat = (np.concatenate(refpos_parts) if refpos_parts
                            else np.zeros(0, np.int32))
        self.cigar_flat = (np.concatenate(cigar_parts) if cigar_parts
                           else np.zeros(0, np.uint32))
        self.cigar_offsets = np.asarray(cigar_offsets, dtype=np.int64)
        del self._records
        self._finalize_order()


def _decode_int_tag(typ: int, val: bytes) -> int:
    t = chr(typ)
    fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[t]
    return struct.unpack_from(fmt, val, 0)[0]


def _header_from_sam_text(text: str) -> BamHeader:
    names, lengths = [], []
    for line in text.splitlines():
        if line.startswith("@SQ"):
            sn, ln = None, None
            for fld in line.split("\t")[1:]:
                if fld.startswith("SN:"):
                    sn = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            if sn is not None and ln is not None:
                names.append(sn)
                lengths.append(ln)
    return BamHeader(text, names, lengths)


# ------------------------------------------------------------------- writer

class _SeriesBuf:
    """Per-series output accumulators for one slice."""

    def __init__(self):
        self.ints: dict[str, bytearray] = {}
        self.bytes_: dict[str, bytearray] = {}
        self.tag_lens: dict[int, bytearray] = {}
        self.tag_vals: dict[int, bytearray] = {}
        # constant-detection for htslib-style zero-bit HUFFMAN encodings
        self.first: dict[str, int] = {}
        self.same: dict[str, bool] = {}

    def put_int(self, key: str, v: int):
        if key not in self.first:
            self.first[key] = v
            self.same[key] = True
        elif self.same[key] and v != self.first[key]:
            self.same[key] = False
        self.ints.setdefault(key, bytearray()).extend(write_itf8(v))

    def put_byte(self, key: str, b: int):
        self.bytes_.setdefault(key, bytearray()).append(b)

    def put_bytes(self, key: str, data: bytes):
        self.bytes_.setdefault(key, bytearray()).extend(data)

    def put_tag(self, key: int, data: bytes):
        self.tag_lens.setdefault(key, bytearray()).extend(write_itf8(len(data)))
        self.tag_vals.setdefault(key, bytearray()).extend(data)


# data series → preferred block compression on write
_SERIES_METHOD = {"QS": RANS, "BA": RANS, "SC": RANS, "IN": RANS, "BB": RANS,
                  "RN": GZIP}


def bam_to_cram(bam, fasta, out_path: str, slice_size: int = 1024,
                emit_index: bool = True, series_method=None,
                huffman_const: bool = False) -> None:
    """Convert a decoded alignment file (AlignmentSoA) to CRAM 3.0.

    Reference-based feature encoding (X substitutions against `fasta`,
    I/D/N/S/H/P from the CIGAR, literal 'B' features for non-ACGTN read
    bases), detached mate info, lossless quality scores. One slice per
    container; records are grouped by (tid) in file order, so a
    coordinate-sorted BAM yields a coordinate-sorted CRAM.
    """
    if isinstance(fasta, str):
        fasta = FastaFile(fasta)
    out = bytearray()
    out += CRAM_MAGIC + bytes([3, 0]) + (out_path.encode()[:20].ljust(20, b"\x00"))

    # ---- file header container
    text = bam.header.text
    if not text.endswith("\n") and text:
        text += "\n"
    hdr_payload = struct.pack("<i", len(text)) + text.encode()
    hdr_block = _write_block(Block(FILE_HEADER, 0, hdr_payload, RAW))
    out += _container_header(len(hdr_block), -1, 0, 0, 0, 0, 0, 1, [0])
    out += hdr_block

    index_rows = []
    counter = 0
    n = bam.n_reads
    # group file-order records into same-tid runs of ≤ slice_size
    i = 0
    ref_cache: dict[int, np.ndarray] = {}
    while i < n:
        tid = int(bam.tid[i])
        j = i
        while j < n and j - i < slice_size and int(bam.tid[j]) == tid:
            j += 1
        idx = list(range(i, j))
        if tid >= 0 and tid not in ref_cache:
            name = bam.header.names[tid]
            ref_cache[tid] = fasta.fetch(name, 0, bam.header.lengths[tid] - 1)
        container_off = len(out)
        blob, landmarks, aln_start, aln_span, slice_len = _encode_container(
            bam, idx, tid, ref_cache.get(tid), counter,
            series_method=series_method, huffman_const=huffman_const)
        out += blob
        counter += len(idx)
        index_rows.append((tid, aln_start, aln_span, container_off,
                           landmarks[0], slice_len))
        i = j

    out += _eof_container()
    with open(out_path, "wb") as fh:
        fh.write(out)
    if emit_index:
        write_crai(out_path + ".crai", index_rows)


def write_crai(path: str, rows) -> None:
    """.crai: gzipped text, one line per slice:
    seqid, alignment start (1-based), span, container offset, slice offset
    within container data, slice size in bytes."""
    txt = "".join(f"{t}\t{s}\t{sp}\t{co}\t{so}\t{sl}\n"
                  for t, s, sp, co, so, sl in rows)
    with open(path, "wb") as fh:
        fh.write(gzip_mod.compress(txt.encode()))


def _container_header(length, ref_id, start, span, n_records, counter, bases,
                      n_blocks, landmarks) -> bytes:
    hdr = bytearray(struct.pack("<i", length))
    hdr += write_itf8(ref_id)
    hdr += write_itf8(start)
    hdr += write_itf8(span)
    hdr += write_itf8(n_records)
    hdr += write_ltf8(counter)
    hdr += write_ltf8(bases)
    hdr += write_itf8(n_blocks)
    hdr += _write_array_itf8(landmarks)
    hdr += struct.pack("<I", zlib.crc32(bytes(hdr)) & 0xFFFFFFFF)
    return bytes(hdr)


def _eof_container() -> bytes:
    """Structurally valid empty EOF container (ref -1, start 0x454F46)."""
    blk = _write_block(Block(COMPRESSION_HEADER, 0,
                             bytes([0x01, 0x00, 0x01, 0x00, 0x01, 0x00]), RAW))
    return _container_header(len(blk), -1, EOF_POSITION, 0, 0, 0, 0, 1, [0]) + blk


_SUB_ENCODE: dict[tuple[int, int], int] = {}
for _row in range(5):
    for _t, _b in enumerate(_row_targets(_row)):
        # identity matrix byte 0x1B assigns code t to target index t
        _SUB_ENCODE[(_row, _b)] = _t


def _encode_container(bam, idx, tid, ref, counter, series_method=None,
                      huffman_const=False):
    """Encode one single-slice container; returns (bytes, landmarks,
    aln_start, aln_span, slice_byte_len)."""
    sb = _SeriesBuf()
    mapped_any = tid >= 0
    ap_delta = mapped_any
    first_pos = int(bam.pos[idx[0]]) if mapped_any else 0
    slice_start = first_pos + 1 if mapped_any else 0
    last_ap = slice_start
    max_end = 0
    tag_lines: list[tuple] = []
    tag_line_ids: dict[tuple, int] = {}
    rec_tls = []

    # same-slice proper pairs use the downstream-mate chain (NF) like htslib;
    # everything else is stored detached with explicit MF/NS/NP/TS
    by_qname: dict[str, list[int]] = {}
    for row, i in enumerate(idx):
        if int(bam.flag[i]) & 0x1:
            by_qname.setdefault(bam.qname[i], []).append(row)
    nf_of: dict[int, int] = {}      # row → NF value (chain head)
    mate_member: set[int] = set()   # rows whose mate info is implied by a chain
    for rows in by_qname.values():
        if len(rows) == 2:
            a, b = rows
            ia, ib = idx[a], idx[b]
            fa, fb = int(bam.flag[ia]), int(bam.flag[ib])
            # link only read1/read2 of a pair (not secondary copies), and only
            # when the stored mate fields are fully reconstructible from the
            # mate record — otherwise NF resolution would diverge from the
            # (possibly inconsistent) BAM values, so store detached instead
            consistent = (
                int(bam.mpos[ia]) == int(bam.pos[ib])
                and int(bam.mpos[ib]) == int(bam.pos[ia])
                and int(bam.mtid[ia]) == int(bam.tid[ib])
                and int(bam.mtid[ib]) == int(bam.tid[ia])
                and bool(fa & 0x20) == bool(fb & 0x10)
                and bool(fb & 0x20) == bool(fa & 0x10)
                and bool(fa & 0x8) == bool(fb & 0x4)
                and bool(fb & 0x8) == bool(fa & 0x4)
            )
            if ((fa ^ fb) & 0xC0 and not (fa & 0x900) and not (fb & 0x900)
                    and consistent):
                nf_of[a] = b - a - 1
                mate_member.add(b)

    # first pass: tag lines
    for i in idx:
        line = []
        if int(bam.xg[i]) != 0:
            line.append((b"XG", ord("Z")))
        if int(bam.nh[i]) != -1:
            line.append((b"NH", ord("i")))
        key = tuple(line)
        if key not in tag_line_ids:
            tag_line_ids[key] = len(tag_lines)
            tag_lines.append(key)
        rec_tls.append(tag_line_ids[key])

    for row, i in enumerate(idx):
        flag = int(bam.flag[i])
        pos = int(bam.pos[i])
        rl = int(bam.l_qseq[i])
        seq_codes, quals, _rp = bam.read_arrays(i)
        seq_ascii = _CODE2ASCII[seq_codes]
        if row in nf_of:
            cf = CF_QUAL | CF_MATE_DOWNSTREAM
        elif row in mate_member:
            cf = CF_QUAL
        elif (flag & 0x1) or int(bam.mtid[i]) >= 0:
            cf = CF_QUAL | CF_DETACHED
        else:
            cf = CF_QUAL
        sb.put_int("BF", flag)
        sb.put_int("CF", cf)
        sb.put_int("RL", rl)
        ap = pos + 1
        if ap_delta:
            sb.put_int("AP", ap - last_ap)
            last_ap = ap
        else:
            sb.put_int("AP", ap)
        sb.put_int("RG", -1)
        sb.put_bytes("RN", bam.qname[i].encode() + b"\x00")
        if cf & CF_DETACHED:
            mf = ((MF_MATE_REVERSE if flag & 0x20 else 0)
                  | (MF_MATE_UNMAPPED if flag & 0x8 else 0))
            sb.put_int("MF", mf)
            sb.put_int("NS", int(bam.mtid[i]))
            sb.put_int("NP", int(bam.mpos[i]) + 1)
            sb.put_int("TS", 0)
        elif cf & CF_MATE_DOWNSTREAM:
            sb.put_int("NF", nf_of[row])
        sb.put_int("TL", rec_tls[row])
        for tag, typ in tag_lines[rec_tls[row]]:
            key = (tag[0] << 16) | (tag[1] << 8) | typ
            if tag == b"XG":
                val = (b"CT\x00" if int(bam.xg[i]) == 1 else b"GA\x00")
                sb.put_tag(key, val)
            else:
                sb.put_tag(key, struct.pack("<i", int(bam.nh[i])))
        if not (flag & 0x4):
            _encode_features(sb, bam.cigar(i), seq_ascii, quals, pos, rl, ref)
            sb.put_int("MQ", int(bam.mapq[i]))
            sb.put_bytes("QS", bytes(quals))
            end = pos + max(1, _ref_len(bam.cigar(i)))
            max_end = max(max_end, end)
        else:
            sb.put_bytes("BA", bytes(seq_ascii))
            sb.put_bytes("QS", bytes(quals))

    aln_span = (max_end - first_pos) if mapped_any else 0

    # ---- content id assignment + encoding maps
    cid = 1
    series_spec: dict[str, tuple[int, bytes]] = {}
    ext_payload: dict[int, bytes] = {}
    for key, buf in sb.ints.items():
        if huffman_const and sb.same.get(key) and sb.first[key] >= 0:
            # htslib-style zero-bit canonical HUFFMAN for constant series
            # (single symbol, code length 0 — no core bits, no external)
            series_spec[key] = (E_HUFFMAN,
                                _write_array_itf8([sb.first[key]])
                                + _write_array_itf8([0]))
            continue
        series_spec[key] = (E_EXTERNAL, write_itf8(cid))
        ext_payload[cid] = bytes(buf)
        cid += 1
    for key, buf in sb.bytes_.items():
        if key in ("RN", "SC", "IN", "BB", "QQ"):
            # NUL-terminated arrays (bases/names are never 0x00)
            series_spec[key] = (E_BYTE_ARRAY_STOP, bytes([0x00]) + write_itf8(cid))
        else:
            series_spec[key] = (E_EXTERNAL, write_itf8(cid))
        ext_payload[cid] = bytes(buf)
        cid += 1
    tag_spec: dict[int, tuple[int, bytes]] = {}
    for key in sb.tag_vals:
        len_cid, val_cid = cid, cid + 1
        ext_payload[len_cid] = bytes(sb.tag_lens[key])
        ext_payload[val_cid] = bytes(sb.tag_vals[key])
        nested = (_encoding_bytes(E_EXTERNAL, write_itf8(len_cid))
                  + _encoding_bytes(E_EXTERNAL, write_itf8(val_cid)))
        tag_spec[key] = (E_BYTE_ARRAY_LEN, nested)
        cid += 2

    # ---- compression header
    td_blob = b"".join(
        b"".join(tag + bytes([typ]) for tag, typ in line) + b"\x00"
        for line in tag_lines)
    pres = bytearray()
    pres += b"RN" + bytes([1])
    pres += b"AP" + bytes([1 if ap_delta else 0])
    pres += b"RR" + bytes([1])
    pres += b"SM" + bytes([0x1B] * 5)
    pres += b"TD" + write_itf8(len(td_blob)) + td_blob
    pres_map = write_itf8(5) + bytes(pres)
    dse = bytearray(write_itf8(len(series_spec)))
    for key, (codec, params) in series_spec.items():
        dse += key.encode() + _encoding_bytes(codec, params)
    tse = bytearray(write_itf8(len(tag_spec)))
    for key, (codec, params) in tag_spec.items():
        tse += write_itf8(key) + _encoding_bytes(codec, params)
    ch_body = (write_itf8(len(pres_map)) + pres_map
               + write_itf8(len(dse)) + bytes(dse)
               + write_itf8(len(tse)) + bytes(tse))
    ch_block = _write_block(Block(COMPRESSION_HEADER, 0, ch_body, GZIP))

    # ---- slice blocks
    ext_cids = sorted(ext_payload)
    cid2key = {}
    for key, (codec, params) in series_spec.items():
        c, _ = read_itf8_signed(params, 0) if codec in (E_EXTERNAL,) else (None, 0)
        if codec == E_EXTERNAL:
            cid2key[c] = key
        elif codec == E_BYTE_ARRAY_STOP:
            c, _ = read_itf8_signed(params, 1)
            cid2key[c] = key
    core_block = _write_block(Block(CORE_DATA, 0, b"", RAW))
    data_blocks = [core_block]
    for c in ext_cids:
        key = cid2key.get(c, "")
        method = (series_method if series_method is not None
                  else _SERIES_METHOD).get(key, GZIP)
        data_blocks.append(_write_block(Block(EXTERNAL_DATA, c,
                                              ext_payload[c], method)))

    shdr = bytearray()
    shdr += write_itf8(tid)
    shdr += write_itf8(slice_start if mapped_any else 0)
    shdr += write_itf8(aln_span)
    shdr += write_itf8(len(idx))
    shdr += write_ltf8(counter)
    shdr += write_itf8(len(data_blocks))
    shdr += _write_array_itf8(ext_cids)
    shdr += write_itf8(-1)  # no embedded reference
    shdr += bytes(16)       # reference md5 (unchecked)
    slice_hdr_block = _write_block(Block(SLICE_HEADER, 0, bytes(shdr), RAW))

    slice_bytes = slice_hdr_block + b"".join(data_blocks)
    body = ch_block + slice_bytes
    landmarks = [len(ch_block)]
    nbases = int(sum(int(bam.l_qseq[i]) for i in idx))
    hdr = _container_header(len(body), tid, slice_start if mapped_any else 0,
                            aln_span, len(idx), counter, nbases,
                            1 + len(data_blocks), landmarks)
    return hdr + body, landmarks, slice_start if mapped_any else 0, \
        aln_span, len(slice_bytes)


def _ref_len(cigar: np.ndarray) -> int:
    if len(cigar) == 0:
        return 1
    ops = cigar & 0xF
    lens = cigar >> 4
    consume = np.isin(ops, (0, 2, 3, 7, 8))
    return int(lens[consume].sum())


def _encode_features(sb: _SeriesBuf, cigar: np.ndarray, seq_ascii: np.ndarray,
                     quals: np.ndarray, pos: int, rl: int, ref) -> None:
    feats = []  # (read_pos_1based, code_char, payload-closure data)
    rpos = 1
    ref_cursor = pos
    for word in cigar:
        op = int(word) & 0xF
        ln = int(word) >> 4
        if op in (0, 7, 8):  # M/=/X: find mismatches
            for k in range(ln):
                rb = (int(ref[ref_cursor + k]) if ref is not None
                      and ref_cursor + k < len(ref) else ord("N"))
                sbase = int(seq_ascii[rpos - 1 + k])
                if (sbase | 0x20) == (rb | 0x20):
                    continue
                # seq_ascii comes from the 4-bit code table: always uppercase
                row = int(_REFROW[rb])
                code = _SUB_ENCODE.get((row, sbase))
                if code is not None:
                    feats.append((rpos + k, "X", code))
                else:
                    feats.append((rpos + k, "B", (sbase, int(quals[rpos - 1 + k]))))
            rpos += ln
            ref_cursor += ln
        elif op == 1:  # I
            feats.append((rpos, "I", bytes(seq_ascii[rpos - 1 : rpos - 1 + ln])))
            rpos += ln
        elif op == 4:  # S
            feats.append((rpos, "S", bytes(seq_ascii[rpos - 1 : rpos - 1 + ln])))
            rpos += ln
        elif op == 2:  # D
            feats.append((rpos, "D", ln))
            ref_cursor += ln
        elif op == 3:  # N
            feats.append((rpos, "N", ln))
            ref_cursor += ln
        elif op == 5:  # H
            feats.append((rpos, "H", ln))
        elif op == 6:  # P
            feats.append((rpos, "P", ln))
        else:
            raise ValueError(f"cram writer: unsupported CIGAR op {op}")
    sb.put_int("FN", len(feats))
    prev = 0
    for fpos, code, payload in feats:
        sb.put_byte("FC", ord(code))
        sb.put_int("FP", fpos - prev)
        prev = fpos
        if code == "X":
            sb.put_byte("BS", payload)
        elif code == "B":
            sb.put_byte("BA", payload[0])
            sb.put_byte("QS", payload[1])
        elif code == "I":
            sb.put_bytes("IN", payload + b"\x00")
        elif code == "S":
            sb.put_bytes("SC", payload + b"\x00")
        elif code in ("D",):
            sb.put_int("DL", payload)
        elif code == "N":
            sb.put_int("RS", payload)
        elif code == "H":
            sb.put_int("HC", payload)
        elif code == "P":
            sb.put_int("PD", payload)


# ------------------------------------------------------------------ dispatch

def read_crai(path: str):
    """Parse a .crai (gzipped text; one line per slice): returns a list of
    (seq_id, aln_start, aln_span, container_offset, slice_offset,
    slice_size) int tuples. Inverse of write_crai; also accepts
    htslib-written indexes (same 6-column format)."""
    rows = []
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip_mod.decompress(data)
    for line in data.decode().splitlines():
        parts = line.split("\t")
        if len(parts) != 6:
            parts = line.split()
        if len(parts) != 6:
            raise ValueError(f"crai: malformed line {line!r}")
        rows.append(tuple(int(x) for x in parts))
    return rows


def _parse_container_header(buf: bytes, p: int):
    """Container header fields + end offset (no CRC check — used for
    seeking/scanning; the decode path re-verifies)."""
    (length,) = struct.unpack_from("<i", buf, p)
    p += 4
    ref_id, p = read_itf8_signed(buf, p)
    start, p = read_itf8_signed(buf, p)
    span, p = read_itf8_signed(buf, p)
    n_records, p = read_itf8(buf, p)
    _counter, p = read_ltf8(buf, p)
    _bases, p = read_ltf8(buf, p)
    n_blocks, p = read_itf8(buf, p)
    _landmarks, p = _read_array_itf8(buf, p)
    p += 4  # crc
    return length, ref_id, start, span, n_records, p


class StreamingCramFile:
    """.crai-indexed windowed CRAM reader: the streaming twin of
    io/bam.StreamingBamFile for CRAM input (the reference gets this from
    htslib's cram_index/.crai seeks, MethylDackel.h:80). Where CramFile
    decodes the whole file up front, this seeks to and decodes only the
    containers whose alignment span intersects the requested window —
    O(one window's containers) memory.

    The .crai next to the file is used when present (ours or htslib's);
    otherwise a container-granularity index is built by scanning container
    HEADERS only (no record decode), which is O(n_containers) reads.
    Decoded containers are LRU-cached so adjacent windows re-decode only
    their new containers."""

    streaming = True

    def __init__(self, path: str, fasta=None, cache_containers: int = 4):
        import os
        import threading

        self.path = path
        if isinstance(fasta, str):
            fasta = FastaFile(fasta)
        self._fasta = fasta
        self._fh = open(path, "rb")
        # extract's -@ N pool calls window_soa concurrently: reads go
        # through os.pread (offset-explicit, no shared seek cursor) and the
        # container cache/LRU is guarded by this lock.
        self._cache_lock = threading.Lock()
        head = self._read_at(0, 26)
        if head[:4] != CRAM_MAGIC:
            raise ValueError(f"{path} is not a CRAM file")
        if head[4] != 3 or head[5] > 1:
            raise ValueError(
                f"cram: unsupported version {head[4]}.{head[5]} (this "
                f"reader supports CRAM 3.0 and 3.1)")
        # file-header container
        buf = self._read_at(26, 1 << 20)
        shell = CramFile.__new__(CramFile)
        shell._fasta = fasta
        shell._records = []
        data_end, _eof = shell._read_container(buf, 0, True)
        self.header = shell.header
        self._first_data = 26 + data_end

        crai = next((c for c in (path + ".crai",
                                 path.rsplit(".", 1)[0] + ".crai")
                     if os.path.exists(c)), None)
        if crai is not None:
            # container granularity: collapse slice rows by offset
            by_off: dict[int, list] = {}
            for (sid, st, sp, c_off, _so, _sl) in read_crai(crai):
                by_off.setdefault(c_off, []).append((sid, st, sp))
            self._index = []
            for c_off in sorted(by_off):
                for sid, st, sp in by_off[c_off]:
                    self._index.append((sid, st, sp, c_off))
        else:
            self._index = self._scan_containers()
        self._cache: "dict[int, list]" = {}
        self._cache_order: list[int] = []
        self._cache_max = cache_containers

    def _read_at(self, off: int, size: int) -> bytes:
        import os

        # pread: atomic (offset, size) read — safe under concurrent
        # window_soa calls from the -@ N worker pool (no seek+read race).
        return os.pread(self._fh.fileno(), size, off)

    def _scan_containers(self):
        rows = []
        off = self._first_data
        import os

        fsize = os.path.getsize(self.path)
        while off < fsize:
            hdr = self._read_at(off, 1 << 16)
            if len(hdr) < 10:
                break
            length, ref_id, start, span, n_records, hdr_end = \
                _parse_container_header(hdr, 0)
            if ref_id == -1 and start == EOF_POSITION and n_records == 0:
                break
            if n_records:
                rows.append((ref_id, start, span, off))
            off += hdr_end + length
        return rows

    @property
    def n_reads(self) -> int:
        """Total records, summed from the container headers (one small
        pread per container, computed once). Keeps the reads_decoded stat
        (engine/extract.py) truthful on the streaming CRAM path."""
        cached = getattr(self, "_n_reads", None)
        if cached is None:
            total = 0
            # .crai rows are per-slice: dedupe to container offsets
            for c_off in dict.fromkeys(r[3] for r in self._index):
                # Container headers with many slices/landmarks can exceed a
                # small fixed read; retry with a doubled buffer instead of
                # silently dropping the container from the count.
                read_len = 4096
                while True:
                    hdr = self._read_at(c_off, read_len)
                    try:
                        _l, _r, _s, _sp2, n_records, _he = \
                            _parse_container_header(hdr, 0)
                    except (ValueError, IndexError):
                        if len(hdr) == read_len and read_len < (1 << 20):
                            read_len *= 2  # plausibly truncated: read more
                            continue
                        n_records = 0  # genuinely unparseable
                    break
                total += n_records
            cached = self._n_reads = total
        return cached

    def _container_records(self, off: int) -> list:
        with self._cache_lock:
            recs = self._cache.get(off)
            if recs is not None:
                self._cache_order.remove(off)
                self._cache_order.append(off)
                return recs
        hdr = self._read_at(off, 1 << 16)
        length, _r, _s, _sp, _n, hdr_end = _parse_container_header(hdr, 0)
        total = hdr_end + length
        buf = hdr[:total] if total <= len(hdr) else (
            hdr + self._read_at(off + len(hdr), total - len(hdr)))
        shell = CramFile.__new__(CramFile)
        shell._fasta = self._fasta
        shell.header = self.header
        shell._records = []
        shell._read_container(buf, 0, False)
        recs = shell._records
        with self._cache_lock:
            self._cache[off] = recs
            self._cache_order.append(off)
            while len(self._cache_order) > self._cache_max:
                self._cache.pop(self._cache_order.pop(0), None)
        return recs

    def window_soa(self, tid: int, start: int, end: int):
        """Decode the containers intersecting [start, end) on tid (±1 slack
        absorbs 0/1-based aln_start conventions; multi-ref containers,
        ref_id -2, are always candidates) into an assembled AlignmentSoA."""
        offs = []
        for (sid, st, sp, c_off) in self._index:
            if sid == -2 or (sid == tid and st - 1 < end
                             and st + max(sp, 0) + 1 > start):
                if c_off not in offs:
                    offs.append(c_off)
        shell = CramFile.__new__(CramFile)
        shell._fasta = self._fasta
        shell.header = self.header
        shell._records = []
        for off in sorted(offs):
            shell._records = shell._records + self._container_records(off)
        shell._assemble()
        return shell


def open_alignment(path: str, fasta=None, prefer_stream: bool | None = None):
    """Open a BAM or CRAM by magic bytes → AlignmentSoA (or the streaming
    window reader for huge inputs: decode-per-window keeps memory at
    O(one window's reads) instead of O(whole file); BAM needs the .bai,
    CRAM uses the .crai or a container-header scan). `prefer_stream`
    lowers the size threshold (the device engine's decode-prefetch thread
    overlaps per-window decode with dispatch, so streaming wins there far
    below the memory-pressure threshold)."""
    import os

    with open(path, "rb") as fh:
        magic = fh.read(4)
    force = os.environ.get("MDTPU_STREAM") == "1"
    if os.environ.get("MDTPU_STREAM") == "0":
        prefer_stream = None  # explicit opt-out keeps whole-file decode
    threshold = int(os.environ.get("MDTPU_STREAM_THRESHOLD", 4 << 30))
    if prefer_stream:
        threshold = min(threshold, int(os.environ.get(
            "MDTPU_DEVICE_STREAM_THRESHOLD", 256 << 20)))
    big = os.path.getsize(path) >= threshold
    if magic == CRAM_MAGIC:
        if force or big:
            return StreamingCramFile(path, fasta=fasta)
        return CramFile(path, fasta=fasta)
    if magic[:2] != b"\x1f\x8b" or path.endswith(".sam.gz"):
        if magic == b"BAM\x01":
            # Uncompressed BAM (hts_open accepts it): decode the record
            # stream directly instead of surfacing a SAM parse error.
            from .bam import BamFile

            return BamFile(path, raw=True)
        # Not BGZF/gzip-framed (or explicitly gzipped SAM): htslib's
        # hts_open auto-detects SAM text and the reference binary
        # therefore accepts it (main.c:31); so do we.
        from .sam import SamFile

        return SamFile(path)
    from .bam import BamFile, StreamingBamFile

    if force or big:
        has_idx = any(os.path.exists(c) for c in (
            path + ".bai", path.rsplit(".", 1)[0] + ".bai",
            path + ".csi", path.rsplit(".", 1)[0] + ".csi"))
        if not has_idx:
            # Build it with O(chunk) memory (bam_index_build parity,
            # extract.c:1050-1057) — never inflate a huge file whole.
            # Contigs beyond BAI's 2^29 ceiling get a CSI instead.
            import sys
            from .bai import build_bai_streaming
            from .bgzf import BGZFBlockIndex
            from .bam import parse_bam_header_flat
            from .csi import BAI_MAX_POS, build_csi_streaming

            sys.stderr.write(
                f"Couldn't load the index for {path}, will attempt to build it.\n")
            hdr0, _ = parse_bam_header_flat(BGZFBlockIndex(path))
            if max([0] + list(hdr0.lengths or [])) > BAI_MAX_POS:
                build_csi_streaming(path, path + ".csi")
            else:
                build_bai_streaming(path, path + ".bai")
        return StreamingBamFile(path)
    return BamFile(path)
