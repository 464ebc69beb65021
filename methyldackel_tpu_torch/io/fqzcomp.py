"""fqzcomp quality codec — CRAM 3.1 block compression method 7.

From-scratch implementation of the adaptive context-modelled quality
coder CRAM 3.1 adds as codec 7 (hts-specs CRAMcodecs "fqzcomp qual";
htscodecs fqzcomp_qual). The reference consumes CRAM through htslib
(MethylDackel.h:80), which accepts 3.1 containers compressing the QS
series with this codec; this module extends this framework's own CRAM
reader (io/cram.py).

Wire-format note (PARITY.md "Known gaps"): no htslib binary or network
exists in this build environment; the layout follows the hts-specs /
htscodecs definitions as closely as reconstructable offline and is
validated by round-trip + adversarial fixtures in-repo
(tests/test_cram31_codecs.py), not against htslib output. The lookup-
array serialization (`read_array`) is the least-certain corner and is
kept strict: out-of-range or short arrays raise ValueError.

Layout::

    header := vers:u8 (=5) gflags:u8
              [nparam:u8 if gflags&MULTI_PARAM]
              [max_sel:u8 + stab array(256) if gflags&HAVE_STAB]
              nparam × param
    param  := context:u16le pflags:u8 max_sym:u8 (0 == 256)
              (qbits<<4|qshift):u8 (qloc<<4|sloc):u8 (ploc<<4|dloc):u8
              [qmap: max_sym×u8   if pflags&HAVE_QMAP]
              [qtab: array(256)   if pflags&HAVE_QTAB]
              [ptab: array(1024)  if pflags&HAVE_PTAB]
              [dtab: array(256)   if pflags&HAVE_DTAB]
    array  := runs of the non-decreasing values 0,1,2,...: for each value
              its run length in 255-continuation chunks
    body   := one range-coded stream (io/arith range coder + model):
              per record: [sel if max_sel>0] [len:4×u8(LE) via 4 models if
              DO_LEN or first record] [rev bit if gflags&DO_REV]
              [dup bit if DO_DEDUP; 1 → copy previous record's quals]
              then per base: q from qual_model[ctx] (quality =
              qmap[q] if HAVE_QMAP else q), ctx advanced by the
              qtab/ptab/dtab context update; records flagged rev are
              reversed after the full decode.

Context update (the spec's fqz_update_ctx)::

    qctx   = (qctx << qshift) + qtab[q]
    ctx    = param.context + ((qctx & (2^qbits-1)) << qloc)
           + (ptab[min(p, 1023)] << ploc   if HAVE_PTAB)
           + (dtab[min(delta, 255)] << dloc if HAVE_DTAB)
           + (sel << sloc                   if DO_SEL)
    p -= 1;  delta += (prevq != q);  prevq = q;  ctx &= 0xFFFF
"""
from __future__ import annotations

import numpy as np

from .arith import Model, RangeDecoder, RangeEncoder

VERS = 5

GFLAG_MULTI_PARAM = 0x01
GFLAG_HAVE_STAB = 0x02
GFLAG_DO_REV = 0x04

PFLAG_DO_DEDUP = 0x02
PFLAG_DO_LEN = 0x04
PFLAG_DO_SEL = 0x08
PFLAG_HAVE_QMAP = 0x10
PFLAG_HAVE_PTAB = 0x20
PFLAG_HAVE_DTAB = 0x40
PFLAG_HAVE_QTAB = 0x80

CTX_SIZE = 1 << 16


# ------------------------------------------------------------------- arrays

def _store_array(vals) -> bytes:
    """Serialize a non-decreasing lookup table as per-value run lengths
    (255-continuation chunks)."""
    vals = list(vals)
    out = bytearray()
    i, n = 0, len(vals)
    v = 0
    while i < n:
        if vals[i] < v:
            raise ValueError("fqzcomp: lookup arrays must be non-decreasing")
        run = 0
        while i < n and vals[i] == v:
            run += 1
            i += 1
        while True:
            chunk = min(run, 255)
            out.append(chunk)
            run -= chunk
            if chunk < 255:
                break
        v += 1
    return bytes(out)


def _read_array(buf, p: int, size: int):
    vals = []
    v = 0
    while len(vals) < size:
        run = 0
        while True:
            if p >= len(buf):
                raise ValueError("fqzcomp: truncated lookup array")
            chunk = buf[p]
            p += 1
            run += chunk
            if chunk < 255:
                break
        if len(vals) + run > size:
            raise ValueError("fqzcomp: lookup array overruns declared size")
        vals.extend([v] * run)
        v += 1
        if v > size:
            raise ValueError("fqzcomp: lookup array failed to converge")
    return vals, p


# -------------------------------------------------------------------- param

class _Param:
    __slots__ = ("context", "pflags", "max_sym", "qbits", "qshift", "qloc",
                 "sloc", "ploc", "dloc", "qmap", "qtab", "ptab", "dtab",
                 "qmask")

    def header(self) -> bytes:
        out = bytearray()
        out += self.context.to_bytes(2, "little")
        out.append(self.pflags)
        out.append(self.max_sym & 0xFF)
        out.append((self.qbits << 4) | self.qshift)
        out.append((self.qloc << 4) | self.sloc)
        out.append((self.ploc << 4) | self.dloc)
        if self.pflags & PFLAG_HAVE_QMAP:
            out += bytes(self.qmap[: self.max_sym])
        if self.pflags & PFLAG_HAVE_QTAB:
            out += _store_array(self.qtab)
        if self.pflags & PFLAG_HAVE_PTAB:
            out += _store_array(self.ptab)
        if self.pflags & PFLAG_HAVE_DTAB:
            out += _store_array(self.dtab)
        return bytes(out)


def _param_default(max_sym: int) -> _Param:
    pp = _Param()
    pp.context = 0
    pp.pflags = PFLAG_DO_LEN
    pp.max_sym = max_sym
    pp.qbits, pp.qshift = 12, 5
    pp.qloc = pp.sloc = pp.ploc = pp.dloc = 0
    pp.qmap = None
    pp.qtab = list(range(256))
    pp.ptab = [0] * 1024
    pp.dtab = [0] * 256
    pp.qmask = (1 << pp.qbits) - 1
    return pp


def _read_param(buf, p: int):
    pp = _Param()
    if p + 6 > len(buf):
        raise ValueError("fqzcomp: truncated parameter block")
    pp.context = int.from_bytes(buf[p : p + 2], "little")
    pp.pflags = buf[p + 2]
    pp.max_sym = buf[p + 3] or 256
    x = buf[p + 4]
    pp.qbits, pp.qshift = x >> 4, x & 15
    x = buf[p + 5]
    pp.qloc, pp.sloc = x >> 4, x & 15
    p += 6
    x = buf[p]
    pp.ploc, pp.dloc = x >> 4, x & 15
    p += 1
    pp.qmask = (1 << pp.qbits) - 1
    if pp.pflags & PFLAG_HAVE_QMAP:
        pp.qmap = list(buf[p : p + pp.max_sym])
        if len(pp.qmap) != pp.max_sym:
            raise ValueError("fqzcomp: truncated qmap")
        p += pp.max_sym
    else:
        pp.qmap = None
    if pp.pflags & PFLAG_HAVE_QTAB:
        pp.qtab, p = _read_array(buf, p, 256)
    else:
        pp.qtab = list(range(256))
    if pp.pflags & PFLAG_HAVE_PTAB:
        pp.ptab, p = _read_array(buf, p, 1024)
    else:
        pp.ptab = [0] * 1024
    if pp.pflags & PFLAG_HAVE_DTAB:
        pp.dtab, p = _read_array(buf, p, 256)
    else:
        pp.dtab = [0] * 256
    return pp, p


# -------------------------------------------------------------------- state

class _Models:
    def __init__(self, max_sym: int, max_sel: int):
        self.max_sym = max_sym
        self.qual: dict[int, Model] = {}
        self.len = [Model(256) for _ in range(4)]
        self.rev = Model(2)
        self.dup = Model(2)
        self.sel = Model(max_sel + 1) if max_sel > 0 else None

    def qual_model(self, ctx: int) -> Model:
        m = self.qual.get(ctx)
        if m is None:
            m = self.qual[ctx] = Model(self.max_sym)
        return m


def _update_ctx(pp: _Param, st: dict, q: int) -> int:
    st["qctx"] = ((st["qctx"] << pp.qshift) + pp.qtab[q]) & 0xFFFFFFFF
    ctx = pp.context + ((st["qctx"] & pp.qmask) << pp.qloc)
    if pp.pflags & PFLAG_HAVE_PTAB:
        ctx += pp.ptab[min(st["p"], 1023)] << pp.ploc
    if pp.pflags & PFLAG_HAVE_DTAB:
        ctx += pp.dtab[min(st["delta"], 255)] << pp.dloc
    if pp.pflags & PFLAG_DO_SEL:
        ctx += st["sel"] << pp.sloc
    st["p"] -= 1
    st["delta"] += st["prevq"] != q
    st["prevq"] = q
    return ctx & (CTX_SIZE - 1)


# ------------------------------------------------------------------- encode

def compress(raw: bytes, lens=None) -> bytes:
    """Encode concatenated per-record quality bytes. `lens` gives record
    lengths (defaults to one record spanning `raw`)."""
    data = np.frombuffer(raw, dtype=np.uint8)
    if lens is None:
        lens = [len(raw)] if len(raw) else []
    if sum(lens) != len(raw):
        raise ValueError("fqzcomp: record lengths do not sum to input size")
    max_sym = (int(data.max()) + 1) if len(data) else 1
    pp = _param_default(max_sym)

    out = bytearray([VERS, 0])  # gflags 0: single param, no stab, no rev
    out += pp.header()

    models = _Models(max_sym, 0)
    rc = RangeEncoder()
    pos = 0
    first = True
    for ln in lens:
        if pp.pflags & PFLAG_DO_LEN or first:
            for k in range(4):
                models.len[k].encode(rc, (ln >> (8 * k)) & 0xFF)
            first = False
        st = {"qctx": 0, "prevq": 0, "delta": 0, "p": ln, "sel": 0}
        ctx = pp.context
        for q in data[pos : pos + ln].tolist():
            models.qual_model(ctx).encode(rc, q)
            ctx = _update_ctx(pp, st, q)
        pos += ln
    out += rc.finish()
    return bytes(out)


# ------------------------------------------------------------------- decode

def uncompress(stream: bytes, ulen: int) -> bytes:
    try:
        return _uncompress(stream, ulen)
    except IndexError as exc:  # truncated buffer indexing
        raise ValueError(f"fqzcomp: truncated stream ({exc})") from exc


def _uncompress(stream: bytes, ulen: int) -> bytes:
    if len(stream) < 2:
        raise ValueError("fqzcomp: truncated stream")
    if stream[0] != VERS:
        raise ValueError(f"fqzcomp: unsupported version {stream[0]}")
    gflags = stream[1]
    p = 2
    nparam = 1
    if gflags & GFLAG_MULTI_PARAM:
        nparam = stream[p]
        p += 1
    max_sel = nparam - 1 if nparam > 1 else 0
    if gflags & GFLAG_HAVE_STAB:
        max_sel = stream[p]
        p += 1
        stab, p = _read_array(stream, p, 256)
    else:
        stab = [min(i, nparam - 1) for i in range(256)]
    params = []
    for _ in range(nparam):
        pp, p = _read_param(stream, p)
        params.append(pp)
    if any(s >= nparam for s in stab[: max_sel + 1]):
        raise ValueError("fqzcomp: selector table exceeds parameter count")

    max_sym = max(pp.max_sym for pp in params)
    models = _Models(max_sym, max_sel)
    rc = RangeDecoder(stream, p)
    out = bytearray()
    rec_bounds = []  # (start, end, reversed?)
    last_len = 0
    first = True
    while len(out) < ulen:
        sel = models.sel.decode(rc) if models.sel is not None else 0
        pp = params[stab[sel]]
        if pp.pflags & PFLAG_DO_LEN or first:
            ln = 0
            for k in range(4):
                ln |= models.len[k].decode(rc) << (8 * k)
            last_len = ln
            first = False
        else:
            ln = last_len
        if ln == 0 or len(out) + ln > ulen:
            raise ValueError("fqzcomp: record length overruns declared size")
        rev = models.rev.decode(rc) if gflags & GFLAG_DO_REV else 0
        if pp.pflags & PFLAG_DO_DEDUP:
            if models.dup.decode(rc):
                if len(out) < ln:
                    raise ValueError("fqzcomp: dup record before any data")
                out += out[-ln:]
                rec_bounds.append((len(out) - ln, len(out), rev))
                continue
        st = {"qctx": 0, "prevq": 0, "delta": 0, "p": ln, "sel": sel}
        ctx = pp.context
        start = len(out)
        for _ in range(ln):
            q = models.qual_model(ctx).decode(rc)
            out.append(pp.qmap[q] if pp.qmap is not None else q)
            ctx = _update_ctx(pp, st, q)
        rec_bounds.append((start, len(out), rev))
    if gflags & GFLAG_DO_REV:
        for start, end, rev in rec_bounds:
            if rev:
                out[start:end] = out[start:end][::-1]
    return bytes(out)
