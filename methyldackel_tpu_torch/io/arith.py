"""Adaptive arithmetic (range) coder — CRAM 3.1 block compression method 6.

From-scratch implementation of the order-0/1 adaptive byte coder the CRAM
3.1 spec adds as codec 6 (hts-specs CRAMcodecs "Adaptive arithmetic
coding"; htscodecs arith_dynamic). The reference consumes CRAM through
htslib (MethylDackel.h:80), which accepts 3.1 containers using this
codec; this module extends this framework's own CRAM reader (io/cram.py).

Wire-format note (PARITY.md "Known gaps"): no htslib binary or network
exists in this build environment, so the byte layout follows the
hts-specs / htscodecs definitions as closely as reconstructable offline
and is validated by round-trip + adversarial fixtures in-repo
(tests/test_cram31_codecs.py), not against htslib output. The layout is
isolated here so reconciling against a real htslib artifact is a local
change. Decoding is strict: structural inconsistencies raise ValueError
rather than returning silently-wrong bytes.

Layout::

    stream := flags:u8 [ulen:uint7 unless NOSZ] body
    flags  : 0x01 ORDER1  0x04 EXT (body is a bzip2 stream)
             0x08 STRIPE  0x10 NOSZ  0x20 CAT  0x40 RLE  0x80 PACK
    STRIPE : X:u8, clen[0..X):uint7, then X full recursive streams;
             substream j carries bytes j, j+X, j+2X, ...
    CAT    : ulen literal bytes
    PACK   : nsym:u8, sym[0..nsym):u8, packed_len:uint7, then the coder
             runs over the packed bytes (1/2/4/8 per byte as in rANS Nx16)
    body   : max_sym:u8 (0 == 256), then a range-coded stream:
             order 0     — one adaptive model over max_sym symbols
             order 1     — max_sym models selected by the previous byte
             RLE         — literals from the byte model(s); after each
                           literal, its run length from a per-symbol run
                           model in chunks of ≤255 (a 255 chunk continues)

The entropy core is the carry-propagating byte-wise range coder
(64-bit low / 32-bit range, 2^24 renormalisation) with the adaptive
frequency model: symbols start at frequency 1, +16 per hit, halved when
the total exceeds 2^16-32, kept approximately frequency-sorted by
adjacent transposition.
"""
from __future__ import annotations

import bz2

import numpy as np

from .ransnx16 import (read_uint7, write_uint7, _pack_encode, _pack_decode)

ORDER1 = 0x01
EXT = 0x04
STRIPE = 0x08
NOSZ = 0x10
CAT = 0x20
RLE = 0x40
PACK = 0x80

MAX_FREQ = (1 << 16) - 32
STEP = 16


# --------------------------------------------------------------- range coder

class RangeEncoder:
    """Byte-wise carry-propagating range encoder (htscodecs c_range_coder)."""

    __slots__ = ("low", "range", "cache", "ffnum", "out")

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0  # the initial zero cache byte is emitted first;
        self.ffnum = 0  # the decoder primes with 5 bytes and discards it
        self.out = bytearray()

    def _shift_low(self):
        carry = self.low >> 32  # 0 or 1: low stays < 2^33
        if carry or (self.low & 0xFFFFFFFF) < 0xFF000000:
            # resolved: flush cache + any pending 0xFF run with the carry
            self.out.append((self.cache + carry) & 0xFF)
            while self.ffnum:
                self.out.append((0xFF + carry) & 0xFF)
                self.ffnum -= 1
            self.cache = (self.low >> 24) & 0xFF
        else:
            self.ffnum += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, cum: int, freq: int, tot: int):
        r = self.range // tot
        self.low += cum * r
        self.range = r * freq
        while self.range < (1 << 24):
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    __slots__ = ("code", "range", "buf", "pos", "end")

    def __init__(self, buf, pos: int, end: int | None = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end
        self.code = 0
        self.range = 0xFFFFFFFF
        for _ in range(5):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFFFF
        self.code &= 0xFFFFFFFF

    def _byte(self) -> int:
        if self.pos < self.end:
            b = self.buf[self.pos]
            self.pos += 1
            return b
        return 0  # zero-fill past the end (final normalisation slack)

    def get_freq(self, tot: int) -> int:
        self.range //= tot
        return min(self.code // self.range, tot - 1)

    def decode(self, cum: int, freq: int):
        self.code -= cum * self.range
        self.range *= freq
        while self.range < (1 << 24):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF


class Model:
    """Adaptive frequency model, approximately sorted by frequency."""

    __slots__ = ("total", "freq", "sym")

    def __init__(self, nsym: int):
        self.total = nsym
        self.freq = [1] * nsym
        self.sym = list(range(nsym))

    def _bump(self, i: int):
        f = self.freq
        f[i] += STEP
        self.total += STEP
        if i > 0 and f[i] > f[i - 1]:
            f[i], f[i - 1] = f[i - 1], f[i]
            s = self.sym
            s[i], s[i - 1] = s[i - 1], s[i]
        if self.total > MAX_FREQ:
            tot = 0
            for j in range(len(f)):
                f[j] -= f[j] >> 1
                tot += f[j]
            self.total = tot

    def encode(self, rc: RangeEncoder, symbol: int):
        cum = 0
        sym = self.sym
        freq = self.freq
        for i in range(len(sym)):
            if sym[i] == symbol:
                rc.encode(cum, freq[i], self.total)
                self._bump(i)
                return
            cum += freq[i]
        raise ValueError(f"arith: symbol {symbol} outside model alphabet")

    def decode(self, rc: RangeDecoder) -> int:
        r = rc.get_freq(self.total)
        cum = 0
        freq = self.freq
        for i in range(len(freq)):
            if cum + freq[i] > r:
                rc.decode(cum, freq[i])
                symbol = self.sym[i]
                self._bump(i)
                return symbol
            cum += freq[i]
        raise ValueError("arith: corrupt stream (cumulative frequency "
                         "exceeded model total)")


# --------------------------------------------------------------- order 0 / 1

def _max_sym(data: np.ndarray) -> int:
    return (int(data.max()) + 1) if len(data) else 1


def _compress_o0(data: np.ndarray, rle: bool) -> bytes:
    m = _max_sym(data)
    rc = RangeEncoder()
    lit = Model(m)
    if not rle:
        for b in data.tolist():
            lit.encode(rc, b)
    else:
        runs = Model(256)  # shared run-length model bank keyed by symbol
        run_m = [None] * m
        vals = data.tolist()
        i, n = 0, len(vals)
        while i < n:
            b = vals[i]
            lit.encode(rc, b)
            j = i + 1
            while j < n and vals[j] == b:
                j += 1
            run = j - i - 1
            i = j
            rm = run_m[b]
            if rm is None:
                rm = run_m[b] = Model(256)
            while True:
                chunk = min(run, 255)
                rm.encode(rc, chunk)
                run -= chunk
                if chunk < 255:
                    break
    return bytes([m & 0xFF]) + rc.finish()


def _uncompress_o0(buf, p: int, n: int, rle: bool) -> bytes:
    if p >= len(buf):
        raise ValueError("arith: truncated stream (missing max_sym)")
    m = buf[p] or 256
    rc = RangeDecoder(buf, p + 1)
    lit = Model(m)
    out = bytearray()
    if not rle:
        for _ in range(n):
            out.append(lit.decode(rc))
    else:
        run_m = [None] * m
        while len(out) < n:
            b = lit.decode(rc)
            rm = run_m[b]
            if rm is None:
                rm = run_m[b] = Model(256)
            run = 0
            while True:
                chunk = rm.decode(rc)
                run += chunk
                if chunk < 255:
                    break
            out.append(b)
            for _ in range(run):
                out.append(b)
        if len(out) != n:
            raise ValueError("arith: RLE expansion overran the declared size")
    return bytes(out)


def _compress_o1(data: np.ndarray, rle: bool) -> bytes:
    m = _max_sym(data)
    rc = RangeEncoder()
    lits = [None] * m
    run_m = [None] * m
    vals = data.tolist()
    last = 0
    i, n = 0, len(vals)
    while i < n:
        b = vals[i]
        lm = lits[last]
        if lm is None:
            lm = lits[last] = Model(m)
        lm.encode(rc, b)
        if not rle:
            last = b
            i += 1
            continue
        j = i + 1
        while j < n and vals[j] == b:
            j += 1
        run = j - i - 1
        i = j
        last = b
        rm = run_m[b]
        if rm is None:
            rm = run_m[b] = Model(256)
        while True:
            chunk = min(run, 255)
            rm.encode(rc, chunk)
            run -= chunk
            if chunk < 255:
                break
    return bytes([m & 0xFF]) + rc.finish()


def _uncompress_o1(buf, p: int, n: int, rle: bool) -> bytes:
    if p >= len(buf):
        raise ValueError("arith: truncated stream (missing max_sym)")
    m = buf[p] or 256
    rc = RangeDecoder(buf, p + 1)
    lits = [None] * m
    run_m = [None] * m
    out = bytearray()
    last = 0
    while len(out) < n:
        lm = lits[last]
        if lm is None:
            lm = lits[last] = Model(m)
        b = lm.decode(rc)
        if not rle:
            out.append(b)
            last = b
            continue
        rm = run_m[b]
        if rm is None:
            rm = run_m[b] = Model(256)
        run = 0
        while True:
            chunk = rm.decode(rc)
            run += chunk
            if chunk < 255:
                break
        out.append(b)
        for _ in range(run):
            out.append(b)
        last = b
    if len(out) != n:
        raise ValueError("arith: RLE expansion overran the declared size")
    return bytes(out)


# ------------------------------------------------------------- public stream

def compress(raw: bytes, flags: int = 0) -> bytes:
    """Encode `raw` as a method-6 stream with the given transform flags."""
    data = np.frombuffer(raw, dtype=np.uint8)
    out = bytearray([flags & 0xFF])
    if not (flags & NOSZ):
        out += write_uint7(len(raw))

    if flags & STRIPE:
        x = 4
        subs = [compress(data[j::x].tobytes(),
                         flags & ~(STRIPE | NOSZ) | NOSZ) for j in range(x)]
        out.append(x)
        for s in subs:
            out += write_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)

    if flags & EXT:
        out += bz2.compress(raw)
        return bytes(out)

    if flags & CAT:
        out += raw
        return bytes(out)

    if flags & PACK:
        packed, syms = _pack_encode(data)
        if syms is None or len(syms) > 16:
            raise ValueError("arith: PACK requested but alphabet exceeds "
                             "16 symbols")
        out.append(len(syms))
        out += bytes(int(s) for s in syms)
        out += write_uint7(len(packed))
        data = packed

    body = (_compress_o1 if flags & ORDER1 else _compress_o0)(
        data, bool(flags & RLE))
    out += body
    return bytes(out)


def uncompress(stream: bytes, ulen: int | None = None) -> bytes:
    try:
        out, _ = _uncompress_at(stream, 0, ulen)
    except IndexError as exc:  # truncated buffer indexing
        raise ValueError(f"arith: truncated stream ({exc})") from exc
    return out


def _uncompress_at(buf: bytes, p: int, ulen=None) -> tuple[bytes, int]:
    if p >= len(buf):
        raise ValueError("arith: empty stream")
    flags = buf[p]
    p += 1
    if not (flags & NOSZ):
        ulen, p = read_uint7(buf, p)
    if ulen is None:
        raise ValueError("arith: NOSZ stream requires an external size")

    if flags & STRIPE:
        x = buf[p]
        p += 1
        if x == 0:
            raise ValueError("arith: STRIPE with zero substreams")
        clens = []
        for _ in range(x):
            c, p = read_uint7(buf, p)
            clens.append(c)
        out = np.zeros(ulen, dtype=np.uint8)
        for j in range(x):
            sub_len = len(range(j, ulen, x))
            sub, q = _uncompress_at(buf[p:p + clens[j]], 0, sub_len)
            out[j::x] = np.frombuffer(sub, dtype=np.uint8)
            p += clens[j]
        return out.tobytes(), p

    if flags & EXT:
        dec = bz2.BZ2Decompressor()
        out = dec.decompress(buf[p:], max_length=ulen)
        if len(out) != ulen:
            raise ValueError("arith: EXT stream shorter than declared size")
        consumed = len(buf) - p - len(dec.unused_data)
        return out, p + consumed

    if flags & CAT:
        if p + ulen > len(buf):
            raise ValueError("arith: CAT stream shorter than declared size")
        return bytes(buf[p:p + ulen]), p + ulen

    n = ulen
    syms = None
    if flags & PACK:
        nsym = buf[p]
        p += 1
        syms = np.frombuffer(bytes(buf[p:p + nsym]), dtype=np.uint8)
        p += nsym
        n, p = read_uint7(buf, p)

    body = (_uncompress_o1 if flags & ORDER1 else _uncompress_o0)(
        buf, p, n, bool(flags & RLE))
    data = np.frombuffer(body, dtype=np.uint8)
    if flags & PACK:
        data = _pack_decode(data, syms, ulen)
    if len(data) != ulen:
        raise ValueError("arith: decoded size mismatch")
    return data.tobytes(), len(buf)
