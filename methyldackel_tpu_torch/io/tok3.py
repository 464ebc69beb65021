"""Name tokeniser — CRAM 3.1 block compression method 8.

From-scratch implementation of the structured read-name codec CRAM 3.1
adds as codec 8 (hts-specs CRAMcodecs "Name tokenisation"; htscodecs
tokenise_name3). The reference consumes CRAM through htslib
(MethylDackel.h:80), which accepts 3.1 containers compressing the RN
series with this codec; this module extends this framework's own CRAM
reader (io/cram.py).

Wire-format note (PARITY.md "Known gaps"): no htslib binary or network
exists in this build environment; the layout follows the hts-specs /
htscodecs definitions as closely as reconstructable offline and is
validated by round-trip + adversarial fixtures in-repo
(tests/test_cram31_codecs.py), not against htslib output. Decoding is
strict — malformed streams raise ValueError.

Model: each name is split into tokens (digit runs, alpha runs, single
chars); token t of every name is described against the SAME token of a
reference name (an earlier name chosen per-name): identical → MATCH,
numeric with a small positive delta → DELTA/DELTA0, else a literal
DIGITS/DIGITS0/ALPHA/CHAR. Token streams are grouped by (position,
type) and each group is entropy-coded independently, so highly similar
columns (flow-cell, lane, tile) collapse to near-nothing.

Layout::

    header  := ulen:uint7 nnames:uint7 use_arith:u8 (0 rANS-Nx16, 1 arith)
    streams := repeated: desc:u8, then
               bit6 set → dup: uint7 index of an earlier stream (shared
                                bytes), no payload
               else      → clen:uint7, clen bytes (one full rANS-Nx16 /
                                arith stream, sizes embedded)
    desc    : bit7 = advance to the next token position (the first stream
              sets it, entering position 0); bits 0-5 = token type
    types   : 0 TYPE, 1 ALPHA, 2 CHAR, 3 DZLEN, 4 DIGITS0, 5 DUP,
              6 DIFF, 7 DIGITS, 8 DELTA, 9 DELTA0, 10 MATCH, 11 NOP,
              12 END

Per name: token 0's TYPE stream yields DIFF (dist:u32le in the DIFF
stream; diff against the name `dist+1` back) or DUP (dist:u32le in the
DUP stream; whole-name copy). Then tokens t=1.. from each stream until
END: ALPHA = NUL-terminated run, CHAR = 1 byte, DIGITS = u32le decimal,
DIGITS0 = u32le + DZLEN width byte (zero-padded), DELTA/DELTA0 = u8
added to the reference name's token-t value, MATCH = copy reference
token. Names are emitted with the input's separator byte (NUL or LF)
after each name; `ulen` covers names + separators.
"""
from __future__ import annotations

import numpy as np

from . import ransnx16
from . import arith as arith_mod
from .ransnx16 import read_uint7, write_uint7

N_TYPE, N_ALPHA, N_CHAR, N_DZLEN, N_DIGITS0, N_DUP, N_DIFF, N_DIGITS, \
    N_DELTA, N_DELTA0, N_MATCH, N_NOP, N_END = range(13)

_MAX_TOKEN = 128  # positions per name (streams beyond this are rejected)


# ---------------------------------------------------------------- tokenise

def _tokenize(name: bytes):
    """Split a name into (kind, text) tokens; kind is 'd' (digit run) or
    'a' (alpha/other run). Digit runs longer than 9 chars are split so
    values stay below 2^32."""
    toks = []
    i, n = 0, len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39 and j - i < 9:
                j += 1
            toks.append(("d", name[i:j]))
            i = j
        else:
            j = i
            while j < n and not (0x30 <= name[j] <= 0x39):
                j += 1
            toks.append(("a", name[i:j]))
            i = j
    return toks


class _Streams:
    """(token position, type) → bytearray, with deterministic ordering."""

    def __init__(self):
        self.bufs: dict[tuple[int, int], bytearray] = {}

    def put(self, t: int, typ: int, data: bytes):
        self.bufs.setdefault((t, typ), bytearray()).extend(data)

    def put_u32(self, t: int, typ: int, v: int):
        self.put(t, typ, int(v).to_bytes(4, "little"))


def compress(raw: bytes, use_arith: bool = False) -> bytes:
    """Encode a NUL- or LF-separated block of read names."""
    if not raw:
        return write_uint7(0) + write_uint7(0) + b"\x00"
    sep = b"\x00"
    if not raw.endswith(sep):
        raise ValueError("tok3: name block must be NUL-separated with a "
                         "trailing NUL")
    names = raw[:-1].split(sep)

    st = _Streams()
    prev_names: list[bytes] = []
    prev_toks: list[list] = []
    for name in names:
        ref = len(prev_names) - 1  # diff against the immediately previous
        if prev_names and prev_names[-1] == name:
            st.put(0, N_TYPE, bytes([N_DUP]))
            st.put_u32(0, N_DUP, 0)  # 0 == one name back
            prev_names.append(name)
            prev_toks.append(prev_toks[-1])
            continue
        st.put(0, N_TYPE, bytes([N_DIFF]))
        st.put_u32(0, N_DIFF, 0 if prev_names else 0)
        rtoks = prev_toks[ref] if ref >= 0 else []
        toks = _tokenize(name)
        if len(toks) + 1 > _MAX_TOKEN:
            raise ValueError("tok3: name has too many tokens")
        for t, (kind, text) in enumerate(toks, start=1):
            rt = rtoks[t - 1] if t - 1 < len(rtoks) else None
            if rt is not None and rt == (kind, text):
                st.put(t, N_TYPE, bytes([N_MATCH]))
                continue
            if kind == "d":
                v = int(text)
                z = len(text) > 1 and text[0:1] == b"0"
                if (rt is not None and rt[0] == "d"):
                    rv = int(rt[1])
                    rz = len(rt[1]) > 1 and rt[1][0:1] == b"0"
                    same_width = len(text) == len(rt[1])
                    if 0 <= v - rv <= 255 and not z and not rz:
                        st.put(t, N_TYPE, bytes([N_DELTA]))
                        st.put(t, N_DELTA, bytes([v - rv]))
                        continue
                    if 0 <= v - rv <= 255 and same_width and (z or rz):
                        st.put(t, N_TYPE, bytes([N_DELTA0]))
                        st.put(t, N_DELTA0, bytes([v - rv]))
                        continue
                if z:
                    st.put(t, N_TYPE, bytes([N_DIGITS0]))
                    st.put_u32(t, N_DIGITS0, v)
                    st.put(t, N_DZLEN, bytes([len(text)]))
                else:
                    st.put(t, N_TYPE, bytes([N_DIGITS]))
                    st.put_u32(t, N_DIGITS, v)
            elif len(text) == 1:
                st.put(t, N_TYPE, bytes([N_CHAR]))
                st.put(t, N_CHAR, text)
            else:
                st.put(t, N_TYPE, bytes([N_ALPHA]))
                st.put(t, N_ALPHA, text + b"\x00")
        st.put(len(toks) + 1, N_TYPE, bytes([N_END]))
        prev_names.append(name)
        prev_toks.append(toks)

    out = bytearray()
    out += write_uint7(len(raw))
    out += write_uint7(len(names))
    out.append(1 if use_arith else 0)
    codec = arith_mod if use_arith else ransnx16
    last_t = -1
    seen: list[bytes] = []
    for (t, typ) in sorted(st.bufs):
        buf = bytes(st.bufs[(t, typ)])
        desc = typ | (0x80 if t != last_t else 0)
        if t != last_t and t != last_t + 1:
            # token positions must advance one at a time for the decoder;
            # emit empty NOP streams for skipped positions (none in
            # practice: TYPE exists at every live position)
            raise ValueError("tok3: non-contiguous token positions")
        last_t = t
        try:
            dup_of = seen.index(buf) if len(buf) >= 4 else -1
        except ValueError:
            dup_of = -1
        seen.append(buf)
        if dup_of >= 0:
            out.append(desc | 0x40)
            out += write_uint7(dup_of)
            continue
        out.append(desc)
        comp = codec.compress(buf, 0)
        out += write_uint7(len(comp))
        out += comp
    return bytes(out)


# ------------------------------------------------------------------ decode

class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ValueError("tok3: token stream exhausted")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def u32(self) -> int:
        if self.pos + 4 > len(self.buf):
            raise ValueError("tok3: token stream exhausted")
        v = int.from_bytes(self.buf[self.pos : self.pos + 4], "little")
        self.pos += 4
        return v

    def cstr(self) -> bytes:
        end = self.buf.find(b"\x00", self.pos)
        if end < 0:
            raise ValueError("tok3: unterminated ALPHA token")
        s = self.buf[self.pos : end]
        self.pos = end + 1
        return s


def uncompress(stream: bytes, ulen: int | None = None) -> bytes:
    try:
        return _uncompress(stream, ulen)
    except IndexError as exc:  # truncated buffer indexing
        raise ValueError(f"tok3: truncated stream ({exc})") from exc


def _uncompress(stream: bytes, ulen: int | None = None) -> bytes:
    p = 0
    total, p = read_uint7(stream, p)
    nnames, p = read_uint7(stream, p)
    if p >= len(stream):
        raise ValueError("tok3: truncated header")
    use_arith = stream[p]
    p += 1
    if use_arith not in (0, 1):
        raise ValueError(f"tok3: bad entropy selector {use_arith}")
    codec = arith_mod if use_arith else ransnx16
    if ulen is not None and ulen != total:
        raise ValueError("tok3: declared size disagrees with container")
    if nnames == 0:
        if total:
            raise ValueError("tok3: zero names but nonzero size")
        return b""

    streams: dict[tuple[int, int], _Reader] = {}
    raw_list: list[bytes] = []
    t = -1
    while p < len(stream):
        desc = stream[p]
        p += 1
        typ = desc & 0x3F
        if typ > N_END:
            raise ValueError(f"tok3: bad token type {typ}")
        if desc & 0x80:
            t += 1
            if t >= _MAX_TOKEN:
                raise ValueError("tok3: too many token positions")
        if t < 0:
            raise ValueError("tok3: stream before first token position")
        if desc & 0x40:
            idx, p = read_uint7(stream, p)
            if idx >= len(raw_list):
                raise ValueError("tok3: dup stream index out of range")
            raw = raw_list[idx]
        else:
            clen, p = read_uint7(stream, p)
            if p + clen > len(stream):
                raise ValueError("tok3: truncated stream payload")
            raw = codec.uncompress(stream[p : p + clen])
            p += clen
        raw_list.append(raw)
        streams[(t, typ)] = _Reader(raw)

    def reader(t: int, typ: int) -> _Reader:
        r = streams.get((t, typ))
        if r is None:
            raise ValueError(
                f"tok3: missing stream for token {t} type {typ}")
        return r

    names: list[bytes] = []
    toks_of: list[list] = []
    for _ in range(nnames):
        t0 = reader(0, N_TYPE).byte()
        if t0 == N_DUP:
            dist = reader(0, N_DUP).u32()
            ref = len(names) - 1 - dist
            if ref < 0:
                raise ValueError("tok3: DUP before any name")
            names.append(names[ref])
            toks_of.append(toks_of[ref])
            continue
        if t0 != N_DIFF:
            raise ValueError(f"tok3: bad leading token type {t0}")
        dist = reader(0, N_DIFF).u32()
        ref = len(names) - 1 - dist
        rtoks = toks_of[ref] if ref >= 0 else []
        if ref < 0 and dist:
            raise ValueError("tok3: DIFF distance before any name")
        parts: list[bytes] = []
        toks: list = []
        t = 1
        while True:
            typ = reader(t, N_TYPE).byte()
            if typ == N_END:
                break
            rt = rtoks[t - 1] if t - 1 < len(rtoks) else None
            if typ == N_MATCH:
                if rt is None:
                    raise ValueError("tok3: MATCH without reference token")
                kind, text = rt
            elif typ == N_ALPHA:
                kind, text = "a", reader(t, N_ALPHA).cstr()
            elif typ == N_CHAR:
                kind, text = "a", bytes([reader(t, N_CHAR).byte()])
            elif typ == N_DIGITS:
                kind, text = "d", str(reader(t, N_DIGITS).u32()).encode()
            elif typ == N_DIGITS0:
                v = reader(t, N_DIGITS0).u32()
                w = reader(t, N_DZLEN).byte()
                kind, text = "d", str(v).encode().rjust(w, b"0")
            elif typ in (N_DELTA, N_DELTA0):
                if rt is None or rt[0] != "d":
                    raise ValueError("tok3: DELTA without numeric reference")
                d = reader(t, typ).byte()
                v = int(rt[1]) + d
                text = str(v).encode()
                if typ == N_DELTA0:
                    text = text.rjust(len(rt[1]), b"0")
                kind = "d"
            elif typ == N_NOP:
                t += 1
                continue
            else:
                raise ValueError(f"tok3: unhandled token type {typ}")
            parts.append(text)
            toks.append((kind, text))
            t += 1
        names.append(b"".join(parts))
        toks_of.append(toks)

    sep = b"\x00"
    out = sep.join(names) + sep
    if len(out) != total:
        # LF-separated blocks have the same length; re-emit with LF if the
        # NUL form mismatches only by separator (both are 1 byte, so any
        # mismatch here is structural)
        raise ValueError("tok3: decoded size disagrees with header")
    return out
