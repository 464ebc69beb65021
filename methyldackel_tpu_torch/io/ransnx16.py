"""rANS Nx16 entropy codec (CRAM 3.1 block compression method 5).

From-scratch implementation of the N-way interleaved 16-bit-renormalizing
rANS codec introduced by CRAM 3.1 (hts-specs CRAMcodecs: "rANS Nx16"),
with the bit-stream transforms the spec composes around the entropy core:
PACK (≤16-symbol bit packing), RLE (run-length extraction with a separately
coded run-length meta stream), CAT (stored/uncompressed), STRIPE (byte
interleave into X independently compressed substreams) and NOSZ (size
omitted, supplied by the container).

The reference consumes CRAM through htslib, which accepts 3.1 containers
(MethylDackel.h:80); this module extends this framework's own CRAM reader
(io/cram.py) to them.

Wire-format note (PARITY.md "Known gaps"): no htslib artifact or network
exists in this build environment, so the exact byte layout follows the
hts-specs / htscodecs definitions as closely as reconstructable offline;
it is validated by an independent in-repo encoder (the foreign-dialect
3.1 fixtures, tests/test_cram31.py) rather than against htslib output.
The layout is isolated here so reconciling against a real htslib file is
a local change. The flag-bit values and the frequency-
table serialization now follow the published spec (previously the flag
layout was shifted and the tables reused the rans4x8 format).

Layout::

    stream  := flags:u8 [ulen:uint7 unless NOSZ] body
    flags   : 0x01 ORDER1  0x04 X32 (32 states, else 4)  0x08 STRIPE
              0x10 NOSZ    0x20 CAT  0x40 RLE  0x80 PACK
    uint7   : big-endian base-128, MSB = continuation
    STRIPE  : X:u8, clen[0..X):uint7, then X full recursive streams
              (NOSZ — sizes derive from ulen); substream j carries bytes
              j, j+X, j+2X, ...
    CAT     : ulen literal bytes
    else    :
      PACK  : nsym:u8, sym[0..nsym):u8, packed_len:uint7
      RLE   : rle_meta_len:uint7 (LSB set = raw meta),
              rle_sym_len:uint7 (entropy-coded stream length),
              meta = raw bytes (rle_meta_len>>1) | comp_meta_len:uint7 +
                     order-0 Nx16 stream of it;
              meta := n_rle_syms:u8 (0 means 256), the symbols, then one
              uint7 run length per run in stream order
      entropy (order 0/1, N states): Nx16 frequency tables — an
              RLE-coded symbol alphabet (ascending symbols; a byte
              following the second of two consecutive symbols counts the
              further consecutive ones; 0-terminated) followed by uint7
              frequencies normalized to total 4096 (order 0), or, for
              order 1, a leading byte (shift 12 << 4, bit 0 = the table
              itself is an order-0 Nx16 stream) and the global alphabet
              with one full |A|-wide uint7 frequency row per context in
              A (each row normalized to 4096). Then N little-endian u32
              states and 16-bit little-endian renormalization words.
              Order-1 splits the data into N segments with previous-byte
              context (initial 0); the tail (len % N) extends the last
              segment. ORDER1 with fewer than N bytes is encoded as
              order 0 (the encoder clears the bit).

Decode pipeline: entropy → RLE expand → PACK expand → ulen bytes.
"""
from __future__ import annotations

import struct

import numpy as np

from .rans4x8 import _normalize_freqs, _sym_lookup, TOTFREQ

# Spec flag-bit values (htscodecs rans_static4x16: RANS_ORDER_*).
ORDER1 = 0x01
X32 = 0x04
STRIPE = 0x08
NOSZ = 0x10
CAT = 0x20
RLE = 0x40
PACK = 0x80

RANS_L = 1 << 15  # lower state bound; 16-bit renormalization


# ------------------------------------------------------------------ uint7

def read_uint7(buf, p):
    v = 0
    while True:
        if p >= len(buf):
            raise ValueError("uint7 varint overruns the buffer")
        c = buf[p]
        p += 1
        v = (v << 7) | (c & 0x7F)
        if not (c & 0x80):
            return v, p


def write_uint7(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(out[::-1])


# ---------------------------------------------------- Nx16 frequency tables

def _write_alphabet(syms) -> bytes:
    """RLE-coded ascending symbol list (htscodecs encode_alphabet): emit
    each present symbol; when a symbol directly follows another present
    one, also emit the count of FURTHER consecutive present symbols
    (which are then implied). 0-terminated."""
    present = np.zeros(257, bool)
    present[np.asarray(syms, dtype=np.int64)] = True
    out = bytearray()
    rle = 0
    for j in range(256):
        if not present[j]:
            continue
        if rle:
            rle -= 1
            continue
        out.append(j)
        if j and present[j - 1]:
            k = j + 1
            while k < 256 and present[k]:
                k += 1
            rle = k - (j + 1)
            out.append(rle)
    out.append(0)
    return bytes(out)


def _read_alphabet(buf, p):
    """Decode the alphabet; returns (ascending symbol list, new offset).
    Terminates when the next symbol byte read is 0 (a genuine 0 can only
    be the very first symbol)."""
    syms = []
    rle = 0
    i = buf[p]
    p += 1
    while True:
        if i > 255:
            raise ValueError("ransnx16: corrupt alphabet")
        syms.append(i)
        if rle:
            rle -= 1
            i += 1
        else:
            last = i
            i = buf[p]
            p += 1
            if i == last + 1:
                rle = buf[p]
                p += 1
        if i == 0:
            break
    return syms, p


def _write_freqs0_nx16(freqs: np.ndarray) -> bytes:
    """Order-0 Nx16 table: alphabet, then one uint7 per present symbol
    (normalized to total 4096)."""
    syms = np.nonzero(freqs)[0]
    out = bytearray(_write_alphabet(syms))
    for s in syms:
        out += write_uint7(int(freqs[s]))
    return bytes(out)


def _read_freqs0_nx16(buf, p):
    syms, p = _read_alphabet(buf, p)
    freqs = np.zeros(256, dtype=np.int64)
    for s in syms:
        f, p = read_uint7(buf, p)
        freqs[s] = f
    if freqs.sum() != TOTFREQ and freqs.sum() > 0:
        # spec: the decoder renormalizes to 1<<12 deterministically
        freqs = _normalize_freqs(freqs)
    return freqs, p


def _write_freqs1_payload(freqs2d: np.ndarray) -> bytes:
    """Order-1 table payload: the global alphabet once, then for each
    context in it a full |A|-wide row of uint7 frequencies (row total
    4096; rows for contexts that never occur are all-zero)."""
    used = np.nonzero(freqs2d.sum(axis=0) + freqs2d.sum(axis=1))[0]
    out = bytearray(_write_alphabet(used))
    for i in used:
        for j in used:
            out += write_uint7(int(freqs2d[i, j]))
    return bytes(out)


def _read_freqs1_payload(buf, p):
    syms, p = _read_alphabet(buf, p)
    freqs2d = np.zeros((256, 256), dtype=np.int64)
    for i in syms:
        for j in syms:
            f, p = read_uint7(buf, p)
            freqs2d[i, j] = f
        if freqs2d[i].sum() not in (0, TOTFREQ):
            freqs2d[i] = _normalize_freqs(freqs2d[i])
    return freqs2d, p


def _write_freqs1_nx16(freqs2d: np.ndarray) -> bytes:
    """Shift/flag byte + (possibly order-0-Nx16-compressed) payload."""
    payload = _write_freqs1_payload(freqs2d)
    comp = _entropy_encode(np.frombuffer(payload, np.uint8), 0, 4)
    hdr = write_uint7(len(payload)) + write_uint7(len(comp))
    if len(hdr) + len(comp) < len(payload):
        return bytes([(12 << 4) | 1]) + hdr + comp
    return bytes([12 << 4]) + payload


def _read_freqs1_nx16(buf, p):
    shift = buf[p] >> 4
    if shift != 12:
        raise ValueError(f"ransnx16: unsupported order-1 shift {shift}")
    compressed = buf[p] & 1
    p += 1
    if compressed:
        ulen, p = read_uint7(buf, p)
        clen, p = read_uint7(buf, p)
        payload, _ = _entropy_decode(buf[p : p + clen], 0, ulen, 0, 4)
        p += clen
        freqs2d, _ = _read_freqs1_payload(payload.tobytes(), 0)
        return freqs2d, p
    return _read_freqs1_payload(buf, p)


# ----------------------------------------------------------- entropy core

def _encode_states(order_pos, order_state, freqs, cum, nway: int) -> bytes:
    """Reverse-encode with `nway` interleaved states, 16-bit renorm."""
    states = [RANS_L] * nway
    out = bytearray()
    x_max_base = (RANS_L >> 12) << 16
    for k in range(len(order_pos) - 1, -1, -1):
        i = int(order_pos[k])
        j = int(order_state[k])
        fr = int(freqs[i])
        cu = int(cum[i])
        x = states[j]
        x_max = x_max_base * fr
        while x >= x_max:
            # high byte first: the final whole-stream reversal leaves the
            # 16-bit words little-endian, as the decoder reads them
            out.append((x >> 8) & 0xFF)
            out.append(x & 0xFF)
            x >>= 16
        states[j] = ((x // fr) << 12) + cu + (x % fr)
    head = struct.pack("<%dI" % nway, *states)
    return head + bytes(out[::-1])


def _segments(n: int, nway: int):
    """Order-1 segment starts/ends: n//nway each, tail extends the last."""
    q = n // nway
    starts = [j * q for j in range(nway)]
    ends = [(j + 1) * q for j in range(nway - 1)] + [n]
    return q, starts, ends


def _entropy_encode(data: np.ndarray, order: int, nway: int) -> bytes:
    n = len(data)
    if n == 0:
        return struct.pack("<%dI" % nway, *([RANS_L] * nway))
    if order == 0 or n < nway:
        counts = np.bincount(data, minlength=256)
        freqs = _normalize_freqs(counts)
        cum = np.concatenate([[0], np.cumsum(freqs)[:-1]])
        table = _write_freqs0_nx16(freqs)
        pos = np.arange(n, dtype=np.int64)
        body = _encode_states(pos, pos % nway, freqs[data], cum[data], nway)
        return table + body
    q, starts, ends = _segments(n, nway)
    ctx = np.empty(n, dtype=np.uint8)
    for j in range(nway):
        ctx[starts[j]] = 0
        ctx[starts[j] + 1 : ends[j]] = data[starts[j] : ends[j] - 1]
    counts = np.zeros((256, 256), dtype=np.int64)
    np.add.at(counts, (ctx, data), 1)
    freqs2d = np.zeros_like(counts)
    for c in np.nonzero(counts.sum(axis=1))[0]:
        freqs2d[c] = _normalize_freqs(counts[c])
    cum2d = np.zeros_like(freqs2d)
    cum2d[:, 1:] = np.cumsum(freqs2d, axis=1)[:, :-1]
    table = _write_freqs1_nx16(freqs2d)
    rounds = np.arange(q, dtype=np.int64)
    main_pos = (rounds[:, None]
                + np.array(starts, dtype=np.int64)[None, :]).reshape(-1)
    main_state = np.tile(np.arange(nway, dtype=np.int64), q)
    tail_pos = np.arange(nway * q, n, dtype=np.int64)
    order_pos = np.concatenate([main_pos, tail_pos])
    order_state = np.concatenate(
        [main_state, np.full(len(tail_pos), nway - 1, np.int64)])
    body = _encode_states(order_pos, order_state,
                          freqs2d[ctx, data], cum2d[ctx, data], nway)
    return table + body


def _entropy_decode(buf: bytes, p: int, n: int, order: int,
                    nway: int) -> tuple[np.ndarray, int]:
    if n == 0:
        return np.zeros(0, np.uint8), p + 4 * nway
    if order == 1 and n >= nway:
        return _decode1(buf, p, n, nway)
    # order-1 below nway bytes is encoded as order 0 (flag kept by some
    # foreign encoders; the table layout is order-0 either way)
    freqs, p = _read_freqs0_nx16(buf, p)
    slot2sym, f, c = _sym_lookup(freqs)
    states = list(struct.unpack_from("<%dI" % nway, buf, p))
    p += 4 * nway
    out = np.empty(n, dtype=np.uint8)
    blen = len(buf)
    for i in range(n):
        j = i % nway
        x = states[j]
        slot = x & 0xFFF
        s = slot2sym[slot]
        out[i] = s
        x = int(f[s]) * (x >> 12) + slot - int(c[s])
        while x < RANS_L and p + 1 < blen:
            x = (x << 16) | buf[p] | (buf[p + 1] << 8)
            p += 2
        states[j] = x
    return out, p


def _decode1(buf: bytes, p: int, n: int, nway: int) -> tuple[np.ndarray, int]:
    freqs2d, p = _read_freqs1_nx16(buf, p)
    slot2sym = np.zeros((256, TOTFREQ), dtype=np.uint8)
    cum2d = np.zeros((256, 256), dtype=np.int64)
    cum2d[:, 1:] = np.cumsum(freqs2d, axis=1)[:, :-1]
    for ctx in np.nonzero(freqs2d.sum(axis=1))[0]:
        slot2sym[ctx], _, _ = _sym_lookup(freqs2d[ctx])
    states = list(struct.unpack_from("<%dI" % nway, buf, p))
    p += 4 * nway
    out = np.empty(n, dtype=np.uint8)
    blen = len(buf)
    q, starts, ends = _segments(n, nway)
    idx = list(starts)
    last = [0] * nway
    for _ in range(q + (n - nway * q)):
        for j in range(nway):
            i = idx[j]
            if i >= ends[j]:
                continue
            x = states[j]
            slot = x & 0xFFF
            s = int(slot2sym[last[j]][slot])
            out[i] = s
            x = int(freqs2d[last[j], s]) * (x >> 12) + slot \
                - int(cum2d[last[j], s])
            while x < RANS_L and p + 1 < blen:
                x = (x << 16) | buf[p] | (buf[p + 1] << 8)
                p += 2
            states[j] = x
            last[j] = s
            idx[j] = i + 1
    return out, p


# ------------------------------------------------------------- transforms

def _pack_encode(data: np.ndarray):
    """≤16-distinct-symbol bit pack. Returns (packed, symbols) or None."""
    syms = np.unique(data)
    if len(syms) > 16:
        return None
    inv = np.zeros(256, np.uint8)
    inv[syms] = np.arange(len(syms), dtype=np.uint8)
    v = inv[data]
    if len(syms) <= 1:
        packed = np.zeros(0, np.uint8)
    elif len(syms) <= 2:
        pad = (-len(v)) % 8
        vp = np.concatenate([v, np.zeros(pad, np.uint8)]).reshape(-1, 8)
        packed = np.zeros(len(vp), np.uint8)
        for b in range(8):
            packed |= vp[:, b] << b
    elif len(syms) <= 4:
        pad = (-len(v)) % 4
        vp = np.concatenate([v, np.zeros(pad, np.uint8)]).reshape(-1, 4)
        packed = (vp[:, 0] | (vp[:, 1] << 2) | (vp[:, 2] << 4)
                  | (vp[:, 3] << 6))
    else:
        pad = (-len(v)) % 2
        vp = np.concatenate([v, np.zeros(pad, np.uint8)]).reshape(-1, 2)
        packed = vp[:, 0] | (vp[:, 1] << 4)
    return packed.astype(np.uint8), syms.astype(np.uint8)


def _pack_decode(packed: np.ndarray, syms: np.ndarray, n: int) -> np.ndarray:
    nsym = len(syms)
    if n == 0:
        return np.zeros(0, np.uint8)
    if nsym == 0:
        raise ValueError("ransnx16: PACK with empty symbol table")
    if nsym == 1:
        return np.full(n, syms[0], np.uint8)
    if nsym <= 2:
        v = np.stack([(packed >> b) & 1 for b in range(8)], axis=1).reshape(-1)
    elif nsym <= 4:
        v = np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=1).reshape(-1)
    else:
        v = np.stack([packed & 15, packed >> 4], axis=1).reshape(-1)
    if len(v) < n:
        raise ValueError("ransnx16: PACK underflow")
    return syms[v[:n]]


def _rle_encode(data: np.ndarray):
    """Extract runs of the most run-profitable symbols. Returns
    (sym_stream, meta) where meta = [n_syms|symbols|uint7 run lengths]."""
    n = len(data)
    if n == 0:
        return data, None
    # boundaries of runs
    change = np.empty(n, bool)
    change[0] = True
    change[1:] = data[1:] != data[:-1]
    starts = np.nonzero(change)[0]
    lens = np.diff(np.concatenate([starts, [n]]))
    run_syms = data[starts]
    # per-symbol benefit: bytes saved by run-coding it
    saved = np.zeros(256, np.int64)
    np.add.at(saved, run_syms, lens - 2)  # ~1 sym byte + ~1 len byte kept
    use = np.nonzero(saved > 0)[0]
    if len(use) == 0:
        return data, None
    is_rle = np.zeros(256, bool)
    is_rle[use] = True
    meta = bytearray()
    meta.append(len(use) & 0xFF)  # 256 → 0
    meta += bytes(use.astype(np.uint8).tolist())
    out = bytearray()
    lens_out = bytearray()
    for s, ln in zip(run_syms.tolist(), lens.tolist()):
        if is_rle[s]:
            out.append(s)
            lens_out += write_uint7(ln - 1)
        else:
            out += bytes([s]) * ln
    meta += lens_out
    return np.frombuffer(bytes(out), np.uint8), bytes(meta)


def _rle_decode(sym_stream: np.ndarray, meta: bytes, out_len: int) -> np.ndarray:
    mp = 0
    n_syms = meta[mp]
    mp += 1
    if n_syms == 0:
        n_syms = 256
    is_rle = np.zeros(256, bool)
    syms = meta[mp : mp + n_syms]
    mp += n_syms
    is_rle[list(syms)] = True
    out = np.empty(out_len, np.uint8)
    o = 0
    for s in sym_stream.tolist():
        if is_rle[s]:
            ln, mp = read_uint7(meta, mp)
            ln += 1
            out[o : o + ln] = s
            o += ln
        else:
            out[o] = s
            o += 1
    if o != out_len:
        raise ValueError(f"ransnx16: RLE expanded to {o}, want {out_len}")
    return out


# ------------------------------------------------------------- public API

def compress(raw: bytes, flags: int = 0) -> bytes:
    """Encode `raw` as a full rANS Nx16 stream with the given flags."""
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    out = bytearray()
    if flags & STRIPE:
        # substreams are NOSZ: their sizes derive from ulen (spec layout)
        sub_flags = (flags & ~STRIPE) | NOSZ
        X = 4
        out.append(flags)
        if not (flags & NOSZ):
            out += write_uint7(n)
        out.append(X)
        subs = [compress(data[j::X].tobytes(), sub_flags) for j in range(X)]
        for s in subs:
            out += write_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)
    if flags & CAT:
        out.append(flags)
        if not (flags & NOSZ):
            out += write_uint7(n)
        out += raw
        return bytes(out)
    pack_part = b""
    if flags & PACK:
        packed = _pack_encode(data)
        if packed is None:
            flags &= ~PACK
        else:
            pdata, syms = packed
            pack_part = (bytes([len(syms)]) + syms.tobytes()
                         + write_uint7(len(pdata)))
            data = pdata
    rle_part = b""
    if flags & RLE:
        sym_stream, meta = _rle_encode(data)
        if meta is None:
            flags &= ~RLE
        else:
            comp_meta = _entropy_encode(np.frombuffer(meta, np.uint8), 0, 4)
            if len(comp_meta) < len(meta):
                rle_part = (write_uint7(len(meta) * 2)
                            + write_uint7(len(sym_stream))
                            + write_uint7(len(comp_meta)) + comp_meta)
            else:
                rle_part = (write_uint7(len(meta) * 2 + 1)
                            + write_uint7(len(sym_stream)) + meta)
            data = sym_stream
    order = 1 if flags & ORDER1 else 0
    nway = 32 if flags & X32 else 4
    body = _entropy_encode(data, order, nway)
    out.append(flags)
    if not (flags & NOSZ):
        out += write_uint7(n)
    out += pack_part + rle_part + body
    return bytes(out)


def uncompress(stream: bytes, ulen: int | None = None) -> bytes:
    """Decode a full rANS Nx16 stream. `ulen` is required iff NOSZ.
    Corrupt/truncated streams raise ValueError (the CRAM block layer's
    CRC normally rejects them first)."""
    try:
        out, _p = _uncompress_at(stream, 0, ulen)
    except (IndexError, struct.error) as exc:
        raise ValueError(f"ransnx16: truncated or corrupt stream ({exc})") \
            from exc
    return out


def _uncompress_at(buf: bytes, p: int, ulen=None) -> tuple[bytes, int]:
    flags = buf[p]
    p += 1
    if not (flags & NOSZ):
        ulen, p = read_uint7(buf, p)
    if ulen is None:
        raise ValueError("ransnx16: NOSZ stream needs an external size")
    if ulen > 1 << 31:
        # allocation guard: a flipped size byte must not demand petabytes
        raise ValueError(f"ransnx16: implausible uncompressed size {ulen}")
    if flags & STRIPE:
        X = buf[p]
        p += 1
        clens = []
        for _ in range(X):
            c, p = read_uint7(buf, p)
            clens.append(c)
        out = np.empty(ulen, np.uint8)
        for j in range(X):
            sub_len = (ulen - j + X - 1) // X
            sub, _ = _uncompress_at(buf[p : p + clens[j]], 0, sub_len)
            out[j::X] = np.frombuffer(sub, np.uint8)
            p += clens[j]
        return out.tobytes(), p
    if flags & CAT:
        return bytes(buf[p : p + ulen]), p + ulen
    pack_syms = None
    pack_len = ulen
    if flags & PACK:
        nsym = buf[p]
        p += 1
        pack_syms = np.frombuffer(buf[p : p + nsym], np.uint8)
        p += nsym
        pack_len, p = read_uint7(buf, p)
    rle_meta = None
    ent_len = pack_len
    if flags & RLE:
        mlen, p = read_uint7(buf, p)
        ent_len, p = read_uint7(buf, p)
        if mlen & 1:
            rle_meta = bytes(buf[p : p + (mlen >> 1)])
            p += mlen >> 1
        else:
            cmlen, p = read_uint7(buf, p)
            meta_arr, _ = _entropy_decode(buf[p : p + cmlen], 0,
                                          mlen >> 1, 0, 4)
            rle_meta = meta_arr.tobytes()
            p += cmlen
    order = 1 if flags & ORDER1 else 0
    nway = 32 if flags & X32 else 4
    data, p = _entropy_decode(buf, p, ent_len, order, nway)
    if rle_meta is not None:
        data = _rle_decode(data, rle_meta, pack_len)
    if pack_syms is not None:
        data = _pack_decode(data, pack_syms, ulen)
    if len(data) != ulen:
        raise ValueError(f"ransnx16: decoded {len(data)} bytes, want {ulen}")
    return data.tobytes(), p
