"""rANS 4x8 entropy codec (CRAM 3.0 block compression method 4).

From-scratch implementation of the 4-way interleaved byte-oriented range
asymmetric numeral system codec specified in the CRAM 3.0 format
(hts-specs CRAMcodecs: rANS4x8) and used by htslib for CRAM external
blocks. The reference framework consumes CRAM via htslib
(MethylDackel.h:80, "must be a BAM or CRAM file"); this module is the
entropy layer of this framework's own CRAM reader (io/cram.py).

Stream layout (both orders):
    byte 0      : order (0 or 1)
    bytes 1-4   : compressed size of the remainder (u32 LE)
    bytes 5-8   : uncompressed size (u32 LE)
    then        : frequency table(s) + 4 interleaved rANS states + renorm bytes

12-bit frequency precision (TOTFREQ = 4096), lower-bound 1<<23, byte-wise
renormalization. Order-1 splits the output into 4 quarters, each decoded by
its own state with the previous byte as context (initial context 0); the
tail (len % 4) is decoded by the 4th state.

Pure numpy/python; speed is adequate for test fixtures and modest real
inputs (the hot path of this framework is BGZF/BAM, which has a native
decoder — csrc/).
"""
from __future__ import annotations

import struct

import numpy as np

TOTFREQ = 1 << 12          # 12-bit precision
RANS_BYTE_L = 1 << 23      # lower renormalization bound


# ---------------------------------------------------------------- itf8 (local)

def _read_itf8(buf: bytes, p: int) -> tuple[int, int]:
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[p + 1], p + 2
    if b0 < 0xE0:
        return ((b0 & 0x1F) << 16) | (buf[p + 1] << 8) | buf[p + 2], p + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[p + 1] << 16)
                | (buf[p + 2] << 8) | buf[p + 3]), p + 4
    v = (((b0 & 0x0F) << 28) | (buf[p + 1] << 20) | (buf[p + 2] << 12)
         | (buf[p + 3] << 4) | (buf[p + 4] & 0x0F))
    return v, p + 5


def _write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


# ------------------------------------------------------------- freq tables

def _normalize_freqs(counts: np.ndarray, total: int = TOTFREQ) -> np.ndarray:
    """Scale counts to sum exactly `total`, keeping every nonzero ≥ 1."""
    n = int(counts.sum())
    if n == 0:
        return counts.astype(np.int64)
    f = counts.astype(np.float64) * total / n
    out = np.floor(f).astype(np.int64)
    out[(counts > 0) & (out == 0)] = 1
    # adjust the largest bucket to hit the exact total
    diff = total - int(out.sum())
    k = int(out.argmax())
    out[k] += diff
    if out[k] <= 0:
        raise ValueError("degenerate frequency normalization")
    return out


def _rle_groups(syms: np.ndarray):
    """Split ascending symbol list into maximal consecutive runs."""
    groups = []
    i = 0
    while i < len(syms):
        j = i
        while j + 1 < len(syms) and syms[j + 1] == syms[j] + 1:
            j += 1
        groups.append(syms[i : j + 1])
        i = j + 1
    return groups


def _write_freqs0(freqs: np.ndarray) -> bytes:
    """Symbol-RLE frequency table. Layout per run of consecutive symbols
    s0..sk: [s0][f0] then (k ≥ 1) [s1][rle=k-1][f1][f2]..[fk]; the run-length
    byte directly follows the second symbol byte (htslib rans_static.c
    frequency-table layout). Terminated by a 0 symbol byte."""
    out = bytearray()
    for grp in _rle_groups(np.nonzero(freqs)[0]):
        out.append(int(grp[0]))
        out += _write_itf8(int(freqs[grp[0]]))
        if len(grp) > 1:
            out.append(int(grp[1]))
            out.append(len(grp) - 2)
            for s in grp[1:]:
                out += _write_itf8(int(freqs[s]))
    out.append(0)
    return bytes(out)


def _read_freqs0(buf: bytes, p: int) -> tuple[np.ndarray, int]:
    freqs = np.zeros(256, dtype=np.int64)
    sym = buf[p]
    p += 1
    rle = 0
    while True:
        f, p = _read_itf8(buf, p)
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        elif buf[p] == (sym + 1) & 0xFF and sym + 1 < 256:
            sym = buf[p]
            rle = buf[p + 1]
            p += 2
        else:
            sym = buf[p]
            p += 1
            if sym == 0:
                break
    return freqs, p


def _write_freqs1(freqs2d: np.ndarray) -> bytes:
    """Order-1 table: context-RLE, same layout as order-0 but each context is
    followed by its full order-0 table instead of a single frequency."""
    out = bytearray()
    ctxs = np.nonzero(freqs2d.sum(axis=1))[0]
    for grp in _rle_groups(ctxs):
        out.append(int(grp[0]))
        out += _write_freqs0(freqs2d[grp[0]])
        if len(grp) > 1:
            out.append(int(grp[1]))
            out.append(len(grp) - 2)
            for c in grp[1:]:
                out += _write_freqs0(freqs2d[c])
    out.append(0)
    return bytes(out)


def _read_freqs1(buf: bytes, p: int) -> tuple[np.ndarray, int]:
    freqs = np.zeros((256, 256), dtype=np.int64)
    ctx = buf[p]
    p += 1
    rle = 0
    while True:
        row, p = _read_freqs0(buf, p)
        freqs[ctx] = row
        if rle > 0:
            rle -= 1
            ctx += 1
        elif buf[p] == (ctx + 1) & 0xFF and ctx + 1 < 256:
            ctx = buf[p]
            rle = buf[p + 1]
            p += 2
        else:
            ctx = buf[p]
            p += 1
            if ctx == 0:
                break
    return freqs, p


# ------------------------------------------------------------------ encode

def _encode_stream(order_pos: np.ndarray, order_state: np.ndarray,
                   freqs: np.ndarray, cum: np.ndarray) -> bytes:
    """Reverse-encode with 4 interleaved states.

    `order_pos` is the DECODER's symbol traversal order (positions into the
    per-position `freqs`/`cum` arrays) and `order_state` the state id used at
    each step; encoding walks it backwards so the shared renormalization
    byte stream is consumed in exactly the right interleaved order.
    """
    states = [RANS_BYTE_L] * 4
    out = bytearray()
    x_max_base = (RANS_BYTE_L >> 12) << 8
    for k in range(len(order_pos) - 1, -1, -1):
        i = int(order_pos[k])
        j = int(order_state[k])
        fr = int(freqs[i])
        cu = int(cum[i])
        x = states[j]
        x_max = x_max_base * fr
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // fr) << 12) + cu + (x % fr)
    head = struct.pack("<4I", *states)
    return head + bytes(out[::-1])


def encode0(raw: bytes) -> bytes:
    """Order-0 rANS4x8 encode (full stream incl. 9-byte header)."""
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    if n == 0:
        payload = bytes([0]) + struct.pack("<4I", *([RANS_BYTE_L] * 4))
        return bytes([0]) + struct.pack("<II", len(payload), 0) + payload
    counts = np.bincount(data, minlength=256)
    freqs = _normalize_freqs(counts)
    cum = np.concatenate([[0], np.cumsum(freqs)[:-1]])
    table = _write_freqs0(freqs)
    pos = np.arange(n, dtype=np.int64)
    body = _encode_stream(pos, pos & 3, freqs[data], cum[data])
    payload = table + body
    return bytes([0]) + struct.pack("<II", len(payload), n) + payload


def encode1(raw: bytes) -> bytes:
    """Order-1 rANS4x8 encode."""
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    if n < 4:
        return encode0(raw)
    q = n >> 2
    starts = [0, q, 2 * q, 3 * q]
    # context byte for each position: previous byte within its quarter
    # (initial context 0); the tail beyond 4*q extends quarter 3.
    ctx = np.empty(n, dtype=np.uint8)
    for j in range(4):
        lo = starts[j]
        hi = starts[j + 1] if j < 3 else n
        ctx[lo] = 0
        ctx[lo + 1 : hi] = data[lo : hi - 1]
    counts = np.zeros((256, 256), dtype=np.int64)
    np.add.at(counts, (ctx, data), 1)
    freqs2d = np.zeros_like(counts)
    for c in np.nonzero(counts.sum(axis=1))[0]:
        freqs2d[c] = _normalize_freqs(counts[c])
    cum2d = np.zeros_like(freqs2d)
    cum2d[:, 1:] = np.cumsum(freqs2d, axis=1)[:, :-1]
    table = _write_freqs1(freqs2d)
    # decoder traversal: round-robin one byte per state per round over the
    # four quarters, then the tail (n % 4) on state 3
    rounds = np.arange(q, dtype=np.int64)
    main_pos = (rounds[:, None] + np.array(starts, dtype=np.int64)[None, :]).reshape(-1)
    main_state = np.tile(np.arange(4, dtype=np.int64), q)
    tail_pos = np.arange(4 * q, n, dtype=np.int64)
    order_pos = np.concatenate([main_pos, tail_pos])
    order_state = np.concatenate([main_state, np.full(len(tail_pos), 3, np.int64)])
    body = _encode_stream(order_pos, order_state,
                          freqs2d[ctx, data], cum2d[ctx, data])
    payload = table + body
    return bytes([1]) + struct.pack("<II", len(payload), n) + payload


def compress(raw: bytes, order: int = 0) -> bytes:
    return encode1(raw) if order == 1 else encode0(raw)


# ------------------------------------------------------------------ decode

def _sym_lookup(freqs: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-slot symbol/cum tables over the 4096 slots."""
    cum = np.concatenate([[0], np.cumsum(freqs)])
    if cum[-1] != TOTFREQ and freqs.sum() > 0:
        raise ValueError(f"rans: frequencies sum to {cum[-1]}, want {TOTFREQ}")
    slot2sym = np.zeros(TOTFREQ, dtype=np.uint8)
    syms = np.nonzero(freqs)[0]
    for s in syms:
        slot2sym[cum[s] : cum[s + 1]] = s
    return slot2sym, freqs.astype(np.int64), cum[:-1].astype(np.int64)


def uncompress(stream: bytes) -> bytes:
    """Decode a full rANS4x8 stream (order byte + sizes + payload)."""
    if len(stream) < 9:
        raise ValueError("rans: truncated stream")
    order = stream[0]
    comp_len, raw_len = struct.unpack_from("<II", stream, 1)
    buf = stream[9 : 9 + comp_len]
    if raw_len == 0:
        return b""
    if order == 0:
        return _decode0(buf, raw_len)
    if order == 1:
        return _decode1(buf, raw_len)
    raise ValueError(f"rans: bad order {order}")


def _decode0(buf: bytes, n: int) -> bytes:
    freqs, p = _read_freqs0(buf, 0)
    slot2sym, f, c = _sym_lookup(freqs)
    states = list(struct.unpack_from("<4I", buf, p))
    p += 16
    out = np.empty(n, dtype=np.uint8)
    blen = len(buf)
    for i in range(n):
        j = i & 3
        x = states[j]
        slot = x & 0xFFF
        s = slot2sym[slot]
        out[i] = s
        x = int(f[s]) * (x >> 12) + slot - int(c[s])
        while x < RANS_BYTE_L and p < blen:
            x = (x << 8) | buf[p]
            p += 1
        states[j] = x
    return out.tobytes()


def _decode1(buf: bytes, n: int) -> bytes:
    freqs2d, p = _read_freqs1(buf, 0)
    nz = np.nonzero(freqs2d.sum(axis=1))[0]
    slot2sym = np.zeros((256, TOTFREQ), dtype=np.uint8)
    cum2d = np.zeros((256, 256), dtype=np.int64)
    cum2d[:, 1:] = np.cumsum(freqs2d, axis=1)[:, :-1]
    for ctx in nz:
        slot2sym[ctx], _, _ = _sym_lookup(freqs2d[ctx])
    states = list(struct.unpack_from("<4I", buf, p))
    p += 16
    out = np.empty(n, dtype=np.uint8)
    blen = len(buf)
    q = n >> 2
    idx = [0, q, 2 * q, 3 * q]
    last = [0, 0, 0, 0]
    ends = [q, 2 * q, 3 * q, n]
    # interleaved main loop: one byte per state per round
    for _ in range(q):
        for j in range(4):
            i = idx[j]
            if i >= ends[j]:
                continue
            x = states[j]
            slot = x & 0xFFF
            s = int(slot2sym[last[j], slot])
            out[i] = s
            x = int(freqs2d[last[j], s]) * (x >> 12) + slot - int(cum2d[last[j], s])
            while x < RANS_BYTE_L and p < blen:
                x = (x << 8) | buf[p]
                p += 1
            states[j] = x
            last[j] = s
            idx[j] = i + 1
    # tail: quarter 3 continues with state 3
    j = 3
    while idx[j] < n:
        i = idx[j]
        x = states[j]
        slot = x & 0xFFF
        s = int(slot2sym[last[j], slot])
        out[i] = s
        x = int(freqs2d[last[j], s]) * (x >> 12) + slot - int(cum2d[last[j], s])
        while x < RANS_BYTE_L and p < blen:
            x = (x << 8) | buf[p]
            p += 1
        states[j] = x
        last[j] = s
        idx[j] = i + 1
    return out.tobytes()
