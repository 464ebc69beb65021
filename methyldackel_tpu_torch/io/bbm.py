"""BBM (Binary BisMap) codec.

Run-length codec for 0-100 integer genome tracks, byte-compatible with the
reference implementation (format: BBM_Specification.md; writer
extract.c:1090-1210; reader extract.c:1236-1339), including the writer's two
quirks: the inner-loop short-run threshold is runlen<156 while the
end-of-chromosome flush uses runlen<155, and NaN values quantize to 0.
"""
from __future__ import annotations

import struct

import numpy as np

RUNOFFSET = 99
BBM_VERSION = 1


class MalformedBBM(ValueError):
    pass


def read_bbm(path: str):
    """Parse a BBM file → (names, lengths, values) with values uint8 0-100."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 5:
        raise MalformedBBM("empty BBM file")
    if data[0] != BBM_VERSION:
        raise MalformedBBM(f"{path} has wrong BBM version or is malformed")
    (chrom_count,) = struct.unpack_from("<I", data, 1)
    p = 5
    names, lengths, values = [], [], []
    for _ in range(chrom_count):
        (name_len,) = struct.unpack_from("<H", data, p)
        p += 2
        name = data[p : p + name_len].decode()
        p += name_len
        if data[p] != 0:
            raise MalformedBBM("fatal: malformed BBM file")
        p += 1
        (chrom_len,) = struct.unpack_from("<I", data, p)
        p += 4
        vals = np.zeros(chrom_len, dtype=np.uint8)
        pos = 0
        while pos < chrom_len:
            v = data[p]
            p += 1
            if v > 100:
                if v == 255:
                    (runlen,) = struct.unpack_from("<H", data, p)
                    p += 2
                    v = data[p]
                    p += 1
                else:
                    runlen = v - RUNOFFSET
                    v = data[p]
                    p += 1
                vals[pos : pos + runlen] = v
                pos += runlen
            else:
                vals[pos] = v
                pos += 1
        names.append(name)
        lengths.append(chrom_len)
        values.append(vals)
    return names, lengths, values


def quantize(raw: np.ndarray) -> np.ndarray:
    """bigWig float → 0-100 integer, matching (char)((v*100)+0.5) with NaN→0
    (extract.c:1138-1144)."""
    v = np.asarray(raw, dtype=np.float64)
    # NaN (uncovered bases) → 0 BEFORE the int cast: casting NaN to int is
    # platform-defined in numpy (and warns); the C's (char)((nan*100)+0.5)
    # behavior the format relies on is "treated as 0" (extract.c:1138-1144).
    v = np.where(np.isnan(v), 0.0, v)
    return (v * 100 + 0.5).astype(np.int64).astype(np.uint8)


def write_bbm(path: str, names, lengths, values) -> None:
    """Write a BBM file from per-chromosome uint8 value arrays (0-100)."""
    out = bytearray()
    out.append(BBM_VERSION)
    out += struct.pack("<I", len(names))
    for name, length, vals in zip(names, lengths, values):
        nb = name.encode()
        out += struct.pack("<H", len(nb))
        out += nb
        out.append(0)
        out += struct.pack("<I", int(length))
        _encode_chrom(out, np.asarray(vals, dtype=np.uint8), int(length))
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def _encode_chrom(out: bytearray, vals: np.ndarray, length: int) -> None:
    lastval = 255
    runlen = 0
    for j in range(length):
        val = int(vals[j])
        if val == lastval and runlen < 65535:
            runlen += 1
        else:
            if runlen > 1:
                if runlen < 156:  # short run (inner-loop threshold)
                    out.append(runlen + RUNOFFSET)
                    out.append(lastval)
                else:
                    out.append(255)
                    out += struct.pack("<H", runlen)
                    out.append(lastval)
                runlen = 0
            if j < length - 1 and int(vals[j + 1]) == val:
                lastval = val
                runlen = 1
            else:
                out.append(val)
                lastval = val
                runlen = 0
    if runlen > 1:
        if runlen < 155:  # flush threshold differs from the inner loop
            out.append(runlen + RUNOFFSET)
            out.append(lastval)
        else:
            out.append(255)
            out += struct.pack("<H", runlen)
            out.append(lastval)
