"""Synthetic WGBS data generator for tests and benchmarks.

Produces window-shaped tensor batches (same layout as io.bam.ReadBatch)
over a random reference, with paired-end reads, bisulfite conversion,
optional indels, XG tags and quality variation — enough surface to exercise
every branch of the call semantics.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.bam import ReadBatch

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 1, 2, 4, 8, 15
ASCII = {0: ord("A"), 1: ord("C"), 2: ord("G"), 3: ord("T")}
CODE = {0: BASE_A, 1: BASE_C, 2: BASE_G, 3: BASE_T}
COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def random_reference(rng, length: int, gc: float = 0.42) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    codes = rng.choice(4, size=length, p=p)
    return np.array([ASCII[c] for c in codes], dtype=np.uint8), codes


def simulate_batch(rng, ref_codes: np.ndarray, n_pairs: int, read_len: int,
                   meth_rate: float = 0.7, indel_rate: float = 0.0,
                   tid: int = 0, mapq: int = 40) -> ReadBatch:
    """Simulate n_pairs proper pairs of OT/OB bisulfite reads."""
    glen = len(ref_codes)
    n = n_pairs * 2
    L = read_len
    seq = np.zeros((n, L), dtype=np.uint8)
    qual = np.zeros((n, L), dtype=np.uint8)
    refpos = np.full((n, L), -2, dtype=np.int64)
    flag = np.zeros(n, dtype=np.uint16)
    pos = np.zeros(n, dtype=np.int64)
    l_qseq = np.full(n, L, dtype=np.int32)
    endpos = np.zeros(n, dtype=np.int64)
    qnames = []

    # Per-genome-position methylation state for CpG cytosines (consistent
    # between strands/pairs at a position, like real data)
    cpg_meth = rng.random(glen) < meth_rate

    for p in range(n_pairs):
        ot = rng.random() < 0.5  # original-top or original-bottom pair
        start = rng.integers(0, max(glen - 2 * L - 20, 1))
        gap = int(rng.integers(-L // 2, L // 2))
        s1, s2 = start, min(start + L + max(gap, -L + 5), glen - L - 1)
        for mate in (0, 1):
            i = p * 2 + mate
            st = s1 if mate == 0 else s2
            f = 0x1 | 0x2 | (0x40 if mate == 0 else 0x80)
            if ot:
                f |= 0x20 if mate == 0 else 0x10
            else:
                f |= 0x10 if mate == 0 else 0x20
            flag[i] = f
            pos[i] = st
            qnames.append(f"sim{p}")
            q = rng.integers(10, 42, size=L).astype(np.uint8)
            qual[i, :L] = q
            rp = np.arange(st, st + L)
            refpos[i, :L] = rp
            endpos[i] = st + L
            base_codes = ref_codes[rp].copy()
            # bisulfite chemistry: OT reads report top strand with C→T unless
            # methylated; OB reads report bottom strand (complement) with G→A
            # in top coordinates unless the bottom C (top G) is methylated.
            if ot:
                cs = np.nonzero(base_codes == 1)[0]
                conv = ~cpg_meth[rp[cs]]
                base_codes[cs[conv]] = 3
            else:
                gs = np.nonzero(base_codes == 2)[0]
                conv = ~cpg_meth[rp[gs]]
                base_codes[gs[conv]] = 0
            # sequencing errors
            err = rng.random(L) < 0.01
            base_codes[err] = rng.integers(0, 4, size=err.sum())
            seq[i, :L] = np.array([CODE[c] for c in base_codes], dtype=np.uint8)

    mtid = np.full(n, tid, dtype=np.int32)
    mpos = pos.reshape(-1, 2)[:, ::-1].reshape(-1)
    return ReadBatch(
        qname=qnames,
        flag=flag,
        tid=np.full(n, tid, dtype=np.int32),
        pos=pos,
        mapq=np.full(n, mapq, dtype=np.uint8),
        l_qseq=l_qseq,
        endpos=endpos,
        mtid=mtid,
        mpos=mpos,
        xg=np.zeros(n, dtype=np.int8),
        nh=np.full(n, -1, dtype=np.int32),
        seq=seq,
        qual=qual,
        refpos=refpos,
    )


def write_synthetic_input(dirpath, n_pairs: int, read_len: int, glen: int,
                          seed: int = 0, chrom: str = "chrSim",
                          gc: float = 0.42):
    """Write a coordinate-sorted synthetic WGBS BAM (+BAI) and its reference
    FASTA (+fai) for CLI-scale benchmarks — fully vectorized record
    serialization (n_pairs can be 500k+). Returns (fasta_path, bam_path)."""
    import os
    import struct
    import zlib

    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = random_reference(rng, glen, gc=gc)
    batch = simulate_batch_fast(rng, ref_codes, n_pairs, read_len)
    n = batch.n
    L = read_len

    # ---- FASTA (60-col lines)
    width = 60
    pad = (-glen) % width
    body = np.concatenate([ref_ascii, np.zeros(pad, np.uint8)])
    lines = body.reshape(-1, width)
    out = np.full((lines.shape[0], width + 1), ord("\n"), np.uint8)
    out[:, :width] = lines
    fa_bytes = out.reshape(-1)
    # strip padding of the final line
    if pad:
        fa_bytes = np.concatenate([fa_bytes[: -pad - 1],
                                   fa_bytes[-1:]])  # keep trailing newline
    fasta_path = os.path.join(dirpath, "sim.fa")
    with open(fasta_path, "wb") as fh:
        fh.write(b">" + chrom.encode() + b"\n")
        fh.write(fa_bytes.tobytes())

    # ---- BAM records, coordinate sorted
    order = np.argsort(batch.pos, kind="stable")
    pos = batch.pos[order].astype(np.int64)
    flag = batch.flag[order]
    mpos = batch.mpos[order].astype(np.int64)
    seq = batch.seq[order]
    qual = batch.qual[order]
    pair_id = (order // 2).astype(np.int64)

    qn_w = 10  # "s%08d" + NUL
    packed_w = (L + 1) // 2
    rec_sz = 4 + 32 + qn_w + 4 + packed_w + L
    buf = np.zeros((n, rec_sz), np.uint8)

    def put32(col, vals, dtype="<i4"):
        buf[:, col : col + 4] = np.ascontiguousarray(
            vals.astype(dtype)).view(np.uint8).reshape(n, 4)

    put32(0, np.full(n, rec_sz - 4, np.int32))   # block_size
    put32(4, np.zeros(n, np.int32))              # refID
    put32(8, pos.astype(np.int32))
    buf[:, 12] = qn_w                            # l_read_name
    buf[:, 13] = 40                              # mapq
    buf[:, 14:16] = np.frombuffer(struct.pack("<H", 4681), np.uint8)
    buf[:, 16:18] = np.frombuffer(struct.pack("<H", 1), np.uint8)  # n_cigar
    buf[:, 18:20] = np.ascontiguousarray(
        flag.astype("<u2")).view(np.uint8).reshape(n, 2)
    put32(20, np.full(n, L, np.int32))           # l_seq
    put32(24, np.zeros(n, np.int32))             # next_refID
    put32(28, mpos.astype(np.int32))
    put32(32, np.zeros(n, np.int32))             # tlen
    # qname "s%08d\0": digits vectorized
    digits = np.empty((n, 8), np.uint8)
    v = pair_id.copy()
    for d in range(7, -1, -1):
        digits[:, d] = (v % 10) + ord("0")
        v //= 10
    buf[:, 36] = ord("s")
    buf[:, 37:45] = digits
    buf[:, 45] = 0
    put32(36 + qn_w, np.full(n, (L << 4) | 0, np.uint32), "<u4")  # cigar LM
    # packed 4-bit seq
    s = seq[:, : L + (L % 2)]
    if L % 2:
        s = np.concatenate([seq, np.zeros((n, 1), np.uint8)], axis=1)
    buf[:, 40 + qn_w : 40 + qn_w + packed_w] = (
        (s[:, 0::2] << 4) | s[:, 1::2])
    buf[:, 40 + qn_w + packed_w :] = qual

    hdr = b"BAM\x01"
    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{glen}\n\x00".encode()
    hdr += struct.pack("<i", len(text)) + text
    hdr += struct.pack("<i", 1)
    nb = chrom.encode() + b"\x00"
    hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", glen)

    body = hdr + buf.tobytes()
    bam_path = os.path.join(dirpath, "sim.bam")
    with open(bam_path, "wb") as fh:
        for i in range(0, len(body), 60000):
            payload = body[i : i + 60000]
            co = zlib.compressobj(1, zlib.DEFLATED, -15)
            comp = co.compress(payload) + co.flush()
            # BGZF framing: 18-byte header + comp + 8-byte trailer; BSIZE
            # field is total block length - 1 = len(comp) + 25.
            fh.write(
                b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
                + struct.pack("<H", len(comp) + 25)
                + comp
                + struct.pack("<I", zlib.crc32(payload))
                + struct.pack("<I", len(payload))
            )
        fh.write(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))
    return fasta_path, bam_path


def simulate_batch_fast(rng, ref_codes: np.ndarray, n_pairs: int, read_len: int,
                        meth_rate: float = 0.7, tid: int = 0,
                        mapq: int = 40) -> ReadBatch:
    """Vectorized simulator (no indels) for large benchmark batches."""
    glen = len(ref_codes)
    n = n_pairs * 2
    L = read_len
    code_lut = np.array([BASE_A, BASE_C, BASE_G, BASE_T], dtype=np.uint8)

    cpg_meth = rng.random(glen) < meth_rate
    starts1 = rng.integers(0, glen - 2 * L - 4, size=n_pairs)
    gaps = rng.integers(0, L // 2, size=n_pairs)
    starts2 = starts1 + gaps  # heavy mate overlap, like real short-insert WGBS
    pos = np.empty(n, dtype=np.int64)
    pos[0::2] = starts1
    pos[1::2] = starts2
    ot = rng.random(n_pairs) < 0.5
    flag = np.empty(n, dtype=np.uint16)
    f1 = np.where(ot, 0x63, 0x53).astype(np.uint16)  # paired+proper+mate-rev/rev +read1
    f2 = np.where(ot, 0x93, 0xA3).astype(np.uint16)
    flag[0::2] = f1
    flag[1::2] = f2

    refpos = pos[:, None] + np.arange(L)[None, :]
    base_codes = ref_codes[refpos]
    meth = cpg_meth[refpos]
    ot_rows = np.repeat(ot, 2)
    conv_c = ot_rows[:, None] & (base_codes == 1) & ~meth
    conv_g = (~ot_rows[:, None]) & (base_codes == 2) & ~meth
    base_codes = np.where(conv_c, 3, base_codes)
    base_codes = np.where(conv_g, 0, base_codes)
    err = rng.random((n, L)) < 0.005
    base_codes = np.where(err, rng.integers(0, 4, size=(n, L)), base_codes)
    seq = code_lut[base_codes]
    qual = rng.integers(10, 42, size=(n, L)).astype(np.uint8)

    mpos = pos.reshape(-1, 2)[:, ::-1].reshape(-1)
    return ReadBatch(
        qname=[f"sim{i // 2}" for i in range(n)],
        flag=flag,
        tid=np.full(n, tid, dtype=np.int32),
        pos=pos,
        mapq=np.full(n, mapq, dtype=np.uint8),
        l_qseq=np.full(n, L, dtype=np.int32),
        endpos=pos + L,
        mtid=np.full(n, tid, dtype=np.int32),
        mpos=mpos,
        xg=np.zeros(n, dtype=np.int8),
        nh=np.full(n, -1, dtype=np.int32),
        seq=seq,
        qual=qual,
        refpos=refpos.astype(np.int64),
    )
