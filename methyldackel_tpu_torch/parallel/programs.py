"""The device programs that are plain tensor code: torch ops on an explicit
device, no hand-written kernel.

Counterparts, under the same names, of the jitted XLA programs of
``methyldackel_tpu/parallel/device.py`` that reach no Pallas kernel there:

- the dense window pipeline of ``extract`` (``strand_device``,
  ``classify_context_device``, ``trim_device``, ``meth_state_device``,
  ``conv_eff_device``, ``arbitrate_device``, ``pileup_device``,
  ``window_front``, ``window_pipeline``), which serves the windows the tiled
  kernels do not take (a BED strand column, reads longer than 256 bp,
  ``MDTPU_NO_PALLAS=1``) and the sharded step of ``parallel.mesh``;
- the ``mbias`` programs (``_mbias_reduce`` over host-packed 2-bit codes,
  ``mbias_device`` over raw rows);
- the ``perRead`` programs (``_perread_reduce`` over host-packed 2-bit
  codes, ``perread_device``, the lockstep chain walker over raw rows).

Every function takes tensors and returns tensors on the device of its
inputs; the same code runs on the card and on the CPU device. Shapes are
exact: there are no pad rows, pad pairs or padded references. Counts are
int32 (a column of one window never holds 2^31 bases; PyTorch's uint32 has
next to no operators) and are viewed as uint32 on the host after the
readback. The plain versions these are held against are the numpy oracles of
``ops.semantics`` and ``engine.perread.process_reads_gapless``.
"""
from __future__ import annotations

import functools

import torch

from ..ops import semantics as sem

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 1, 2, 4, 8, 15
REF_C, REF_G = ord("C"), ord("G")


def _select(conds, values, default):
    """``jnp.select``: the value of the first true condition. A chain of
    ``torch.where`` built from the last condition to the first."""
    out = torch.full_like(conds[0], default, dtype=torch.int32)
    for cond, value in zip(reversed(conds), reversed(values)):
        out = torch.where(cond, value, out)
    return out


@functools.lru_cache(maxsize=None)
def _qual_boost(device):
    """``semantics.QUAL_BOOST`` as an int32 table on ``device``, uploaded
    once."""
    return torch.from_numpy(sem.QUAL_BOOST.astype("int32")).to(device)


# ----------------------------------------------------------------- pieces

def strand_device(flag, xg):
    """getStrand (common.c:84-116) as vector selects. ``flag`` int32 [N],
    ``xg`` int8 [N]; returns int32 [N]."""
    flag = flag.to(torch.int32)
    paired = (flag & 0x1) != 0
    no_xg = _select(
        [paired & ((flag & 0x50) == 0x50), paired & ((flag & 0x40) != 0),
         paired & ((flag & 0x90) == 0x90), paired & ((flag & 0x80) != 0),
         paired, (flag & 0x10) != 0],
        [2, 1, 1, 2, 0, 2], 1)
    xg_conds = [(flag & 0x51) == 0x41, (flag & 0x51) == 0x51,
                (flag & 0x91) == 0x81, (flag & 0x91) == 0x91,
                (flag & 0x10) != 0]
    xg_c = _select(xg_conds, [1, 3, 3, 1, 3], 1)
    xg_g = _select(xg_conds, [4, 2, 2, 4, 2], 4)
    return torch.where(xg == 1, xg_c, torch.where(xg == 2, xg_g, no_xg))


def classify_context_device(ref):
    """isCpG/isCHG/isCHH over the window (common.c:49-82). ``ref`` uint8
    [n]; returns int8 [n]: 0 CpG, 1 CHG, 2 CHH, 3 none."""
    n = ref.shape[0]
    is_c = ref == REF_C
    is_g = ref == REF_G
    z1 = ref.new_zeros(1)
    z2 = ref.new_zeros(2)
    nxt = torch.cat([ref[1:], z1])
    nxt2 = torch.cat([ref[2:], z2])[:n]
    prv = torch.cat([z1, ref[:-1]])[:n]
    prv2 = torch.cat([z2, ref[:-2]])[:n]
    idx = torch.arange(n, device=ref.device)
    cpg = (is_c & (idx + 1 < n) & (nxt == REF_G)) \
        | (is_g & (idx > 0) & (prv == REF_C))
    chg = (is_c & (idx + 2 < n) & (nxt2 == REF_G)) \
        | (is_g & (idx > 1) & (prv2 == REF_C))
    return _select([cpg, chg, is_c | is_g], [0, 1, 2], 3).to(torch.int8)


def trim_device(seq, qual, l_qseq, strand, flag, bounds, absolute_bounds):
    """trimAlignment + trimAbsoluteAlignment (common.c:137-208), with the
    absolute right-trim keeping base l_qseq-rb (see ops.semantics).
    ``bounds`` and ``absolute_bounds`` are int32 [16]: per strand (row
    ``strand - 1``; strand 0 takes the last row, as numpy indexing does)
    left, right of read 1, left, right of read 2."""
    L = seq.shape[1]
    col = torch.arange(L, device=seq.device)[None, :]
    lq = l_qseq.to(torch.int32)[:, None]
    is_read2 = ((flag.to(torch.int32) & 0x80) != 0)[:, None]
    s = (strand.to(torch.int64) - 1) % 4

    def per_read_bounds(b16):
        b = b16.to(torch.int32).reshape(4, 4)[s]  # [N, 4]
        lb = torch.where(is_read2, b[:, 2:3], b[:, 0:1])
        rb = torch.where(is_read2, b[:, 3:4], b[:, 1:2])
        return lb, rb

    # positional bounds: trim [0, lb) and [rb, L)
    lb, rb = per_read_bounds(bounds)
    lb = torch.minimum(lb, lq)
    cut = ((lb > 0) & (col < lb)) | ((rb > 0) & (col >= rb))
    # absolute bounds: trim [0, lb) and [L-rb+1, L)
    alb, arb = per_read_bounds(absolute_bounds)
    alb = torch.minimum(alb, lq)
    arb = torch.minimum(arb, lq)
    cut |= ((alb > 0) & (col < alb)) | ((arb > 0) & (col >= lq - arb + 1))
    cut &= col < lq
    qual = torch.where(cut, 0, qual).to(torch.uint8)
    seq = torch.where(cut, BASE_N, seq).to(torch.uint8)
    return seq, qual


def meth_state_device(seq, qual, strand, min_phred):
    """+1 methylated, -1 unmethylated, 0 neither, per base (int8 [N, L])."""
    odd = (strand.to(torch.int32) & 1)[:, None] == 1
    passing = qual >= min_phred
    meth = torch.where(odd, seq == BASE_C, seq == BASE_G)
    unmeth = torch.where(odd, seq == BASE_T, seq == BASE_A)
    return ((passing & meth).to(torch.int8)
            - (passing & unmeth).to(torch.int8))


def conv_eff_device(seq, qual, refpos, strand, ctype, win_offset, seq_len,
                    min_phred):
    """computeConversionEfficiency (common.c:361-404) per read, float32:
    the unmethylated share of the read's CHG and CHH calls, 1.0 when it has
    none."""
    aligned = (refpos >= win_offset) & (refpos < win_offset + seq_len)
    idx = torch.where(aligned, refpos - win_offset, 0).long()
    ct = torch.where(aligned, ctype[idx], 3)
    state = meth_state_device(seq, qual, strand, min_phred)
    informative = aligned & ((ct == 1) | (ct == 2))
    n_meth = ((state > 0) & informative).sum(1, dtype=torch.int32)
    n_unmeth = ((state < 0) & informative).sum(1, dtype=torch.int32)
    total = n_meth + n_unmeth
    return torch.where(total == 0, 1.0,
                       n_unmeth.to(torch.float32) / total.to(torch.float32))


def arbitrate_device(seq, qual, refpos, strand, pair_a, pair_b, pair_valid,
                     ovw):
    """cust_tweak_overlap_quality (overlaps.c:54-119), all pairs at once.

    Each pair is aligned on a dense window of ``ovw`` columns anchored at
    the pair's smallest aligned coordinate; a base outside it, or unaligned,
    goes to a dump column that is never read back. ``pair_a`` / ``pair_b``
    are row indices [P] (P = 0 works), ``pair_valid`` bool [P] or None for
    all valid. Returns the updated qual tensor (uint8 [N, L]); the input is
    not written.
    """
    P = pair_a.shape[0]
    if P == 0:
        return qual
    pair_a = pair_a.long()
    pair_b = pair_b.long()
    pa = refpos[pair_a]  # [P, L]
    pb = refpos[pair_b]
    qa = qual[pair_a].to(torch.int32)
    qb = qual[pair_b].to(torch.int32)
    compatible = ((strand[pair_a] - strand[pair_b]) & 1) == 0
    if pair_valid is not None:
        compatible &= pair_valid

    big = 2**31 - 1
    base = torch.minimum(torch.where(pa >= 0, pa, big).amin(1),
                         torch.where(pb >= 0, pb, big).amin(1))[:, None]
    va = (pa >= 0) & (pa - base >= 0) & (pa - base < ovw)
    vb = (pb >= 0) & (pb - base >= 0) & (pb - base < ovw)
    offa = torch.where(va, pa - base, ovw).long()
    offb = torch.where(vb, pb - base, ovw).long()
    del pa, pb

    def densify(off, vals, fill):
        d = torch.full((P, ovw + 1), fill, dtype=torch.int32,
                       device=seq.device)
        return d.scatter_(1, off, vals)

    # two bases of one read share an offset only in the dump column
    dqa = densify(offa, qa, 0)
    dqb = densify(offb, qb, 0)
    dba = densify(offa, seq[pair_a].to(torch.int32), -1)
    dbb = densify(offb, seq[pair_b].to(torch.int32), -1)

    boost = _qual_boost(seq.device)
    has = (dba >= 0) & (dbb >= 0) & compatible[:, None]
    differ = dba != dbb
    awins_d = differ & (dqa > dqb) & (dba != BASE_N)
    bwins_d = differ & ~awins_d & (dqb > dqa) & (dbb != BASE_N)
    awins_s = ~differ & (dqa > dqb)
    bwins_s = ~differ & ~awins_s
    del dba, dbb, differ
    # where both mates cover a column exactly one of the four holds or both
    # quals go to 0
    zero = torch.zeros((), dtype=torch.int32, device=seq.device)
    new_dqa = torch.where(awins_d, dqa - dqb,
                          torch.where(awins_s, boost[dqa.long()], zero))
    new_dqb = torch.where(bwins_d, dqb - dqa,
                          torch.where(bwins_s, boost[dqb.long()], zero))
    new_dqa = torch.where(has, new_dqa, dqa)
    new_dqb = torch.where(has, new_dqb, dqb)
    del dqa, dqb, awins_d, bwins_d, awins_s, bwins_s, has

    out = qual.clone()
    out[pair_a] = torch.where(va, new_dqa.gather(1, offa), qa).to(torch.uint8)
    out[pair_b] = torch.where(vb, new_dqb.gather(1, offb), qb).to(torch.uint8)
    return out


def pileup_device(seq, qual, refpos, strand, keep_read, keep_base, ref,
                  win_offset, win_start, wpad, min_phred):
    """The 4-channel scatter-add (extract.c:420-441 + isVariant): meth,
    unmeth, opposite-strand depth and opposite-strand variants per column
    of [win_start, win_start + wpad). ``keep_base`` bool [N, L] or None for
    all kept. Returns int32 [wpad, 4]."""
    if wpad <= 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=seq.device)
    valid = (refpos >= win_start) & (refpos < win_start + wpad) \
        & keep_read[:, None]
    if keep_base is not None:
        valid &= keep_base
    # A base that is not counted adds 0 in every channel, so it needs no
    # column of its own: it goes to the column its coordinate falls on
    # modulo the width. One dump column would take every such base of a
    # column slice (three quarters of all bases when the window is cut in
    # four) as atomic adds on a single address.
    rp = torch.where(valid, refpos - win_start,
                     refpos.remainder(wpad)).reshape(-1)
    ridx = torch.where(valid, refpos - win_offset, 0)
    ridx = ridx.clamp_(max=ref.shape[0] - 1).long()
    refbase = torch.where(valid, ref[ridx], 0)
    del ridx
    odd = (strand.to(torch.int32) & 1)[:, None] == 1
    calling = torch.where(odd, refbase == REF_C, refbase == REF_G)
    del refbase
    passing = valid & (qual >= min_phred)
    on = passing & calling
    off = passing & ~calling
    chans = (
        on & torch.where(odd, seq == BASE_C, seq == BASE_G),
        on & torch.where(odd, seq == BASE_T, seq == BASE_A),
        off,
        off & (seq != BASE_N) & torch.where(odd, seq != BASE_G,
                                            seq != BASE_C),
    )
    # one flat int32 row per channel, never an int64 [N, L, 4]
    counters = torch.zeros((4, wpad), dtype=torch.int32, device=seq.device)
    for c, chan in enumerate(chans):
        counters[c].index_add_(0, rp, chan.reshape(-1).to(torch.int32))
    return counters.T.contiguous()


def window_front(seq, qual, refpos, flag, xg, l_qseq, keep_read, pair_a,
                 pair_b, pair_valid, ref, bounds, absolute_bounds, win_offset,
                 *, ovw, min_phred, min_conv_eff, use_overlaps):
    """Everything of the window pipeline that does not depend on the
    window's columns: strand, context, the conversion-efficiency gate,
    trimming and mate-overlap arbitration. The mesh step (``parallel.mesh``)
    runs it once a row shard and the pileup once a column slice. Returns
    (seq, qual, strand, keep_read)."""
    strand = strand_device(flag, xg)
    if min_conv_eff > 0.0:
        ctype = classify_context_device(ref)
        eff = conv_eff_device(seq, qual, refpos, strand, ctype, win_offset,
                              ref.shape[0], min_phred)
        keep_read = keep_read & (eff >= torch.tensor(
            min_conv_eff, dtype=torch.float32, device=eff.device))
    seq, qual = trim_device(seq, qual, l_qseq, strand, flag, bounds,
                            absolute_bounds)
    if use_overlaps:
        qual = arbitrate_device(seq, qual, refpos, strand, pair_a, pair_b,
                                pair_valid, ovw)
    return seq, qual, strand, keep_read


def window_pipeline(seq, qual, refpos, flag, xg, l_qseq, mapq, keep_read,
                    keep_base, pair_a, pair_b, pair_valid, ref, bounds,
                    absolute_bounds, win_offset, win_start, *, wpad, ovw,
                    min_phred, min_conv_eff, use_overlaps):
    """Everything from strand inference to the pileup counters on the
    device: strand, context, the conversion-efficiency gate, trimming,
    mate-overlap arbitration, pileup. ``mapq`` is carried for the
    reference's signature (the MAPQ gate is the host's). Returns int32
    [wpad, 4]."""
    seq, qual, strand, keep_read = window_front(
        seq, qual, refpos, flag, xg, l_qseq, keep_read, pair_a, pair_b,
        pair_valid, ref, bounds, absolute_bounds, win_offset, ovw=ovw,
        min_phred=min_phred, min_conv_eff=min_conv_eff,
        use_overlaps=use_overlaps)
    return pileup_device(seq, qual, refpos, strand, keep_read, keep_base,
                         ref, win_offset, win_start, wpad, min_phred)


# ------------------------------------------------------------------ mbias

def mbias_device(seq, qual, refpos, strand, flag, keep_base, ref, win_offset,
                 win_start, win_end, *, keep_ctx, min_phred):
    """extractMBias counter loop (MBias.c:180-214) over raw rows: the
    read-cycle axis is the column axis, so the [4 strands, 2 reads, 2
    states, L] counters are 16 masked column sums over the [N, L] call
    tensors. Bit-equal to ``ops.semantics.mbias_counters``. Deliberately no
    overlap arbitration (MBias.c:160). Returns int32 [4, 2, 2, L]."""
    n = ref.shape[0]
    ctype = classify_context_device(ref)
    valid = (refpos >= win_start) & (refpos < win_end) & keep_base
    widx = torch.where(valid, refpos - win_offset, 0)
    inref = valid & (widx < n)
    widx = torch.where(inref, widx, 0).long()
    ct = torch.where(inref, ctype[widx], 3)
    ctx_ok = torch.zeros_like(valid)
    for t in range(3):
        if keep_ctx[t]:
            ctx_ok |= ct == t
    refbase = torch.where(inref, ref[widx], 0)
    del widx, ct
    strand = strand.to(torch.int32)
    sodd = (strand & 1)[:, None] == 1
    calling = torch.where(sodd, refbase == REF_C, refbase == REF_G)
    state = meth_state_device(seq, qual, strand, min_phred)
    use = valid & ctx_ok & calling & (state != 0)
    r_idx = ((flag.to(torch.int32) & 0x80) != 0).to(torch.int32)
    combo = (((strand - 1) * 2 + r_idx) * 2)[:, None] \
        + (state < 0).to(torch.int32)  # [N, L] in 0..15
    combo = torch.where(use, combo, 16).to(torch.uint8)
    rows = [(combo == c).sum(0, dtype=torch.int32) for c in range(16)]
    return torch.stack(rows).reshape(4, 2, 2, seq.shape[1])


def _mbias_reduce(codes, combo):
    """The mbias reduction over host-packed rows (``io.native.mbias_pack``):
    ``codes`` uint8 [Nb, Lq], four 2-bit codes a byte (1 = methylated, 2 =
    unmethylated, 0 = no call) with context, calling base, window and phred
    gates resolved on the host; ``combo`` uint8 [Nb] = (strand - 1) * 2 +
    read. Sixteen masked column sums; returns int32 [4, 2, 2, 4 * Lq]. Nb
    may be 0."""
    Nb, Lq = codes.shape
    code = torch.stack([(codes >> s) & 3 for s in (0, 2, 4, 6)],
                       dim=-1).reshape(Nb, 4 * Lq)
    # code 1 or 2 of combo c -> c * 2 + (code - 1); everything else 16
    key = torch.where((code == 1) | (code == 2),
                      combo[:, None] * 2 + code - 1, 16)
    rows = [(key == c).sum(0, dtype=torch.int32) for c in range(16)]
    return torch.stack(rows).reshape(4, 2, 2, 4 * Lq)


# ---------------------------------------------------------------- perRead

def perread_device(seq, qual, pos, lq, strand, ref, seq_start, seq_len, *,
                   min_phred):
    """processRead's CpG chain walk (perRead.c:37-94) for gapless reads:
    every read steps its cursor in lockstep. The low-qual quirk (a failing
    base advances the cursor and the NEXT base is tallied without a quality
    re-check) is the ``where`` on ``lowq``. L sequential steps of [N]-vector
    work; bit-equal to ``engine.perread.process_reads_gapless``. Returns
    int32 (n_meth [N], n_unmeth [N])."""
    N, L = seq.shape
    dev = seq.device
    is_c = ref == REF_C
    is_g = ref == REF_G
    f1 = torch.zeros(1, dtype=torch.bool, device=dev)
    nxt_g = torch.cat([is_g[1:], f1])
    prv_c = torch.cat([f1, is_c[:-1]])
    # CpG direction per reference position; positions at or after seq_len
    # are zeroed by the in-window mask below
    dirv = (is_c & nxt_g).to(torch.int8) - (is_g & prv_c).to(torch.int8)
    nref = ref.shape[0]
    odd = (strand.to(torch.int32) & 1) == 1
    lq = lq.to(torch.int32)
    pos = pos.to(torch.int32)
    cursor = torch.zeros(N, dtype=torch.int32, device=dev)
    nm = torch.zeros(N, dtype=torch.int32, device=dev)
    nu = torch.zeros(N, dtype=torch.int32, device=dev)
    for _ in range(L):
        active = cursor < lq
        j = cursor.clamp(0, L - 1).long()
        qj = qual.take_along_dim(j[:, None], 1)[:, 0]
        lowq = active & (qj < min_phred)
        e = torch.where(lowq, cursor + 1, cursor)
        evaluate = active & (e < lq)
        widx = pos + e - seq_start
        inw = evaluate & (widx >= 0) & (widx < seq_len) & (widx < nref)
        d = torch.where(inw, dirv[widx.clamp(0, nref - 1).long()], 0)
        base = seq.take_along_dim(e.clamp(0, L - 1).long()[:, None], 1)[:, 0]
        top = (d == 1) & odd
        bot = (d == -1) & ~odd
        nm += (top & (base == BASE_C)) | (bot & (base == BASE_G))
        nu += (top & (base == BASE_T)) | (bot & (base == BASE_A))
        cursor = torch.where(active, torch.where(lowq, cursor + 2,
                                                 cursor + 1), cursor)
    return nm, nu


def _perread_reduce(codes):
    """The perRead reduction over host-packed rows
    (``io.native.perread_pack``): per row of ``codes`` uint8 [Nb, Lq] the
    count of 2-bit code 1 (methylated) and of code 2 (unmethylated). The
    low-qual skip quirk never reaches this program: rows holding a
    sub-phred base are redone by the exact host walker. Returns int32
    (n_meth [Nb], n_unmeth [Nb])."""
    nm = torch.zeros(codes.shape[0], dtype=torch.int32, device=codes.device)
    nu = torch.zeros_like(nm)
    for s in (0, 2, 4, 6):
        c = (codes >> s) & 3
        nm += (c == 1).sum(1, dtype=torch.int32)
        nu += (c == 2).sum(1, dtype=torch.int32)
    return nm, nu
