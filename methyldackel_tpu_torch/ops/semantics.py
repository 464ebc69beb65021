"""Exact vectorized (numpy) semantics of the methylation-call core.

This is the host-side twin of the device ops (the CUDA kernels of ops/): every function here
reproduces the corresponding reference C routine bit-for-bit and serves both
as the host execution engine and as the oracle the device kernels are tested
against.

Reference mapping:
- strand()                ← getStrand (common.c:84-116)
- classify_context()      ← isCpG/isCHG/isCHH (common.c:49-82)
- trim_alignment()        ← trimAlignment (common.c:137-172)
- trim_absolute()         ← trimAbsoluteAlignment (common.c:174-208)
- arbitrate_overlaps()    ← cust_tweak_overlap_quality (overlaps.c:54-119)
- meth_state()            ← updateMetrics/getMethylState (common.c:118-134)
- conversion_efficiency() ← computeConversionEfficiency (common.c:361-404)
- filter_reads()          ← filter_func (common.c:407-463)
- pileup_channels()       ← the per-column tally in extractCalls
                            (extract.c:420-441) + isVariant (extract.c:225-239)
- mbias_counters()        ← extractMBias's counter loop (MBias.c:180-214)
"""
from __future__ import annotations

import numpy as np

# BAM 4-bit base codes
A, C, G, T, N = 1, 2, 4, 8, 15

# ASCII codes for the (uppercased) reference
REF_A, REF_C, REF_G, REF_T = ord("A"), ord("C"), ord("G"), ord("T")

# Channel layout of the pileup counters
CH_METH, CH_UNMETH, CH_OFF, CH_VARIANT = 0, 1, 2, 3

# Quality boost table for agreeing overlap bases: C computes
# `q += 0.2*q` in double then truncates through the uint8 store
# (overlaps.c:102-107). Python floats are C doubles, so this table is exact.
QUAL_BOOST = np.array([int(q + 0.2 * q) & 0xFF for q in range(256)], dtype=np.uint8)


# ----------------------------------------------------------------- strand

def strand(flag: np.ndarray, xg: np.ndarray) -> np.ndarray:
    """getStrand vectorized: 1 OT, 2 OB, 3 CTOT, 4 CTOB, 0 unknown.

    xg: 0 = no usable XG tag, 1 = first char 'C', 2 = first char 'G'
    (common.c:86-88 treats any other value as absent).
    """
    flag = flag.astype(np.uint32)
    paired = (flag & 0x1) != 0
    # no-XG path (common.c:88-98)
    no_xg = np.select(
        [
            paired & ((flag & 0x50) == 0x50),
            paired & ((flag & 0x40) != 0),
            paired & ((flag & 0x90) == 0x90),
            paired & ((flag & 0x80) != 0),
            paired,
            (flag & 0x10) != 0,
        ],
        [2, 1, 1, 2, 0, 2],
        default=1,
    )
    # XG == 'C' (common.c:100-106)
    xg_c = np.select(
        [
            (flag & 0x51) == 0x41,
            (flag & 0x51) == 0x51,
            (flag & 0x91) == 0x81,
            (flag & 0x91) == 0x91,
            (flag & 0x10) != 0,
        ],
        [1, 3, 3, 1, 3],
        default=1,
    )
    # XG == 'G' (common.c:107-114)
    xg_g = np.select(
        [
            (flag & 0x51) == 0x41,
            (flag & 0x51) == 0x51,
            (flag & 0x91) == 0x81,
            (flag & 0x91) == 0x91,
            (flag & 0x10) != 0,
        ],
        [4, 2, 2, 4, 2],
        default=4,
    )
    return np.select([xg == 1, xg == 2], [xg_c, xg_g], default=no_xg).astype(np.int8)


# ----------------------------------------------------------------- context

CTX_CPG, CTX_CHG, CTX_CHH, CTX_NONE = 0, 1, 2, 3


def classify_context(seq: np.ndarray):
    """Per-position context over an uppercased ASCII reference window.

    Returns (ctype, cdir): ctype in {CPG, CHG, CHH, NONE}; cdir +1 for a C on
    the top strand, -1 for a G (reverse context), 0 for none. Truncated
    contexts at window edges degrade exactly as the C does (a C with no
    visible partner falls through CpG→CHG→CHH; common.c:49-82).
    """
    n = len(seq)
    is_c = seq == REF_C
    is_g = seq == REF_G
    # A CG at (i, i+1) marks both bases CpG; a C.G at (i, i+2) marks both
    # CHG. Every C/G is at least CHH, so priority collapses to arithmetic:
    # ctype = 3 - [C or G] - [CpG or CHG] - [CpG], and the direction is
    # simply +1 at C, -1 at G, 0 elsewhere (the select lists were is_c /
    # is_g partitioned).
    cpg = np.zeros(n, bool)
    chg = np.zeros(n, bool)
    if n > 1:
        pair = is_c[:-1] & is_g[1:]
        cpg[:-1] = pair
        cpg[1:] |= pair
    if n > 2:
        pair2 = is_c[:-2] & is_g[2:]
        chg[:-2] = pair2
        chg[2:] |= pair2
    chh = is_c | is_g
    ctype = (CTX_NONE - chh.astype(np.int8) - (cpg | chg).astype(np.int8)
             - cpg.astype(np.int8))
    cdir = is_c.astype(np.int8) - is_g.astype(np.int8)
    return ctype, cdir


# ----------------------------------------------------------------- trimming

def _bounds_per_read(strand_arr, is_read2, bounds16):
    b = np.asarray(bounds16, dtype=np.int64).reshape(4, 4)
    s = strand_arr.astype(np.int64) - 1
    lb = np.where(is_read2, b[s, 2], b[s, 0])
    rb = np.where(is_read2, b[s, 3], b[s, 1])
    return lb, rb


def trim_alignment(seq, qual, l_qseq, strand_arr, flag, bounds16):
    """trimAlignment (common.c:137-172): positional inclusion windows.

    Trims base indices [0, lb) and [rb, l_qseq) in place: qual→0, base→N.
    """
    if not np.any(bounds16):
        return seq, qual  # zero bounds trim nothing (lb = rb = 0 below)
    L = seq.shape[1]
    is_read2 = (flag & 0x80) != 0
    lb, rb = _bounds_per_read(strand_arr, is_read2, bounds16)
    lb = np.minimum(lb, l_qseq)
    col = np.arange(L)[None, :]
    inread = col < l_qseq[:, None]
    left = (lb[:, None] > 0) & (col < lb[:, None])
    right = (rb[:, None] > 0) & (col >= rb[:, None])
    cut = (left | right) & inread
    qual[cut] = 0
    seq[cut] = N
    return seq, qual


def trim_absolute(seq, qual, l_qseq, strand_arr, flag, bounds16):
    """trimAbsoluteAlignment (common.c:174-208): N bases off each end.

    Right-side semantics follow the released binary's behavior, pinned by the
    reference CI anchor (tests/test.py:84-88 expects 12 lines with
    --nOT 50,50,40,40 on 100bp reads): the right loop indexes from l_qseq
    down, so the trimmed indices are [l_qseq-rb+1, l_qseq) and base
    l_qseq-rb is KEPT (the top index lands one past the array and is a
    no-op here). The left loop trims [0, lb) exactly.
    """
    if not np.any(bounds16):
        return seq, qual  # zero bounds trim nothing (lb = rb = 0 below)
    L = seq.shape[1]
    is_read2 = (flag & 0x80) != 0
    lb, rb = _bounds_per_read(strand_arr, is_read2, bounds16)
    lb = np.minimum(lb, l_qseq)
    rb = np.minimum(rb, l_qseq)
    col = np.arange(L)[None, :]
    inread = col < l_qseq[:, None]
    left = (lb[:, None] > 0) & (col < lb[:, None])
    right = (rb[:, None] > 0) & (col >= (l_qseq - rb + 1)[:, None])
    cut = (left | right) & inread
    qual[cut] = 0
    seq[cut] = N
    return seq, qual


# ------------------------------------------------------- overlap arbitration

def pair_mates(qnames, flag, order=None, qname_hash=None):
    """Pair mate occurrences the way the pileup constructor does
    (overlaps.c:121-139): reads arrive in position-sorted order; the first
    passing occurrence of a qname is stored, the second triggers arbitration
    (a 3rd occurrence re-enters the hash and pairs with a 4th, etc.).
    Unpaired reads and reads with self/mate unmapped (flag & 12) never enter
    the hash. Returns (a_idx, b_idx) row-index arrays, ordered by the second
    occurrence — exactly the khash pop order.

    With `qname_hash` (a per-row uint64 name hash, e.g. io.bam's blob FNV),
    pairing is fully vectorized: group by hash keeping arrival order, pair
    consecutive occurrences, then verify every formed pair's NAMES are
    byte-equal (qnames.verify_equal when available). Any mismatch — a hash
    collision that would change the pairing — falls back to the exact dict
    loop, so the result is always identical to the khash semantics."""
    if qname_hash is not None and len(qname_hash):
        a, b = _pair_by_key(np.asarray(qname_hash), flag, order)
        if len(a) == 0:
            return a, b
        verify = getattr(qnames, "verify_equal", None)
        if verify is not None:
            ok = bool(np.all(verify(a, b)))
        else:
            ok = all(qnames[int(x)] == qnames[int(y)] for x, y in zip(a, b))
        if ok:
            return a, b
    return _pair_mates_loop(qnames, flag, order)


def _pair_by_key(key, flag, order=None):
    """Group eligible rows by an integer key (keeping arrival order within
    each group) and pair consecutive occurrences. Equals the dict-loop
    pairing whenever equal keys imply equal qnames (the caller verifies)."""
    n = len(key)
    empty = np.zeros(0, dtype=np.int64)
    rows_in_order = (np.arange(n, dtype=np.int64) if order is None
                     else np.asarray(order, np.int64))
    f = np.asarray(flag).astype(np.int64)[rows_in_order]
    elig = ((f & 0x1) != 0) & ((f & 12) == 0)
    arrival = rows_in_order[elig]  # row ids, in arrival order
    if len(arrival) < 2:
        return empty, empty
    _, inv = np.unique(key[arrival], return_inverse=True)
    # Stable sort by group: within a group, arrival order is preserved.
    by_group = np.argsort(inv, kind="stable")
    g = inv[by_group]
    r = arrival[by_group]
    new_group = np.empty(len(g), dtype=bool)
    new_group[0] = True
    new_group[1:] = g[1:] != g[:-1]
    group_start = np.nonzero(new_group)[0]
    occ = np.arange(len(g)) - np.repeat(group_start, np.diff(
        np.r_[group_start, len(g)]))
    b_pos = np.nonzero((occ & 1) == 1)[0]
    a_rows = r[b_pos - 1]
    b_rows = r[b_pos]
    # The dict loop emits pairs in order of the SECOND occurrence; by_group
    # maps sorted-frame positions back to arrival indices.
    emit_order = np.argsort(by_group[b_pos], kind="stable")
    return a_rows[emit_order], b_rows[emit_order]


def touching_pairs(pos, endpos, a_idx, b_idx):
    """Subset of mate pairs whose reference spans intersect. Pairs with
    disjoint spans share no column, so cust_tweak_overlap_quality is a
    no-op on them (overlaps.c:54-119 only rewrites shared positions) —
    callers skip the O(L) per-pair arbitration scan for those (typically
    most pairs). Returns (a_idx, b_idx) filtered, exact."""
    if not len(a_idx):
        return a_idx, b_idx
    touching = (pos[a_idx] < endpos[b_idx]) & (pos[b_idx] < endpos[a_idx])
    return np.asarray(a_idx)[touching], np.asarray(b_idx)[touching]


def pair_mates_batch(batch, kidx):
    """pair_mates over a ReadBatch row subset, using the batch's vectorized
    qname hashes when present (no Python string materialization).

    Blob-backed batches take the native open-addressing kernel
    (csrc mdtpu_pair_mates): the true dict semantics with inline byte-exact
    name comparison — collisions are resolved in place, never by falling
    back, and the ~30 ms/window numpy group-sort disappears."""
    qn = batch.qname
    qh = getattr(batch, "qname_hash", None)
    if qh is not None:
        from ..io import native as _nat

        parent = getattr(qn, "_parent", None)
        sub_idx = getattr(qn, "_idx", None)
        blob = getattr(parent, "_arr", None)
        off = getattr(parent, "_off", None)
        if blob is not None and off is not None and sub_idx is not None:
            got = _nat.pair_mates(qh[kidx], np.asarray(batch.flag)[kidx],
                                  blob, off, np.asarray(sub_idx)[kidx])
            if got is not None:
                return got
    if hasattr(qn, "verify_equal"):
        sub = qn[kidx]
    else:
        sub = [qn[int(i)] for i in kidx]
    return pair_mates(sub, np.asarray(batch.flag)[kidx],
                      qname_hash=None if qh is None else qh[kidx])


def _pair_mates_loop(qnames, flag, order=None):
    """Exact khash walk (overlaps.c:121-139); oracle for the hash path."""
    pending: dict[str, int] = {}
    a_list, b_list = [], []
    n = len(qnames)
    rng = range(n) if order is None else order
    for i in rng:
        f = int(flag[i])
        if not (f & 0x1) or (f & 12):
            continue
        q = qnames[i]
        j = pending.pop(q, None)
        if j is None:
            pending[q] = i
        else:
            a_list.append(j)
            b_list.append(i)
    return np.asarray(a_list, dtype=np.int64), np.asarray(b_list, dtype=np.int64)


def arbitrate_overlaps(seq, qual, refpos, strand_arr, a_idx, b_idx):
    """cust_tweak_overlap_quality (overlaps.c:54-119), vectorized per pair.

    Mutates qual in place. Rules at each shared reference position:
    - bases differ: higher-qual non-N base keeps (its qual minus the other's),
      loser zeroed; N-or-tie zeroes both.
    - bases agree: winner (a on ties... b on ties — the C's else branch) gets
      floor(1.2*q) through uint8 wraparound, loser zeroed.
    Pairs on incompatible strands (parity differs) are skipped.

    Gapless pairs (both mates a single aligned run: refpos == start + col)
    take a vectorized all-pairs shift-aligned path; pairs containing indel/
    clipped mates fall back to the per-pair intersect loop. Both produce the
    C's per-position results exactly (the state machine is position-local).
    """
    a_idx = np.asarray(a_idx, dtype=np.int64)
    b_idx = np.asarray(b_idx, dtype=np.int64)
    if len(a_idx):
        N, L = refpos.shape
        col = np.arange(L, dtype=np.int64)
        valid = refpos >= 0
        nvalid = valid.sum(axis=1)
        start = refpos[:, 0]
        expect = start[:, None] + col[None, :]
        gapless = (
            (start >= 0)
            & (valid == (col[None, :] < nvalid[:, None])).all(axis=1)
            & np.where(valid, refpos == expect, True).all(axis=1)
        )
        compatible = ((strand_arr[a_idx] - strand_arr[b_idx]) & 1) == 0
        fast = compatible & gapless[a_idx] & gapless[b_idx]
        if fast.any():
            _arbitrate_gapless_dense(seq, qual, refpos, nvalid,
                                     a_idx[fast], b_idx[fast])
        a_idx = a_idx[~fast]
        b_idx = b_idx[~fast]
    return _arbitrate_pairs_loop(seq, qual, refpos, strand_arr, a_idx, b_idx)


def _arbitrate_pairs_loop(seq, qual, refpos, strand_arr, a_idx, b_idx):
    """Per-pair intersect1d arbitration (handles indels/clips); the oracle
    for the dense fast path. Mutates qual in place."""
    for a, b in zip(a_idx, b_idx):
        if ((int(strand_arr[a]) - int(strand_arr[b])) & 1) == 1:
            continue
        pa, pb = refpos[a], refpos[b]
        va = np.nonzero(pa >= 0)[0]
        vb = np.nonzero(pb >= 0)[0]
        common, i1, i2 = np.intersect1d(pa[va], pb[vb], return_indices=True)
        if len(common) == 0:
            continue
        ia, ib = va[i1], vb[i2]
        qa = qual[a][ia].astype(np.int64)
        qb = qual[b][ib].astype(np.int64)
        ba = seq[a][ia]
        bb = seq[b][ib]
        differ = ba != bb
        awins_d = differ & (qa > qb) & (ba != N)
        bwins_d = differ & ~awins_d & (qb > qa) & (bb != N)
        zero_d = differ & ~awins_d & ~bwins_d
        awins_s = ~differ & (qa > qb)
        bwins_s = ~differ & ~awins_s
        new_qa = np.select(
            [awins_d, awins_s, bwins_d | bwins_s | zero_d],
            [qa - qb, QUAL_BOOST[qa], 0],
            default=qa,
        )
        new_qb = np.select(
            [bwins_d, bwins_s, awins_d | awins_s | zero_d],
            [qb - qa, QUAL_BOOST[qb], 0],
            default=qb,
        )
        qual[a][ia] = new_qa.astype(np.uint8)
        qual[b][ib] = new_qb.astype(np.uint8)
    return qual


def _arbitrate_gapless_dense(seq, qual, refpos, nvalid, a_idx, b_idx):
    """All-pairs vectorized arbitration for gapless mates.

    Every mate is a single aligned run (refpos == start + col), so mate b's
    bases land in mate a's frame at column j - (start_b - start_a): one
    take_along_axis per side replaces the per-pair intersect1d. Rules and
    the a/b role asymmetry (the agree-tie boost goes to b,
    overlaps.c:95-103) are identical to the loop path. Mutates qual."""
    L = seq.shape[1]
    col = np.arange(L, dtype=np.int32)[None, :]
    d = (refpos[b_idx, 0] - refpos[a_idx, 0]).astype(np.int32)[:, None]
    # Snapshot both sides: each side's update reads the OTHER side's
    # pre-update quals (the C rewrites from the captured pair state,
    # overlaps.c:70-115) — writing a first must not feed into b's pass.
    qa_orig = qual[a_idx].astype(np.int16)
    qb_orig = qual[b_idx].astype(np.int16)
    seq_a = seq[a_idx]
    seq_b = seq[b_idx]
    nv_a = nvalid[a_idx][:, None]
    nv_b = nvalid[b_idx][:, None]

    def aligned_views(q_other, s_other, nv_self, nv_other, shift):
        # other-mate base/qual seen from self's frame: self col j ↔ other
        # col j - shift; returns (qual_o, base_o, has) with has = both
        # in-read and the shifted column in range.
        jo = col - shift
        in_range = (jo >= 0) & (jo < L)
        joc = np.clip(jo, 0, L - 1)
        q_o = np.take_along_axis(q_other, joc, 1)
        b_o = np.take_along_axis(s_other, joc, 1)
        has = in_range & (col < nv_self) & (jo < nv_other)
        return q_o, b_o, has

    # The five outcome categories partition every overlapped position
    # (differ → a-wins / b-wins / zero-both; agree → a-wins / b-wins), so
    # each side's new qual is a two-level select — no np.select temporaries.
    qa = qa_orig
    ba = seq_a
    qb_al, bb_al, has_a = aligned_views(qb_orig, seq_b, nv_a, nv_b, d)
    differ = ba != bb_al
    awins_d = differ & (qa > qb_al) & (ba != N)
    awins_s = ~differ & (qa > qb_al)
    new_qa = np.where(awins_d, qa - qb_al,
                      np.where(awins_s, QUAL_BOOST[qa], 0))
    qual[a_idx] = np.where(has_a, new_qa, qa).astype(np.uint8)

    qb = qb_orig
    bb = seq_b
    qa_al, ba_al, has_b = aligned_views(qa_orig, seq_a, nv_b, nv_a, -d)
    differ = ba_al != bb
    awins_d = differ & (qa_al > qb) & (ba_al != N)
    bwins_d = differ & ~awins_d & (qb > qa_al) & (bb != N)
    bwins_s = ~differ & (qa_al <= qb)
    new_qb = np.where(bwins_d, qb - qa_al,
                      np.where(bwins_s, QUAL_BOOST[qb], 0))
    qual[b_idx] = np.where(has_b, new_qb, qb).astype(np.uint8)


# ----------------------------------------------------------- methylation call

def meth_state(seq, qual, strand_arr, min_phred):
    """updateMetrics/getMethylState vectorized over [N, L]:
    +1 methylated, -1 unmethylated, 0 uninformative."""
    odd = (strand_arr.astype(np.int64) & 1)[:, None] == 1
    passing = qual >= min_phred
    state = np.zeros(seq.shape, dtype=np.int8)
    state[passing & odd & (seq == C)] = 1
    state[passing & odd & (seq == T)] = -1
    state[passing & ~odd & (seq == G)] = 1
    state[passing & ~odd & (seq == A)] = -1
    return state


# ------------------------------------------------------ conversion efficiency

def conversion_efficiency(seq, qual, refpos, strand_arr, ref_window, win_offset,
                          min_phred):
    """computeConversionEfficiency (common.c:361-404) per read.

    Counts meth/unmeth states at CHG+CHH (non-CpG) reference positions over
    the read's aligned bases, truncated at the end of the fetched reference
    window; efficiency = unmeth/(meth+unmeth), or 1.0 with no sites.
    Uses *pre-trimming* quals (filter_func order, common.c:442 vs :458).
    """
    seqlen = len(ref_window)
    seq_end = win_offset + seqlen
    ctype, _ = classify_context(ref_window)
    aligned = (refpos >= 0) & (refpos < seq_end)
    # The C also never looks left of the window start; refpos < win_offset
    # cannot happen for reads fetched for this window except via clipping
    # quirks — guard anyway.
    aligned &= refpos >= win_offset
    idx = np.where(aligned, refpos - win_offset, 0)
    ct = np.where(aligned, ctype[idx], CTX_NONE)
    state = meth_state(seq, qual, strand_arr, min_phred)
    informative = aligned & ((ct == CTX_CHG) | (ct == CTX_CHH))
    n_meth = ((state > 0) & informative).sum(axis=1)
    n_unmeth = ((state < 0) & informative).sum(axis=1)
    total = n_meth + n_unmeth
    with np.errstate(invalid="ignore", divide="ignore"):
        eff = np.where(
            total == 0,
            np.float32(1.0),
            n_unmeth.astype(np.float32) / total.astype(np.float32),
        )
    return eff.astype(np.float32)


# ----------------------------------------------------------------- filtering

def filter_reads(cfg, batch, strand_arr, mappability=None):
    """filter_func stages 1-10 (common.c:412-431) as one boolean mask.

    BED prefilter, conversion efficiency and trimming are applied by the
    caller (they need window context / mutate the batch). Returns
    (keep, flag) where flag has the discordant-pair bit patch applied
    (common.c:431)."""
    flag = batch.flag.astype(np.uint32).copy()
    keep = np.ones(batch.n, dtype=bool)
    keep &= ~((batch.tid == -1) | ((flag & 0x4) != 0))          # unmapped
    keep &= batch.mapq >= cfg.minMapq                            # -q
    keep &= (flag & cfg.ignoreFlags) == 0                        # -F
    if cfg.requireFlags:
        keep &= (flag & cfg.requireFlags) == cfg.requireFlags    # -R
    if not cfg.keepDupes:
        keep &= (flag & 0x400) == 0
    if not cfg.ignoreNH:
        keep &= ~(batch.nh > 1)                                  # multimappers
    if cfg.filterMappability and mappability is not None:
        keep &= check_mappability(cfg, batch, mappability)
    if not cfg.keepSingleton:
        keep &= (flag & 0x9) != 0x9
    if not cfg.keepDiscordant:
        keep &= (flag & 0x3) != 0x1
    promote = (flag & 0x9) == 0x1
    flag = np.where(promote, flag | 0x2, flag)
    return keep, flag.astype(np.uint16)


# Two-level bit-rank structure for mappability tracks. A flat int64 prefix
# sum over a 100 Mb chromosome is an ~800 MB allocation that thrashes small
# hosts; packing the track to bits (L/8 bytes) plus an in-block uint16
# exclusive byte-prefix and a block-level int64 prefix costs ~L/2.6 bytes
# total (~38 MB for 100 Mb) with O(1) rank queries.
_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)
# _MASK_HI[r] keeps the top r bits of a (big-endian packed) byte; r=0 → 0.
_MASK_HI = np.array([(0xFF << (8 - r)) & 0xFF if r else 0 for r in range(8)],
                    dtype=np.uint8)
_MAPP_BLOCK_BYTES = 512  # 4096 bits/block → in-block prefix fits uint16


def _build_mapp_rank(bits):
    """Build (packed, inblock_excl, block_pref, L) rank index for a 0/1
    track. rank(x) = #set bits in bits[:x] for 0 <= x <= L."""
    bits = np.asarray(bits, dtype=bool)
    L = len(bits)
    packed = np.packbits(bits)  # big-endian within each byte
    BB = _MAPP_BLOCK_BYTES
    # +1 spare block so byte index len(packed) (x == L, L % 8 == 0) is valid
    nblocks = (len(packed) + BB - 1) // BB + 1
    byte_pop = np.zeros(nblocks * BB, dtype=np.uint16)
    byte_pop[: len(packed)] = _POP8[packed]
    blocks = byte_pop.reshape(nblocks, BB)
    inc = np.cumsum(blocks, axis=1, dtype=np.uint16)  # block max 4096 < 2^16
    block_pref = np.zeros(nblocks + 1, dtype=np.int64)
    np.cumsum(inc[:, -1], dtype=np.int64, out=block_pref[1:])
    inblock_excl = np.zeros_like(inc)
    inblock_excl[:, 1:] = inc[:, :-1]
    return packed, inblock_excl.reshape(-1), block_pref, L


def _mapp_rank(idx, x):
    """Vectorized rank over the _build_mapp_rank structure (x in [0, L])."""
    packed, inblock_excl, block_pref, _L = idx
    nb = x >> 3
    rem = x & 7
    f = block_pref[nb // _MAPP_BLOCK_BYTES] + inblock_excl[nb]
    pb = packed[np.minimum(nb, len(packed) - 1)]
    return f + _POP8[pb & _MASK_HI[rem]]


def check_mappability(cfg, batch, mappability):
    """check_mappability (common.c:277-335): a read passes if either mate's
    assumed span (mate span approximated with this read's l_qseq) contains
    >= minMappableBases mappable bases. Spans starting at a negative
    coordinate (unmapped mate, mpos=-1) read as all-unmappable, matching the
    uint32 wraparound in the C.

    Vectorized: per-chromosome two-level bit-rank indexes (cached on cfg)
    turn each span count into O(1) lookups, so reference-scale tracks
    (whole human Bismap) cost O(reads) time and ~L/2.6 bytes memory."""
    out = np.zeros(batch.n, dtype=bool)
    if cfg.minMappableBases <= 0:
        # span counts are always >= 0, so every read passes (loop parity:
        # `cnt >= minMappableBases` with cnt = 0 still increments ok)
        out[:] = True
        return out
    cache = getattr(cfg, "_mapp_rank_by_tid", None)
    if cache is None:
        cache = cfg._mapp_rank_by_tid = {}
    lq = np.asarray(batch.l_qseq, np.int64)
    pos = np.asarray(batch.pos, np.int64)
    mpos = np.asarray(batch.mpos, np.int64)
    min_ok = cfg.minMappableBases
    for tid in np.unique(np.asarray(batch.tid)):
        tid = int(tid)
        bits = mappability.get(tid)
        if bits is None:
            continue  # both spans count 0 → filtered (out stays False)
        idx = cache.get(tid)
        if idx is None:
            idx = cache[tid] = _build_mapp_rank(bits)
        rows = np.nonzero(np.asarray(batch.tid) == tid)[0]
        L = idx[3]

        def span_count(s):
            e0 = np.clip(s + lq[rows], 0, L)
            s0 = np.clip(s, 0, L)
            return np.where(
                s < 0, 0,
                _mapp_rank(idx, e0) - _mapp_rank(idx, np.minimum(s0, e0)))

        out[rows] = (span_count(pos[rows]) >= min_ok) | (
            span_count(mpos[rows]) >= min_ok)
    return out


# ------------------------------------------------------------------- pileup

def pileup_channels(seq, qual, refpos, strand_arr, keep_base, ref_window,
                    win_offset, win_start, win_end, min_phred):
    """The hot loop: per-column tally of extractCalls (extract.c:420-441)
    as a 4-channel scatter-add over [win_start, win_end).

    Channels: meth, unmeth, opposite-strand coverage, opposite-strand
    variants. keep_base lets callers mask per-base contributions (BED strand
    filtering). Returns uint32 [W, 4].
    """
    W = win_end - win_start
    counters = np.zeros((W, 4), dtype=np.uint32)
    valid = (refpos >= win_start) & (refpos < win_end) & keep_base
    if not valid.any():
        return counters
    # Stay 2D throughout: nearly every base is in-window, so boolean-mask
    # extraction of the big arrays costs full gathers without shrinking the
    # later elementwise work. Gather only the final (small) channel sets,
    # then one bincount over a fused (position, channel) index (bincount is
    # ~10x faster than the np.add.at scatter-add it replaces).
    widx = np.where(valid, refpos - win_offset, 0)
    refbase = ref_window[widx]
    sodd = (strand_arr & 1)[:, None] == 1
    calling = np.where(sodd, refbase == REF_C, refbase == REF_G)
    act = valid & (qual >= min_phred)

    meth_b = np.where(sodd, seq == C, seq == G)
    unmeth_b = np.where(sodd, seq == T, seq == A)
    on = act & calling
    off = act & ~calling
    variant = off & ~np.where(sodd, (seq == G) | (seq == N), (seq == C) | (seq == N))

    rp4 = np.where(valid, refpos - win_start, 0).astype(np.int64) * 4
    flat = np.concatenate([
        rp4[on & meth_b] + CH_METH, rp4[on & unmeth_b] + CH_UNMETH,
        rp4[off] + CH_OFF, rp4[variant] + CH_VARIANT,
    ])
    counters += np.bincount(flat, minlength=W * 4).reshape(W, 4).astype(np.uint32)
    return counters


# -------------------------------------------------------------------- mbias

def mbias_counters(seq, qual, refpos, strand_arr, flag, keep_base, ref_window,
                   win_offset, win_start, win_end, keep_ctx, min_phred, max_len):
    """extractMBias counter loop (MBias.c:180-214): uint32 counters of shape
    [4 strands, 2 reads, 2 states(meth, unmeth), max_len read cycles]."""
    counters = np.zeros((4, 2, 2, max_len), dtype=np.uint32)
    ctype, _ = classify_context(ref_window)
    valid = (refpos >= win_start) & (refpos < win_end) & keep_base
    if not valid.any():
        return counters
    widx = refpos - win_offset
    widx = np.where(valid, widx, 0)
    ct = np.where(valid, ctype[widx], CTX_NONE)
    ctx_ok = np.zeros(ct.shape, dtype=bool)
    for t, k in ((CTX_CPG, keep_ctx[0]), (CTX_CHG, keep_ctx[1]), (CTX_CHH, keep_ctx[2])):
        if k:
            ctx_ok |= ct == t
    refbase = np.where(valid, ref_window[widx], 0)
    sodd = (strand_arr.astype(np.int64) & 1)[:, None] == 1
    calling = np.where(sodd, refbase == REF_C, refbase == REF_G)
    state = meth_state(seq, qual, strand_arr, min_phred)
    use = valid & ctx_ok & calling & (state != 0)
    if not use.any():
        return counters
    qpos = np.broadcast_to(np.arange(seq.shape[1])[None, :], seq.shape)[use]
    s_idx = np.broadcast_to((strand_arr - 1)[:, None], seq.shape)[use]
    r_idx = np.broadcast_to(((flag & 0x80) != 0)[:, None], seq.shape)[use].astype(np.int64)
    m_idx = (state[use] < 0).astype(np.int64)  # 0 = meth, 1 = unmeth
    flat = ((s_idx * 2 + r_idx) * 2 + m_idx) * max_len + qpos
    counters += np.bincount(flat, minlength=16 * max_len).reshape(
        4, 2, 2, max_len).astype(np.uint32)
    return counters
