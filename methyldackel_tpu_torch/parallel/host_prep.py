"""JAX-free host preparation for the port's window programs.

``methyldackel_tpu/parallel/device.py`` keeps its host helpers beside its JAX
code and imports jax at module scope, so the port carries its own copies of
the ones the port's window programs run (row classification, mate pairing
and overlap arbitration, the 2-bit semantic and 4-bit nibble packs, the v2
pair table, the reference bitmaps, the context candidate mask, the row and
tile tables) over the same native kernels (``io.native``) and the
same numpy fallbacks.

Not carried over: the shape-bucket high-water floors, the row-count
padding and the prewarm of the reference, which exist only to bound XLA
recompiles. The port's shapes are exact. The CSLOT and Lc ladders stay: they
fix the candidate-space geometry and decide when it falls back to window
space.
"""
from __future__ import annotations

import numpy as np

from ..io import native
from ..ops import semantics as sem

REF_C, REF_G = ord("C"), ord("G")
T = 512  # window columns per kernel tile


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ctx_code(cfg) -> int:
    """Context selector (device.py:1006): bit 0 = CpG, bit 1 = CHG, bit 2 =
    CHH; 7 = every C/G position (cytosine_report reads them all)."""
    if getattr(cfg, "cytosine_report", False):
        return 7
    return ((1 if cfg.keepCpG else 0) | (2 if cfg.keepCHG else 0)
            | (4 if cfg.keepCHH else 0))


def ctx_mask_np(cb, gb, ctx: int, slot):
    """Candidate mask over window coordinates (device.py:1017): positions
    whose reference context is ctx-selected, the only positions emit_window
    reads. ``slot`` is the window extent, or (period, data) for grouped
    slots. Positions within 2 of a slot start or 8 of its data end keep the
    full C|G rule, a superset of what emit reads there."""
    cb = np.asarray(cb, bool)
    gb = np.asarray(gb, bool)
    if ctx == 7:
        return cb | gb
    period, data = slot if isinstance(slot, tuple) else (slot, slot)
    W = len(cb)
    g1 = np.zeros(W, bool)
    g1[:-1] = gb[1:]
    g2 = np.zeros(W, bool)
    g2[:-2] = gb[2:]
    c1 = np.zeros(W, bool)
    c1[1:] = cb[:-1]
    c2 = np.zeros(W, bool)
    c2[2:] = cb[:-2]
    m = np.zeros(W, bool)
    if ctx & 1:
        m |= (cb & g1) | (gb & c1)
    if ctx & 2:
        m |= (cb & ~g1 & g2) | (gb & ~c1 & c2)
    if ctx & 4:
        m |= (cb & ~g1 & ~g2) | (gb & ~c1 & ~c2)
    pos = np.arange(W, dtype=np.int64) % period
    guard = (pos < 2) | (pos >= data - 8)
    return np.where(guard, cb | gb, m)


# Candidate-slot capacity ladder, in sixteenths of the window (device.py:1092)
_NCAND_FRACS = (1, 3, 6, 10)


def ncand_bucket(count: int, wtot: int) -> int:
    """Smallest ladder bucket >= count; 0 when count is above the 5/8 cap
    (extraordinary GC: the caller takes the window-space program)."""
    need = max(count, 1)
    for f in _NCAND_FRACS:
        b = round_up(max(wtot * f // 16, 128), 128)
        if b >= need:
            return b
    return 0


# Per-read candidate-slot width ladder (device.py:1213)
_LC_LADDER = (16, 32, 48, 64, 96, 128)


def lc_bucket(need: int) -> int:
    """Smallest ladder width >= need; 0 when a read covers more than 128
    candidate slots (the caller takes the window-space program)."""
    need = max(need, 1)
    for b in _LC_LADDER:
        if b >= need:
            return b
    return 0


def rows_gapless(refpos, pos, l_qseq):
    """Rows whose aligned positions are exactly pos+j for j < l_qseq
    (device.py:1544)."""
    N, L = refpos.shape
    lq = np.asarray(l_qseq, np.int64)
    rows = np.arange(N)
    first_ok = refpos[:, 0] == pos
    last_ok = refpos[rows, np.clip(lq - 1, 0, L - 1)] == pos + lq - 1
    col = np.arange(L, dtype=np.int64)[None, :]
    any_gap = ((refpos < 0) & (col < lq[:, None])).any(axis=1)
    return np.where(lq > 0, first_ok & last_ok & ~any_gap, True)


def rows_no_eq_base(seq, l_qseq):
    """Rows free of base code 0 ('=', match to the reference)
    (device.py:1561)."""
    L = seq.shape[1]
    col = np.arange(L, dtype=np.int64)[None, :]
    lq = np.asarray(l_qseq, np.int64)[:, None]
    return ~((seq == 0) & (col < lq)).any(axis=1)


def _rows_and_pairs(batch, strand_arr, kidx, copy_qual):
    """The kept rows (views when every row is kept; ``qual`` copied on
    request), their gapless/no-'=' flags, the mate pairs, the pairs whose
    mates are both simple, and the hard rows: the non-simple ones and both
    mates of a pair holding one (device.py:2418-2451)."""
    if len(kidx) == batch.n:
        seq = batch.seq
        qual = batch.qual.copy() if copy_qual else batch.qual
        refpos = batch.refpos
        pos = batch.pos
        lq = batch.l_qseq
    else:
        seq = batch.seq[kidx]
        qual = batch.qual[kidx]
        refpos = batch.refpos[kidx]
        pos = batch.pos[kidx]
        lq = batch.l_qseq[kidx]
    st = strand_arr[kidx].astype(np.int32)

    simple = native.v3_flags(seq, refpos, pos, lq)
    if simple is None:
        simple = rows_gapless(refpos, pos, lq) & rows_no_eq_base(seq, lq)
    a_np, b_np = sem.pair_mates_batch(batch, kidx)
    pair_simple = np.ones(len(a_np), bool)
    hard = ~simple
    if len(a_np):
        pair_simple = simple[a_np] & simple[b_np]
        hard[a_np[~pair_simple]] = True
        hard[b_np[~pair_simple]] = True
    return (seq, qual, refpos, pos, lq, st, simple, hard, a_np, b_np,
            pair_simple)


def prep_v2_rows(cfg, batch, strand_arr, keep, kidx):
    """Row selection, gapless classification and mate pairing of the v2
    window program, without host arbitration (device.py:2418-2451): the
    card arbitrates the simple pairs, the host fold the hard ones. Returns
    (seq, qual, refpos, pos, lq, st, hard_rows, a, b, pair_simple); the
    arrays are views of the batch when every row is kept, never mutated."""
    (seq, qual, refpos, pos, lq, st, _simple, hard, a_np, b_np,
     pair_simple) = _rows_and_pairs(batch, strand_arr, kidx, False)
    return seq, qual, refpos, pos, lq, st, hard, a_np, b_np, pair_simple


def v2_pair_tables(al_s, st_s, pa_f, pb_f):
    """The pairs the card arbitrates, of ``_fused_dispatch``
    (device.py:2613-2623) in the sorted row frame: mate a is the one with
    the smaller 128-aligned start (a swap only when strictly greater, so
    pairs in one 128-block keep ``pair_mates_batch`` order: b wins a qual
    tie on the same base, and b may start left of a), and a pair is listed
    when both mates have the same strand parity and their aligned starts
    are 0-2 blocks apart; the others are left alone. Returns (pa, pb) int32,
    the eligible pairs only."""
    al_s = np.asarray(al_s, np.int64)
    st_s = np.asarray(st_s, np.int64)
    swap = al_s[pa_f] > al_s[pb_f]
    pa = np.where(swap, pb_f, pa_f)
    pb = np.where(swap, pa_f, pb_f)
    sh = (al_s[pb] - al_s[pa]) // 128
    elig = (((st_s[pa] - st_s[pb]) & 1) == 0) & (sh >= 0) & (sh <= 2)
    return pa[elig].astype(np.int32), pb[elig].astype(np.int32)


def prep_v3_rows(cfg, batch, strand_arr, keep, kidx):
    """Row selection, gapless classification, mate pairing and host overlap
    arbitration (device.py:2308; overlaps.c:54-119). Returns (seq, qual,
    refpos, pos, lq, st, hard_rows) with ``qual`` arbitrated; hard rows
    (indels, '=' bases, pairs holding one) are left to the host oracle. The
    caller's batch is never mutated (qual is copied)."""
    (seq, qual, refpos, pos, lq, st, simple, hard, a_np, b_np,
     _ps) = _rows_and_pairs(batch, strand_arr, kidx, True)

    a_t, b_t = sem.touching_pairs(batch.pos[kidx], batch.endpos[kidx],
                                  a_np, b_np)
    if len(a_t):
        fb = native.arbitrate2(seq, qual, refpos, st, lq, simple, a_t, b_t)
        if fb is None:
            fb = native.arbitrate(seq, qual, refpos, st, a_t, b_t)
        if fb is None:
            sem.arbitrate_overlaps(seq, qual, refpos, st, a_t, b_t)
        elif len(fb):
            sem._arbitrate_pairs_loop(seq, qual, refpos, st,
                                      np.asarray(a_t)[fb],
                                      np.asarray(b_t)[fb])
    return seq, qual, refpos, pos, lq, st, hard


def ref_padded(ref_window, ref_static: int) -> np.ndarray:
    """The window's reference bytes in a zero-padded [ref_static] buffer."""
    ref_p = np.zeros(ref_static, np.uint8)
    rw = np.asarray(ref_window, np.uint8)
    n = min(len(rw), ref_static)
    ref_p[:n] = rw[:n]
    return ref_p


def ref_bits(ref_p, woff: int, wpad: int):
    """(isc, isg): np.packbits bitmaps of window columns whose reference
    base, after the woff frame shift, is C / G."""
    rb = native.v3_refbits(ref_p, woff, wpad)
    if rb is not None:
        return rb
    idx = np.arange(wpad, dtype=np.int64) - woff
    inr = (idx >= 0) & (idx < len(ref_p))
    rbw = np.where(inr, ref_p[np.clip(idx, 0, len(ref_p) - 1)], 0)
    return np.packbits(rbw == REF_C), np.packbits(rbw == REF_G)


def unpack_mask(bits, n: int) -> np.ndarray:
    return np.unpackbits(bits)[:n] != 0


def candidates(isc, isg, wpad: int, ctx: int):
    """(cand int64 [C], csum int32 [wpad+1]) of one window. ``cand`` is a
    copy: the native result is a view pinning a [wpad] buffer."""
    got = native.v3_candidates(isc, isg, wpad, ctx)
    if got is not None:
        cand, csum = got
        return cand.copy(), csum
    mask = ctx_mask_np(unpack_mask(isc, wpad), unpack_mask(isg, wpad), ctx,
                       wpad)
    csum = np.zeros(wpad + 1, np.int32)
    np.cumsum(mask, dtype=np.int32, out=csum[1:])
    return np.nonzero(mask)[0].astype(np.int64), csum


def row_spos(start, parity) -> np.ndarray:
    """One int32 per row of the window programs: 2 * start + parity, the
    column of the row's first code (may be negative) and its strand parity
    in bit 0."""
    return (2 * np.asarray(start, np.int64)
            + (np.asarray(parity, np.int64) & 1)).astype(np.int32)


def tile_rows(start_sorted, ntiles: int, Lc: int):
    """Per-tile row ranges of the pileup kernels over rows sorted by their
    start column: rows [tlo[t], thi[t]) are those whose Lc codes can reach
    tile t, t*T - Lc < start < (t+1)*T. Returns int32 (tlo, thi) [ntiles].
    The kernels find each column's rows by a search that relies on the
    order, so starts that decrease anywhere raise ValueError."""
    start = np.asarray(start_sorted, np.int64)
    if len(start) > 1 and bool((start[1:] < start[:-1]).any()):
        raise ValueError("rows are not sorted by their start column: the "
                         "pileup kernels need position-sorted rows")
    lo = np.arange(ntiles, dtype=np.int64) * T
    tlo = np.searchsorted(start, lo - Lc, side="right").astype(np.int32)
    thi = np.searchsorted(start, lo + T, side="left").astype(np.int32)
    return tlo, thi


def window_tables(start, parity, ntiles: int, Lc: int):
    """(order, spos, tlo, thi) of one window's rows for the pileup
    kernels: the stable sort by start column (the identity for a
    coordinate-sorted batch) and the row and tile tables in that order."""
    start = np.asarray(start, np.int64)
    if len(start) < 2 or bool((start[1:] >= start[:-1]).all()):
        order = np.arange(len(start))
    else:
        order = np.argsort(start, kind="stable")
    start = start[order]
    tlo, thi = tile_rows(start, ntiles, Lc)
    return order, row_spos(start, np.asarray(parity)[order]), tlo, thi


def semantic_codes(seq, qual, st, min_phred: int):
    """Phred-gated 2-bit semantic codes (1 = the strand's methylated base,
    2 = its unmethylated base, 0 = other) and the row parities."""
    par = (st & 1).astype(np.uint8)
    mc = np.where(par == 1, 2, 4).astype(np.uint8)[:, None]
    uc = np.where(par == 1, 8, 1).astype(np.uint8)[:, None]
    g = np.where(qual >= min_phred, seq, 0).astype(np.uint8)
    v = np.where(g == mc, 1, np.where(g == uc, 2, 0)).astype(np.uint8)
    return v, par


def pack4(v) -> np.ndarray:
    """Four 2-bit codes per byte, code j in bits 2*(j&3)."""
    return v[:, 0::4] | (v[:, 1::4] << 2) | (v[:, 2::4] << 4) | (v[:, 3::4] << 6)


def pack2_rows(seq, qual, src, pos, st, Lq: int, win_start: int,
               min_phred: int, out) -> None:
    """Window-space 2-bit pack of rows ``src`` into ``out`` = (seqpack
    [n, Lq], pos_p [n], parity_p [n]) views; pos_p = pos - win_start."""
    n = len(src)
    if native.v3_pack2(seq, qual, src, pos, st, Lq, n, win_start, min_phred,
                       out=out) is not None:
        return
    seqpack, pos_p, parity_p = out
    v, par = semantic_codes(seq[src], qual[src], st[src], min_phred)
    L4 = 4 * Lq
    if L4 != v.shape[1]:
        v = np.concatenate([v, np.zeros((n, L4 - v.shape[1]), np.uint8)],
                           axis=1)
    seqpack[:] = pack4(v)
    pos_p[:] = pos[src] - win_start
    parity_p[:] = par


def pack4bit_rows(seq, qual, src, pos, st, Lh: int, win_start: int,
                  min_phred: int):
    """The NCH=4 window-space pack (device.py:1312-1328): rows ``src``
    phred pre-gated (a base under min_phred becomes code 0) and packed two
    codes to a byte, code 2j in the low nibble of byte j. Returns (seqpack
    [n, Lh], pos_p = pos - win_start, parity_p)."""
    n = len(src)
    if n:
        nat = native.v3_pack(seq, qual, src, pos, st, Lh, n, win_start,
                             min_phred)
        if nat is not None:
            return nat
    f_seq = np.where(qual[src] >= min_phred, seq[src], 0).astype(np.uint8)
    if 2 * Lh != f_seq.shape[1]:
        f_seq = np.concatenate(
            [f_seq, np.zeros((n, 2 * Lh - f_seq.shape[1]), np.uint8)], axis=1)
    seqpack = np.ascontiguousarray(f_seq[:, 0::2] | (f_seq[:, 1::2] << 4))
    pos_p = (pos[src] - win_start).astype(np.int32)
    parity_p = (st[src] & 1).astype(np.uint8)
    return seqpack, pos_p, parity_p


def pack2_cand_rows(seq, qual, src, pos, st, Lq: int, win_start: int,
                    min_phred: int, cand, csum, wpad: int, slot0: int,
                    f_pos, s0, cnt, out) -> None:
    """Candidate-space 2-bit pack: row r's slots [s0, s0+cnt) get its codes
    at the candidate offsets; pos_p = s0 + slot0."""
    if native.v3_pack2_cand(seq, qual, src, pos, st, Lq, win_start,
                            min_phred, cand, csum, wpad, slot0,
                            out=out) is not None:
        return
    seqpack, pos_p, parity_p = out
    n = len(src)
    L = seq.shape[1]
    L4 = 4 * Lq
    v, par = semantic_codes(seq[src], qual[src], st[src], min_phred)
    vv = np.zeros((n, L4), np.uint8)
    C = len(cand)
    if C:
        j = np.arange(L4, dtype=np.int64)[None, :]
        slotpos = s0[:, None] + j
        valid = j < cnt[:, None]
        coff = np.clip(cand[np.minimum(slotpos, C - 1)] - f_pos[:, None],
                       0, L - 1)
        vv = np.where(valid, v[np.arange(n)[:, None], coff], 0).astype(
            np.uint8)
    seqpack[:] = pack4(vv)
    pos_p[:] = (s0 + slot0).astype(np.int32)
    parity_p[:] = par


def packed_tables(seqpack, pos_p, parity_p, ntiles: int):
    """(seqpack, spos, tlo, thi) of a 2-bit pack for ``pileup2_tiles``: the
    rows in the order of their start column ``pos_p`` (a stable sort; the
    arrays themselves for coordinate-sorted input, whose starts already do
    not decrease, also across the slots of a group) with their row and tile
    tables."""
    if len(pos_p) > 1 and bool((pos_p[1:] < pos_p[:-1]).any()):
        order = np.argsort(pos_p, kind="stable")
        seqpack = seqpack[order]
        pos_p, parity_p = pos_p[order], parity_p[order]
    tlo, thi = tile_rows(pos_p, ntiles, 4 * seqpack.shape[1])
    return seqpack, row_spos(pos_p, parity_p), tlo, thi
