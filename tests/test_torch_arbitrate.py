"""The port's mate-overlap arbitration (methyldackel_tpu_torch.ops.arbitrate)
against the JAX package: its plain PyTorch version must equal the CPU twin
of the TPU kernel (device._arbitrate_pallas_interpret, the _arb_kernel body
on the phase-aligned split-mate layout), its XLA twin
(device.arbitrate_prealigned) and the host oracle
(semantics.arbitrate_overlaps) exactly — quals are bytes, so the tolerance
is 0. The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_card.py, and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.ops.pileup_pallas import prealign_reads
from methyldackel_tpu.parallel import device as jdev
from methyldackel_tpu_torch.ops import arbitrate as ta
from methyldackel_tpu_torch.parallel import host_prep as hp

from chip_smoke import ARBITRATE_EDGE_CASES, arbitrate_edge_inputs

BASES = np.array([1, 2, 4, 8, 15], np.uint8)


def _pairs(seed, P, L, *, max_delta=330, hi_qual=False):
    """P mate pairs (rows 2i, 2i+1) plus a few unpaired rows: mate
    distances that give block shifts 0-3 either way round, ragged read
    ends, N bases, qual ties, quals 200-255 when ``hi_qual``, and some
    pairs on different strand parities (left alone)."""
    rng = np.random.default_rng(seed)
    n = 2 * P + 5
    seq = BASES[rng.choice(5, (n, L), p=[0.3, 0.2, 0.2, 0.25, 0.05])]
    lo, hi = (200, 256) if hi_qual else (0, 61)
    qual = rng.integers(lo, hi, (n, L)).astype(np.uint8)
    f_pos = rng.integers(-200, 3000, n).astype(np.int64)
    delta = rng.integers(-max_delta, max_delta + 1, P)
    f_pos[1 : 2 * P : 2] = f_pos[0 : 2 * P : 2] + delta
    # same bases and quals on the shared positions of some pairs: ties
    for i in range(0, P, 3):
        a, b = 2 * i, 2 * i + 1
        d = int(f_pos[b] - f_pos[a])
        ia = np.arange(max(0, d), min(L, L + d))
        if len(ia):
            seq[b, ia - d] = seq[a, ia]
            qual[b, ia - d] = qual[a, ia]
    lq = rng.integers(L - 15, L + 1, n)
    past = np.arange(L)[None, :] >= lq[:, None]
    seq[past] = 0
    qual[past] = 0
    st = rng.integers(1, 3, n).astype(np.int64)
    st[1 : 2 * P : 2] = st[0 : 2 * P : 2]
    st[1 : 2 * P : 7] ^= 3  # a parity mismatch: code 3
    a_np = np.arange(0, 2 * P, 2)
    return seq, qual, f_pos, st, lq, a_np, a_np + 1


def _sorted_frame(seq, qual, f_pos, st, a_np, b_np):
    """The v2 program's frame: rows sorted by start column, the pairs of
    host_prep.v2_pair_tables (the eligible ones only) and, for the JAX
    twins, their block-shift code 0-2."""
    order = np.argsort(f_pos, kind="stable")
    frame = np.empty(len(order), np.int64)
    frame[order] = np.arange(len(order))
    aligned = (f_pos - f_pos % 128)[order]
    pa, pb = hp.v2_pair_tables(aligned, st[order], frame[a_np], frame[b_np])
    code = ((aligned[pb] - aligned[pa]) // 128).astype(np.uint8)
    return (seq[order], qual[order], f_pos[order], st[order], pa, pb, code,
            order)


def _port(seq_s, qual_s, f_pos_s, st_s, pa, pb):
    spos = hp.row_spos(f_pos_s, st_s & 1)
    q = torch.from_numpy(qual_s.copy())
    out = ta.arbitrate(torch.from_numpy(seq_s), q, torch.from_numpy(spos),
                       torch.from_numpy(pa), torch.from_numpy(pb))
    assert out is q
    return q.numpy()


@pytest.mark.parametrize("seed,P,L,hi_qual", [(1, 120, 150, False),
                                              (2, 90, 101, True),
                                              (3, 60, 64, False),
                                              (4, 80, 200, True)])
def test_matches_arb_kernel_and_xla_twin(seed, P, L, hi_qual):
    seq, qual, f_pos, st, _lq, a_np, b_np = _pairs(seed, P, L,
                                                  hi_qual=hi_qual)
    seq_s, qual_s, f_pos_s, st_s, pa, pb, code, _o = _sorted_frame(
        seq, qual, f_pos, st, a_np, b_np)
    assert set(np.unique(code)) == {0, 1, 2} and 0 < len(pa) < P
    assert (f_pos_s[pb] < f_pos_s[pa]).any()  # b left of a in one block
    got = _port(seq_s, qual_s, f_pos_s, st_s, pa, pb)

    seq_a, qual_a, aligned, _par = prealign_reads(seq_s, qual_s, f_pos_s,
                                                  st_s)
    LP2 = seq_a.shape[1]
    sa = seq_a[pa] | (code[:, None] << 6)
    na, nb = jdev._arbitrate_pallas_interpret(sa, qual_a[pa], seq_a[pb],
                                              qual_a[pb], LP2, 2)
    ph = (f_pos_s % 128).astype(np.int64)
    cols = np.arange(L)[None, :]
    np.testing.assert_array_equal(got[pa], na[np.arange(len(pa))[:, None],
                                              ph[pa][:, None] + cols])
    np.testing.assert_array_equal(got[pb], nb[np.arange(len(pb))[:, None],
                                              ph[pb][:, None] + cols])
    lone = np.setdiff1d(np.arange(len(seq_s)), np.concatenate([pa, pb]))
    np.testing.assert_array_equal(got[lone], qual_s[lone])
    assert (got != qual_s).sum() > 100

    # the XLA twin on the adjacent-mate layout (a, b, a, b, ...)
    inter = np.stack([pa, pb], axis=1).reshape(-1)
    out = np.asarray(jdev.arbitrate_prealigned(
        jnp.asarray(seq_a[inter]), jnp.asarray(qual_a[inter]),
        jnp.asarray(aligned[inter]), jnp.asarray(st_s[inter]),
        jnp.asarray(np.full(len(inter), 0x1, np.uint16)), 2))
    np.testing.assert_array_equal(
        got[inter], out[np.arange(len(inter))[:, None],
                        ph[inter][:, None] + cols])


def test_matches_host_oracle():
    """Gapless mates: every overlapping pair of one strand parity is within
    two blocks, so the card's pairs are exactly the host oracle's. The
    roles decide qual ties (b wins), so the pairs come in the order
    pair_mates gives on coordinate-sorted input: a is the mate met first,
    the one with the smaller start, which the v2 table never swaps."""
    L = 150
    seq, qual, f_pos, st, lq, a_np, b_np = _pairs(7, 150, L)
    swap = f_pos[a_np] > f_pos[b_np]
    a_np, b_np = np.where(swap, b_np, a_np), np.where(swap, a_np, b_np)
    refpos = np.where(np.arange(L)[None, :] < lq[:, None],
                      f_pos[:, None] + np.arange(L)[None, :], -2)
    want = qual.copy()
    sem.arbitrate_overlaps(seq, want, refpos, st, a_np, b_np)
    seq_s, qual_s, f_pos_s, st_s, pa, pb, code, order = _sorted_frame(
        seq, qual, f_pos, st, a_np, b_np)
    got = _port(seq_s, qual_s, f_pos_s, st_s, pa, pb)
    np.testing.assert_array_equal(got, want[order])
    assert (want != qual).sum() > 100


def test_pad_does_not_zero_N():
    """tests/test_pallas_kernel.py:128: an N base (qual 30) of mate a facing
    no base of mate b keeps its qual."""
    L = 12
    seq = np.zeros((2, L), np.uint8)
    qual = np.zeros((2, L), np.uint8)
    seq[0] = [2, 8, 2, 8, 2, 8, 2, 8, 2, 8, 15, 2]
    qual[0] = 20
    qual[0, 10] = 30
    seq[1, :8] = [2, 8, 2, 8, 2, 8, 2, 8]
    qual[1, :8] = 25
    refpos = np.full((2, L), -2, np.int64)
    refpos[0] = np.arange(L)
    refpos[1, :8] = np.arange(8)
    st = np.array([1, 1], np.int64)
    want = qual.copy()
    sem.arbitrate_overlaps(seq, want, refpos, st, np.array([0]), np.array([1]))
    assert want[0, 10] == 30
    f_pos = np.zeros(2, np.int64)
    seq_s, qual_s, f_pos_s, st_s, pa, pb, code, order = _sorted_frame(
        seq, qual, f_pos, st, np.array([0]), np.array([1]))
    got = _port(seq_s, qual_s, f_pos_s, st_s, pa, pb)
    np.testing.assert_array_equal(got, want[order])
    assert got[order == 0][0, 10] == 30


def test_pair_table_roles_and_codes():
    """Mate a is the smaller aligned start, swapped only when strictly
    greater (a same-block pair keeps its order: b wins a tie); a pair with a
    parity mismatch or a shift past two blocks is not listed."""
    al = np.array([0, 0, 128, 256, 512, 128], np.int64)
    st = np.array([1, 1, 2, 2, 1, 1], np.int64)
    pa, pb = hp.v2_pair_tables(al, st, np.array([1, 3, 4, 5]),
                               np.array([0, 2, 0, 2]))
    np.testing.assert_array_equal(pa, [1, 2])
    np.testing.assert_array_equal(pb, [0, 3])
    assert pa.dtype == np.int32 and pb.dtype == np.int32
    none = hp.v2_pair_tables(al, st, np.zeros(0, np.int64),
                             np.zeros(0, np.int64))
    assert len(none[0]) == 0 and none[0].dtype == np.int32


def test_wrapper_checks_and_counts():
    seq = torch.zeros((4, 10), dtype=torch.uint8)
    spos = torch.zeros(4, dtype=torch.int32)
    idx = torch.tensor([0, 2], dtype=torch.int32)
    before = ta.LAUNCHES
    ta.arbitrate(seq, seq.clone(), spos, idx, idx + 1)
    assert ta.LAUNCHES == before
    with pytest.raises(TypeError):
        ta.arbitrate(seq, seq.clone(), spos, idx.long(), idx + 1)
    with pytest.raises(ValueError):
        ta.arbitrate(seq, seq[:, :5].contiguous(), spos, idx, idx + 1)
    with pytest.raises(ValueError):
        ta.arbitrate(seq, seq.clone(), spos, idx, (idx + 1)[:1])
    with pytest.raises(TypeError):
        ta.arbitrate(seq, seq.clone(), spos.to(torch.uint8), idx, idx + 1)


def _interpret_pair(seq, qual, f_pos, st, pa, pb):
    """_arb_kernel's CPU twin on explicit pairs, read back on the rows'
    own positions: (new quals of the a rows, of the b rows)."""
    L = seq.shape[1]
    seq_a, qual_a, aligned, _par = prealign_reads(seq, qual, f_pos, st)
    code = ((aligned[pb] - aligned[pa]) // 128).astype(np.uint8)
    na, nb = jdev._arbitrate_pallas_interpret(
        seq_a[pa] | (code[:, None] << 6), qual_a[pa], seq_a[pb], qual_a[pb],
        seq_a.shape[1], 2)
    ph = (f_pos % 128).astype(np.int64)
    cols = np.arange(L)[None, :]
    rows = np.arange(len(pa))[:, None]
    return na[rows, ph[pa][:, None] + cols], nb[rows, ph[pb][:, None] + cols]


def test_b_left_of_a_in_one_block_wins_ties():
    """Two mates in one 128-block keep pair_mates order, so b can start
    left of a (d < 0). On the same base and the same qual b gets the boost:
    deriving the roles from the exact starts would change bytes."""
    L = 40
    seq = np.tile(np.array([2, 8, 1, 4], np.uint8), (2, L // 4))
    qual = np.full((2, L), 30, np.uint8)
    f_pos = np.array([70, 50], np.int64)  # row 0 = a, row 1 = b, d = -20
    st = np.array([1, 1], np.int64)
    seq[1, 20:] = seq[0, : L - 20]  # the same bases on the 20 shared columns
    pa, pb = hp.v2_pair_tables(f_pos - f_pos % 128, st, np.array([0]),
                               np.array([1]))
    np.testing.assert_array_equal([pa, pb], [[0], [1]])
    got = _port(seq, qual, f_pos, st, pa, pb)
    np.testing.assert_array_equal(got[0, :20], 0)       # a loses the ties
    np.testing.assert_array_equal(got[1, 20:], 36)      # b: 30 + 30 // 5
    np.testing.assert_array_equal(got[0, 20:], 30)      # outside the overlap
    np.testing.assert_array_equal(got[1, :20], 30)
    wa, wb = _interpret_pair(seq, qual, f_pos, st, pa, pb)
    np.testing.assert_array_equal(got[0], wa[0])
    np.testing.assert_array_equal(got[1], wb[0])


@pytest.mark.parametrize("L", [36, 37, 151])
def test_odd_and_short_lengths_and_padded_rows(L):
    """L = 36, odd L, rows zero-padded past a short read (code 0 keeps its
    qual), every d from -127 to L: the plain version equals the CPU twin of
    the TPU kernel byte for byte, and changes nothing outside an overlap."""
    rng = np.random.default_rng(L)
    ds = np.arange(-127, L + 1)
    P = len(ds)
    n = 2 * P
    f_pos = np.empty(n, np.int64)
    # a's start in the upper part of its block when d < 0, so that b stays
    # in the same block (the only way the table keeps a negative d)
    f_pos[0::2] = 1024 * np.arange(P) + np.where(ds < 0, 127, 3)
    f_pos[1::2] = f_pos[0::2] + ds
    seq = BASES[rng.choice(5, (n, L), p=[0.3, 0.2, 0.2, 0.25, 0.05])]
    qual = rng.integers(0, 256, (n, L)).astype(np.uint8)
    lq = rng.integers(1, L + 1, n)
    past = np.arange(L)[None, :] >= lq[:, None]
    seq[past] = 0
    st = np.ones(n, np.int64)
    a_np = np.arange(0, n, 2)
    pa, pb = hp.v2_pair_tables(f_pos - f_pos % 128, st, a_np, a_np + 1)
    assert len(pa) == P and (pa == a_np).all()
    got = _port(seq, qual, f_pos, st, pa, pb)
    wa, wb = _interpret_pair(seq, qual, f_pos, st, pa, pb)
    np.testing.assert_array_equal(got[pa], wa)
    np.testing.assert_array_equal(got[pb], wb)
    i = np.arange(L)[None, :]
    d = ds[:, None]
    in_a = (i >= d) & (i < L + d)
    in_b = (i + d >= 0) & (i + d < L)
    np.testing.assert_array_equal(got[pa][~in_a], qual[pa][~in_a])
    np.testing.assert_array_equal(got[pb][~in_b], qual[pb][~in_b])
    np.testing.assert_array_equal(got[seq == 0], qual[seq == 0])
    assert (got != qual).sum() > 500


def test_empty_pair_table():
    """No pair to arbitrate: the quals come back untouched."""
    seq = torch.ones((3, 8), dtype=torch.uint8)
    qual = torch.arange(24, dtype=torch.uint8).reshape(3, 8)
    none = torch.zeros(0, dtype=torch.int32)
    out = ta.arbitrate(seq, qual.clone(), torch.zeros(3, dtype=torch.int32),
                       none, none)
    assert torch.equal(out, qual)


@pytest.mark.parametrize("L,shift", ARBITRATE_EDGE_CASES)
def test_card_edge_inputs_match_arb_kernel(L, shift):
    """The pairs chip_smoke.py and the card tests hold the CUDA kernel to
    (every d from -127 to L, every rule branch, arrays off alignment): on
    them the plain version equals the CPU twin of the TPU kernel and leaves
    every byte outside an overlap alone."""
    rng = np.random.default_rng(300 + L + shift)
    (seq, qual, spos, pa, pb), inside = arbitrate_edge_inputs(rng, L=L,
                                                              shift=shift)
    got = ta.arbitrate(seq, qual.clone(), spos, pa, pb).numpy()
    seq, qual, pa, pb = seq.numpy(), qual.numpy(), pa.numpy(), pb.numpy()
    f_pos = (spos.numpy() >> 1).astype(np.int64)
    st = np.ones(len(f_pos), np.int64)
    wa, wb = _interpret_pair(seq, qual, f_pos, st, pa, pb)
    np.testing.assert_array_equal(got[pa], wa)
    np.testing.assert_array_equal(got[pb], wb)
    np.testing.assert_array_equal(got[~inside], qual[~inside])
    assert (got != qual).sum() > 20
