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
    """The v2 program's frame: rows sorted by aligned start, the pair table
    of host_prep.v2_pair_tables."""
    aligned = f_pos - f_pos % 128
    order = np.argsort(aligned, kind="stable")
    frame = np.empty(len(order), np.int64)
    frame[order] = np.arange(len(order))
    pa, pb, code = hp.v2_pair_tables(aligned[order], st[order], frame[a_np],
                                     frame[b_np])
    return (seq[order], qual[order], f_pos[order], st[order], pa, pb, code,
            order)


def _port(seq_s, qual_s, f_pos_s, st_s, pa, pb, code):
    shp = hp.shp_bytes(f_pos_s.astype(np.int32), (st_s & 1).astype(np.uint8))
    q = torch.from_numpy(qual_s.copy())
    out = ta.arbitrate(torch.from_numpy(seq_s), q, torch.from_numpy(shp),
                       torch.from_numpy(pa), torch.from_numpy(pb),
                       torch.from_numpy(code))
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
    assert set(np.unique(code)) == {0, 1, 2, 3}
    got = _port(seq_s, qual_s, f_pos_s, st_s, pa, pb, code)

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
    got = _port(seq_s, qual_s, f_pos_s, st_s, pa, pb, code)
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
    got = _port(seq_s, qual_s, f_pos_s, st_s, pa, pb, code)
    np.testing.assert_array_equal(got, want[order])
    assert got[order == 0][0, 10] == 30


def test_pair_table_roles_and_codes():
    """Mate a is the smaller aligned start, swapped only when strictly
    greater (a same-block pair keeps its order: b wins a tie); code 3 for a
    parity mismatch or a shift past two blocks."""
    al = np.array([0, 0, 128, 256, 512, 128], np.int64)
    st = np.array([1, 1, 2, 2, 1, 1], np.int64)
    pa, pb, code = hp.v2_pair_tables(al, st, np.array([1, 3, 4, 5]),
                                     np.array([0, 2, 0, 2]))
    np.testing.assert_array_equal(pa, [1, 2, 0, 5])
    np.testing.assert_array_equal(pb, [0, 3, 4, 2])
    np.testing.assert_array_equal(code, [0, 1, 3, 3])
    assert pa.dtype == np.int32 and code.dtype == np.uint8


def test_wrapper_checks_and_counts():
    seq = torch.zeros((4, 10), dtype=torch.uint8)
    shp = torch.zeros(4, dtype=torch.uint8)
    idx = torch.tensor([0, 2], dtype=torch.int32)
    code = torch.tensor([0, 3], dtype=torch.uint8)
    before = ta.LAUNCHES
    ta.arbitrate(seq, seq.clone(), shp, idx, idx + 1, code)
    assert ta.LAUNCHES == before
    with pytest.raises(TypeError):
        ta.arbitrate(seq, seq.clone(), shp, idx.long(), idx + 1, code)
    with pytest.raises(ValueError):
        ta.arbitrate(seq, seq[:, :5].contiguous(), shp, idx, idx + 1, code)
    with pytest.raises(ValueError):
        ta.arbitrate(seq, seq.clone(), shp, idx, idx + 1, code[:1])
