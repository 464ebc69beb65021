"""The port's 12-count pileup (methyldackel_tpu_torch.ops.pileup4) against
the JAX package: its plain PyTorch version must equal the CPU twins of the
TPU kernels (pileup_pallas._pileup_tiles_nq_interpret for the nq layout,
_pileup_tiles_interpret for the qual layout), the counts_to_channels
epilogue and the pileup_pallas() wrapper exactly — integer counts, so the
tolerance is 0. The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_card.py, and chip_smoke.py)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from methyldackel_tpu.ops import pileup_pallas as jpk
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.utils.simulate import random_reference, simulate_batch_fast
from methyldackel_tpu_torch.ops import pileup4 as p4
from methyldackel_tpu_torch.parallel import host_prep as hp

from chip_smoke import pileup4_edge_inputs
from test_torch_convert import jax_group_tables

T = 512
CODES = np.array([1, 2, 4, 8, 15, 1, 2, 4, 8, 3, 5, 12], np.uint8)


def _rows(seed, n, L, W, *, tail=True):
    """n random rows of L codes (nonzero inside the read, a zero tail past a
    random read length when ``tail``), quals 0-60, sorted window starts that
    straddle both ends, random parities."""
    rng = np.random.default_rng(seed)
    seq = CODES[rng.integers(0, len(CODES), (n, L))]
    qual = rng.integers(0, 61, (n, L)).astype(np.uint8)
    if tail and n:
        lq = rng.integers(max(1, L - 20), L + 1, n)
        past = np.arange(L)[None, :] >= lq[:, None]
        seq[past] = 0
        qual[past] = 0
    f_pos = np.sort(rng.integers(-L - 140, W + 60, n)).astype(np.int64)
    parity = rng.integers(0, 2, n).astype(np.uint8)
    return seq, qual, f_pos, parity


def _geometry(L, W):
    """Route A's geometry: LP from L4 = 4*ceil(L/4) bounds both layouts."""
    L4 = 4 * ((L + 3) // 4)
    LP = hp.round_up(max(L4, 128), 128)
    K = (T + LP) // 128
    ntiles = hp.round_up(W, T) // T
    return LP, K, ntiles


def _tables(f_pos, ntiles, K, LP):
    return jax_group_tables(f_pos - f_pos % 128, ntiles, K, LP)


def _port_tables(f_pos, parity, ntiles, Lc):
    """The port's row and tile tables (rows already sorted by start)."""
    tlo, thi = hp.tile_rows(f_pos, ntiles, Lc)
    return hp.row_spos(f_pos, parity), tlo, thi


def _twin(kind, seq, qual, f_pos, parity, srtk, cntk, ntiles, K, LP,
          min_phred=0):
    """A JAX CPU twin on the phase-aligned [n, LP2] layout (parity in bit
    5), as rows [16, ntiles*T]."""
    n = len(seq)
    seq_a, qual_a, _al, _par = jpk.prealign_reads(
        seq, qual, f_pos, parity.astype(np.int64))
    seq_a = np.concatenate([seq_a, np.zeros((1, seq_a.shape[1]), np.uint8)])
    qual_a = np.concatenate([qual_a, np.zeros((1, qual_a.shape[1]), np.uint8)])
    geo = dict(ntiles=ntiles, T=T, HALO_L=LP + 128, LP=LP,
               LP2=seq_a.shape[1], K=K)
    if kind == "nq":
        tiles = jpk._pileup_tiles_nq_interpret(srtk, cntk, seq_a, **geo)
    else:
        tiles = jpk._pileup_tiles_interpret(srtk, cntk, seq_a, qual_a,
                                            min_phred=min_phred, **geo)
    assert n < len(seq_a)
    return tiles.transpose(1, 0, 2).reshape(16, ntiles * T)


def _nibbles(codes):
    n, L = codes.shape
    Lh = (L + 1) // 2
    c = np.zeros((n, 2 * Lh), np.uint8)
    c[:, :L] = codes
    return np.ascontiguousarray(c[:, 0::2] | (c[:, 1::2] << 4))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,n,L,W,min_phred", [
    (1, 200, 101, 3072, 0), (2, 160, 150, 2048, 5), (3, 120, 75, 2560, 40),
    (4, 90, 64, 1536, 5)])
def test_nq_counts_match_interpret(seed, n, L, W, min_phred):
    """Pre-gated nibble-packed codes (the host gate applied at min_phred),
    odd and even L, ragged rows."""
    seq, qual, f_pos, parity = _rows(seed, n, L, W)
    gated = np.where(qual >= min_phred, seq, 0).astype(np.uint8)
    LP, K, ntiles = _geometry(L, W)
    srtk, cntk = _tables(f_pos, ntiles, K, LP)
    want = _twin("nq", gated, qual, f_pos, parity, srtk, cntk, ntiles, K, LP)
    packed = _nibbles(gated)
    tabs = _port_tables(f_pos, parity, ntiles, 2 * packed.shape[1])
    got = p4.pileup4_counts_reference(*_t(packed, *tabs), ntiles=ntiles)
    assert got.dtype == torch.int32 and got.shape == (12, ntiles * T)
    np.testing.assert_array_equal(got.numpy(), want[:12])
    assert not want[12:].any() and want[0].sum() > 1000


@pytest.mark.parametrize("seed,n,L,W,min_phred", [
    (5, 200, 101, 3072, 0), (6, 160, 150, 2048, 5), (7, 150, 100, 2560, 40),
    (8, 100, 75, 1536, 5)])
def test_qual_counts_match_interpret(seed, n, L, W, min_phred):
    """The in-kernel phred gate on raw codes + quals. At min_phred 0 the TPU
    kernel also counted the zero pad bytes of its phase-aligned rows (qual
    0 >= 0) in the two totals; the port counts no code-0 byte, so there its
    totals equal the nq twin's (code != 0) and its base counts the qual
    twin's."""
    seq, qual, f_pos, parity = _rows(seed, n, L, W)
    LP, K, ntiles = _geometry(L, W)
    srtk, cntk = _tables(f_pos, ntiles, K, LP)
    want = _twin("qual", seq, qual, f_pos, parity, srtk, cntk, ntiles, K, LP,
                 min_phred)
    s_t, q_t, *tabs = _t(seq, qual, *_port_tables(f_pos, parity, ntiles, L))
    got = p4.pileup4_counts_reference(s_t, *tabs, ntiles=ntiles, qual=q_t,
                                      min_phred=min_phred).numpy()
    if min_phred >= 1:
        np.testing.assert_array_equal(got, want[:12])
    else:
        bases = [1, 2, 3, 4, 5, 7, 8, 9, 10, 11]
        np.testing.assert_array_equal(got[bases], want[bases])
        nq = _twin("nq", seq, qual, f_pos, parity, srtk, cntk, ntiles, K, LP)
        np.testing.assert_array_equal(got[[0, 6]], nq[[0, 6]])
        assert (want[0] > got[0]).any()  # the pads the TPU kernel counted
    assert got[0].sum() > 1000


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(0, 30),
       L=st.integers(1, 140), tiles=st.integers(1, 3),
       qual_mode=st.booleans())
def test_ragged_rows_property(seed, n, L, tiles, qual_mode):
    """Empty groups, rows straddling either end, any L, both layouts."""
    W = tiles * T
    seq, qual, f_pos, parity = _rows(seed, n, L, W)
    LP, K, ntiles = _geometry(L, W)
    srtk, cntk = _tables(f_pos, ntiles, K, LP)
    if qual_mode:
        want = _twin("qual", seq, qual, f_pos, parity, srtk, cntk, ntiles, K,
                     LP, 7)
        args = _t(seq, *_port_tables(f_pos, parity, ntiles, L), qual)
        got = p4.pileup4_counts_reference(*args[:4], ntiles=ntiles,
                                          qual=args[4], min_phred=7)
    else:
        want = _twin("nq", seq, qual, f_pos, parity, srtk, cntk, ntiles, K,
                     LP)
        packed = _nibbles(seq)
        tabs = _port_tables(f_pos, parity, ntiles, 2 * packed.shape[1])
        got = p4.pileup4_counts_reference(*_t(packed, *tabs), ntiles=ntiles)
    np.testing.assert_array_equal(got.numpy(), want[:12])


@pytest.mark.parametrize("woff", [-2, 0, 3])
def test_counts_to_channels_matches_jax(woff):
    """Host-packed frame-shifted bitmaps in place of the reference bytes and
    the dynamic slice."""
    rng = np.random.default_rng(11 + woff)
    W = 2048
    counts = np.zeros((16, W), np.int32)
    for blk in (0, 6):
        per_base = rng.integers(0, 300, (5, W)).astype(np.int32)
        counts[blk + 1 : blk + 6] = per_base
        counts[blk] = per_base.sum(axis=0) + rng.integers(0, 40, W)
    ref = rng.choice(np.frombuffer(b"ACGTN", np.uint8), W + 16)
    want = np.asarray(jpk.counts_to_channels(counts, ref, woff, W))
    isc, isg = hp.ref_bits(ref, woff, W)
    got = p4.counts_to_channels(*_t(counts, isc, isg), W)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _stacked(n=420, qual_mode=False):
    """n rows stacked on one span, all odd-parity C over an all-C reference
    stretch (meth = n at C columns) and a third of them even (opposite
    depth and, with code C on the even strand, no variant)."""
    L = 100
    ntiles = 3
    f_pos = np.full(n, 700, np.int64)
    f_pos[::4] = 640
    f_pos = np.sort(f_pos)
    parity = np.ones(n, np.uint8)
    parity[::3] = 0
    seq = np.full((n, L), 2, np.uint8)
    seq[::5, ::7] = 8
    cb = np.zeros(ntiles * T, bool)
    cb[600:1000] = True
    gb = np.zeros_like(cb)
    gb[1000:1100] = True
    codes = seq if qual_mode else _nibbles(seq)
    args = _t(codes, *_port_tables(f_pos, parity, ntiles, L),
              np.packbits(cb), np.packbits(gb))
    extra = dict(qual=torch.full((n, L), 30, dtype=torch.uint8),
                 min_phred=5) if qual_mode else {}
    return args, dict(ntiles=ntiles), extra


@pytest.mark.parametrize("qual_mode", [False, True])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("sat_bits", [8, 16, 32])
def test_narrowing_overflow_and_compaction(sat_bits, compact, qual_mode):
    """u8 overflows (flag set, values clamped), u16 and u32 hold the
    counts; the compacted output is the dense one's candidate columns."""
    args, geom, extra = _stacked(qual_mode=qual_mode)
    W = geom["ntiles"] * T
    dense = p4.counts_to_channels(
        p4.pileup4_counts_reference(*args[:4], **geom, **extra), args[4],
        args[5], W).numpy()
    assert dense.max() > 255 and dense[2].max() > 0 and dense[3].max() > 0
    kw = dict(geom, nch=4, sat_bits=sat_bits, **extra)
    want = dense
    if compact:
        rng = np.random.default_rng(2)
        cand = np.sort(rng.choice(W, W // 5, replace=False))
        cand = np.union1d(cand, [700, 750])  # two columns above 255
        dst = np.full(W, -1, np.int32)
        dst[cand] = np.arange(len(cand), dtype=np.int32)
        kw.update(dst=torch.from_numpy(dst), out_width=len(cand))
        want = dense[:, cand]
    out, ovf = p4.pileup4_tiles(*args, **kw)
    assert out.dtype == {8: torch.uint8, 16: torch.uint16,
                         32: torch.uint32}[sat_bits]
    assert int(ovf) == (1 if sat_bits == 8 else 0)
    cap = (1 << sat_bits) - 1
    np.testing.assert_array_equal(out.numpy().astype(np.int64),
                                  np.minimum(want, cap))
    out2, _ = p4.pileup4_tiles(*args, **dict(kw, nch=2))
    np.testing.assert_array_equal(out2.numpy(), out.numpy()[:2])


def test_pileup_window_matches_pileup_pallas():
    """tests/test_pallas_kernel.py:11: the whole window against the
    interpret-mode wrapper and the host semantics."""
    rng = np.random.default_rng(3)
    W = 2048
    ref_ascii, ref_codes = random_reference(rng, W)
    batch = simulate_batch_fast(rng, ref_codes, 150, 100)
    order = np.argsort(batch.pos, kind="stable")
    st_arr = sem.strand(batch.flag, batch.xg)
    host = sem.pileup_channels(batch.seq, batch.qual, batch.refpos, st_arr,
                               np.ones(batch.seq.shape, bool), ref_ascii,
                               0, 0, W, 5)
    want = jpk.pileup_pallas(batch.seq[order], batch.qual[order],
                             batch.pos[order].astype(np.int64), st_arr[order],
                             ref_ascii, 0, W, min_phred=5, interpret=True)
    got = p4.pileup_window(batch.seq, batch.qual, batch.pos, st_arr,
                           ref_ascii, 0, W, min_phred=5, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (W, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)


def test_pileup_window_offsets():
    """tests/test_pallas_kernel.py:27: a window not starting at 0 and a
    reference with a left offset."""
    rng = np.random.default_rng(9)
    glen = 3000
    ref_ascii, ref_codes = random_reference(rng, glen)
    batch = simulate_batch_fast(rng, ref_codes, 120, 80)
    win_start, win_end = 512, 2560
    W = win_end - win_start
    keep = (batch.pos < win_end) & (batch.endpos > win_start)
    idx = np.nonzero(keep)[0]
    idx = idx[np.argsort(batch.pos[idx], kind="stable")]
    st_arr = sem.strand(batch.flag, batch.xg)
    win_offset = win_start - 2
    ref_window = ref_ascii[win_offset:]
    host = sem.pileup_channels(batch.seq[idx], batch.qual[idx],
                               batch.refpos[idx], st_arr[idx],
                               np.ones(batch.seq[idx].shape, bool),
                               ref_window, win_offset, win_start, win_end, 5)
    args = (batch.seq[idx], batch.qual[idx],
            (batch.pos[idx] - win_start).astype(np.int64), st_arr[idx],
            ref_window, win_offset - win_start, W)
    want = jpk.pileup_pallas(*args, min_phred=5, interpret=True)
    got = p4.pileup_window(*args, min_phred=5, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)


def test_wrapper_checks_and_counts():
    """The wrapper validates its inputs; on the CPU it runs the plain
    version and counts no kernel launch."""
    ntiles = 2
    codes = torch.zeros((4, 8), dtype=torch.uint8)
    spos = torch.zeros(4, dtype=torch.int32)
    tab = torch.zeros(ntiles, dtype=torch.int32)
    bits = torch.zeros(ntiles * T // 8, dtype=torch.uint8)
    before = dict(p4.LAUNCHES)
    kw = dict(ntiles=ntiles, nch=4, sat_bits=8)
    out, ovf = p4.pileup4_tiles(codes, spos, tab, tab, bits, bits, **kw)
    out_q, _ = p4.pileup4_tiles(codes, spos, tab, tab, bits, bits,
                                qual=codes.clone(), min_phred=5, **kw)
    assert p4.LAUNCHES == before
    assert out.shape == (4, ntiles * T) and not out.numpy().any()
    assert not out_q.numpy().any() and int(ovf) == 0
    with pytest.raises(TypeError):
        p4.pileup4_tiles(codes, spos, tab.long(), tab, bits, bits, **kw)
    with pytest.raises(TypeError):
        p4.pileup4_tiles(codes, spos.to(torch.uint8), tab, tab, bits, bits,
                         **kw)
    with pytest.raises(ValueError):
        p4.pileup4_tiles(codes, spos, tab, tab, bits, bits,
                         qual=codes[:, :4].contiguous(), **kw)
    with pytest.raises(ValueError):
        p4.pileup4_tiles(codes, spos, tab, tab, bits, bits,
                         **dict(kw, nch=3))
    with pytest.raises(ValueError):
        p4.pileup4_tiles(codes, spos, tab, tab, bits, bits,
                         **dict(kw, sat_bits=12))
    with pytest.raises(ValueError):
        p4.pileup4_tiles(codes, spos, tab, tab, bits, bits,
                         dst=torch.zeros(ntiles * T, dtype=torch.int32), **kw)
    with pytest.raises(ValueError):
        p4.pileup4_tiles(codes, spos, tab, tab, bits, bits, chunk_rows=0,
                         **kw)


def test_pileup_window_runs_on_the_card_by_default():
    """No device argument means the card: without one the upload raises
    instead of counting on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    seq = np.full((2, 8), 2, np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        p4.pileup_window(seq, seq, np.array([0, 3]), np.array([1, 2]),
                         np.frombuffer(b"ACGT" * 128, np.uint8), 0, T)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(0, 300),
       L=st.integers(1, 160), tiles=st.integers(1, 4))
def test_sorted_rows_give_contiguous_tile_ranges(seed, n, L, tiles):
    """What the kernel's staging and run search rest on, for any
    coordinate-sorted window: a tile's rows [tlo, thi) are exactly the rows
    that touch it, in one range; and in the offset-group tables of the 2-bit
    program the groups of a tile follow one another without a gap and the
    phases inside a group never decrease."""
    rng = np.random.default_rng(seed)
    W = tiles * T
    f_pos = np.sort(rng.integers(-L - 140, W + 60, n)).astype(np.int64)
    tlo, thi = hp.tile_rows(f_pos, tiles, L)
    rows = np.arange(n)
    for t in range(tiles):
        touch = (f_pos + L > t * T) & (f_pos < (t + 1) * T)
        np.testing.assert_array_equal(rows[touch],
                                      np.arange(tlo[t], thi[t]))
    LP, K, ntiles = _geometry(L, W)
    srtk, cntk = _tables(f_pos, ntiles, K, LP)
    phase = f_pos % 128
    for g in range(ntiles * K):
        r0, r1 = srtk[g], srtk[g] + cntk[g]
        if (g + 1) % K:
            assert r1 == srtk[g + 1]
        assert (np.diff(phase[r0:r1]) >= 0).all()
        assert len(set((f_pos[r0:r1] - phase[r0:r1]).tolist())) <= 1


def test_unsorted_rows_are_refused():
    """The order is a checked precondition: hp.tile_rows raises on
    rows that are not sorted by start, and window_tables sorts first."""
    rng = np.random.default_rng(4)
    f_pos = np.sort(rng.integers(-50, 1500, 200))
    hp.tile_rows(f_pos, 3, 100)
    shuffled = rng.permutation(f_pos)
    with pytest.raises(ValueError, match="sorted"):
        hp.tile_rows(shuffled, 3, 100)
    parity = rng.integers(0, 2, 200)
    order, spos, tlo, thi = hp.window_tables(shuffled, parity, 3, 100)
    np.testing.assert_array_equal(shuffled[order], f_pos)
    np.testing.assert_array_equal(spos, 2 * f_pos + parity[order])
    assert spos.dtype == np.int32 and (spos >> 1 == f_pos).all()
    want = hp.tile_rows(f_pos, 3, 100)
    np.testing.assert_array_equal(tlo, want[0])
    np.testing.assert_array_equal(thi, want[1])
    same = hp.window_tables(f_pos, parity, 3, 100)[0]
    np.testing.assert_array_equal(same, np.arange(200))


def _brute_channels(args, kw, nch):
    """The four channels by a plain loop over rows, from the row starts
    alone (no tile tables): int64 [nch, out_width]."""
    codes, spos = args[0].numpy(), args[1].numpy()
    qual = kw.get("qual")
    ntiles = kw["ntiles"]
    W = ntiles * T
    if qual is None:
        c = np.zeros((codes.shape[0], 2 * codes.shape[1]), np.uint8)
        c[:, 0::2], c[:, 1::2] = codes & 15, codes >> 4
    else:
        c = np.where(qual.numpy() >= kw["min_phred"], codes & 15, 0)
    is_c = np.unpackbits(args[4].numpy())[:W] != 0
    is_g = (np.unpackbits(args[5].numpy())[:W] != 0) & ~is_c
    ch = np.zeros((4, W), np.int64)
    for r in range(len(spos)):
        start, odd = int(spos[r]) >> 1, int(spos[r]) & 1
        for j in np.nonzero(c[r])[0]:
            x = start + int(j)
            if not 0 <= x < W:
                continue
            b = int(c[r, j])
            if (is_c[x] and odd) or (is_g[x] and not odd):
                ch[0, x] += b == (2 if odd else 4)
                ch[1, x] += b == (8 if odd else 1)
            else:
                ch[2, x] += 1
                ch[3, x] += b != 15 and b != (4 if odd else 2)
    dst = kw["dst"].numpy()
    out = np.zeros((4, kw["out_width"]), np.int64)
    out[:, dst[dst >= 0]] = ch[:, dst >= 0]
    return out[:nch]


@pytest.mark.parametrize("qual_mode", [False, True])
@pytest.mark.parametrize("L,shift", [(151, 0), (151, 5), (150, 3), (36, 5)])
def test_staging_edge_cases_on_the_cpu_path(L, shift, qual_mode):
    """The inputs chip_smoke.py gives the kernel for its staging's edge
    cases (an odd read length, arrays off 16-byte alignment, a 300-row tile
    range that needs several chunks, tiles without rows, a last tile whose
    tail has no output slot) through the CPU path, against a plain loop
    over rows that knows nothing of tiles."""
    rng = np.random.default_rng(17 + L + shift)
    args, kw = pileup4_edge_inputs(rng, L=L, qual_mode=qual_mode, n=500,
                                   deep=300, shift=shift)
    assert (args[3] - args[2]).max() >= 300 and (args[3] - args[2]).min() == 0
    if shift:
        assert args[0].data_ptr() % 16 and args[1].data_ptr() % 16
    want = _brute_channels(args, kw, 4)
    assert want[2].max() > 150  # the deep tile
    for nch, sat, chunk in ((4, 16, 8), (2, 32, None)):
        out, ovf = p4.pileup4_tiles(*args, nch=nch, sat_bits=sat,
                                    chunk_rows=chunk, **kw)
        assert int(ovf) == 0
        np.testing.assert_array_equal(out.numpy().astype(np.int64),
                                      want[:nch])
