"""The port's 2-bit pileup (methyldackel_tpu_torch.ops.pileup) against the
JAX package: its plain PyTorch version must equal the CPU twin of the TPU
kernel (pileup_pallas._pileup_tiles_nq2_interpret) and the channels_nch2
epilogue exactly — these are integer counts, so the tolerance is 0. The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_card.py, and chip_smoke.py)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from methyldackel_tpu.io import native
from methyldackel_tpu.ops import pileup_pallas as jpk
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.utils.simulate import random_reference, simulate_batch_fast
from methyldackel_tpu_torch.ops import pileup as tpk
from methyldackel_tpu_torch.parallel import host_prep as hp
from test_torch_convert import jax_group_tables

from chip_smoke import pileup2_edge_inputs

T = 512


def _geometry(L, W):
    Lq = (L + 3) // 4
    L4 = 4 * Lq
    LP = hp.round_up(max(L4, 128), 128)
    LP2 = hp.round_up(L4 + 127, 128)
    K = (T + LP) // 128
    ntiles = hp.round_up(W, T) // T
    return Lq, L4, LP, LP2, K, ntiles


def _prealigned(seqpack, pos_p, parity_p, LP2):
    """The interpret twin's input: unpacked codes shifted by pos % 128 into
    [n, LP2] rows with the parity in bit 5 (device.py's numpy twin of the
    barrel shift)."""
    n, Lq = seqpack.shape
    L4 = 4 * Lq
    codes = np.zeros((max(n, 1), L4), np.uint8)
    for s_i, sh_bits in enumerate((0, 2, 4, 6)):
        codes[:n, s_i::4] = (seqpack >> sh_bits) & 3
    seq_a = np.zeros((max(n, 1), LP2), np.uint8)
    if n:
        sh = (pos_p % 128).astype(np.int64)
        cols = sh[:, None] + np.arange(L4, dtype=np.int64)[None, :]
        seq_a[np.arange(n)[:, None], cols] = (
            codes[:n] | (parity_p[:, None].astype(np.uint8) << 5))
    return seq_a


def _packed_inputs(seed, L, W, n_pairs):
    """Inputs packed by the native v3_pack2 from a simulated arbitrated
    batch (tests/test_fused_v3.py:test_2bit_semantic_path_matches_semantics)."""
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = random_reference(rng, W + 64)
    batch = simulate_batch_fast(rng, ref_codes, n_pairs, L)
    st_arr = sem.strand(batch.flag, batch.xg).astype(np.int32)
    qual = batch.qual.copy()
    a = np.arange(0, batch.n, 2)
    sem.arbitrate_overlaps(batch.seq, qual, batch.refpos, st_arr, a, a + 1)
    Lq, L4, LP, LP2, K, ntiles = _geometry(L, W)
    pos = batch.pos.astype(np.int64)
    aligned = pos - (pos % 128)
    order = np.argsort(aligned, kind="stable")
    srtk, cntk = jax_group_tables(aligned[order], ntiles, K, LP)
    nat = native.v3_pack2(batch.seq, qual, order.astype(np.int64), pos, st_arr,
                          Lq, batch.n, 0, 7)
    assert nat is not None
    seqpack, pos_p, parity_p = nat
    rbw = np.zeros(ntiles * T, np.uint8)
    rbw[: min(len(ref_ascii), len(rbw))] = ref_ascii[: len(rbw)]
    return dict(seqpack=seqpack, pos_p=pos_p, parity_p=parity_p, srtk=srtk,
                cntk=cntk, isc=np.packbits(rbw == ord("C")),
                isg=np.packbits(rbw == ord("G")), Lq=Lq, LP=LP, LP2=LP2, K=K,
                ntiles=ntiles)


def _interpret(inp):
    seq_a = _prealigned(inp["seqpack"], inp["pos_p"], inp["parity_p"],
                        inp["LP2"])
    tiles = jpk._pileup_tiles_nq2_interpret(
        inp["srtk"], inp["cntk"], seq_a, ntiles=inp["ntiles"], T=T,
        HALO_L=inp["LP"] + 128, LP=inp["LP"], LP2=inp["LP2"], K=inp["K"])
    return tiles.transpose(1, 0, 2).reshape(8, inp["ntiles"] * T)


def _port_tables(seqpack, pos_p, parity_p, ntiles):
    """The port's tables from the same rows: sorted by exact start (the JAX
    layout sorts by 128-aligned start only), ``spos`` and the tile row
    ranges of ``host_prep.window_tables``."""
    order, spos, tlo, thi = hp.window_tables(pos_p, parity_p, ntiles,
                                             4 * seqpack.shape[1])
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (seqpack[order], spos, tlo, thi)]


def _torch_args(inp):
    return _port_tables(inp["seqpack"], inp["pos_p"], inp["parity_p"],
                        inp["ntiles"]) + [
        torch.from_numpy(np.ascontiguousarray(inp[k])) for k in ("isc", "isg")]


@pytest.mark.parametrize("seed,L,W,n_pairs", [(59, 101, 4608, 150),
                                               (61, 150, 3072, 120),
                                               (67, 64, 2048, 100)])
def test_counts_match_nq2_interpret(seed, L, W, n_pairs):
    inp = _packed_inputs(seed, L, W, n_pairs)
    want = _interpret(inp)
    args = _torch_args(inp)
    got = tpk.pileup2_counts_reference(*args[:4], ntiles=inp["ntiles"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want[:4])
    assert want[:4].sum() > 1000  # the scenario must carry calls


def test_channels_nch2_matches_jax():
    rng = np.random.default_rng(5)
    W = 3000
    counts = rng.integers(0, 70000, (8, W)).astype(np.int32)
    cb = rng.random(W) < 0.3
    gb = (rng.random(W) < 0.4) & ~cb
    isc, isg = np.packbits(cb), np.packbits(gb)
    want = np.asarray(jpk.channels_nch2(counts, isc, isg, W))
    got = tpk.channels_nch2(torch.from_numpy(counts), torch.from_numpy(isc),
                            torch.from_numpy(isg), W)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        tpk.unpack_bits(torch.from_numpy(isc), W).numpy(),
        np.asarray(jpk.unpack_bits_device(isc, W)))


@pytest.mark.parametrize("compact", [False, True])
def test_fused_program_matches_jax_epilogue(compact):
    """pileup2_tiles (plain on the CPU) = interpret kernel + channels_nch2
    (+ the candidate compaction's gather), dense u32 and compacted u32."""
    inp = _packed_inputs(71, 101, 4608, 150)
    W = inp["ntiles"] * T
    want = np.asarray(jpk.channels_nch2(_interpret(inp), inp["isc"],
                                        inp["isg"], W))
    kw = dict(ntiles=inp["ntiles"], sat_bits=32)
    if compact:
        rng = np.random.default_rng(3)
        cand = np.sort(rng.choice(W, W // 8, replace=False))
        dst = np.full(W, -1, np.int32)
        dst[cand] = np.arange(len(cand), dtype=np.int32)
        kw.update(dst=torch.from_numpy(dst), out_width=len(cand))
        want = want[:, cand]
    out, ovf = tpk.pileup2_tiles(*_torch_args(inp), **kw)
    assert out.dtype == torch.uint32 and int(ovf) == 0
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("sat_bits,flag", [(8, 1), (16, 0), (32, 0)])
def test_narrowing_and_overflow_flag(sat_bits, flag):
    """300 methylated rows stacked on one span: a u8 readback overflows
    (flag set, values clamped), u16 and u32 hold the counts."""
    n, Lq, ntiles = 300, 38, 3
    f_pos = np.full(n, 700, np.int64)
    f_pos[::3] = 650  # a second depth level below 255
    seqpack = np.full((n, Lq), 0x55, np.uint8)
    isc = np.full(ntiles * T // 8, 0xFF, np.uint8)
    isg = np.zeros_like(isc)
    args = _port_tables(seqpack, f_pos, np.ones(n, np.uint8), ntiles) \
        + [torch.from_numpy(isc), torch.from_numpy(isg)]
    dense = tpk.channels_nch2(
        tpk.pileup2_counts_reference(*args[:4], ntiles=ntiles),
        args[4], args[5], ntiles * T).numpy()
    assert dense.max() == 300
    out, ovf = tpk.pileup2_tiles(*args, ntiles=ntiles, sat_bits=sat_bits)
    assert out.dtype == {8: torch.uint8, 16: torch.uint16,
                         32: torch.uint32}[sat_bits]
    assert int(ovf) == flag
    cap = (1 << sat_bits) - 1
    np.testing.assert_array_equal(out.numpy().astype(np.int64),
                                  np.minimum(dense, cap))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(0, 40),
       L=st.integers(1, 140), tiles=st.integers(1, 3))
def test_ragged_rows_property(seed, n, L, tiles):
    """Random ragged tails (L not a multiple of 4), empty groups, and rows
    that straddle the window at negative f_pos or run off its end."""
    rng = np.random.default_rng(seed)
    W = tiles * T
    Lq, L4, LP, LP2, K, ntiles = _geometry(L, W)
    f_pos = np.sort(rng.integers(-L - 140, W + 60, n)).astype(np.int64)
    aligned = f_pos - f_pos % 128
    srtk, cntk = jax_group_tables(aligned, ntiles, K, LP)
    codes = rng.integers(0, 4, (n, L4)).astype(np.uint8)
    codes[:, L:] = 0  # the pack's zero tail past the read
    seqpack = np.ascontiguousarray(hp.pack4(codes)) if n else \
        np.zeros((0, Lq), np.uint8)
    parity = rng.integers(0, 2, n).astype(np.uint8)
    inp = dict(seqpack=seqpack, pos_p=f_pos.astype(np.int32), parity_p=parity,
               srtk=srtk, cntk=cntk, LP=LP, LP2=LP2, K=K, ntiles=ntiles)
    want = _interpret(inp)[:4]
    got = tpk.pileup2_counts_reference(
        *_port_tables(seqpack, f_pos, parity, ntiles), ntiles=ntiles)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_and_counts():
    """The wrapper validates its inputs; on the CPU it runs the plain
    version and counts no kernel launch."""
    ntiles = 2
    sp = torch.zeros((4, 16), dtype=torch.uint8)
    spos = torch.zeros(4, dtype=torch.int32)
    tlo = torch.zeros(ntiles, dtype=torch.int32)
    thi = torch.tensor([4, 0], dtype=torch.int32)
    bits = torch.zeros(ntiles * T // 8, dtype=torch.uint8)
    before = tpk.LAUNCHES
    out, ovf = tpk.pileup2_tiles(sp, spos, tlo, thi, bits, bits,
                                 ntiles=ntiles, sat_bits=8)
    assert tpk.LAUNCHES == before
    assert out.shape == (2, ntiles * T) and not out.numpy().any()
    with pytest.raises(TypeError):
        tpk.pileup2_tiles(sp, spos, tlo.long(), thi, bits, bits,
                          ntiles=ntiles, sat_bits=8)
    with pytest.raises(ValueError):
        tpk.pileup2_tiles(sp, spos[:3], tlo, thi, bits, bits, ntiles=ntiles,
                          sat_bits=8)
    with pytest.raises(ValueError):
        tpk.pileup2_tiles(sp, spos, tlo, thi, bits, bits, ntiles=ntiles,
                          sat_bits=12)
    with pytest.raises(ValueError):
        tpk.pileup2_tiles(sp, spos, tlo, thi, bits, bits, ntiles=ntiles,
                          sat_bits=8,
                          dst=torch.zeros(ntiles * T, dtype=torch.int32))
    with pytest.raises(ValueError):
        tpk.pileup2_tiles(sp, spos, tlo, thi, bits, bits, ntiles=ntiles,
                          sat_bits=8, chunk_rows=0)


def test_unsorted_exact_starts_raise():
    """Rows sorted by 128-aligned start only (the JAX layout's order) are
    not enough: the kernel's run search needs exact starts that do not
    decrease, and the host code that builds the tile tables refuses
    anything else."""
    f_pos = np.array([5, 130, 129, 300], np.int64)  # aligned: 0 128 128 256
    aligned = f_pos - f_pos % 128
    assert (np.diff(aligned) >= 0).all()
    with pytest.raises(ValueError, match="sorted"):
        hp.tile_rows(f_pos, 2, 64)
    seqpack = np.arange(4 * 16, dtype=np.uint8).reshape(4, 16)
    parity = np.array([0, 1, 0, 1], np.uint8)
    sp, spos, tlo, thi = hp.packed_tables(seqpack, f_pos.astype(np.int32),
                                          parity, 2)
    np.testing.assert_array_equal(spos >> 1, [5, 129, 130, 300])
    np.testing.assert_array_equal(spos & 1, [0, 0, 1, 1])
    np.testing.assert_array_equal(sp, seqpack[[0, 2, 1, 3]])
    # sorted input comes back as it is, not copied
    sp2, spos2, _, _ = hp.packed_tables(sp, (spos >> 1).astype(np.int32),
                                        (spos & 1).astype(np.uint8), 2)
    assert sp2 is sp and (spos2 == spos).all()


@pytest.mark.parametrize("case", ["equal_starts", "negative_starts",
                                  "short_rows", "L36", "odd_L"])
def test_edge_rows_match_nq2_interpret(case):
    """Many rows on one exact start, starts left of the window, rows whose
    codes end early (zero-padded), and read lengths 36 and 37 (a ragged last
    byte): the plain version on the port's tables equals the CPU twin of the
    TPU kernel on the JAX layout. Integer counts, tolerance 0."""
    rng = np.random.default_rng(len(case))
    L = {"L36": 36, "odd_L": 37}.get(case, 101)
    W, n = 3 * T, 90
    Lq, L4, LP, LP2, K, ntiles = _geometry(L, W)
    if case == "equal_starts":
        f_pos = np.repeat(np.array([-7, 511, 512, 900]), [20, 30, 30, 10])
    elif case == "negative_starts":
        f_pos = np.sort(rng.integers(-L - 130, 40, n))
    else:
        f_pos = np.sort(rng.integers(-L, W, n))
    f_pos = f_pos.astype(np.int64)
    codes = rng.integers(0, 4, (n, L4)).astype(np.uint8)
    codes[:, L:] = 0
    if case == "short_rows":
        lq = rng.integers(1, L + 1, n)
        codes[np.arange(L4)[None, :] >= lq[:, None]] = 0
    seqpack = np.ascontiguousarray(hp.pack4(codes))
    parity = rng.integers(0, 2, n).astype(np.uint8)
    srtk, cntk = jax_group_tables(f_pos - f_pos % 128, ntiles, K, LP)
    want = _interpret(dict(seqpack=seqpack, pos_p=f_pos.astype(np.int32),
                           parity_p=parity, srtk=srtk, cntk=cntk, LP=LP,
                           LP2=LP2, K=K, ntiles=ntiles))[:4]
    got = tpk.pileup2_counts_reference(
        *_port_tables(seqpack, f_pos, parity, ntiles), ntiles=ntiles)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 100


@pytest.mark.parametrize("Lq,shift", [(38, 5), (16, 3), (9, 5), (1, 3)])
def test_card_edge_inputs_match_nq2_interpret(Lq, shift):
    """The rows chip_smoke.py and the card tests hold the CUDA kernel to (a
    5,000-row spike on one start, tiles without rows, starts left of column
    0, a last tile whose tail has no slot, arrays off alignment): on them
    the plain version equals the CPU twin of the TPU kernel + channels_nch2,
    u8 flags the overflow and u32 is exact."""
    rng = np.random.default_rng(200 + Lq + shift)
    args, kw = pileup2_edge_inputs(rng, Lq=Lq, shift=shift)
    seqpack, spos = args[0].numpy(), args[1].numpy()
    ntiles = kw["ntiles"]
    W = ntiles * T
    f_pos = (spos >> 1).astype(np.int64)
    L4 = 4 * Lq
    LP = hp.round_up(max(L4, 128), 128)
    K = (T + LP) // 128
    srtk, cntk = jax_group_tables(f_pos - f_pos % 128, ntiles, K, LP)
    counts = _interpret(dict(
        seqpack=seqpack, pos_p=f_pos.astype(np.int32),
        parity_p=(spos & 1).astype(np.uint8), srtk=srtk, cntk=cntk, LP=LP,
        LP2=hp.round_up(L4 + 127, 128), K=K, ntiles=ntiles))
    want = np.asarray(jpk.channels_nch2(counts, args[4].numpy(),
                                        args[5].numpy(), W))
    out32, ovf32 = tpk.pileup2_tiles(*args, ntiles=ntiles, sat_bits=32)
    np.testing.assert_array_equal(out32.numpy(), want)
    assert int(ovf32) == 0 and want.max() > 255
    out8, ovf8 = tpk.pileup2_tiles(*args, sat_bits=8, **kw)
    cand = np.nonzero(kw["dst"].numpy() >= 0)[0]
    np.testing.assert_array_equal(out8.numpy(),
                                  np.minimum(want[:, cand], 255))
    assert int(ovf8) == 1
