"""The port's dense window pipeline (methyldackel_tpu_torch.parallel.programs:
strand, context, trim, conversion efficiency, arbitration, pileup and the
whole window_pipeline) on the CPU device against the JAX functions of the
same names (methyldackel_tpu.parallel.device, on the CPU) and the numpy
oracles of ops/semantics.py, on seeded inputs; and the port's CLI on the
windows that take the dense dispatch (a stranded BED under --keepStrand,
reads of 300 bp, MDTPU_NO_PALLAS=1) against both host engines.

Integer results are bit-equal (tolerance 0). The one float quantity, the
conversion efficiency, is compared as float32: equal to the numpy float32
quotient, and within 1 ulp (rtol 2e-7) of the JAX program, whose compiler
may turn the division into a reciprocal and a product."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from methyldackel_tpu import cli as ref_cli
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.parallel import device as jdev
from methyldackel_tpu.utils.simulate import random_reference, simulate_batch
from methyldackel_tpu_torch import cli as port_cli
from methyldackel_tpu_torch.io.bai import build_bai
from methyldackel_tpu_torch.io.bam import BamFile
from methyldackel_tpu_torch.ops import semantics as psem
from methyldackel_tpu_torch.parallel import programs as prog
from methyldackel_tpu_torch.utils.simulate import write_synthetic_input
from test_torch_convert import PortBackend, port_batch

SEEDS = [42, 7]


def _t(a, dtype=None):
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    return torch.from_numpy(a)


def _sim(seed, n_pairs=60, L=100, glen=5000):
    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = random_reference(rng, glen)
    batch = simulate_batch(rng, ref_codes, n_pairs=n_pairs, read_len=L)
    return rng, ref_ascii, batch


@pytest.mark.parametrize("seed", SEEDS)
def test_strand_parity(seed):
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 1 << 12, size=512).astype(np.uint16)
    flags |= 0x1
    flags[::2] &= ~np.uint16(0x1)  # unpaired too
    xg = rng.integers(0, 3, size=512).astype(np.int8)
    got = prog.strand_device(_t(flags, np.int32), _t(xg)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, psem.strand(flags, xg))
    np.testing.assert_array_equal(
        got, np.asarray(jdev.strand_device(jnp.asarray(flags),
                                           jnp.asarray(xg))))


@pytest.mark.parametrize("n", [5000, 17, 3, 2])
def test_context_parity(n):
    rng = np.random.default_rng(n)
    ref_ascii, _ = random_reference(rng, n)
    got = prog.classify_context_device(_t(ref_ascii)).numpy()
    np.testing.assert_array_equal(got, psem.classify_context(ref_ascii)[0])
    np.testing.assert_array_equal(
        got, np.asarray(jdev.classify_context_device(jnp.asarray(ref_ascii))))


def _trim_both(batch, st, bounds, abounds):
    got = prog.trim_device(
        _t(batch.seq), _t(batch.qual), _t(batch.l_qseq),
        _t(st, np.int32), _t(batch.flag, np.int32),
        _t(bounds, np.int32), _t(abounds, np.int32))
    want = jdev.trim_device(
        jnp.asarray(batch.seq), jnp.asarray(batch.qual),
        jnp.asarray(batch.l_qseq), jnp.asarray(st.astype(np.int32)),
        jnp.asarray(batch.flag.astype(np.uint16)),
        jnp.asarray(np.array(bounds, np.int32)),
        jnp.asarray(np.array(abounds, np.int32)))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("seed", SEEDS)
def test_trim_parity(seed):
    _rng, _ref, batch = _sim(seed)
    st = sem.strand(batch.flag, batch.xg)
    bounds = [3, 80, 5, 90] + [0] * 12
    abounds = [0] * 4 + [7, 6, 2, 9] + [0] * 8
    hseq, hqual = batch.seq.copy(), batch.qual.copy()
    psem.trim_alignment(hseq, hqual, batch.l_qseq, st, batch.flag, bounds)
    psem.trim_absolute(hseq, hqual, batch.l_qseq, st, batch.flag, abounds)
    (dseq, dqual), (jseq, jqual) = _trim_both(batch, st, bounds, abounds)
    assert dseq.dtype == np.uint8 and dqual.dtype == np.uint8
    np.testing.assert_array_equal(dseq, hseq)
    np.testing.assert_array_equal(dqual, hqual)
    np.testing.assert_array_equal(dseq, jseq)
    np.testing.assert_array_equal(dqual, jqual)
    assert (dqual != batch.qual).sum() > 100


def test_trim_unknown_strand_takes_the_last_bounds_row():
    """Strand 0 (unknown) indexes row -1 of the [4, 4] bounds table: the
    last row, in numpy, in jax and in the port."""
    _rng, _ref, batch = _sim(3, n_pairs=10, L=40)
    st = np.zeros(batch.n, np.int32)
    bounds = [0] * 12 + [4, 30, 6, 35]  # only the CTOB row trims
    (dseq, dqual), (jseq, jqual) = _trim_both(batch, st, bounds, [0] * 16)
    np.testing.assert_array_equal(dseq, jseq)
    np.testing.assert_array_equal(dqual, jqual)
    assert not dqual[:, :4].any() and not dqual[:, 35:].any()
    hseq, hqual = batch.seq.copy(), batch.qual.copy()
    psem.trim_alignment(hseq, hqual, batch.l_qseq, st, batch.flag, bounds)
    np.testing.assert_array_equal(dqual, hqual)


def _conv_eff_both(seq, qual, refpos, st, ref_ascii, min_phred=5):
    ctype = prog.classify_context_device(_t(ref_ascii))
    got = prog.conv_eff_device(
        _t(seq), _t(qual), _t(refpos, np.int32), _t(st, np.int32), ctype, 0,
        len(ref_ascii), min_phred).numpy()
    jtype = jdev.classify_context_device(jnp.asarray(ref_ascii))
    want = np.asarray(jdev.conv_eff_device(
        jnp.asarray(seq), jnp.asarray(qual),
        jnp.asarray(refpos.astype(np.int32)),
        jnp.asarray(st.astype(np.int32)), jtype, 0, len(ref_ascii),
        min_phred))
    return got, want


@pytest.mark.parametrize("seed", SEEDS)
def test_conv_eff_parity(seed):
    _rng, ref_ascii, batch = _sim(seed)
    st = sem.strand(batch.flag, batch.xg)
    host = psem.conversion_efficiency(batch.seq, batch.qual, batch.refpos, st,
                                      ref_ascii, 0, 5)
    got, want = _conv_eff_both(batch.seq, batch.qual, batch.refpos, st,
                               ref_ascii)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, host.astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert len(np.unique(got)) > 5


def test_conv_eff_on_the_threshold():
    """Reads with 9 of 10 (and 8 of 10, 10 of 10) CHH calls converted:
    float32 9/10 must pass a 0.9 gate exactly as the JAX program's."""
    ref = np.frombuffer(b"CATCATCATCATCATCATCATCATCATCATAA", np.uint8)
    L = len(ref)
    code = {65: 1, 67: 2, 71: 4, 84: 8}
    base = np.array([code[c] for c in ref], np.uint8)
    seq = np.tile(base, (3, 1))
    for row, n_unmeth in enumerate((9, 8, 10)):
        cs = np.nonzero(base == 2)[0][:n_unmeth]
        seq[row, cs] = 8  # C read as T: unmethylated
    qual = np.full((3, L), 30, np.uint8)
    refpos = np.tile(np.arange(L, dtype=np.int32), (3, 1))
    st = np.ones(3, np.int32)
    got, want = _conv_eff_both(seq, qual, refpos, st, ref)
    np.testing.assert_array_equal(
        got, np.array([9, 8, 10], np.float32) / np.float32(10))
    gate = np.float32(0.9)
    np.testing.assert_array_equal(got >= gate, [True, False, True])
    np.testing.assert_array_equal(got >= gate, want >= gate)


def _arbitrate(seq, qual, refpos, st, a, b, valid, ovw):
    return prog.arbitrate_device(
        _t(seq), _t(qual), _t(refpos, np.int32), _t(st, np.int32),
        _t(a, np.int64), _t(b, np.int64),
        None if valid is None else _t(valid), ovw).numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_arbitrate_parity(seed):
    _rng, _ref, batch = _sim(seed)
    st = sem.strand(batch.flag, batch.xg)
    a, b = sem.pair_mates(batch.qname, batch.flag)
    hqual = batch.qual.copy()
    psem.arbitrate_overlaps(batch.seq, hqual, batch.refpos, st, a, b)
    ovw = ((2 * batch.seq.shape[1] + 127) // 128) * 128
    before = batch.qual.copy()
    got = _arbitrate(batch.seq, batch.qual, batch.refpos, st, a, b, None, ovw)
    np.testing.assert_array_equal(batch.qual, before)  # input not written
    np.testing.assert_array_equal(got, hqual)
    want = np.asarray(jdev.arbitrate_device(
        jnp.asarray(batch.seq), jnp.asarray(batch.qual),
        jnp.asarray(batch.refpos.astype(np.int32)),
        jnp.asarray(st.astype(np.int32)),
        jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
        jnp.asarray(np.ones(len(a), bool)), ovw))
    np.testing.assert_array_equal(got, want)
    assert (got != before).sum() > 100


def test_arbitrate_without_pairs_returns_qual_unchanged():
    _rng, _ref, batch = _sim(5, n_pairs=8, L=30)
    st = sem.strand(batch.flag, batch.xg)
    none = np.zeros(0, np.int64)
    got = _arbitrate(batch.seq, batch.qual, batch.refpos, st, none, none,
                     None, 128)
    np.testing.assert_array_equal(got, batch.qual)


def test_arbitrate_pad_pairs_alias_row():
    """Pairs marked invalid may point both mates at one row (the JAX
    package's pad convention): that row keeps its quals and real pairs are
    still rewritten."""
    rng = np.random.default_rng(5)
    n, L = 8, 32
    seq = rng.integers(0, 16, (n, L)).astype(np.uint8)
    qual = rng.integers(0, 42, (n, L)).astype(np.uint8)
    start = rng.integers(0, 10, n).astype(np.int32)
    refpos = start[:, None] + np.arange(L, dtype=np.int32)[None, :]
    strand = np.ones(n, np.int32)
    pair_a = np.array([0, n - 1, n - 1])
    pair_b = np.array([1, n - 1, n - 1])
    pv = np.array([True, False, False])
    want = qual.copy()
    psem.arbitrate_overlaps(seq, want, refpos, strand, pair_a[:1], pair_b[:1])
    got = _arbitrate(seq, qual, refpos, strand, pair_a, pair_b, pv, 128)
    np.testing.assert_array_equal(got, want)
    assert (got != qual).any()


def test_arbitrate_indels_and_far_bases():
    """Mates with deletions (a base past the dense window keeps its qual)
    and insertions (refpos -1), against the numpy oracle and the JAX
    program."""
    _rng, _ref, batch = _sim(11, n_pairs=40, L=60)
    batch.refpos[::5, 30:] += 4
    batch.refpos[3::7, 10] = -1
    batch.refpos[2, 50:] += 400  # beyond ovw
    st = sem.strand(batch.flag, batch.xg)
    a, b = sem.pair_mates(batch.qname, batch.flag)
    got = _arbitrate(batch.seq, batch.qual, batch.refpos, st, a, b, None, 128)
    want = np.asarray(jdev.arbitrate_device(
        jnp.asarray(batch.seq), jnp.asarray(batch.qual),
        jnp.asarray(batch.refpos.astype(np.int32)),
        jnp.asarray(st.astype(np.int32)), jnp.asarray(a.astype(np.int32)),
        jnp.asarray(b.astype(np.int32)), jnp.asarray(np.ones(len(a), bool)),
        128))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("masked", [False, True])
def test_pileup_parity(seed, masked):
    rng, ref_ascii, batch = _sim(seed)
    st = sem.strand(batch.flag, batch.xg)
    a, b = sem.pair_mates(batch.qname, batch.flag)
    psem.arbitrate_overlaps(batch.seq, batch.qual, batch.refpos, st, a, b)
    W = 4096
    keep_base = rng.random(batch.seq.shape) < 0.8 if masked \
        else np.ones(batch.seq.shape, bool)
    host = psem.pileup_channels(batch.seq, batch.qual, batch.refpos, st,
                                keep_base, ref_ascii, 0, 0, W, 5)
    got = prog.pileup_device(
        _t(batch.seq), _t(batch.qual), _t(batch.refpos, np.int32),
        _t(st, np.int32), torch.ones(batch.n, dtype=torch.bool),
        _t(keep_base) if masked else None, _t(ref_ascii), 0, 0, W, 5).numpy()
    assert got.dtype == np.int32 and got.shape == (W, 4)
    np.testing.assert_array_equal(got.view(np.uint32), host)
    want = np.asarray(jdev.pileup_device(
        jnp.asarray(batch.seq), jnp.asarray(batch.qual),
        jnp.asarray(batch.refpos.astype(np.int32)),
        jnp.asarray(st.astype(np.int32)), jnp.ones(batch.n, bool),
        jnp.asarray(keep_base), jnp.asarray(ref_ascii), 0, 0, W, 5))
    np.testing.assert_array_equal(got.view(np.uint32), want)
    assert host[:, 0].sum() > 100 and host[:, 2].sum() > 100


def test_pileup_window_offsets_and_dropped_reads():
    """A window that starts inside the reference fetch (win_offset <
    win_start), reads that straddle both edges, and keep_read dropping every
    third read."""
    _rng, ref_ascii, batch = _sim(13, n_pairs=80, L=80, glen=3000)
    st = sem.strand(batch.flag, batch.xg)
    keep_read = np.ones(batch.n, bool)
    keep_read[::3] = False
    off, start, W = 998, 1000, 1024
    sub = ref_ascii[off : start + W + 10]
    kb = np.ones(batch.seq.shape, bool) & keep_read[:, None]
    host = psem.pileup_channels(batch.seq, batch.qual, batch.refpos, st, kb,
                                sub, off, start, start + W, 5)
    got = prog.pileup_device(
        _t(batch.seq), _t(batch.qual), _t(batch.refpos, np.int32),
        _t(st, np.int32), _t(keep_read), None, _t(sub), off, start, W,
        5).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), host)
    assert host.sum() > 500


@pytest.mark.parametrize("min_conv_eff,use_overlaps", [
    (0.0, True), (0.3, True), (0.3, False)])
def test_window_pipeline_matches_jax_and_host(min_conv_eff, use_overlaps):
    """The whole pipeline from flags to counters, bounds set: bit-equal to
    the JAX program and to the chain of numpy oracles."""
    _rng, ref_ascii, batch = _sim(7, n_pairs=40, L=80, glen=3000)
    a, b = sem.pair_mates(batch.qname, batch.flag)
    bounds = [2, 70, 4, 75] * 4
    abounds = [1, 2, 3, 1] * 4
    W, ovw, min_phred = 2816, 256, 5
    keep_read = np.ones(batch.n, bool)
    keep_base = np.ones(batch.seq.shape, bool)
    statics = dict(wpad=W, ovw=ovw, min_phred=min_phred,
                   min_conv_eff=min_conv_eff, use_overlaps=use_overlaps)
    got = prog.window_pipeline(
        _t(batch.seq), _t(batch.qual), _t(batch.refpos, np.int32),
        _t(batch.flag, np.int32), _t(batch.xg), _t(batch.l_qseq),
        _t(batch.mapq), _t(keep_read), _t(keep_base), _t(a, np.int64),
        _t(b, np.int64), _t(np.ones(len(a), bool)), _t(ref_ascii),
        _t(bounds, np.int32), _t(abounds, np.int32), 0, 0,
        **statics).numpy().view(np.uint32)
    want = np.asarray(jdev.window_pipeline(
        jnp.asarray(batch.seq), jnp.asarray(batch.qual),
        jnp.asarray(batch.refpos.astype(np.int32)),
        jnp.asarray(batch.flag.astype(np.uint16)), jnp.asarray(batch.xg),
        jnp.asarray(batch.l_qseq), jnp.asarray(batch.mapq),
        jnp.asarray(keep_read), jnp.asarray(keep_base),
        jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
        jnp.asarray(np.ones(len(a), bool)), jnp.asarray(ref_ascii),
        jnp.asarray(np.array(bounds, np.int32)),
        jnp.asarray(np.array(abounds, np.int32)), 0, 0, **statics))
    np.testing.assert_array_equal(got, want)

    st = psem.strand(batch.flag, batch.xg)
    hseq, hqual = batch.seq.copy(), batch.qual.copy()
    keep = np.ones(batch.n, bool)
    if min_conv_eff > 0:
        eff = psem.conversion_efficiency(hseq, hqual, batch.refpos, st,
                                         ref_ascii, 0, min_phred)
        keep = eff.astype(np.float32) >= np.float32(min_conv_eff)
        assert 0 < keep.sum() < batch.n
    psem.trim_alignment(hseq, hqual, batch.l_qseq, st, batch.flag, bounds)
    psem.trim_absolute(hseq, hqual, batch.l_qseq, st, batch.flag, abounds)
    if use_overlaps:
        psem.arbitrate_overlaps(hseq, hqual, batch.refpos, st, a, b)
    host = psem.pileup_channels(hseq, hqual, batch.refpos, st,
                                keep_base & keep[:, None], ref_ascii, 0, 0,
                                W, min_phred)
    np.testing.assert_array_equal(got, host)
    assert host[:, :2].sum() > 100


def test_dense_dispatch_matches_host_backend(monkeypatch):
    """tests/test_device_parity.py:113 on the port: with MDTPU_NO_PALLAS=1
    the backend's window is the dense dispatch and equals the host engine at
    every position and channel."""
    import copy

    from methyldackel_tpu.config import Config
    from methyldackel_tpu.engine.extract import compute_window_counters_host

    monkeypatch.setenv("MDTPU_NO_PALLAS", "1")
    _rng, ref_ascii, batch = _sim(7, n_pairs=40, L=80, glen=3000)
    cfg = Config()
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, bool)
    host = compute_window_counters_host(cfg, copy.deepcopy(batch), st, keep,
                                        ref_ascii, 0, 0, 2800)
    backend = PortBackend(cfg)
    got = backend(cfg, copy.deepcopy(batch), st, keep, ref_ascii, 0, 0, 2800)
    np.testing.assert_array_equal(got, host)
    assert got.dtype == np.uint32
    assert backend.launches["dense"] == 1 and backend.host_routed == 0
    # nothing kept, nothing launched
    got = backend(cfg, port_batch(copy.deepcopy(batch)), st,
                  np.zeros(batch.n, bool), ref_ascii, 0, 0, 2800)
    assert not got.any() and backend.launches["dense"] == 1


# ------------------------------------------------------------------- CLI

def _run_three(monkeypatch, d, args, port_env):
    """The JAX package's host engine in d/ref, the port's host engine in
    d/host and the port on the CPU device in d/port, same -o prefix;
    asserts equal, non-empty files and returns the port's backend."""
    for sub in ("ref", "host", "port"):
        (d / sub).mkdir()
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    monkeypatch.chdir(d / "ref")
    assert ref_cli.main(["extract", *args]) == 0
    monkeypatch.chdir(d / "host")
    assert port_cli.main(["extract", *args]) == 0
    monkeypatch.delenv("MDTPU_ENGINE")
    monkeypatch.setenv("MDTPU_STEAL", "0")
    for k, v in port_env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(d / "port")
    rc, backend = port_cli.extract(args, device="cpu")
    assert rc == 0
    names = sorted(os.listdir(d / "host"))
    assert names and names == sorted(os.listdir(d / "port"))
    for name in names:
        data = (d / "port" / name).read_bytes()
        assert data.count(b"\n") > 20, name
        assert data == (d / "host" / name).read_bytes(), name
        assert data == (d / "ref" / name).read_bytes(), name
    return backend


def _synthetic(d, n_pairs, L, glen, seed):
    fa, bam = write_synthetic_input(str(d), n_pairs, L, glen, seed=seed)
    build_bai(BamFile(bam), bam + ".bai")
    return fa, bam


@pytest.mark.parametrize("threads", ["1", "3"])
def test_cli_stranded_bed_keepstrand(tmp_path, monkeypatch, threads):
    """A BED with a strand column under --keepStrand: every window carries
    a per-base strand mask and takes the dense dispatch."""
    fa, bam = _synthetic(tmp_path, 1500, 100, 20000, 3)
    bed = tmp_path / "r.bed"
    bed.write_text("chrSim\t500\t6000\ta\t0\t+\n"
                   "chrSim\t7000\t12000\tb\t0\t-\n"
                   "chrSim\t13000\t19000\tc\t0\t.\n")
    backend = _run_three(
        monkeypatch, tmp_path,
        ["--chunkSize", "4000", "-@", threads, "-l", str(bed),
         "--keepStrand", fa, bam, "-o", "o"], {})
    assert backend.launches["dense"] >= 4 and backend.host_routed == 0


def test_cli_reads_of_300_bp(tmp_path, monkeypatch):
    fa, bam = _synthetic(tmp_path, 500, 300, 20000, 5)
    backend = _run_three(monkeypatch, tmp_path,
                         ["--chunkSize", "5000", fa, bam, "-o", "o"], {})
    assert backend.launches["dense"] >= 4 and backend.host_routed == 0


@pytest.mark.parametrize("extra", [[], ["--CHG", "--CHH"],
                                   ["--minOppositeDepth", "2",
                                    "--maxVariantFrac", "0.2"]])
def test_cli_no_pallas(tmp_path, monkeypatch, extra):
    fa, bam = _synthetic(tmp_path, 1500, 100, 20000, 9)
    backend = _run_three(monkeypatch, tmp_path,
                         ["--chunkSize", "4000", *extra, fa, bam, "-o", "o"],
                         {"MDTPU_NO_PALLAS": "1"})
    assert backend.launches["dense"] >= 5 and backend.host_routed == 0


def test_cli_default_route_launches_no_dense_program(tmp_path, monkeypatch):
    fa, bam = _synthetic(tmp_path, 600, 100, 8000, 1)
    backend = _run_three(monkeypatch, tmp_path,
                         ["--chunkSize", "4000", fa, bam, "-o", "o"], {})
    assert backend.launches["dense"] == 0 and backend.host_routed == 0
