"""The port's mbias backend (methyldackel_tpu_torch.parallel.device
.make_mbias_backend with programs._mbias_reduce and programs.mbias_device)
on the CPU device against the JAX package's (methyldackel_tpu.parallel.device
.{make_mbias_backend, mbias_device, _mbias_reduce}, on the CPU) and the numpy
oracle semantics.mbias_counters, on seeded inputs; and the port's mbias CLI
(--txt and the SVG files) against both host engines. Integer counts and
text: every comparison is exact."""
import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from methyldackel_tpu import cli as ref_cli
from methyldackel_tpu.config import Config
from methyldackel_tpu.io import native as jnative
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.parallel import device as jdev
from methyldackel_tpu.utils.simulate import random_reference, simulate_batch
from methyldackel_tpu_torch import cli as port_cli
from methyldackel_tpu_torch.engine import mbias as pmbias
from methyldackel_tpu_torch.io import native as pnative
from methyldackel_tpu_torch.io.bai import build_bai
from methyldackel_tpu_torch.io.bam import BamFile
from methyldackel_tpu_torch.io.fasta import FastaFile
from methyldackel_tpu_torch.ops import semantics as psem
from methyldackel_tpu_torch.parallel import (device as pdev, programs as prog,
                                             select_mbias_backend)
from methyldackel_tpu_torch.utils.simulate import write_synthetic_input
from test_torch_convert import port_config


def _case(seed, n, L, glen):
    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = random_reference(rng, glen)
    batch = simulate_batch(rng, ref_codes, n_pairs=n // 2, read_len=L)
    return rng, ref_ascii, batch, sem.strand(batch.flag, batch.xg)


def _cfg(chunk):
    cfg = Config()
    cfg.chunkSize = chunk
    return cfg


def _port(cfg):
    return pdev.make_mbias_backend(port_config(cfg), "cpu")


def _three_ways(cfg, batch, st, keep_base, ref, off, start, end, keep_ctx,
                packed):
    """(oracle, port, JAX backend) on one window; ``packed`` hands pos and
    lq over, which opens the packed path."""
    if packed:
        _need_native()
    wl = int(batch.l_qseq.max())
    host = psem.mbias_counters(batch.seq, batch.qual, batch.refpos, st,
                               batch.flag, keep_base, ref, off, start, end,
                               keep_ctx, cfg.minPhred, wl)
    kw = dict(pos=batch.pos, lq=batch.l_qseq) if packed else {}
    backend = _port(cfg)
    got = backend(batch.seq, batch.qual, batch.refpos, st, batch.flag,
                  keep_base, ref, off, start, end, keep_ctx, wl, **kw)
    want = jdev.make_mbias_backend(cfg)(
        batch.seq, batch.qual, batch.refpos, st, batch.flag, keep_base, ref,
        off, start, end, keep_ctx, wl, **kw)
    assert got.dtype == np.uint32 and got.shape == (4, 2, 2, wl)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, want)
    assert host.sum() > 20
    return backend


@pytest.mark.parametrize("keep_ctx", [(1, 0, 0), (1, 1, 1), (0, 1, 1)])
def test_mbias_device_parity(keep_ctx):
    """The program over raw rows under a random per-base keep mask."""
    rng, ref_ascii, batch, st = _case(42, 30, 40, 800)
    keep_base = rng.random(batch.seq.shape) < 0.9
    backend = _three_ways(_cfg(512), batch, st, keep_base, ref_ascii, 0, 0,
                          512, keep_ctx, packed=False)
    assert backend.launches == {"reduce": 0, "legacy": 1}


def test_mbias_device_window_offsets():
    """Non-zero window start/offset and a truncated reference."""
    _rng, ref_ascii, batch, st = _case(7, 20, 32, 600)
    keep_base = np.ones(batch.seq.shape, bool)
    _three_ways(_cfg(256), batch, st, keep_base, ref_ascii[100:357], 100, 100,
                356, (1, 1, 1), packed=False)


@pytest.mark.parametrize("keep_ctx", [(1, 0, 0), (1, 1, 1)])
def test_mbias_device_program_matches_jax_program(keep_ctx):
    """programs.mbias_device against the jitted mbias_device on the same
    numpy arrays, all sixteen counters."""
    rng, ref_ascii, batch, st = _case(5, 40, 50, 900)
    keep_base = rng.random(batch.seq.shape) < 0.95
    t = torch.from_numpy
    got = prog.mbias_device(
        t(batch.seq), t(batch.qual), t(batch.refpos.astype(np.int32)),
        t(st.astype(np.int32)), t(batch.flag.astype(np.int32)), t(keep_base),
        t(ref_ascii), 0, 0, 800, keep_ctx=keep_ctx, min_phred=5).numpy()
    want = np.asarray(jdev.mbias_device(
        jnp.asarray(batch.seq), jnp.asarray(batch.qual),
        jnp.asarray(batch.refpos.astype(np.int32)),
        jnp.asarray(st.astype(np.int32)),
        jnp.asarray(batch.flag.astype(np.uint16)), jnp.asarray(keep_base),
        jnp.asarray(ref_ascii), jnp.int32(0), jnp.int32(0), jnp.int32(800),
        keep_ctx=tuple(bool(k) for k in keep_ctx), min_phred=5))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)
    assert (want.reshape(16, -1).sum(1) > 0).sum() >= 8


def _need_native():
    """Skip, from inside a test, where the native pack library is absent."""
    if not (pnative.available() and jnative.available()):
        pytest.skip("native library not built")


@pytest.mark.parametrize("keep_ctx", [(1, 0, 0), (1, 1, 1)])
def test_mbias_v3_pack_path_parity(keep_ctx):
    """A mixed batch: gapless rows through the pack and the reduction, rows
    shaped like indels through the oracle on the host."""
    _rng, ref_ascii, batch, st = _case(90, 80, 50, 1200)
    batch.refpos[5, 20:] += 3
    batch.refpos[11, 7] = -1
    keep_base = np.ones(batch.seq.shape, bool)
    backend = _three_ways(_cfg(1024), batch, st, keep_base, ref_ascii, 0, 0,
                          1024, keep_ctx, packed=True)
    assert backend.launches == {"reduce": 1, "legacy": 0}


def test_mbias_v3_nonzero_window_parity():
    _rng, ref_ascii, batch, st = _case(91, 60, 40, 900)
    keep_base = np.ones(batch.seq.shape, bool)
    backend = _three_ways(_cfg(256), batch, st, keep_base, ref_ascii[150:410],
                          150, 150, 406, (1, 1, 1), packed=True)
    assert backend.launches["reduce"] == 1


@pytest.mark.parametrize("L", [149, 150, 151])
@pytest.mark.parametrize("packed", [True, False])
def test_mbias_read_lengths_off_a_multiple_of_four(L, packed):
    """The packed path returns 4 * ceil(L / 4) cycles and is cropped to the
    longest read; the program over raw rows returns exactly L."""
    _rng, ref_ascii, batch, st = _case(100 + L, 40, L, 2500)
    keep_base = np.ones(batch.seq.shape, bool)
    backend = _three_ways(_cfg(2048), batch, st, keep_base, ref_ascii, 0, 0,
                          2048, (1, 1, 1), packed=packed)
    assert backend.launches["reduce" if packed else "legacy"] == 1


def test_mbias_grows_to_max_len():
    """max_len above what the rows give: zero-grown, as the engine's merge
    expects."""
    _need_native()
    _rng, ref_ascii, batch, st = _case(3, 20, 30, 600)
    cfg = _cfg(512)
    keep_base = np.ones(batch.seq.shape, bool)
    for kw in ({}, dict(pos=batch.pos, lq=batch.l_qseq)):
        got = _port(cfg)(batch.seq, batch.qual, batch.refpos, st, batch.flag,
                         keep_base, ref_ascii, 0, 0, 512, (1, 1, 1), 45, **kw)
        host = psem.mbias_counters(batch.seq, batch.qual, batch.refpos, st,
                                   batch.flag, keep_base, ref_ascii, 0, 0,
                                   512, (1, 1, 1), cfg.minPhred, 45)
        assert got.shape == (4, 2, 2, 45)
        np.testing.assert_array_equal(got, host)


def test_mbias_bed_window_takes_the_raw_rows_program():
    """A keep mask that is not all true (a BED window) takes
    programs.mbias_device even with pos and lq given."""
    rng, ref_ascii, batch, st = _case(17, 40, 40, 900)
    keep_base = np.ones(batch.seq.shape, bool)
    keep_base[:, :10] = False
    keep_base[rng.random(batch.n) < 0.3] = False
    backend = _three_ways(_cfg(512), batch, st, keep_base, ref_ascii, 0, 0,
                          800, (1, 1, 1), packed=True)
    assert backend.launches == {"reduce": 0, "legacy": 1}


def test_mbias_zero_simple_rows():
    """Every row shaped like an indel: the reduction runs on Nb = 0 and the
    oracle's fold gives the whole answer."""
    _need_native()
    _rng, ref_ascii, batch, st = _case(23, 20, 40, 900)
    batch.refpos[:, 20:] += 2
    assert not pnative.v3_flags(batch.seq, batch.refpos, batch.pos,
                                batch.l_qseq).any()
    keep_base = np.ones(batch.seq.shape, bool)
    backend = _three_ways(_cfg(512), batch, st, keep_base, ref_ascii, 0, 0,
                          800, (1, 1, 1), packed=True)
    assert backend.launches == {"reduce": 1, "legacy": 0}


def test_mbias_empty_window_launches_nothing():
    backend = _port(_cfg(512))
    z = np.zeros((0, 40), np.uint8)
    got = backend(z, z, np.zeros((0, 40), np.int32), np.zeros(0, np.int32),
                  np.zeros(0, np.uint16), np.zeros((0, 40), bool),
                  np.zeros(10, np.uint8), 0, 0, 10, (1, 0, 0), 40)
    assert got.shape == (4, 2, 2, 40) and got.dtype == np.uint32
    assert not got.any() and backend.launches == {"reduce": 0, "legacy": 0}


@pytest.mark.parametrize("n_rows", [0, 1, 300])
def test_mbias_reduce_matches_jax_reduce(n_rows):
    """programs._mbias_reduce against the jitted _mbias_reduce on the codes
    the native pack gives (exact Nb, zero rows included)."""
    _need_native()
    _rng, ref_ascii, batch, st = _case(31, 300, 50, 3000)
    rows = np.arange(n_rows)
    ctype, _ = psem.classify_context(ref_ascii)
    kept = np.array([1, 1, 1, 0], bool)[ctype]
    Lq = 13
    codes, combo = pnative.mbias_pack(
        batch.seq, batch.qual, rows, batch.pos, batch.l_qseq,
        st.astype(np.int32), batch.flag.astype(np.uint16),
        (kept & (ref_ascii == ord("C"))).astype(np.uint8),
        (kept & (ref_ascii == ord("G"))).astype(np.uint8), 0, 0, 3000, Lq,
        n_rows, 5)
    assert codes.shape == (n_rows, Lq) and combo.shape == (n_rows,)
    got = prog._mbias_reduce(torch.from_numpy(codes),
                             torch.from_numpy(combo)).numpy()
    assert got.dtype == np.int32 and got.shape == (4, 2, 2, 52)
    if n_rows:
        want = np.asarray(jdev._mbias_reduce(jnp.asarray(codes),
                                             jnp.asarray(combo), Lq=Lq))
        np.testing.assert_array_equal(got.view(np.uint32), want)
        if n_rows > 1:
            assert got.sum() > 100
    else:
        assert not got.any()


# ------------------------------------------------------------------- CLI

def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _run_three(monkeypatch, d, args):
    """mbias of the JAX package's host engine (prefix d/ref/p), the port's
    host engine (d/host/p) and the port on the CPU device (d/port/p):
    stdout and every file equal. Returns the port's backend, its stdout
    and the names of the files."""
    _need_native()
    texts = {}
    for sub in ("ref", "host", "port"):
        (d / sub).mkdir()
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    monkeypatch.chdir(d / "ref")
    rc, texts["ref"] = _capture(lambda: ref_cli.main(["mbias", *args, "p"]))
    assert rc == 0
    monkeypatch.chdir(d / "host")
    rc, texts["host"] = _capture(lambda: port_cli.main(["mbias", *args, "p"]))
    assert rc == 0
    monkeypatch.delenv("MDTPU_ENGINE")
    monkeypatch.chdir(d / "port")
    (rc, backend), texts["port"] = _capture(
        lambda: pmbias.mbias([*args, "p"], device="cpu"))
    assert rc == 0
    assert texts["port"] == texts["host"] == texts["ref"]
    names = sorted(os.listdir(d / "host"))
    assert names == sorted(os.listdir(d / "port")) == \
        sorted(os.listdir(d / "ref"))
    for name in names:
        data = (d / "port" / name).read_bytes()
        assert data == (d / "host" / name).read_bytes(), name
        assert data == (d / "ref" / name).read_bytes(), name
    return backend, texts["port"], names


@pytest.fixture(scope="module")
def synthetic_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("mbias_syn")
    fa, bam = write_synthetic_input(str(d), 3000, 100, 30000, seed=3)
    build_bai(BamFile(bam), bam + ".bai")
    return fa, bam


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("extra", [[], ["--CHG", "--CHH"]])
def test_mbias_cli_matches_both_host_engines(tmp_path, monkeypatch,
                                             synthetic_input, threads, extra):
    fa, bam = synthetic_input
    backend, text, names = _run_three(
        monkeypatch, tmp_path,
        ["--txt", "-@", threads, "--chunkSize", "3000", *extra, fa, bam])
    assert text.count("\n") > 150
    assert sorted(names) == ["p_OB.svg", "p_OT.svg"]
    assert backend.launches == {"reduce": 10, "legacy": 0}


def test_mbias_cli_bed_windows(tmp_path, monkeypatch, synthetic_input):
    """With -l every window has a per-base keep mask: the raw-rows program
    does them all."""
    fa, bam = synthetic_input
    bed = tmp_path / "r.bed"
    bed.write_text("chrSim\t1000\t9000\ta\t0\t+\n"
                   "chrSim\t14000\t26000\tb\t0\t-\n")
    backend, text, _names = _run_three(
        monkeypatch, tmp_path,
        ["--txt", "--chunkSize", "3000", "-l", str(bed), "--keepStrand", fa,
         bam])
    assert text.count("\n") > 100
    assert backend.launches["legacy"] >= 6 and backend.launches["reduce"] == 0


def test_mbias_cli_no_svg_and_region(tmp_path, monkeypatch, synthetic_input):
    fa, bam = synthetic_input
    _backend, text, names = _run_three(
        monkeypatch, tmp_path,
        ["--noSVG", "-r", "chrSim:5000-16000", "--chunkSize", "2000", fa,
         bam])
    assert text.count("\n") > 100 and names == []


def test_select_mbias_backend_modes(monkeypatch):
    """host is the numpy engine; cuda (also the default) and mesh (for mbias
    the card's backend) need a card and raise without one, naming
    MDTPU_ENGINE=host; auto and anything else is rejected, never a silent
    move to the CPU."""
    cfg = port_config(Config())
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    assert select_mbias_backend(cfg) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("auto", "jax"):
        monkeypatch.setenv("MDTPU_ENGINE", mode)
        with pytest.raises(ValueError, match=mode):
            select_mbias_backend(cfg)
    for mode in ("cuda", "mesh"):
        monkeypatch.setenv("MDTPU_ENGINE", mode)
        with pytest.raises(RuntimeError, match="MDTPU_ENGINE=host"):
            select_mbias_backend(cfg)
    monkeypatch.delenv("MDTPU_ENGINE")
    with pytest.raises(RuntimeError, match="MDTPU_ENGINE=host"):
        select_mbias_backend(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        pdev.make_mbias_backend(cfg, "cuda")


def test_mbias_cli_defaults_to_the_card(tmp_path, monkeypatch,
                                        synthetic_input):
    """With MDTPU_ENGINE unset the command asks for the card and raises
    where there is none; it does not compute on the CPU instead."""
    fa, bam = synthetic_input
    monkeypatch.delenv("MDTPU_ENGINE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="MDTPU_ENGINE=host"):
        port_cli.main(["mbias", "--noSVG", fa, bam])


def test_mbias_multi_host_is_not_ported(synthetic_input):
    """What this test once refused now runs: with nHosts > 1 compute_mbias
    counts the windows of its residue class only, and the classes add up to
    the one-host counters (uint64 adds, exact)."""
    fa, bam = synthetic_input
    fasta = FastaFile(fa)

    def counters(n_hosts, host_id):
        cfg = port_config(_cfg(3000))
        cfg.nHosts, cfg.hostId = n_hosts, host_id
        got, backend = pmbias.compute_mbias(cfg, BamFile(bam), fasta,
                                            device="cpu")
        assert backend is not None
        return got

    whole = counters(1, 0)
    parts = [counters(3, h) for h in range(3)]
    assert all(0 < p.sum() < whole.sum() for p in parts)
    np.testing.assert_array_equal(sum(parts), whole)
