"""The port's perRead backend (methyldackel_tpu_torch.parallel.device
.make_perread_backend with programs._perread_reduce and
programs.perread_device) on the CPU device against the JAX package's
(methyldackel_tpu.parallel.device.{make_perread_backend, perread_device,
_perread_reduce}, on the CPU), the vectorised host walker
process_reads_gapless and the scalar state machine process_read, on seeded
inputs; and the port's perRead CLI against both host engines. Integer
tallies and text: every comparison is exact."""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from methyldackel_tpu import cli as ref_cli
from methyldackel_tpu.config import Config
from methyldackel_tpu.io import native as jnative
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.parallel import device as jdev
from methyldackel_tpu.utils.simulate import (random_reference, simulate_batch,
                                             simulate_batch_fast)
from methyldackel_tpu_torch import cli as port_cli
from methyldackel_tpu_torch.config import perread_defaults
from methyldackel_tpu_torch.engine import perread as pperread
from methyldackel_tpu_torch.io import native as pnative
from methyldackel_tpu_torch.io.bai import build_bai
from methyldackel_tpu_torch.io.bam import BamFile
from methyldackel_tpu_torch.parallel import (device as pdev, programs as prog,
                                             select_perread_backend)
from methyldackel_tpu_torch.utils.simulate import write_synthetic_input
from test_synthetic_e2e import write_fa
from test_torch_convert import port_config
from util_bam import write_bam


def _need_native():
    """Skip, from inside a test, where the native pack library is absent."""
    if not (pnative.available() and jnative.available()):
        pytest.skip("native library not built")


def _cfg(chunk, min_phred=5):
    cfg = Config()
    cfg.minPhred = min_phred
    cfg.chunkSize = chunk
    return cfg


def _port(cfg):
    return pdev.make_perread_backend(port_config(cfg), "cpu")


def _three_ways(cfg, seq, qual, pos, lq, st, ref, seq_start, seq_len):
    """(host walker, port, JAX backend) on one window's gapless rows."""
    want = pperread.process_reads_gapless(port_config(cfg), seq, qual, pos,
                                          lq, st, ref, seq_start, seq_len)
    backend = _port(cfg)
    got = backend(seq, qual, pos, lq, st, ref, seq_start, seq_len)
    jax_got = jdev.make_perread_backend(cfg)(seq, qual, pos, lq, st, ref,
                                             seq_start, seq_len)
    for g, w, j in zip(got, want, jax_got):
        assert g.dtype == np.int64 and g.shape == (len(seq),)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    return backend, got


def test_perread_device_parity_random():
    """Low quals so that the skip quirk fires often; a few rows
    cross-checked against the scalar state machine."""
    rng = np.random.default_rng(3)
    cfg = _cfg(512)
    ref_ascii, ref_codes = random_reference(rng, 1024)
    batch = simulate_batch(rng, ref_codes, n_pairs=25, read_len=44)
    batch.qual[rng.random(batch.qual.shape) < 0.3] = 2
    st = sem.strand(batch.flag, batch.xg)
    _backend, (nm, nu) = _three_ways(cfg, batch.seq, batch.qual, batch.pos,
                                     batch.l_qseq, st, ref_ascii, 0, 1024)
    assert nm.sum() + nu.sum() > 20
    pcfg = port_config(cfg)
    for i in range(0, batch.n, 7):
        L = int(batch.l_qseq[i])
        cigar = np.array([(L << 4) | 0], np.uint32)
        got = pperread.process_read(
            pcfg, batch.seq[i, :L], batch.qual[i, :L], cigar,
            int(batch.pos[i]), int(st[i]), ref_ascii, 0, 1024)
        assert got == (int(nm[i]), int(nu[i])), i


def test_perread_device_window_offset():
    """A truncated window with a non-zero start."""
    rng = np.random.default_rng(4)
    ref_ascii, ref_codes = random_reference(rng, 900)
    batch = simulate_batch(rng, ref_codes, n_pairs=15, read_len=36)
    st = sem.strand(batch.flag, batch.xg)
    sub = ref_ascii[198:500]
    _three_ways(_cfg(256), batch.seq, batch.qual, batch.pos, batch.l_qseq, st,
                sub, 198, len(sub))


def _lowq_batch(seed):
    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = random_reference(rng, 3000)
    batch = simulate_batch_fast(rng, ref_codes, 60, 60)
    low = rng.random(batch.qual.shape) < 0.15
    low[::2] = False  # sub-phred quals over half the rows
    batch.qual[low] = rng.integers(0, 5, int(low.sum())).astype(np.uint8)
    return ref_ascii, batch, sem.strand(batch.flag, batch.xg)


def test_perread_v3_lowq_rows_exact():
    """Rows holding a sub-phred base are redone by the exact host walker
    (the low-qual skip quirk, perRead.c:59-63); the others are tallied from
    the packed codes."""
    _need_native()
    ref_ascii, batch, st = _lowq_batch(77)
    backend, (nm, nu) = _three_ways(
        _cfg(4096), batch.seq, batch.qual, batch.pos, batch.l_qseq, st,
        ref_ascii, 0, len(ref_ascii))
    assert backend.launches == {"reduce": 1, "legacy": 0}
    assert nm.sum() + nu.sum() > 50


def _long_reads(L=1100, glen=4000, n=6):
    rng = np.random.default_rng(5)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), glen)
    pos = rng.integers(0, glen - L - 1, n).astype(np.int64)
    code_of = np.zeros(256, np.uint8)
    for b, c in ((65, 1), (67, 2), (71, 4), (84, 8)):
        code_of[b] = c
    seq = code_of[ref[pos[:, None] + np.arange(L)[None, :]]]
    qual = np.full((n, L), 30, np.uint8)
    qual[:, 7::50] = 2  # the quirk on the walker's path too
    return ref, seq, qual, pos, np.full(n, L, np.int32), np.ones(n, np.int32)


def test_perread_long_reads_fall_back_exactly():
    """Reads wider than the pack's row buffer (1020) take the lockstep
    walker over raw rows, not the pack."""
    _need_native()
    ref, seq, qual, pos, lq, st = _long_reads()
    backend, (nm, _nu) = _three_ways(_cfg(4000), seq, qual, pos, lq, st, ref,
                                     0, 4000)
    assert backend.launches == {"reduce": 0, "legacy": 1}
    assert int(nm.sum()) > 0
    # and the pack itself refuses over-wide rows
    res = pnative.perread_pack(seq, qual, np.arange(6, dtype=np.int64), pos,
                               lq, st, np.zeros(4000, np.int8), 0, 4000,
                               275, 6, 5)
    assert res is None


@pytest.mark.parametrize("min_phred", [5, 20])
def test_perread_device_program_matches_jax_program(min_phred):
    """programs.perread_device against the jitted perread_device and the
    scalar state machine, quals clustered around the threshold so that skip
    chains occur (tests/test_subcommands.py:99)."""
    rng = np.random.default_rng(99)
    glen, L, N = 600, 30, 300
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), glen)
    lq = rng.integers(5, L + 1, N).astype(np.int32)
    pos = rng.integers(0, glen - L - 2, N)
    seq = np.zeros((N, L), np.uint8)
    qual = np.zeros((N, L), np.uint8)
    for i in range(N):
        m = int(lq[i])
        seq[i, :m] = rng.choice([1, 2, 4, 8, 15], m)
        qual[i, :m] = rng.integers(17, 24, m)
    strand = rng.integers(1, 5, N).astype(np.int32)
    t = torch.from_numpy
    nm, nu = prog.perread_device(
        t(seq), t(qual), t(pos.astype(np.int32)), t(lq), t(strand), t(ref), 0,
        glen, min_phred=min_phred)
    assert nm.dtype == torch.int32
    jm, ju = jdev.perread_device(
        jnp.asarray(seq), jnp.asarray(qual),
        jnp.asarray(pos.astype(np.int32)), jnp.asarray(lq),
        jnp.asarray(strand), jnp.asarray(ref), jnp.int32(0), jnp.int32(glen),
        min_phred=min_phred)
    np.testing.assert_array_equal(nm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(nu.numpy(), np.asarray(ju))
    cfg = perread_defaults()
    cfg.minPhred = min_phred
    for i in range(N):
        m = int(lq[i])
        cigar = np.array([(m << 4) | 0], np.uint32)
        want = pperread.process_read(cfg, seq[i, :m], qual[i, :m], cigar,
                                     int(pos[i]), int(strand[i]), ref, 0,
                                     glen)
        assert want == (int(nm[i]), int(nu[i])), i
    assert int(nm.sum()) > 20 and int(nu.sum()) > 20


@pytest.mark.parametrize("n_rows", [0, 1, 120])
def test_perread_reduce_matches_jax_reduce(n_rows):
    """programs._perread_reduce against the jitted _perread_reduce on the
    codes the native pack gives (exact Nb, zero rows included)."""
    _need_native()
    ref_ascii, batch, st = _lowq_batch(78)
    rw = ref_ascii
    is_c, is_g = rw == ord("C"), rw == ord("G")
    dirv = np.zeros(len(rw), np.int8)
    dirv[:-1][is_c[:-1] & is_g[1:]] = 1
    dirv[1:][is_g[1:] & is_c[:-1]] = -1
    sel = slice(0, n_rows)
    codes, haslow = pnative.perread_pack(
        np.ascontiguousarray(batch.seq[sel]),
        np.ascontiguousarray(batch.qual[sel]),
        np.arange(n_rows, dtype=np.int64), batch.pos[sel], batch.l_qseq[sel],
        st[sel].astype(np.int32), dirv, 0, len(rw), 15, n_rows, 5)
    assert codes.shape == (n_rows, 15) and haslow.shape == (n_rows,)
    nm, nu = prog._perread_reduce(torch.from_numpy(codes))
    assert nm.dtype == torch.int32 and nm.shape == (n_rows,)
    if n_rows:
        jm, ju = jdev._perread_reduce(jnp.asarray(codes), Lq=15)
        np.testing.assert_array_equal(nm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(nu.numpy(), np.asarray(ju))
    if n_rows > 1:
        assert int(nm.sum()) > 5 and haslow.any() and not haslow.all()


def test_perread_empty_window_launches_nothing():
    backend = _port(_cfg(512))
    z = np.zeros((0, 40), np.uint8)
    fin = backend.dispatch(z, z, np.zeros(0, np.int64), np.zeros(0, np.int32),
                           np.zeros(0, np.int32), np.zeros(10, np.uint8), 0,
                           10)
    nm, nu = fin()
    assert nm.shape == (0,) and nu.shape == (0,)
    assert backend.launches == {"reduce": 0, "legacy": 0}


def test_perread_finish_closures_in_any_order():
    """Several dispatches stay open, as the engine's pipeline keeps them,
    and are finished out of order: each gives its own window's tallies."""
    _need_native()
    backend = _port(_cfg(4096))
    cfg = port_config(_cfg(4096))
    wins, fins = [], []
    for seed in (1, 2, 3, 4):
        ref_ascii, batch, st = _lowq_batch(seed)
        args = (batch.seq, batch.qual, batch.pos, batch.l_qseq, st, ref_ascii,
                0, len(ref_ascii))
        wins.append(args)
        fins.append(backend.dispatch(*args))
    for k in (2, 0, 3, 1):
        nm, nu = fins[k]()
        want = pperread.process_reads_gapless(cfg, *wins[k])
        np.testing.assert_array_equal(nm, want[0])
        np.testing.assert_array_equal(nu, want[1])
    assert backend.launches["reduce"] == 4


# ------------------------------------------------------------------- CLI

def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _run_three(monkeypatch, args, port_env=None):
    """perRead of the JAX package's host engine, the port's host engine and
    the port on the CPU device: equal stdout. Returns (backend, stdout)."""
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    rc, ref_out = _capture(lambda: ref_cli.main(["perRead", *args]))
    assert rc == 0
    rc, host_out = _capture(lambda: port_cli.main(["perRead", *args]))
    assert rc == 0
    monkeypatch.delenv("MDTPU_ENGINE")
    for k, v in (port_env or {}).items():
        monkeypatch.setenv(k, v)
    (rc, backend), port_out = _capture(
        lambda: pperread.perread(args, device="cpu"))
    assert rc == 0
    assert port_out == host_out == ref_out
    return backend, port_out


@pytest.fixture(scope="module")
def synthetic_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("perread_syn")
    fa, bam = write_synthetic_input(str(d), 3000, 100, 30000, seed=3)
    build_bai(BamFile(bam), bam + ".bai")
    return fa, bam


@pytest.mark.parametrize("depth", ["1", "6"])
def test_perread_cli_pipeline_depths(monkeypatch, synthetic_input, depth):
    """MDTPU_PIPELINE=1 and 6 give the same bytes, equal to both host
    engines."""
    _need_native()
    fa, bam = synthetic_input
    backend, out = _run_three(monkeypatch, ["--chunkSize", "3000", fa, bam],
                              {"MDTPU_PIPELINE": depth})
    assert out.count("\n") == 6000
    assert backend.launches == {"reduce": 10, "legacy": 0}


@pytest.mark.parametrize("extra", [["-@", "3"], ["-q", "20", "-F", "0x10"],
                                   ["-r", "chrSim:4000-21000"], ["-p", "25"]])
def test_perread_cli_options(monkeypatch, synthetic_input, extra):
    _need_native()
    fa, bam = synthetic_input
    backend, out = _run_three(monkeypatch,
                              ["--chunkSize", "3000", *extra, fa, bam])
    assert out.count("\n") > 500 and backend.launches["reduce"] > 0


def test_perread_cli_output_file_and_bed(tmp_path, monkeypatch,
                                         synthetic_input):
    _need_native()
    fa, bam = synthetic_input
    bed = tmp_path / "r.bed"
    bed.write_text("chrSim\t1000\t9000\nchrSim\t20000\t26000\n")
    monkeypatch.chdir(tmp_path)
    args = ["--chunkSize", "3000", "-l", str(bed), fa, bam]
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    assert ref_cli.main(["perRead", "-o", "ref.txt", *args]) == 0
    monkeypatch.delenv("MDTPU_ENGINE")
    rc, backend = pperread.perread(["-o", "port.txt", *args], device="cpu")
    assert rc == 0 and backend.launches["reduce"] > 0
    data = (tmp_path / "port.txt").read_bytes()
    assert data == (tmp_path / "ref.txt").read_bytes()
    assert 500 < data.count(b"\n") < 6000


def test_perread_cli_quirk_on_a_bam_built_here(tmp_path, monkeypatch):
    """A BAM built in the test with quals clustered around the gate, soft
    clips and indels: the haslow rows are redone on the host, the clipped
    and indel reads take the scalar walker, and stdout equals both host
    engines."""
    _need_native()
    rng = np.random.default_rng(99)
    glen, L = 2000, 60
    ref = "".join(rng.choice(list("ACGT"), glen, p=[0.2, 0.3, 0.3, 0.2]))
    write_fa(tmp_path / "g.fa", [("c", ref)])
    recs = []
    for i in range(300):
        p = int(rng.integers(0, glen - L - 5))
        kind = rng.random()
        if kind < 0.1:
            cigar, seq = "5S55M", "ACGTA" + ref[p : p + 55]
        elif kind < 0.2:
            cigar, seq = "30M2D30M", ref[p : p + 30] + ref[p + 32 : p + 62]
        else:
            cigar, seq = f"{L}M", ref[p : p + L]
        seq = "".join(("T" if c == "C" and rng.random() < 0.5 else c)
                      for c in seq)
        recs.append(dict(qname=f"r{i}", flag=0 if i % 2 else 0x10, tid=0,
                         pos=p, cigar=cigar, seq=seq, mtid=-1, mpos=-1,
                         qual=[int(q) for q in rng.integers(17, 24, len(seq))]))
    recs.sort(key=lambda r: r["pos"])
    write_bam(tmp_path / "r.bam", [("c", glen)], recs)
    monkeypatch.chdir(tmp_path)
    backend, out = _run_three(monkeypatch, ["-p", "20", "--chunkSize", "700",
                                            "g.fa", "r.bam"])
    assert out.count("\n") == 300 and backend.launches["reduce"] == 3
    counted = [int(line.split("\t")[4]) for line in out.splitlines()]
    assert sum(1 for c in counted if c > 0) > 100


def test_select_perread_backend_modes(monkeypatch):
    cfg = perread_defaults()
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    assert select_perread_backend(cfg) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("auto", "jax"):
        monkeypatch.setenv("MDTPU_ENGINE", mode)
        with pytest.raises(ValueError, match=mode):
            select_perread_backend(cfg)
    for mode in ("cuda", "mesh"):  # mesh: for perRead the card's backend
        monkeypatch.setenv("MDTPU_ENGINE", mode)
        with pytest.raises(RuntimeError, match="MDTPU_ENGINE=host"):
            select_perread_backend(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        pdev.make_perread_backend(cfg, "cuda")


def test_perread_cli_defaults_to_the_card(monkeypatch, synthetic_input):
    fa, bam = synthetic_input
    monkeypatch.delenv("MDTPU_ENGINE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MDTPU_ENGINE=host"):
        port_cli.main(["perRead", fa, bam])


def test_perread_multi_host_is_not_ported(synthetic_input, tmp_path):
    """What this test once refused now runs: with nHosts > 1 run_perread
    writes one shard file a window of its residue class and nothing to the
    stream, and merge_shards puts the one-host rows back in window order."""
    from methyldackel_tpu_torch.parallel.distributed import merge_shards

    fa, bam = synthetic_input

    def run(n_hosts, host_id, out):
        cfg = perread_defaults()
        cfg.FastaName, cfg.BAMName, cfg.chunkSize = fa, bam, 3000
        cfg.nHosts, cfg.hostId = n_hosts, host_id
        cfg.out_path = str(tmp_path / "pr.txt")
        assert pperread.run_perread(cfg, out, device="cpu") is not None

    whole = io.StringIO()
    run(1, 0, whole)
    for h in range(2):
        quiet = io.StringIO()
        run(2, h, quiet)
        assert quiet.getvalue() == ""
    shards = sorted(p.name for p in tmp_path.glob("pr.txt.h*.w*"))
    assert len(shards) > 4 and {n.split(".")[2] for n in shards} == {"h0", "h1"}
    assert merge_shards(str(tmp_path / "pr.txt")) == len(shards)
    assert (tmp_path / "pr.txt").read_text() == whole.getvalue()
    assert whole.getvalue().count("\n") > 100
