"""The port's (dp, sp) mesh engine (methyldackel_tpu_torch.parallel.mesh:
make_mesh, sharded_window_pipeline, run_sharded_window, make_mesh_backend) on
the CPU device against the JAX package's mesh engine of the same names and
the numpy host, on seeded inputs (the simulators of utils.simulate and
tests/util_bam.py), and the port's CLI under MDTPU_ENGINE=mesh against both
packages' MDTPU_ENGINE=host.

The JAX side runs once, in a process of its own on the virtual 8-device CPU
mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8,
MDTPU_FORCE_PLATFORM=cpu), which imports this module for the case builders
and writes its counters to an .npz. The port takes the same batches through
the converters of test_torch_convert.py. Counters are integers and files are
bytes: every comparison is exact (tolerance 0).

The conversion-efficiency gate is float32 on both sides and may differ from
numpy (and XLA from PyTorch) by one ulp at the threshold, so the gates that
are held against the JAX package and the numpy host run at min_conv_eff 0,
as the JAX package's own dry run does; with the gate on, the sharded step is
held against the port's one-device ``programs.window_pipeline`` (the same
float code, so equal to the bit).
"""
import contextlib
import copy
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from methyldackel_tpu import cli as jcli
from methyldackel_tpu.config import Config
from methyldackel_tpu.ops import semantics as jsem
from methyldackel_tpu.utils.simulate import (random_reference, simulate_batch,
                                             simulate_batch_fast)
from methyldackel_tpu_torch import cli as pcli
from methyldackel_tpu_torch.engine import extract as pextract
from methyldackel_tpu_torch.ops import semantics as psem
from methyldackel_tpu_torch.parallel import device as pdev
from methyldackel_tpu_torch.parallel import mesh as pmesh
from methyldackel_tpu_torch.parallel import programs as prog
from methyldackel_tpu_torch.parallel import select_backend

from test_torch_convert import port_batch, port_config
from test_torch_hoststack import _sc_pairs

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# (cells, sp) of every grid: 1, 2, 4 and 8 shards under the layout rule, and
# sp 1, 2, 4 spelled out
GRIDS = [(1, None), (2, None), (4, None), (8, None), (8, 1), (8, 2), (8, 4),
         (4, 1), (4, 4), (2, 2)]
# the JAX step needs wpad % sp == 0 and runs one cell as its one-chip engine
JAX_GRIDS = [g for g in GRIDS if g[0] > 1]
BOUNDS = [2, 28, 1, 30] * 4
ABS_BOUNDS = [1, 2, 0, 3] * 4


def _grid_id(g):
    return f"n{g[0]}-sp{g[1] or 'auto'}"


# ------------------------------------------------------------------ cases

def gate1_case(drop_last=False):
    """dryrun_multichip's first input: 32 pairs of 32 bp over 512 bp; with
    ``drop_last`` the last row goes, so the row count is odd and the last
    pair is a lone mate."""
    rng = np.random.default_rng(1)
    ref, codes = random_reference(rng, 512)
    batch = simulate_batch(rng, codes, n_pairs=32, read_len=32)
    if drop_last:
        for f in ("flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
                  "mpos", "xg", "nh", "seq", "qual", "refpos"):
            setattr(batch, f, getattr(batch, f)[:-1])
        batch.qname = batch.qname[:-1]
    return ref, batch


def gate2_case(singles_only=False):
    """dryrun_multichip's second input: 24 pairs of 40 bp in shuffled rows
    (the pairing comes from the qnames), one read whose mate is unmapped, one
    dropped read and a BED strand column. With ``singles_only`` no read is
    paired (zero pairs)."""
    rng = np.random.default_rng(5)
    ref, codes = random_reference(rng, 1024)
    batch = simulate_batch(rng, codes, n_pairs=24, read_len=40)
    order = rng.permutation(batch.n)
    for f in ("flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
              "mpos", "xg", "nh", "seq", "qual", "refpos"):
        setattr(batch, f, getattr(batch, f)[order])
    batch.qname = [batch.qname[i] for i in order]
    batch.flag = batch.flag.copy()
    batch.flag[1] |= 0x8
    if singles_only:
        batch.flag &= ~np.uint16(0x1)
    strand = jsem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, dtype=bool)
    keep[2] = False
    cfg = Config()
    cfg.chunkSize = 512
    rstrand = rng.integers(0, 3, 512).astype(np.int8)
    return cfg, batch, strand, keep, ref, rstrand


def gate3_case(n_pairs=10_000, W=131072):
    """dryrun_multichip's third input: 10,000 pairs of 150 bp over a 128k
    window, absolute trimming applied, 50 dropped reads, a BED strand column
    and minOppositeDepth 3 (all four channels live)."""
    rng = np.random.default_rng(11)
    ref, codes = random_reference(rng, W + 64)
    batch = simulate_batch_fast(rng, codes, n_pairs, 150)
    cfg = Config()
    cfg.chunkSize = W
    cfg.minOppositeDepth = 3
    cfg.maxVariantFrac = 0.25
    for s4 in range(4):
        cfg.absoluteBounds[4 * s4 : 4 * s4 + 4] = [5, 140, 3, 145]
    strand = jsem.strand(batch.flag, batch.xg)
    jsem.trim_absolute(batch.seq, batch.qual, batch.l_qseq, strand,
                       batch.flag, cfg.absoluteBounds)
    keep = np.ones(batch.n, dtype=bool)
    keep[rng.integers(0, batch.n, 50)] = False
    rstrand = rng.integers(0, 3, W).astype(np.int8)
    return cfg, batch, strand, keep, ref, rstrand


def jax_side(out_path):
    """Run in a process of its own: the JAX package's mesh engine on every
    case, saved under the keys the tests look up."""
    import jax

    from methyldackel_tpu.parallel import mesh as jmesh

    assert len(jax.devices()) == 8 and jax.devices()[0].platform == "cpu"
    out = {}
    for drop in (False, True):
        ref, batch = gate1_case(drop)
        for n, sp in JAX_GRIDS:
            out[f"g1/{int(drop)}/{n}/{sp}"] = jmesh.run_sharded_window(
                jmesh.make_mesh(n, sp), batch, ref, 0, 0, 512, min_phred=5,
                min_conv_eff=0.0, use_overlaps=True, bounds=BOUNDS,
                absolute_bounds=ABS_BOUNDS)
    for singles in (False, True):
        cfg, batch, strand, keep, ref, rstrand = gate2_case(singles)
        for n, sp in JAX_GRIDS:
            engine = jmesh.make_mesh_backend(cfg, n, sp=sp)
            out[f"g2/{int(singles)}/{n}/{sp}"] = engine(
                cfg, copy.deepcopy(batch), strand, keep, ref, 0, 0, 512,
                rstrand)
    cfg, batch, strand, keep, ref, rstrand = gate3_case()
    engine = jmesh.make_mesh_backend(cfg, 8, sp=4)
    out["g3/8/4"] = engine(cfg, copy.deepcopy(batch), strand, keep, ref, 0, 0,
                           131072, rstrand)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def jax_counters(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_mesh") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", MDTPU_FORCE_PLATFORM="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import sys, test_torch_mesh as t; t.jax_side(sys.argv[1])")
    res = subprocess.run([sys.executable, "-c", code, path], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return np.load(path)


def _cpu_mesh(n, sp):
    return pmesh.make_mesh(n, sp=sp, device="cpu")


@pytest.fixture()
def forced(monkeypatch):
    """MDTPU_MESH_FORCE=1: a one-cell grid keeps the sharded step."""
    monkeypatch.setenv("MDTPU_MESH_FORCE", "1")


# -------------------------------------------------------------- make_mesh

@pytest.mark.parametrize("n,sp,shape", [
    (1, None, (1, 1)), (2, None, (2, 1)), (3, None, (3, 1)),
    (4, None, (2, 2)), (6, None, (3, 2)), (8, None, (2, 4)),
    (16, None, (4, 4)), (8, 1, (8, 1)), (8, 2, (4, 2)), (4, 4, (1, 4))])
def test_make_mesh_layout_rule(n, sp, shape):
    """The JAX rule: sp 4, then 2, where it divides n and leaves dp >= 2;
    an explicit sp overrides. On the CPU every cell is the CPU."""
    mesh = _cpu_mesh(n, sp)
    assert mesh.shape == {"dp": shape[0], "sp": shape[1]}
    assert len(mesh.devices) == shape[0]
    assert all(len(row) == shape[1] for row in mesh.devices)
    assert {d for row in mesh.devices for d in row} == {torch.device("cpu")}
    assert all(isinstance(lane, pdev._DeviceLane)
               for row in mesh.lanes for lane in row)
    assert len({id(lane) for row in mesh.lanes for lane in row}) == n


def test_make_mesh_never_moves_to_the_cpu(monkeypatch):
    """Without a card the default device raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pmesh.make_mesh(8)
    with pytest.raises(RuntimeError, match="is_available"):
        pmesh.make_mesh_backend(port_config(Config()), 8)
    with pytest.raises(ValueError, match="unsupported"):
        pmesh.make_mesh(2, device="meta")
    with pytest.raises(ValueError, match="sp=3"):
        pmesh.make_mesh(8, sp=3, device="cpu")
    assert pmesh.device_count("cpu") == 1


def test_make_mesh_fills_round_robin_from_the_cards(monkeypatch):
    """Eight cells on two cards: cuda:0 and cuda:1 in turns, every cell a
    lane of its own (entries repeat when the cells outnumber the cards)."""
    monkeypatch.setattr(pmesh, "device_count", lambda device: 2)
    monkeypatch.setattr(pdev, "_DeviceLane", lambda d: ("lane", d))
    mesh = pmesh.make_mesh(8, device="cuda")
    flat = [d for row in mesh.devices for d in row]
    assert flat == [torch.device("cuda", i % 2) for i in range(8)]
    assert mesh.shape == {"dp": 2, "sp": 4}


def test_row_cuts_keep_pairs_together():
    for n in (0, 1, 2, 5, 7, 8, 33, 64, 1001):
        for dp in (1, 2, 3, 4, 8):
            cuts = pmesh._row_cuts(n, dp)
            assert cuts[0] == 0 and cuts[-1] == n and len(cuts) == dp + 1
            assert all(a <= b for a, b in zip(cuts, cuts[1:]))
            assert all(c % 2 == 0 for c in cuts[:-1])
            sizes = [b - a for a, b in zip(cuts, cuts[1:])]
            assert max(sizes) - min(sizes) <= 3


# ------------------------------------------------- gate 1: the sharded step

def _host_gate1(ref, batch, wpad, win_start=0, trim=True):
    b = port_batch(copy.deepcopy(batch))
    st = psem.strand(b.flag, b.xg)
    seq, qual = b.seq.copy(), b.qual.copy()
    if trim:
        psem.trim_alignment(seq, qual, b.l_qseq, st, b.flag, BOUNDS)
        psem.trim_absolute(seq, qual, b.l_qseq, st, b.flag, ABS_BOUNDS)
    a, c = psem.pair_mates(b.qname, b.flag)
    psem.arbitrate_overlaps(seq, qual, b.refpos, st, a, c)
    return psem.pileup_channels(seq, qual, b.refpos, st,
                                np.ones(seq.shape, bool), ref, 0, win_start,
                                win_start + wpad, 5)


@pytest.mark.parametrize("drop_last", [False, True], ids=["even", "odd-rows"])
@pytest.mark.parametrize("grid", GRIDS, ids=_grid_id)
def test_run_sharded_window_equals_jax_and_host(jax_counters, grid,
                                                drop_last):
    n, sp = grid
    ref, batch = gate1_case(drop_last)
    got = pmesh.run_sharded_window(
        _cpu_mesh(n, sp), port_batch(copy.deepcopy(batch)), ref, 0, 0, 512,
        min_phred=5, min_conv_eff=0.0, use_overlaps=True, bounds=BOUNDS,
        absolute_bounds=ABS_BOUNDS)
    assert got.dtype == np.uint32 and got.shape == (512, 4)
    host = _host_gate1(ref, batch, 512)
    np.testing.assert_array_equal(got, host)
    assert host[:, :2].sum() > 100 and host[:, 2].sum() > 100
    if grid in JAX_GRIDS:
        np.testing.assert_array_equal(
            got, jax_counters[f"g1/{int(drop_last)}/{n}/{sp}"])


@pytest.mark.parametrize("grid", [(8, 4), (8, 2), (4, 4), (2, 2)],
                         ids=_grid_id)
@pytest.mark.parametrize("wpad,win_start", [(500, 0), (301, 100), (3, 250),
                                            (0, 0)])
def test_window_that_sp_does_not_divide(grid, wpad, win_start):
    """The last slice is shorter, or empty (a window of 3 columns over 4
    slices of 1): no padding, the same counters as the host."""
    ref, batch = gate1_case()
    got = pmesh.run_sharded_window(
        _cpu_mesh(*grid), port_batch(copy.deepcopy(batch)), ref, 0, win_start,
        wpad, bounds=BOUNDS, absolute_bounds=ABS_BOUNDS)
    assert got.shape == (wpad, 4)
    np.testing.assert_array_equal(
        got, _host_gate1(ref, batch, wpad, win_start))


@pytest.mark.parametrize("grid", GRIDS, ids=_grid_id)
def test_conversion_efficiency_gate_is_shard_invariant(grid):
    """With the gate on, every grid equals the port's one-device
    window_pipeline (the same float32 code) to the bit, and the gate
    drops reads."""
    ref, batch = gate1_case()
    b = port_batch(batch)
    n = b.n
    kw = dict(wpad=512, ovw=128, min_phred=5, min_conv_eff=0.6,
              use_overlaps=True)
    flag = torch.from_numpy(b.flag.astype(np.int32))
    pa = torch.arange(0, n, 2)
    want = prog.window_pipeline(
        torch.from_numpy(b.seq), torch.from_numpy(b.qual),
        torch.from_numpy(b.refpos.astype(np.int32)), flag,
        torch.from_numpy(b.xg), torch.from_numpy(b.l_qseq),
        torch.from_numpy(b.mapq), torch.ones(n, dtype=torch.bool), None, pa,
        pa + 1, None, torch.from_numpy(ref),
        torch.zeros(16, dtype=torch.int32),
        torch.zeros(16, dtype=torch.int32), 0, 0,
        **kw).numpy().view(np.uint32)
    got = pmesh.run_sharded_window(_cpu_mesh(*grid), b, ref, 0, 0, 512,
                                   min_conv_eff=0.6)
    np.testing.assert_array_equal(got, want)
    ungated = pmesh.run_sharded_window(_cpu_mesh(*grid), b, ref, 0, 0, 512)
    assert 0 < got.sum() < ungated.sum()


def test_sharded_step_takes_tensors_and_defers_the_readback():
    """The step's callable takes tensors as well as arrays, and
    ``.dispatch`` returns a fetch() that holds its inputs."""
    ref, batch = gate1_case()
    b = port_batch(batch)
    step = pmesh.sharded_window_pipeline(
        _cpu_mesh(8, 2), wpad=512, ovw=128, min_phred=5, min_conv_eff=0.0,
        use_overlaps=False)
    args = (b.seq, b.qual, b.refpos.astype(np.int32),
            b.flag.astype(np.int32), b.xg, b.l_qseq, np.ones(b.n, bool), ref,
            np.zeros(16, np.int32), np.zeros(16, np.int32), 0, 0)
    want = step(*args)
    fetch = step.dispatch(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in args])
    assert fetch.inputs
    np.testing.assert_array_equal(fetch(), want)
    st = psem.strand(b.flag, b.xg)
    np.testing.assert_array_equal(want, psem.pileup_channels(
        b.seq, b.qual, b.refpos, st, np.ones(b.seq.shape, bool), ref, 0, 0,
        512, 5))  # use_overlaps False: no arbitration


# --------------------------------------------- gate 2: make_mesh_backend

@pytest.mark.parametrize("singles_only", [False, True],
                         ids=["pairs", "zero-pairs"])
@pytest.mark.parametrize("grid", GRIDS, ids=_grid_id)
def test_mesh_backend_equals_jax_and_host(jax_counters, forced, grid,
                                          singles_only):
    n, sp = grid
    cfg, batch, strand, keep, ref, rstrand = gate2_case(singles_only)
    pcfg = port_config(cfg)
    host = pextract.compute_window_counters_host(
        pcfg, port_batch(copy.deepcopy(batch)), strand, keep, ref, 0, 0, 512,
        rstrand)
    engine = pmesh.make_mesh_backend(pcfg, n, sp=sp, device="cpu")
    assert isinstance(engine, pmesh.MeshBackend)
    got = engine(pcfg, port_batch(copy.deepcopy(batch)), strand, keep, ref, 0,
                 0, 512, rstrand)
    assert got.dtype == np.uint32 and got.shape == (512, 4)
    np.testing.assert_array_equal(got, host)
    assert host.sum() > 100
    assert engine.launches == {"sharded": 1} and engine.host_routed == 0
    if grid in JAX_GRIDS:
        np.testing.assert_array_equal(
            got, jax_counters[f"g2/{int(singles_only)}/{n}/{sp}"])


@pytest.mark.parametrize("grid", [(8, None), (8, 1), (3, None)], ids=_grid_id)
def test_mesh_backend_zero_kept_reads_and_empty_batch(forced, grid):
    cfg, batch, strand, keep, ref, rstrand = gate2_case()
    pcfg = port_config(cfg)
    engine = pmesh.make_mesh_backend(pcfg, grid[0], sp=grid[1], device="cpu")
    none = engine(pcfg, port_batch(batch), strand, np.zeros(batch.n, bool),
                  ref, 0, 0, 512, rstrand)
    assert none.shape == (512, 4) and none.dtype == np.uint32
    assert not none.any() and engine.launches["sharded"] == 0
    # fewer rows than shards: 3 kept reads over 8 cells leave shards empty
    few = np.zeros(batch.n, bool)
    few[[0, 5, 9]] = True
    got = engine(pcfg, port_batch(copy.deepcopy(batch)), strand, few, ref, 0,
                 0, 512, None)
    np.testing.assert_array_equal(got, pextract.compute_window_counters_host(
        pcfg, port_batch(copy.deepcopy(batch)), strand, few, ref, 0, 0, 512,
        None))
    assert got.sum() > 0


def test_mesh_backend_window_offsets_and_no_bed(forced):
    """A window that starts inside the contig, its reference fetched from
    two bases before it (the engine's lpos2), and no BED column."""
    cfg, batch, strand, keep, ref, _ = gate2_case()
    pcfg = port_config(cfg)
    engine = pmesh.make_mesh_backend(pcfg, 8, device="cpu")
    args = (strand, keep, ref[298:], 298, 300, 811)
    got = engine(pcfg, port_batch(copy.deepcopy(batch)), *args)
    np.testing.assert_array_equal(got, pextract.compute_window_counters_host(
        pcfg, port_batch(copy.deepcopy(batch)), *args))
    assert got.shape == (511, 4) and got.sum() > 50


# ------------------------------------ gate 3: a realistic window, every sp

def test_realistic_window_every_sp_equal(jax_counters):
    cfg, batch, strand, keep, ref, rstrand = gate3_case()
    pcfg = port_config(cfg)
    host = pextract.compute_window_counters_host(
        pcfg, port_batch(copy.deepcopy(batch)), strand, keep, ref, 0, 0,
        131072, rstrand)
    results = []
    for sp in (1, 2, 4):
        engine = pmesh.make_mesh_backend(pcfg, 8, sp=sp, device="cpu")
        got = engine(pcfg, port_batch(copy.deepcopy(batch)), strand, keep,
                     ref, 0, 0, 131072, rstrand)
        np.testing.assert_array_equal(got, host)
        results.append(got)
    assert (host.sum(0) > 1000).all()  # all four channels live
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_array_equal(results[0], results[2])
    np.testing.assert_array_equal(results[2], jax_counters["g3/8/4"])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_gates_of_chip_smoke_on_the_cpu(n):
    """chip_smoke.py's three gates (what it runs with 8 streams of the card)
    with ``n`` shards on the CPU device, against the port's host
    functions."""
    from chip_smoke import mesh_gates

    sums = mesh_gates("cpu", n=n, rounds=1)
    assert len(sums) == 3 and all(s > 100 for s in sums)
    assert "MDTPU_MESH_FORCE" not in os.environ


# ------------------------------------------------ selection and the delegate

def test_one_device_delegates_to_the_device_backend(monkeypatch):
    """One device and no MDTPU_MESH_FORCE: the one-device engine (on the
    card, the tiled kernels); MDTPU_MESH_FORCE=1 keeps the (1, 1) grid."""
    cfg = port_config(Config())
    monkeypatch.delenv("MDTPU_MESH_FORCE", raising=False)
    assert type(pmesh.make_mesh_backend(cfg, device="cpu")) is \
        pdev.DeviceBackend
    assert type(pmesh.make_mesh_backend(cfg, 1, device="cpu")) is \
        pdev.DeviceBackend
    assert type(pmesh.make_mesh_backend(cfg, 2, device="cpu")) is \
        pmesh.MeshBackend
    monkeypatch.setenv("MDTPU_MESH_FORCE", "1")
    forced_one = pmesh.make_mesh_backend(cfg, device="cpu")
    assert type(forced_one) is pmesh.MeshBackend
    assert forced_one.mesh.shape == {"dp": 1, "sp": 1}


def test_mesh_engine_needs_a_card(monkeypatch):
    """MDTPU_ENGINE=mesh without a card raises and names MDTPU_ENGINE=host
    and the explicit CPU device; auto stays rejected."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MDTPU_ENGINE", "mesh")
    with pytest.raises(RuntimeError) as err:
        select_backend(port_config(Config()))
    assert "MDTPU_ENGINE=host" in str(err.value)
    assert "device='cpu'" in str(err.value)
    monkeypatch.setenv("MDTPU_ENGINE", "auto")
    with pytest.raises(ValueError, match="auto"):
        select_backend(port_config(Config()))


def test_select_backend_builds_the_mesh_on_the_card(monkeypatch):
    """With a card present MDTPU_ENGINE=mesh asks make_mesh_backend for the
    card's grid (here: recorded, no card needed)."""
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pmesh, "make_mesh_backend",
                        lambda cfg, **kw: asked.append(kw) or "mesh-backend")
    monkeypatch.setenv("MDTPU_ENGINE", "mesh")
    assert select_backend(port_config(Config())) == "mesh-backend"
    assert asked == [{"device": "cuda"}]


# ------------------------------------------------------------------ the CLI

def _cli(cli, d, args, **env):
    """``cli`` run in ``d`` under ``env``; returns what extract gave back."""
    d.mkdir()
    here = os.getcwd()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    os.chdir(d)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return cli(list(args))
    finally:
        os.chdir(here)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_CLI_CASES = [
    ("default", ["--chunkSize", "400"]),
    ("threads", ["--chunkSize", "64", "-@", "4"]),
    ("all_contexts_counts", ["--CHG", "--CHH", "--counts"]),
    ("variant_filtering", ["--minOppositeDepth", "2", "--maxVariantFrac",
                           "0.2"]),
    ("trimming_and_merge", ["--nOT", "5,5,4,4", "--mergeContext",
                            "--chunkSize", "333"]),
    ("bed_keep_strand", ["-l", "../r.bed", "--keepStrand"]),
    ("conversion_efficiency", ["--minConversionEfficiency", "0.5", "--CHH",
                               "--CHG"]),
    ("cytosine_report", ["--cytosine_report", "--CHH", "--CHG"]),
]


@pytest.mark.parametrize("cells", [8, 1], ids=["8-cells", "forced-1-cell"])
@pytest.mark.parametrize("name,extra", _CLI_CASES,
                         ids=[c[0] for c in _CLI_CASES])
def test_cli_mesh_files_equal_both_host_engines(tmp_path, monkeypatch, name,
                                                extra, cells):
    """`extract` under MDTPU_ENGINE=mesh on the CPU device (the scenarios of
    the JAX package's mesh tests): the files of the port's and of the JAX
    package's MDTPU_ENGINE=host, byte for byte, and every window went through
    the sharded step. MDTPU_STEAL=0 keeps the host lanes out of it."""
    _sc_pairs(tmp_path)
    monkeypatch.setattr(pmesh, "device_count", lambda device: cells)
    args = ["extract", *extra, "../g.fa", "../r.bam", "-o", "o"]
    assert _cli(jcli.main, tmp_path / "jax", args, MDTPU_ENGINE="host") == 0
    assert _cli(pcli.main, tmp_path / "host", args, MDTPU_ENGINE="host") == 0
    rc, backend = _cli(lambda a: pcli.extract(a[1:], device="cpu"),
                       tmp_path / "mesh", args, MDTPU_ENGINE="mesh",
                       MDTPU_MESH_FORCE="1", MDTPU_STEAL="0")
    assert rc == 0 and type(backend) is pmesh.MeshBackend
    assert backend.mesh.shape["dp"] * backend.mesh.shape["sp"] == cells
    assert backend.launches["sharded"] >= (20 if name == "threads" else 1)
    assert backend.host_routed == 0
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "host")) \
        == sorted(os.listdir(tmp_path / "mesh"))
    for f in files:
        want = (tmp_path / "jax" / f).read_bytes()
        assert (tmp_path / "host" / f).read_bytes() == want, f
        assert (tmp_path / "mesh" / f).read_bytes() == want, f
    assert max(len((tmp_path / "jax" / f).read_bytes()) for f in files) > 500


def test_cli_mesh_with_the_steal_lanes_and_two_hosts(tmp_path, monkeypatch):
    """The mesh backend under the default scheduler (host lanes stealing
    windows) and as host 1 of 2: the shards merge to the one-host bytes."""
    from methyldackel_tpu_torch.parallel.distributed import merge_shards

    _sc_pairs(tmp_path)
    monkeypatch.setattr(pmesh, "device_count", lambda device: 4)
    args = ["extract", "--chunkSize", "100", "../g.fa", "../r.bam", "-o", "o"]
    assert _cli(pcli.main, tmp_path / "host", args, MDTPU_ENGINE="host") == 0
    mesh_cli = lambda a: pcli.extract(a[1:], device="cpu")  # noqa: E731
    rc, _ = _cli(mesh_cli, tmp_path / "steal", args, MDTPU_ENGINE="mesh")
    assert rc == 0
    for h in ("0", "1"):
        d = tmp_path / f"h{h}"
        rc, backend = _cli(mesh_cli, d, args, MDTPU_ENGINE="mesh",
                           MDTPU_STEAL="0", MDTPU_NUM_HOSTS="2",
                           MDTPU_HOST_ID=h)
        assert rc == 0 and backend.launches["sharded"] >= 4
    # both hosts wrote beside their own -o: gather the shards, then merge
    for p in (tmp_path / "h1").iterdir():
        os.rename(p, tmp_path / "h0" / p.name)
    assert merge_shards(str(tmp_path / "h0" / "o_CpG.bedGraph")) >= 8
    want = (tmp_path / "host" / "o_CpG.bedGraph").read_bytes()
    assert (tmp_path / "steal" / "o_CpG.bedGraph").read_bytes() == want
    assert (tmp_path / "h0" / "o_CpG.bedGraph").read_bytes() == want
    assert want.count(b"\n") > 50
