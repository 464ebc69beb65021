"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch versions, and the port CLI on the card against the host engine.
They import no jax (the card's machine has none) and skip without a CUDA
device:

    python -m pytest tests/test_torch_card.py -m cuda
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from methyldackel_tpu_torch.ops import arbitrate as tar
from methyldackel_tpu_torch.ops import pileup as tpk
from methyldackel_tpu_torch.ops import pileup4 as tp4
from methyldackel_tpu_torch.parallel import host_prep as hp

from chip_smoke import (ARBITRATE_EDGE_CASES, PILEUP2_EDGE_CASES, _to_cuda,
                        arbitrate_edge_inputs, pileup2_edge_inputs,
                        pileup4_edge_inputs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 512


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("Lq", [38, 16])
def test_kernel_matches_plain_on_card(Lq):
    """All three widths, dense and compacted, rows straddling both ends."""
    _need_card()
    rng = np.random.default_rng(Lq)
    ntiles, n = 16, 4000
    W = ntiles * T
    f_pos = np.sort(rng.integers(-4 * Lq - 130, W + 40, n))
    tlo, thi = hp.tile_rows(f_pos, ntiles, 4 * Lq)
    host = (rng.integers(0, 256, (n, Lq), dtype=np.uint8),
            hp.row_spos(f_pos, rng.integers(0, 2, n)), tlo, thi,
            rng.integers(0, 256, W // 8, dtype=np.uint8),
            rng.integers(0, 256, W // 8, dtype=np.uint8))
    args = [torch.from_numpy(a).cuda() for a in host]
    cand = np.sort(rng.choice(W, W // 7, replace=False))
    dst = np.full(W, -1, np.int32)
    dst[cand] = np.arange(len(cand), dtype=np.int32)
    for sat in (8, 16, 32):
        for extra in ({}, dict(dst=torch.from_numpy(dst).cuda(),
                               out_width=len(cand))):
            kw = dict(ntiles=ntiles, sat_bits=sat, **extra)
            before = tpk.LAUNCHES
            got, gov = tpk.pileup2_tiles(*args, **kw)
            want, wov = tpk.pileup2_tiles_reference(*args, **kw)
            torch.cuda.synchronize()
            assert tpk.LAUNCHES == before + 1
            assert torch.equal(got.view(torch.uint8).cpu(),
                               want.view(torch.uint8).cpu())
            assert int(gov) == int(wov)


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,shift,chunk,split", PILEUP2_EDGE_CASES)
def test_pileup2_edge_cases_on_card(Lq, shift, chunk, split):
    """The edge cases of chip_smoke.py's phase 2 against the kernel: arrays
    off 16-byte alignment, a tile range of several chunks, forced small
    chunks, 1 to 16 lanes a column group, tiles without rows, a last tile whose
    tail has no output slot, a 5,000-row spike on one column (u8 flags the
    overflow, u16 and u32 are exact), rows of 38, 16, 9 and 1 bytes."""
    _need_card()
    rng = np.random.default_rng(200 + Lq + shift)
    args, kw = pileup2_edge_inputs(rng, Lq=Lq, shift=shift)
    d_args = [_to_cuda(a, shift if i < 2 else 0) for i, a in enumerate(args)]
    if shift:
        assert d_args[0].data_ptr() % 16 and d_args[1].data_ptr() % 16
    compact = dict(dst=kw["dst"].cuda(), out_width=kw["out_width"])
    for sat, flag in ((8, 1), (16, 0), (32, 0)):
        for extra in ({}, compact):
            k = dict(ntiles=kw["ntiles"], sat_bits=sat, **extra)
            got, gov = tpk.pileup2_tiles(*d_args, chunk_rows=chunk,
                                         split=split, **k)
            want, wov = tpk.pileup2_tiles_reference(*d_args, **k)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            assert int(gov) == int(wov) == flag
    cpu, _ = tpk.pileup2_tiles(*args, sat_bits=32, **kw)
    assert torch.equal(got.cpu().view(torch.uint8), cpu.view(torch.uint8))


def _bytes_equal(got, want):
    torch.cuda.synchronize()
    return torch.equal(got.view(torch.uint8).cpu(), want.view(torch.uint8).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("qual_mode", [False, True])
def test_pileup4_matches_plain_on_card(qual_mode):
    """Both layouts, NCH 2 and 4, all three widths, dense and compacted,
    rows straddling both ends, zero (gated or absent) codes."""
    _need_card()
    rng = np.random.default_rng(7 + qual_mode)
    ntiles, n, L = 16, 4000, 150
    W = ntiles * T
    f_pos = np.sort(rng.integers(-L - 130, W + 40, n))
    tlo, thi = hp.tile_rows(f_pos, ntiles, L)
    codes = np.array([0, 1, 2, 4, 8, 15, 3], np.uint8)[
        rng.integers(0, 7, (n, L if qual_mode else (L + 1) // 2))]
    if not qual_mode:
        codes = codes | (np.array([0, 1, 2, 4, 8, 15], np.uint8)[
            rng.integers(0, 6, codes.shape)] << 4)
    host = (codes, hp.row_spos(f_pos, rng.integers(0, 2, n)), tlo, thi,
            rng.integers(0, 256, W // 8, dtype=np.uint8),
            rng.integers(0, 256, W // 8, dtype=np.uint8))
    args = [torch.from_numpy(a).cuda() for a in host]
    mode = {}
    if qual_mode:
        mode = dict(qual=torch.from_numpy(rng.integers(
            0, 42, (n, L), dtype=np.uint8)).cuda(), min_phred=5)
    cand = np.sort(rng.choice(W, W // 7, replace=False))
    dst = np.full(W, -1, np.int32)
    dst[cand] = np.arange(len(cand), dtype=np.int32)
    for nch in (2, 4):
        for sat in (8, 16, 32):
            for extra in ({}, dict(dst=torch.from_numpy(dst).cuda(),
                                   out_width=len(cand))):
                kw = dict(ntiles=ntiles, nch=nch, sat_bits=sat, **extra,
                          **mode)
                key = "qual" if qual_mode else "nq"
                before = tp4.LAUNCHES[key]
                got, gov = tp4.pileup4_tiles(*args, **kw)
                want, wov = tp4.pileup4_tiles_reference(*args, **kw)
                assert tp4.LAUNCHES[key] == before + 1
                assert _bytes_equal(got, want)
                assert int(gov) == int(wov)


@pytest.mark.cuda
@pytest.mark.parametrize("qual_mode", [False, True])
@pytest.mark.parametrize("L,shift,chunk", [
    (151, 0, 8), (151, 5, None), (150, 3, 8), (36, 5, None), (150, 0, 1),
    (75, 5, 1000)])
def test_pileup4_staging_edge_cases_on_card(L, shift, chunk, qual_mode):
    """The staging's edge cases against the kernel: an odd read length,
    arrays off 16-byte alignment, chunks of 1, 8, the default and more rows
    than a chunk may hold (a 700-row tile range needs several either way),
    tiles without rows, a last tile whose tail has no output slot."""
    _need_card()
    rng = np.random.default_rng(100 + L + shift)
    args, kw = pileup4_edge_inputs(rng, L=L, qual_mode=qual_mode,
                                   shift=shift)
    d_args = [_to_cuda(a, shift if i < 2 else 0) for i, a in enumerate(args)]
    d_kw = dict(kw, dst=kw["dst"].cuda())
    if qual_mode:
        d_kw["qual"] = _to_cuda(kw["qual"], shift)
    if shift:
        assert d_args[0].data_ptr() % 16 and d_args[1].data_ptr() % 16
    for nch, sat in ((4, 16), (2, 8), (4, 32)):
        k = dict(d_kw, nch=nch, sat_bits=sat)
        got, gov = tp4.pileup4_tiles(*d_args, chunk_rows=chunk, **k)
        want, wov = tp4.pileup4_tiles_reference(*d_args, **k)
        assert _bytes_equal(got, want) and int(gov) == int(wov)
        cpu, _ = tp4.pileup4_tiles(*args, **dict(kw, nch=nch, sat_bits=sat))
        assert torch.equal(got.cpu().view(torch.uint8), cpu.view(torch.uint8))


@pytest.mark.cuda
def test_pileup_window_on_card_matches_cpu():
    """pileup_window runs on the card by default and equals its CPU path."""
    _need_card()
    rng = np.random.default_rng(12)
    n, L, W = 600, 101, 3000
    seq = np.array([1, 2, 4, 8, 15], np.uint8)[rng.integers(0, 5, (n, L))]
    qual = rng.integers(0, 42, (n, L), dtype=np.uint8)
    pos = rng.integers(-L, W, n)
    strand = rng.integers(1, 5, n)
    ref = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, W + 8)]
    before = tp4.LAUNCHES["qual"]
    got = tp4.pileup_window(seq, qual, pos, strand, ref, -3, W, min_phred=7)
    assert tp4.LAUNCHES["qual"] == before + 1
    want = tp4.pileup_window(seq, qual, pos, strand, ref, -3, W, min_phred=7,
                             device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 10000


@pytest.mark.cuda
def test_arbitrate_matches_plain_on_card():
    """Pairs 0-329 apart (some beyond two blocks or on different strand
    parities: not listed), N bases, code 0, ties, quals to 255, rewritten
    in place."""
    _need_card()
    rng = np.random.default_rng(3)
    P, L = 3000, 150
    n = 2 * P
    f_pos = np.sort(rng.integers(0, 200_000, n)).astype(np.int64)
    f_pos[1::2] = f_pos[0::2] + rng.integers(0, 330, P)
    order = np.argsort(f_pos, kind="stable")
    frame = np.empty(n, np.int64)
    frame[order] = np.arange(n)
    f_pos = f_pos[order]
    st = rng.integers(1, 3, n)
    st[1::2] = st[0::2]
    st[1::9] ^= 3
    st = st[order]
    pa, pb = hp.v2_pair_tables(f_pos - f_pos % 128, st, frame[0::2],
                               frame[1::2])
    assert 1000 < len(pa) < P
    seq = np.array([1, 2, 4, 8, 15, 0], np.uint8)[
        rng.choice(6, (n, L), p=[0.3, 0.2, 0.2, 0.2, 0.05, 0.05])]
    qual = rng.integers(0, 256, (n, L), dtype=np.uint8)
    dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
           for a in (seq, hp.row_spos(f_pos, st & 1), pa, pb)]
    q0 = torch.from_numpy(qual).cuda()
    got, want = q0.clone(), q0.clone()
    before = tar.LAUNCHES
    tar.arbitrate(dev[0], got, *dev[1:])
    tar.arbitrate_reference(dev[0], want, *dev[1:])
    torch.cuda.synchronize()
    assert tar.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want.cpu())
    assert int((got != q0).sum()) > 1000
    none = torch.zeros(0, dtype=torch.int32, device="cuda")
    tar.arbitrate(dev[0], got, dev[1], none, none)  # nothing to launch
    assert tar.LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("L,shift", ARBITRATE_EDGE_CASES)
def test_arbitrate_edge_cases_on_card(L, shift):
    """The edge cases of chip_smoke.py's phase 2 against the kernel: rows at
    odd addresses, every mate distance from -127 to L (overlaps of 1, 3, 4,
    5 ... L bytes at every alignment), every rule branch, ties that b wins;
    no byte outside a pair's overlap changes."""
    _need_card()
    rng = np.random.default_rng(300 + L + shift)
    (seq, qual, spos, pa, pb), inside = arbitrate_edge_inputs(
        rng, L=L, shift=shift)
    d_seq, got = _to_cuda(seq, shift), _to_cuda(qual, shift)
    rest = [t.cuda() for t in (spos, pa, pb)]
    want = tar.arbitrate(seq, qual.clone(), spos, pa, pb)  # plain, on the CPU
    tar.arbitrate(d_seq, got, *rest)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    outside = ~torch.from_numpy(inside)
    assert torch.equal(got.cpu()[outside], qual[outside])
    assert int((want != qual).sum()) > 20


@pytest.mark.cuda
@pytest.mark.parametrize("env,extra", [
    ({}, []), ({"MDTPU_BATCH_WINDOWS": "1"}, []), ({"MDTPU_CANDSPACE": "0"}, []),
    ({}, ["--minOppositeDepth", "2", "--maxVariantFrac", "0.1"]),
    ({"MDTPU_FUSED": "v2"}, []),
    ({"MDTPU_FUSED": "v2"}, ["--minOppositeDepth", "2", "--maxVariantFrac",
                             "0.1"])])
def test_cli_on_card_matches_host_engine(tmp_path, env, extra):
    """`python -m methyldackel_tpu_torch.cli extract` with MDTPU_ENGINE=cuda
    writes the host engine's bytes, on every route the card serves."""
    _need_card()
    from methyldackel_tpu_torch.utils.simulate import write_synthetic_input

    fa, bam = write_synthetic_input(str(tmp_path), 4000, 120, 40000, seed=9)
    base = dict(os.environ, MDTPU_STEAL="0",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = {}
    for engine in ("cuda", "host"):
        d = tmp_path / engine
        d.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu_torch.cli", "extract",
             "--chunkSize", "7000", *extra, fa, bam, "-o", "o"],
            cwd=d, env=dict(base, MDTPU_ENGINE=engine, **env),
            capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
        assert "routed to the host engine" not in res.stderr
        outs[engine] = (d / "o_CpG.bedGraph").read_bytes()
    assert outs["cuda"] == outs["host"] and outs["host"].count(b"\n") > 100


@pytest.mark.cuda
@pytest.mark.parametrize("cmd,args,env", [
    ("extract", ["--chunkSize", "7000", "@FA", "@BAM", "-o", "o"],
     {"MDTPU_NO_PALLAS": "1"}),
    ("mbias", ["--txt", "--chunkSize", "7000", "@FA", "@BAM", "p"], {}),
    ("mbias", ["--txt", "-@", "3", "--chunkSize", "7000", "-l", "@BED",
               "--keepStrand", "@FA", "@BAM", "p"], {}),
    ("perRead", ["--chunkSize", "7000", "@FA", "@BAM"], {}),
    ("perRead", ["--chunkSize", "7000", "-p", "30", "@FA", "@BAM"],
     {"MDTPU_PIPELINE": "1"})])
def test_subcommands_on_card_match_host_engine(tmp_path, cmd, args,
                                               env):
    """The dense dispatch of extract, mbias (packed and raw-rows programs)
    and perRead (with rows redone for sub-phred bases) through `python -m
    methyldackel_tpu_torch.cli` with MDTPU_ENGINE=cuda: stdout and every
    file equal the host engine's."""
    _need_card()
    from methyldackel_tpu_torch.utils.simulate import write_synthetic_input

    fa, bam = write_synthetic_input(str(tmp_path), 4000, 120, 40000, seed=9)
    bed = tmp_path / "r.bed"
    bed.write_text("chrSim\t2000\t15000\ta\t0\t+\n"
                   "chrSim\t21000\t36000\tb\t0\t-\n")
    subst = {"@FA": fa, "@BAM": bam, "@BED": str(bed)}
    argv = [subst.get(a, a) for a in args]
    base = dict(os.environ, MDTPU_STEAL="0",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = {}
    for engine in ("cuda", "host"):
        d = tmp_path / engine
        d.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu_torch.cli", cmd, *argv],
            cwd=d, env=dict(base, MDTPU_ENGINE=engine, **env),
            capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
        outs[engine] = (res.stdout, {p.name: p.read_bytes()
                                     for p in sorted(d.iterdir())})
    assert outs["cuda"] == outs["host"]
    assert len(outs["host"][0]) + sum(map(len, outs["host"][1].values())) > 2000


@pytest.mark.cuda
def test_programs_on_card_equal_the_cpu_device():
    """Each torch program of parallel/programs.py gives the same integers on
    the card as on the CPU device."""
    _need_card()
    from chip_smoke import program_cases

    for name, fn, args, _ops in program_cases(np.random.default_rng(1), 3000,
                                             100):
        cpu = fn(*args)
        gpu = fn(*[a.cuda() if isinstance(a, torch.Tensor) else a
                   for a in args])
        cpu, gpu = [(x if isinstance(x, tuple) else (x,)) for x in (cpu, gpu)]
        for c, g in zip(cpu, gpu):
            assert torch.equal(c, g.cpu()), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 4, 1])
def test_mesh_gates_on_card(n):
    """The three gates of the JAX package's multi-chip dry run with ``n``
    shards as ``n`` streams of the card, five rounds each (a missing
    dependency between two streams shows sometimes, not always), against the
    port's host functions."""
    _need_card()
    from chip_smoke import mesh_gates

    sums = mesh_gates("cuda", n=n, rounds=5)
    assert all(s > 100 for s in sums)


@pytest.mark.cuda
def test_mesh_backend_through_run_extract_on_card(tmp_path):
    """run_extract with the 8-cell mesh backend on the card writes the host
    engine's bytes, every window through the sharded step."""
    _need_card()
    from chip_smoke import run_extract_with, run_host, same_outputs
    from methyldackel_tpu_torch.parallel import mesh as pm
    from methyldackel_tpu_torch.utils.simulate import write_synthetic_input

    fa, bam = write_synthetic_input(str(tmp_path), 4000, 120, 40000, seed=9)
    for d in ("mesh", "host"):
        (tmp_path / d).mkdir()
    args = ["--chunkSize", "1000000", fa, bam, "-o", "out"]
    run_host(args, str(tmp_path / "host"))
    _dt, backend = run_extract_with(
        lambda cfg: pm.make_mesh_backend(cfg, n_devices=8, device="cuda"),
        fa, bam, str(tmp_path / "mesh"), {"MDTPU_STEAL": "0"})
    assert backend.launches["sharded"] >= 1 and backend.host_routed == 0
    same_outputs(str(tmp_path / "mesh"), str(tmp_path / "host"),
                 ["out_CpG.bedGraph"])


@pytest.mark.cuda
@pytest.mark.parametrize("job", ["simulated", "live"])
def test_two_host_extract_on_card(tmp_path, job):
    """Two processes of the port's CLI share the card as two hosts
    (MDTPU_NUM_HOSTS=2, then merge-shards; or a live gloo job over loopback,
    where rank 0 merges): the bytes of the host engine."""
    _need_card()
    from chip_smoke import (live_ranks, merge_shards_cli, run_host,
                            run_processes, same_outputs, sim_hosts)
    from methyldackel_tpu_torch.utils.simulate import write_synthetic_input

    fa, bam = write_synthetic_input(str(tmp_path), 4000, 120, 40000, seed=9)
    for d in ("two", "host"):
        (tmp_path / d).mkdir()
    args = ["--chunkSize", "7000", fa, bam, "-o", "out"]
    run_host(args, str(tmp_path / "host"))
    envs = sim_hosts(2) if job == "simulated" else live_ranks(2)
    run_processes("extract", args, str(tmp_path / "two"),
                  [dict(e, MDTPU_STEAL="0") for e in envs])
    if job == "simulated":
        merge_shards_cli(str(tmp_path / "two"), ["out_CpG.bedGraph"])
    same_outputs(str(tmp_path / "two"), str(tmp_path / "host"),
                 ["out_CpG.bedGraph"])
