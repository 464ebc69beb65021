"""The port's benchmark (methyldackel_tpu_torch/bench.py) on the CPU device
(the kernels' plain versions): its result line has the keys of the JAX
package's bench line, each step mode's window counters equal the JAX
package's host semantics (ops/semantics arbitrate_overlaps +
pileup_channels) on the same seeded batch at tolerance 0, and without a
card every entry point raises unless the CPU is asked for."""
import json
import os

import numpy as np
import pytest
import torch

from methyldackel_tpu.ops import semantics as jsem
from methyldackel_tpu.utils.simulate import (random_reference,
                                             simulate_batch_fast)
from methyldackel_tpu_torch import bench
from methyldackel_tpu_torch.utils import profiling
from test_torch_convert import port_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 1 << 14
TINY = {"MDTPU_BENCH_PAIRS": "2000", "MDTPU_BENCH_ITERS": "2",
        "MDTPU_BENCH_CLI_PAIRS": "2000",
        "MDTPU_BENCH_CLI_REPS": "2", "MDTPU_BENCH_AT_REPS": "2",
        "MDTPU_BENCH_SUB_PAIRS": "1000", "MDTPU_BENCH_SUB_REPS": "1"}


def _batches(seeds=(0,), n_pairs=400, L=150):
    """(ref_ascii, [JAX-package batches]) from numpy seeds over one
    reference of W + 64 bases."""
    rng = np.random.default_rng(11)
    ref_ascii, codes = random_reference(rng, W + 64)
    return ref_ascii, [simulate_batch_fast(np.random.default_rng(s), codes,
                                           n_pairs, L) for s in seeds]


def _jax_host(jbatch, ref_ascii):
    """The JAX package's host semantics of the window: mates (2i, 2i+1)
    arbitrated on a copy of the quals, then the 4-channel pileup."""
    st = jsem.strand(jbatch.flag, jbatch.xg)
    hq = jbatch.qual.copy()
    a = np.arange(0, jbatch.n, 2)
    jsem.arbitrate_overlaps(jbatch.seq, hq, jbatch.refpos, st, a, a + 1)
    return jsem.pileup_channels(jbatch.seq, hq, jbatch.refpos, st,
                                np.ones(jbatch.seq.shape, bool), ref_ascii,
                                0, 0, W, 5)


def _held_to_jax(outputs, want, names):
    assert sorted(outputs) == sorted(names)
    for name, (out, cols, nch) in outputs.items():
        sel = slice(None) if cols is None else cols
        got = np.asarray(out)[sel, :nch].astype(np.int64)
        ref = want[sel, :nch].astype(np.int64)
        assert got.shape == ref.shape, name
        assert np.array_equal(got, ref), name
        assert ref.sum() > 0, name  # the window is not empty


def test_main_line_has_the_keys_of_the_jax_bench(monkeypatch, capsys,
                                                tmp_path):
    """main() at tiny sizes with every section on: the last line is one
    JSON object with exactly the keys of BENCH_r05.json's parsed line, the
    lines before it are the bench's own, the host lane's windows are
    reported, and the inputs it wrote are gone."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(bench, "CLI_GLEN", 1 << 16)
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MDTPU_STEAL", raising=False)
    monkeypatch.delenv("MDTPU_BENCH_MODE", raising=False)
    result = bench.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    with open(os.path.join(REPO, "BENCH_r05.json")) as fh:
        want = set(json.load(fh)["parsed"])
    line = json.loads(lines[-1])
    assert set(line) == want and len(want) == 20
    assert line == result
    assert line["metric"] == "extract_e2e_throughput"
    assert line["cli_n_reads"] == 4000
    assert all(line[k] > 0 for k in want if k not in ("metric", "unit"))
    assert all(ln.startswith("bench: ") for ln in lines[:-1])
    assert any("windows_host_steal" in ln and "-@ 4" in ln
               for ln in lines[:-1])
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("group_k", [4, 2])
def test_e2e_step_matches_jax_semantics(group_k):
    """e2e: the timed group window and the single window at 2 channels on
    the emitted columns, and the 4-channel single window, each equal to the
    JAX package's host semantics; the batch is left as it was found."""
    ref_ascii, jb = _batches(seeds=(0, 1))
    want = _jax_host(jb[0], ref_ascii)
    qual0 = jb[0].qual.copy()
    pb = [bench.blobify_qnames(port_batch(b)) for b in jb]
    dt, outputs = bench.bench_e2e_fused(pb[0], ref_ascii, W, 4,
                                        batches=pb[1:], group_k=group_k,
                                        device="cpu")
    assert dt > 0
    _held_to_jax(outputs, want, ["e2e timed window", "e2e single window",
                                 "e2e 4-channel window"])
    assert np.array_equal(jb[0].qual, qual0)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_resident_step_matches_jax_semantics(mode):
    """pallas (arbitration, then the qual-gated 12-count pileup) and xla
    (window_pipeline), all four channels over the whole window."""
    ref_ascii, (jb,) = _batches()
    want = _jax_host(jb, ref_ascii)
    qual0 = jb.qual.copy()
    fn = bench.bench_pallas if mode == "pallas" else bench.bench_xla
    dt, outputs = fn(port_batch(jb), ref_ascii, W, 2, device="cpu")
    assert dt > 0
    _held_to_jax(outputs, want, [mode])
    assert np.array_equal(jb.qual, qual0)


@pytest.mark.parametrize("mode", ["e2e", "pallas", "xla"])
def test_step_bench_checks_and_reports(mode):
    """step_bench gives the head of the result line for each mode, and its
    exactness check fails on counts that differ by one."""
    ref_ascii, (jb,) = _batches()
    batch = bench.blobify_qnames(port_batch(jb))
    head = bench.step_bench(mode, batch, ref_ascii, W, 2, device="cpu",
                            chunks=1)
    assert head["metric"] == f"extract_{mode}_throughput"
    assert head["value"] > 0 and head["vs_baseline"] > 0
    host = bench.host_counts(batch, ref_ascii, W)
    assert np.array_equal(host, _jax_host(jb, ref_ascii))
    # a column every mode compares: a CpG site with calls
    from methyldackel_tpu_torch.config import Config

    cpg = bench.emitted_columns(Config(), ref_ascii, W)
    cols = cpg[host[cpg, 0] > 0]
    host[cols[len(cols) // 2], 0] += 1
    with pytest.raises(AssertionError, match="diverges"):
        bench.step_bench(mode, batch, ref_ascii, W, 2, device="cpu",
                         chunks=1, host=host)


def test_unknown_mode_is_refused():
    ref_ascii, (jb,) = _batches(n_pairs=20)
    with pytest.raises(ValueError, match="e2e, pallas or xla"):
        bench.step_bench("jax", port_batch(jb), ref_ascii, W, 1,
                         device="cpu")


@pytest.mark.parametrize("entry", ["main", "step_bench", "bench_e2e_fused",
                                   "bench_pallas", "bench_xla"])
def test_without_a_card_every_entry_point_raises(monkeypatch, entry):
    """The card is the default; without one each entry point raises before
    it measures anything, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref_ascii, (jb,) = _batches(n_pairs=20)
    batch = port_batch(jb)
    calls = {
        "main": lambda: bench.main(),
        "step_bench": lambda: bench.step_bench("e2e", batch, ref_ascii, W, 1),
        "bench_e2e_fused": lambda: bench.bench_e2e_fused(batch, ref_ascii, W,
                                                         1),
        "bench_pallas": lambda: bench.bench_pallas(batch, ref_ascii, W, 1),
        "bench_xla": lambda: bench.bench_xla(batch, ref_ascii, W, 1),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[entry]()


@pytest.mark.parametrize("engine,threads", [("cuda", 1), ("mesh", 1),
                                            ("cuda", 4), ("host", 1)])
def test_cli_run_tallies_the_lanes(monkeypatch, tmp_path, engine, threads):
    """run_cli with MDTPU_STEAL unset: the windows and the host lane's
    share are tallied (the host lane takes the first window of the default
    hybrid when it has a worker: min(-@, cores - 1)), the engine variable
    and the stage counters are put back."""
    from methyldackel_tpu_torch.utils.simulate import write_synthetic_input

    monkeypatch.delenv("MDTPU_STEAL", raising=False)
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    fa, bam = write_synthetic_input(str(tmp_path), 600, 100, 12000, seed=2)
    tally = {}
    for _ in range(2):
        assert bench.run_cli(fa, bam, engine, threads, device="cpu",
                             tally=tally) > 0
    assert tally["runs"] == 2 and tally["windows"] == 2
    workers = min(threads, max(0, (os.cpu_count() or 1) - 1))
    assert tally["windows_host_steal"] == (
        2 if engine != "host" and workers else 0)
    assert os.environ["MDTPU_ENGINE"] == "host"
    assert not profiling.STATS.enabled


def test_e2e_readback_failure_raises_and_does_not_hang(monkeypatch):
    """A readback that fails on the drain thread during the timed loop
    reaches the caller as the error, with more windows than the queue holds
    still to come (a drain thread that died would leave the producer
    blocked on a full queue)."""
    import threading

    from methyldackel_tpu_torch.parallel import device as pdev

    real = pdev.make_device_backend
    calls = {"groups": 0}

    class Failing:
        def get(self):
            raise RuntimeError("readback failed")

    def make(cfg, dev):
        backend = real(cfg, dev)
        group = backend.dispatch_group

        def dispatch_group(cfg, items, pad_to=0):
            calls["groups"] += 1
            if calls["groups"] == 1:  # the warm-up group
                return group(cfg, items, pad_to)
            return [Failing() for _ in items]

        backend.dispatch_group = dispatch_group
        return backend

    monkeypatch.setattr(pdev, "make_device_backend", make)
    ref_ascii, (jb,) = _batches(n_pairs=50)
    batch = bench.blobify_qnames(port_batch(jb))
    errors = []

    def run():
        try:
            bench.bench_e2e_fused(batch, ref_ascii, W, 64, group_k=4,
                                  device="cpu")
        except RuntimeError as exc:
            errors.append(exc)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive()
    assert [str(e) for e in errors] == ["readback failed"]
    assert calls["groups"] == 17  # the warm-up and all 16 timed groups
