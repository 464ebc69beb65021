"""Benchmark of the port: ``extract``'s window step and whole CLI runs on one
card.

    python -m methyldackel_tpu_torch.bench

The counterpart of the repo's ``bench.py`` (the JAX package's benchmark),
with its modes, sizes, protocol and output keys. It imports torch and numpy,
never jax and nothing of the JAX package. Every entry point runs on the card
unless the caller asks for the CPU: ``main(device="cuda")`` and each
``bench_*`` function take ``device=``; without a card they raise, as the CLI
does. ``device="cpu"`` runs the kernels' plain PyTorch versions (tests, at
tiny sizes); nothing falls back to the CPU by itself.

Step modes (``MDTPU_BENCH_MODE``), one 1 Mb window of simulated WGBS reads:

- ``e2e`` (default, the headline): everything ``extract`` pays a window —
  host prep, the upload, the group program (``csrc/pileup2.cu``) and the
  readback — through ``DeviceBackend.dispatch_group`` at K =
  ``MDTPU_BENCH_WINDOW_K`` windows a dispatch, one ordered drain thread,
  distinct batches rotating; the pipelined steady state. Four chunks, each
  beside one host window step, medians.
- ``pallas``: the hand-written CUDA kernels' window step, inputs resident on
  the card: mate arbitration (``csrc/arbitrate.cu``) over the eligible pairs,
  then the qual-gated 12-count pileup with its 4-channel epilogue
  (``csrc/pileup4.cu``, qual layout). The name is ``bench.py``'s.
- ``xla``: ``parallel.programs.window_pipeline``, torch ops and no kernel of
  ours (the JAX package's XLA pipeline). The name is ``bench.py``'s.

Every mode's window counters are held against the host semantics
(``ops.semantics``); on the card the bench also asserts that the mode's
kernels launched. ``vs_baseline`` is over the port's production host window
step (``engine.extract.compute_window_counters_host``), ``vs_numpy_oracle``
over the numpy oracle on a 20k-read subsample.

Then whole CLI calls in this process, ingest to bytes out, on a synthetic
input of ``MDTPU_BENCH_CLI_PAIRS`` pairs: ``extract`` with the card engine
(``MDTPU_BENCH_CLI_ENGINE``, default ``cuda``), ``mesh`` (one card: the same
engine) and ``host``, a warm run of each card engine, then medians of
``MDTPU_BENCH_CLI_REPS`` rounds with the order rotated; ``-@ 2`` and ``-@ 4``
(``MDTPU_BENCH_AT_COUNTS``) card engine against host engine, order
alternated; ``mbias`` and ``perRead`` medians on a smaller input. The CLI
runs leave ``MDTPU_STEAL`` as the caller set it; unset, that is the
product's default: ``min(-@, cores - 1)`` host-lane workers beside the card
lane, so these figures are the adaptive two-lane hybrid and not the card
lane alone. A line before the result gives each engine's windows, how many
of them the host lane took (``windows_host_steal``) and the kernel launches.

Variables (defaults as ``bench.py``): ``MDTPU_BENCH_PAIRS`` 50000,
``_READLEN`` 150, ``_ITERS`` 10, ``_MODE`` e2e, ``_WINDOW_K`` 4, ``_CLI`` 1,
``_CLI_PAIRS`` 1000000, ``_CLI_REPS`` 5, ``_CLI_ENGINE`` cuda, ``_MESH`` 1,
``_AT`` 1, ``_AT_REPS`` 4, ``_AT_COUNTS`` "2,4", ``_SUBCMDS`` 1,
``_SUB_PAIRS`` 100000, ``_SUB_REPS`` 3, ``_SINGLES`` 0. The genome of the
``extract`` input is ``CLI_GLEN`` (8 Mb, as ``bench.py``'s); the
subcommands' is half of it.

The last line is one JSON object with the keys of ``bench.py``'s line.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import os
import queue
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .config import Config
from .ops import arbitrate as ar
from .ops import pileup as pk
from .ops import pileup4 as p4
from .ops import semantics as sem
from .parallel import host_prep as hp

W_BENCH = 1 << 20
CLI_GLEN = 1 << 23
MIN_PHRED = 5


def _env_int(name, default):
    return int(os.environ.get(name, default))


def _device(device):
    """``device`` as a torch.device; the card raises when there is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the bench runs on a CUDA device, but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run the kernels' plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _up(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _mean_seconds(step, iters, dev):
    """(mean seconds of ``iters`` calls of ``step`` after one warm-up call,
    the last call's result); the device is synchronised around the loop."""
    out = step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step()
    _sync(dev)
    return (time.perf_counter() - t0) / iters, out


def launch_counts():
    """Launches of each kernel so far in this process."""
    return {"pileup2": pk.LAUNCHES, "pileup4_nq": p4.LAUNCHES["nq"],
            "pileup4_qual": p4.LAUNCHES["qual"], "arbitrate": ar.LAUNCHES}


def _launched(before):
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def _assert_launched(dev, before, names, what):
    """On the card, each kernel of ``names`` launched since ``before``."""
    if dev.type != "cuda":
        return
    moved = _launched(before)
    missing = [k for k in names if moved[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched on the card "
                             f"(launches {moved})")


# ------------------------------------------------------------- references

def host_baseline(batch, ref_ascii, W, reps=3):
    """Reads/s of the production host window step,
    ``compute_window_counters_host`` over the whole window with the native
    kernels (what ``MDTPU_ENGINE=host`` runs a window), best of ``reps``,
    each on a deep copy (the step rewrites quals)."""
    from .engine.extract import compute_window_counters_host

    cfg = Config()
    cfg.chunkSize = W
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, dtype=bool)
    best = 1e18
    for _ in range(reps):
        b = copy.deepcopy(batch)
        t0 = time.perf_counter()
        compute_window_counters_host(cfg, b, st, keep, ref_ascii, 0, 0, W)
        best = min(best, time.perf_counter() - t0)
    return batch.n / best


def oracle_baseline(batch, ref_ascii, W, n_sub=20_000):
    """Reads/s of the pure-numpy oracle on a subsample of the batch."""
    m = min(batch.n, n_sub)
    sub_seq = batch.seq[:m].copy()
    sub_qual = batch.qual[:m].copy()
    sub_rp = batch.refpos[:m]
    st = sem.strand(batch.flag[:m], batch.xg[:m])
    t0 = time.perf_counter()
    a_idx = np.arange(0, m, 2)
    sem.arbitrate_overlaps(sub_seq, sub_qual, sub_rp, st, a_idx, a_idx + 1)
    sem.pileup_channels(sub_seq, sub_qual, sub_rp, st,
                        np.ones(sub_seq.shape, bool), ref_ascii, 0, 0, W,
                        MIN_PHRED)
    return m / (time.perf_counter() - t0)


def host_counts(batch, ref_ascii, W):
    """The window's counters by the host semantics: mates (2i, 2i+1)
    arbitrated, then the 4-channel pileup. uint32 [W, 4]."""
    st = sem.strand(batch.flag, batch.xg)
    hq = batch.qual.copy()
    a_idx = np.arange(0, batch.n, 2)
    sem.arbitrate_overlaps(batch.seq, hq, batch.refpos, st, a_idx, a_idx + 1)
    return sem.pileup_channels(batch.seq, hq, batch.refpos, st,
                               np.ones(batch.seq.shape, bool), ref_ascii, 0,
                               0, W, MIN_PHRED)


def check_exact(outputs, host):
    """Each ``name: (counters [W, 4], columns or None, nch)`` of a step
    equals ``host`` on those columns and its first ``nch`` channels."""
    for name, (out, cols, nch) in outputs.items():
        sel = slice(None) if cols is None else cols
        if not np.array_equal(np.asarray(out)[sel, :nch], host[sel, :nch]):
            raise AssertionError(f"{name} diverges from host semantics")


def emitted_columns(cfg, ref_ascii, W):
    """The columns the packed readback ships (the ctx-enabled positions
    emit reads), in the dispatch's own geometry."""
    wpad = hp.round_up(W + 16, pk.T)
    refp = hp.ref_padded(ref_ascii, wpad)
    m = hp.ctx_mask_np(refp == hp.REF_C, refp == hp.REF_G, hp.ctx_code(cfg),
                       wpad)
    return np.nonzero(m[:W])[0]


# ------------------------------------------------------------ step modes

def bench_xla(batch, ref_ascii, W, iters, device="cuda"):
    """``programs.window_pipeline`` (torch ops) over the window, inputs on
    ``device``, mean seconds of ``iters`` calls after a warm-up. Returns
    (seconds, {"xla": (counters, None, 4)})."""
    from .parallel.programs import window_pipeline

    dev = _device(device)
    n, L = batch.seq.shape
    ovw = hp.round_up(2 * L, 128)
    pair_a = np.arange(0, n, 2)
    zeros16 = np.zeros(16, np.int32)
    args = [_up(a, dev) for a in (
        batch.seq, batch.qual, batch.refpos.astype(np.int32),
        batch.flag.astype(np.int32), batch.xg, batch.l_qseq.astype(np.int32),
        batch.mapq, np.ones(n, bool), np.ones((n, L), bool), pair_a,
        pair_a + 1, np.ones(len(pair_a), bool),
        np.asarray(ref_ascii, np.uint8), zeros16, zeros16)] + [0, 0]

    def run():
        return window_pipeline(*args, wpad=hp.round_up(W, pk.T), ovw=ovw,
                               min_phred=MIN_PHRED, min_conv_eff=0.0,
                               use_overlaps=True)

    dt, out = _mean_seconds(run, iters, dev)
    counters = out.cpu().numpy().view(np.uint32)[:W]
    return dt, {"xla": (counters, None, 4)}


def bench_pallas(batch, ref_ascii, W, iters, device="cuda"):
    """The hand-written kernels' window step, inputs resident on
    ``device``: ``ops.arbitrate`` (``csrc/arbitrate.cu``) over the eligible
    pairs of ``host_prep.v2_pair_tables``, then ``ops.pileup4.pileup4_tiles``
    in the qual layout with the 4-channel epilogue (``csrc/pileup4.cu``).
    Each step restores the raw quals first (arbitration rewrites them in
    place). Mean seconds of ``iters`` steps after a warm-up. Returns
    (seconds, {"pallas": (counters, None, 4)})."""
    dev = _device(device)
    n, L = batch.seq.shape
    wpad = hp.round_up(W, pk.T)
    ntiles = wpad // pk.T
    st = sem.strand(batch.flag, batch.xg)
    order, spos, tlo, thi = hp.window_tables(batch.pos, st & 1, ntiles, L)
    frame = np.empty(n, np.int64)
    frame[order] = np.arange(n)
    f_pos = np.asarray(batch.pos, np.int64)[order]
    a_idx = np.arange(0, n, 2)
    pa, pb = hp.v2_pair_tables(f_pos - f_pos % 128, st[order], frame[a_idx],
                               frame[a_idx + 1])
    isc, isg = hp.ref_bits(hp.ref_padded(ref_ascii, wpad + 256), 0, wpad)
    seq_d, qual_d, spos_d, tlo_d, thi_d, pa_d, pb_d, isc_d, isg_d = (
        _up(a, dev) for a in (batch.seq[order], batch.qual[order], spos, tlo,
                              thi, pa, pb, isc, isg))
    q = torch.empty_like(qual_d)
    before = launch_counts()

    def step():
        q.copy_(qual_d)
        ar.arbitrate(seq_d, q, spos_d, pa_d, pb_d)
        return p4.pileup4_tiles(seq_d, spos_d, tlo_d, thi_d, isc_d, isg_d,
                                ntiles=ntiles, nch=4, sat_bits=32, qual=q,
                                min_phred=MIN_PHRED)[0]

    dt, out = _mean_seconds(step, iters, dev)
    _assert_launched(dev, before, ("arbitrate", "pileup4_qual"), "pallas")
    counters = out.view(torch.uint8).cpu().numpy().view(np.uint32).T[:W]
    return dt, {"pallas": (counters, None, 4)}


def blobify_qnames(b):
    """Back the batch's read names with the decoder's blob layout
    (``QnameView`` + vectorized hashes), as every decoded BAM has them, so
    mate pairing takes the native path and not Python strings."""
    from .io.bam import QnameSubset, QnameView

    names = list(b.qname)
    blob = b"".join(q.encode() + b"\0" for q in names)
    off = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(q) + 1 for q in names], out=off[1:])
    view = QnameView(blob, off)
    b.qname = QnameSubset(view, np.arange(len(names), dtype=np.int64))
    b.qname_hash = view.hashes()
    return b


def bench_e2e_fused(batch, ref_ascii, W, iters, batches=None, group_k=None,
                    device="cuda"):
    """The production window step in its production shape: host prep,
    upload, group program and readback of ``DeviceBackend``, measured as the
    pipelined steady state (windows in flight as ``run_extract`` keeps them
    at -@ 1, one ordered drain thread), distinct batches rotating. Mean
    seconds a window. Then the checks' outputs: the first window of the
    timed groups and a single-window dispatch (NCH=2, on the emitted
    columns) and the 4-channel single window (``minOppositeDepth = 3``,
    the backend's ``__call__``). Returns (seconds, outputs)."""
    from .parallel.device import make_device_backend

    dev = _device(device)
    cfg = Config()
    cfg.chunkSize = W
    backend = make_device_backend(cfg, dev)
    keep = np.ones(batch.n, dtype=bool)
    pool = [batch] + list(batches or [])
    sts = [sem.strand(b.flag, b.xg) for b in pool]
    if group_k is None:
        group_k = max(1, int(os.environ.get("MDTPU_BATCH_WINDOWS", "4")))
    depth = max(int(os.environ.get("MDTPU_PIPELINE", "3")), 2 * group_k, 6)
    before = launch_counts()

    def dispatch(i):
        j = i % len(pool)
        return backend.dispatch(cfg, pool[j], sts[j], keep, ref_ascii, 0, 0,
                                W)

    def dispatch_group(i):
        items = []
        for k in range(group_k):
            j = (i * group_k + k) % len(pool)
            items.append((pool[j], sts[j], keep, ref_ascii, 0, 0, W, None))
        hs = backend.dispatch_group(cfg, items, pad_to=group_k)
        assert len(hs) == group_k
        return hs

    # group_k 1 still rides the group program unless MDTPU_BENCH_SINGLES=1
    use_group = (group_k > 1
                 or os.environ.get("MDTPU_BENCH_SINGLES", "0") != "1")
    for i in range(len(pool)):  # warm every batch once
        dispatch(i).get()
    if use_group:
        for h in dispatch_group(0):
            h.get()

    q: queue.Queue = queue.Queue(maxsize=depth)
    done = []
    errors = []

    def drain_loop():
        # keeps taking handles after a failure, so the producer never
        # blocks on a full queue; the main thread raises the error
        while True:
            h = q.get()
            if h is None:
                return
            if errors:
                continue
            try:
                done.append(h.get())
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

    t0 = time.perf_counter()
    th = threading.Thread(target=drain_loop)
    th.start()
    try:
        if use_group:
            n_win = ((iters + group_k - 1) // group_k) * group_k
            for i in range(n_win // group_k):
                for h in dispatch_group(i):
                    q.put(h)
        else:
            n_win = iters
            for i in range(iters):
                q.put(dispatch(i))
    finally:
        q.put(None)
        th.join()
    if errors:
        raise errors[0]
    dt = (time.perf_counter() - t0) / n_win
    assert len(done) == n_win

    cand = emitted_columns(cfg, ref_ascii, W)
    cfg4 = Config()
    cfg4.chunkSize = W
    cfg4.minOppositeDepth = 3
    out4 = backend(cfg4, batch, sts[0], keep, ref_ascii, 0, 0, W)
    outputs = {
        "e2e timed window": (done[0], cand, 2),
        "e2e single window": (dispatch(0).get(), cand, 2),
        "e2e 4-channel window": (out4, emitted_columns(cfg4, ref_ascii, W),
                                 4),
    }
    _assert_launched(dev, before, ("pileup2", "pileup4_nq"), "e2e")
    return dt, outputs


def step_bench(mode, batch, ref_ascii, W, iters, device="cuda", extra=(),
               group_k=4, chunks=4, host=None):
    """One step mode as ``main`` measures it, its outputs checked against
    the host semantics (``host``: ``host_counts`` of the batch, computed
    when None). Returns the head of the result line: metric, value, unit,
    vs_baseline, host_window_reads_per_s, vs_numpy_oracle."""
    dev = _device(device)
    if host is None:
        host = host_counts(batch, ref_ascii, W)
    if mode in ("xla", "pallas"):
        fn = bench_xla if mode == "xla" else bench_pallas
        dt, outputs = fn(batch, ref_ascii, W, iters, device=dev)
        check_exact(outputs, host)
        reads_per_s = batch.n / dt
        host_rps = host_baseline(batch, ref_ascii, W)
    elif mode == "e2e":
        # device and host in interleaved chunks, medians: a host's speed
        # drifts over minutes, so two figures taken apart do not compare
        dev_rates, host_rates = [], []
        for _ in range(chunks):
            dt, outputs = bench_e2e_fused(batch, ref_ascii, W,
                                          max(4, iters // 2), batches=extra,
                                          group_k=group_k, device=dev)
            check_exact(outputs, host)
            dev_rates.append(batch.n / dt)
            host_rates.append(host_baseline(batch, ref_ascii, W, reps=1))
        reads_per_s = float(np.median(dev_rates))
        host_rps = float(np.median(host_rates))
    else:
        raise ValueError(f"MDTPU_BENCH_MODE={mode!r}: e2e, pallas or xla")
    oracle_rps = oracle_baseline(batch, ref_ascii, W)
    return {
        "metric": f"extract_{mode}_throughput",
        "value": round(reads_per_s, 1),
        "unit": "reads/s/chip",
        "vs_baseline": round(reads_per_s / host_rps, 3),
        "host_window_reads_per_s": round(host_rps, 1),
        "vs_numpy_oracle": round(reads_per_s / oracle_rps, 3),
    }


def step_batches(mode, n_pairs, read_len, W=W_BENCH):
    """(ref_ascii, batch, extra) of ``main``: a random reference of W + 64
    bases and a batch of ``n_pairs`` pairs from seed 0; for e2e three more
    batches from seeds 1-3."""
    from .utils.simulate import random_reference, simulate_batch_fast

    rng = np.random.default_rng(0)
    ref_ascii, ref_codes = random_reference(rng, W + 64)
    batch = blobify_qnames(simulate_batch_fast(rng, ref_codes, n_pairs,
                                               read_len))
    extra = []
    if mode == "e2e":
        extra = [blobify_qnames(simulate_batch_fast(
            np.random.default_rng(s), ref_codes, n_pairs, read_len))
            for s in (1, 2, 3)]
    return ref_ascii, batch, extra


# -------------------------------------------------------------- CLI runs

def make_cli_input(n_pairs, read_len, glen):
    """A synthetic coordinate-sorted BAM (+BAI) and its FASTA in a new
    temporary directory, which the caller removes. Returns (dir, fa,
    bam)."""
    from .io.bai import build_bai
    from .io.bam import BamFile
    from .utils.simulate import write_synthetic_input

    d = tempfile.mkdtemp(prefix="mdtpu_bench_")
    fa, bam = write_synthetic_input(d, n_pairs, read_len, glen, seed=0)
    build_bai(BamFile(bam), bam + ".bai")
    return d, fa, bam


def _check_run(rc, out):
    if rc != 0 or os.path.getsize(out) == 0:
        raise RuntimeError(f"the run returned {rc} and wrote "
                           f"{os.path.getsize(out)} bytes to {out}")


@contextlib.contextmanager
def _engine_run(engine):
    """MDTPU_ENGINE set for one run and the engine's stage counters on
    (their stderr report is kept back unless the run fails). Yields the
    counters' dict, filled when the run ends."""
    from .utils.profiling import STATS

    old = os.environ.get("MDTPU_ENGINE")
    os.environ["MDTPU_ENGINE"] = engine
    STATS.__init__()
    STATS.enabled = True
    counts = {}
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            yield counts
    except BaseException:
        sys.stderr.write(err.getvalue())
        raise
    finally:
        counts.update(STATS.n)
        STATS.enabled = False
        if old is None:
            os.environ.pop("MDTPU_ENGINE", None)
        else:
            os.environ["MDTPU_ENGINE"] = old


def run_cli(fa, bam, engine, threads=1, device="cuda", tally=None):
    """One timed ``extract`` (in process), ingest to bytes out, with
    ``engine`` "cuda" (the backend on ``device``), "mesh" (the mesh backend
    on ``device``) or "host". Returns seconds; ``tally`` (a dict) gathers
    the windows, the host lane's windows and the kernel launches."""
    from . import cli

    outdir = tempfile.mkdtemp(prefix="mdtpu_bench_out_")
    targs = ["-@", str(threads)] if threads > 1 else []
    argv = [*targs, fa, bam, "-o", os.path.join(outdir, "out")]
    before = launch_counts()
    try:
        with _engine_run(engine) as counts:
            t0 = time.perf_counter()
            rc, _be = cli.extract(argv, device=None if engine == "host"
                                  else device)
            dt = time.perf_counter() - t0
        _check_run(rc, os.path.join(outdir, "out_CpG.bedGraph"))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    if tally is not None:
        tally["runs"] = tally.get("runs", 0) + 1
        for key in ("windows", "windows_host_steal"):
            tally[key] = tally.get(key, 0) + counts.get(key, 0)
        for key, v in _launched(before).items():
            tally[key] = tally.get(key, 0) + v
    return dt


def run_sub(cmd, fa, bam, engine, device="cuda", tally=None):
    """One timed ``mbias --txt`` or ``perRead -o`` (in process), ingest to
    bytes out, with ``engine`` "cuda" (``device``) or "host". Returns
    seconds; ``tally`` gathers the backend's program launches."""
    from .engine.mbias import mbias
    from .engine.perread import perread

    outdir = tempfile.mkdtemp(prefix="mdtpu_bench_sub_")
    dev = None if engine == "host" else device
    try:
        with _engine_run(engine):
            t0 = time.perf_counter()
            if cmd == "mbias":
                out = os.path.join(outdir, "mb.txt")
                with open(out, "w") as fh, contextlib.redirect_stdout(fh):
                    rc, be = mbias(["--txt", fa, bam,
                                    os.path.join(outdir, "mb")], device=dev)
            else:
                out = os.path.join(outdir, "pr.tsv")
                rc, be = perread([fa, bam, "-o", out], device=dev)
            dt = time.perf_counter() - t0
        _check_run(rc, out)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    if tally is not None and be is not None:
        for key, v in be.launches.items():
            tally[key] = tally.get(key, 0) + v
    return dt


def _print_tally(what, tallies):
    print(f"bench: {what}: " + "; ".join(
        f"{eng} {t.get('runs', 0)} runs, {t.get('windows', 0)} windows, "
        f"{t.get('windows_host_steal', 0)} of them on the host lane "
        f"(windows_host_steal), kernel launches "
        + str({k: t.get(k, 0) for k in launch_counts()})
        for eng, t in tallies.items() if eng != "host")
          + f"; MDTPU_STEAL={os.environ.get('MDTPU_STEAL', 'unset')}",
          flush=True)


def cli_medians(fa, bam, cli_n, device="cuda"):
    """``extract`` medians over the ``cli_n`` reads of (fa, bam) of the card
    engine, ``mesh`` and ``host``: a warm run of each card engine, then
    rounds with the order rotated (the run after the host engine's burn
    sampled a slower CPU on the JAX package's host)."""
    reps = _env_int("MDTPU_BENCH_CLI_REPS", 5)
    dev_engine = os.environ.get("MDTPU_BENCH_CLI_ENGINE", "cuda")
    engines = [dev_engine, "host"]
    if os.environ.get("MDTPU_BENCH_MESH", "1") != "0" \
            and "mesh" not in engines:
        engines.insert(1, "mesh")
    for eng in engines:
        if eng != "host":
            run_cli(fa, bam, eng, device=device)  # warm: kernel builds
    times = {e: [] for e in engines}
    tallies = {e: {} for e in engines}
    for rep in range(reps):
        order = engines[rep % len(engines):] + engines[: rep % len(engines)]
        for eng in order:
            times[eng].append(run_cli(fa, bam, eng, device=device,
                                      tally=tallies[eng]))
    _print_tally("extract -@ 1", tallies)
    out = {"cli_reads_per_s": round(cli_n / float(np.median(
        times[dev_engine])), 1), "cli_n_reads": cli_n,
        "cli_host_reads_per_s": round(cli_n / float(np.median(
            times["host"])), 1)}
    if "mesh" in times:
        out["cli_mesh_reads_per_s"] = round(
            cli_n / float(np.median(times["mesh"])), 1)
    return out


def at_scaling(fa, bam, at_n, device="cuda"):
    """The ``-@`` table over the ``at_n`` reads of (fa, bam): each of
    ``MDTPU_BENCH_AT_COUNTS``, card engine against host engine, the order
    alternated by round and thread count; medians and their ratio."""
    at_reps = _env_int("MDTPU_BENCH_AT_REPS", 4)
    at_counts = tuple(int(x) for x in os.environ.get(
        "MDTPU_BENCH_AT_COUNTS", "2,4").split(","))
    out = {}
    for ti, threads in enumerate(at_counts):
        times = {"cuda": [], "host": []}
        tallies = {"cuda": {}, "host": {}}
        for rep in range(at_reps):
            order = (("cuda", "host") if (rep + ti) % 2 == 0
                     else ("host", "cuda"))
            for eng in order:
                times[eng].append(run_cli(fa, bam, eng, threads=threads,
                                          device=device, tally=tallies[eng]))
        _print_tally(f"extract -@ {threads}", tallies)
        jm = at_n / float(np.median(times["cuda"]))
        hm = at_n / float(np.median(times["host"]))
        out[f"cli_at{threads}_reads_per_s"] = round(jm, 1)
        out[f"cli_at{threads}_host_reads_per_s"] = round(hm, 1)
        out[f"cli_at{threads}_ratio"] = round(jm / hm, 3)
    return out


def bench_subcommands(n_pairs, read_len, reps, device="cuda"):
    """Interleaved card-against-host medians of ``mbias`` and ``perRead``
    on an input of their own, over a genome of ``CLI_GLEN // 2``."""
    d, fa, bam = make_cli_input(n_pairs, read_len, CLI_GLEN // 2)
    n = 2 * n_pairs
    out = {}
    tallies = {}
    try:
        for cmd, key in (("mbias", "mbias"), ("perRead", "perread")):
            run_sub(cmd, fa, bam, "cuda", device)  # warm
            times = {"cuda": [], "host": []}
            tally = tallies[cmd] = {}
            for rep in range(reps):
                pair = ("cuda", "host") if rep % 2 == 0 else ("host", "cuda")
                for eng in pair:
                    times[eng].append(run_sub(
                        cmd, fa, bam, eng, device,
                        tally if eng == "cuda" else None))
            out[f"{key}_reads_per_s"] = round(
                n / float(np.median(times["cuda"])), 1)
            out[f"{key}_host_reads_per_s"] = round(
                n / float(np.median(times["host"])), 1)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print("bench: subcommands, device program launches of the timed card "
          "runs: " + "; ".join(f"{c} {t}" for c, t in tallies.items()),
          flush=True)
    return out


def _release(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main(device="cuda"):
    """The whole bench; prints the result as the last line and returns
    it."""
    dev = _device(device)
    n_pairs = _env_int("MDTPU_BENCH_PAIRS", 50_000)
    read_len = _env_int("MDTPU_BENCH_READLEN", 150)
    iters = _env_int("MDTPU_BENCH_ITERS", 10)
    mode = os.environ.get("MDTPU_BENCH_MODE", "e2e")
    ref_ascii, batch, extra = step_batches(mode, n_pairs, read_len)
    result = step_bench(mode, batch, ref_ascii, W_BENCH, iters, device=dev,
                        extra=extra,
                        group_k=_env_int("MDTPU_BENCH_WINDOW_K", 4))
    del batch, extra  # and with them every upload the step held
    _release(dev)
    if os.environ.get("MDTPU_BENCH_CLI", "1") != "0":
        # 1M pairs, 2M reads, 9 windows: long enough that the steady state
        # outweighs the first group's fill and the last one's drain
        cli_pairs = _env_int("MDTPU_BENCH_CLI_PAIRS", 1_000_000)
        d, fa, bam = make_cli_input(cli_pairs, read_len, CLI_GLEN)
        try:
            result.update(cli_medians(fa, bam, 2 * cli_pairs, dev))
            if os.environ.get("MDTPU_BENCH_AT", "1") != "0":
                result.update(at_scaling(fa, bam, 2 * cli_pairs, dev))
        finally:
            shutil.rmtree(d, ignore_errors=True)
    if os.environ.get("MDTPU_BENCH_SUBCMDS", "1") != "0":
        result.update(bench_subcommands(
            _env_int("MDTPU_BENCH_SUB_PAIRS", 100_000), read_len,
            _env_int("MDTPU_BENCH_SUB_REPS", 3), dev))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
