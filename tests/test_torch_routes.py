"""The port's two further window programs on the CPU: the 4-channel extract
(``--minOppositeDepth > 0``, single-window dispatch of the nibble-packed
12-count program) and the v2 window program (``MDTPU_FUSED=v2``: mate
arbitration, then the qual-gated 12-count program), against the JAX
package's programs in interpret mode and the exact host engine
(compute_window_counters_host) at the positions emit reads. Integer counts:
every comparison is exact."""
import copy

import numpy as np
import pytest

from methyldackel_tpu.config import Config
from methyldackel_tpu.engine.extract import compute_window_counters_host
from methyldackel_tpu.io.bam import ReadBatch
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.parallel import device as jdev
from methyldackel_tpu.utils.simulate import random_reference, simulate_batch_fast
from test_fused_v3 import _mix_batch
from test_group_dispatch import GLEN, W, _emit_read_positions, _window_items
from test_torch_convert import PortBackend

GRID = [(5, 0), (5, 3), (0, 0), (0, 2), (40, 0)]  # tests/test_fused_v3.py:46


def _cfg(min_phred=5, min_opp=0):
    cfg = Config()
    cfg.chunkSize = W
    cfg.minPhred = min_phred
    cfg.minOppositeDepth = min_opp
    return cfg


def _mixed_items(seed, starts=(0, W)):
    """Windows of simulated pairs with indel reads and '=' bases (hard
    rows, and pairs holding one), straddling reads at nonzero starts."""
    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=160, n_slow=30)
    batch.seq[5, 8:12] = 0
    batch.seq[17, 0:4] = 0
    return ref_ascii, batch, list(starts)


def _check_window(cfg, backend, it, jax_backend=None):
    """The port's window equals the host engine (and the JAX program) at
    the emit positions: channels 0-3 for NCH=4, 0-1 for NCH=2 (2-3 are
    zero, the readback contract). Returns the port's counters."""
    nch = 4 if cfg.minOppositeDepth > 0 else 2
    got = backend.dispatch(cfg, *copy.deepcopy(it)).get()
    host = compute_window_counters_host(cfg, *copy.deepcopy(it)[:7])
    cand = _emit_read_positions(cfg, it)
    assert len(cand) > 50 and got.shape == host.shape
    np.testing.assert_array_equal(got[cand, :nch], host[cand, :nch])
    if nch == 2:
        assert not got[:, 2:].any()
    if jax_backend is not None:
        want = jax_backend(cfg, *copy.deepcopy(it))
        np.testing.assert_array_equal(got[cand, :nch], want[cand, :nch])
    return got, host, cand


@pytest.mark.parametrize("min_phred,min_opp", GRID)
def test_route_a_matches_jax_and_host(monkeypatch, min_phred, min_opp):
    """Single-window v3 dispatch; with min_opp > 0 the 4-channel program
    (host arbitration, pre-gated nibble codes), hard rows on the host."""
    monkeypatch.setenv("MDTPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    ref_ascii, batch, starts = _mixed_items(31)
    cfg = _cfg(min_phred, min_opp)
    backend = PortBackend(cfg)
    jax_backend = jdev.make_device_backend(cfg)
    for it in _window_items(batch, starts, ref_ascii):
        got, host, cand = _check_window(cfg, backend, it, jax_backend)
        if min_opp:
            assert got[cand, 2].sum() > 200 and got[cand, 3].sum() > 0
    assert backend.host_routed == 0


def test_nch4_hard_rows_fold_all_channels(monkeypatch):
    """The host fold of a window's hard rows (indels, '=' bases) adds all
    four channels under --minOppositeDepth: channels 2-3 at the emit
    positions equal the host engine's, with nothing routed to it."""
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    ref_ascii, batch, _starts = _mixed_items(37, starts=(0,))
    # make every third read an indel read: the hard rows carry real depth
    batch.refpos[::3, 40:] += 1
    cfg = _cfg(5, 2)
    backend = PortBackend(cfg)
    (it,) = _window_items(batch, [0], ref_ascii)
    got, host, cand = _check_window(cfg, backend, it)
    np.testing.assert_array_equal(got[cand, 2:], host[cand, 2:])
    assert host[cand, 2].sum() > 200
    assert backend.host_routed == 0


@pytest.mark.parametrize("min_phred,min_opp", [(5, 0), (5, 2), (40, 0),
                                               (0, 2)])
def test_route_b_v2_matches_jax_and_host(monkeypatch, min_phred, min_opp):
    """MDTPU_FUSED=v2 on gapless pairs (tests/test_fused_v3.py:314), NCH=2
    and NCH=4. The JAX v2 program's qual-gated kernel counted pad bytes at
    min_phred 0 (see tests/test_torch_pileup4.py), so there the port is
    held against the host engine alone."""
    monkeypatch.setenv("MDTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MDTPU_FUSED", "v2")
    rng = np.random.default_rng(61)
    ref_ascii, ref_codes = random_reference(rng, 5000)
    batch = simulate_batch_fast(rng, ref_codes, 60, 100)
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, bool)
    Wv = 4608
    cfg = _cfg(min_phred, min_opp)
    cfg.chunkSize = Wv
    it = (batch, st, keep, ref_ascii, 0, 0, Wv, None)
    backend = PortBackend(cfg)
    jax_backend = jdev.make_device_backend(cfg) if min_phred else None
    got, _host, cand = _check_window(cfg, backend, it, jax_backend)
    assert got[cand, 0].sum() + got[cand, 1].sum() > 50
    assert backend.host_routed == 0


@pytest.mark.parametrize("min_opp", [0, 3])
def test_route_b_hard_pairs(monkeypatch, min_opp):
    """v2 with indel and '=' reads: pairs holding a hard mate are
    arbitrated and counted on the host, the others on the device lane."""
    monkeypatch.setenv("MDTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MDTPU_FUSED", "v2")
    ref_ascii, batch, starts = _mixed_items(43)
    cfg = _cfg(5, min_opp)
    backend = PortBackend(cfg)
    jax_backend = jdev.make_device_backend(cfg)
    for it in _window_items(batch, starts, ref_ascii):
        _check_window(cfg, backend, it, jax_backend)
    assert backend.host_routed == 0


@pytest.mark.parametrize("fused,min_opp", [("v3", 2), ("v2", 0), ("v2", 2)])
def test_coverage_spike_window(monkeypatch, fused, min_opp):
    """5000 reads on one start: a row group far above the JAX package's
    GMAX cap (4096), where it falls back to its dense path. The port has no
    cap, so the window still runs on the device lane and equals the host
    engine."""
    monkeypatch.setenv("MDTPU_FUSED", fused)
    rng = np.random.default_rng(71)
    glen = 3000
    ref_ascii, ref_codes = random_reference(rng, glen)
    base = simulate_batch_fast(rng, ref_codes, 150, 100)
    spike = simulate_batch_fast(rng, ref_codes, 2500, 100)
    spike.pos[:] = 1000
    spike.endpos[:] = 1100
    spike.refpos[:] = 1000 + np.arange(100)[None, :]
    fields = {}
    for f in ("flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
              "mpos", "xg", "nh", "seq", "qual", "refpos"):
        fields[f] = np.concatenate([getattr(base, f), getattr(spike, f)])
    fields["qname"] = list(base.qname) + [q + "_s" for q in spike.qname]
    batch = ReadBatch(**fields)
    order = np.argsort(batch.pos, kind="stable")
    batch = ReadBatch(**{f: (np.asarray(v)[order] if f != "qname"
                             else [v[i] for i in order])
                         for f, v in fields.items()})
    cfg = _cfg(5, min_opp)
    cfg.chunkSize = 2560
    st = sem.strand(batch.flag, batch.xg)
    it = (batch, st, np.ones(batch.n, bool), ref_ascii, 0, 0, 2560, None)
    backend = PortBackend(cfg)
    got, host, cand = _check_window(cfg, backend, it)
    assert (batch.pos == 1000).sum() > 4096  # one row group
    assert host[1000:1100, :3].sum(axis=1).min() > 1000
    assert backend.host_routed == 0


@pytest.mark.parametrize("fused,min_opp", [("v3", 2), ("v2", 0), ("v2", 3),
                                           ("v3", 0)])
def test_unsorted_batch_is_sorted_by_the_dispatch(monkeypatch, fused,
                                                  min_opp):
    """The pileup kernels need rows sorted by start. The dispatch sorts
    (the identity for a coordinate-sorted batch), so a batch in any order
    still equals the host engine, on the 4-channel programs and (v3, no
    --minOppositeDepth) the 2-bit one; hp.tile_rows itself refuses unsorted
    starts (tests/test_torch_pileup4.py, tests/test_torch_pileup.py)."""
    monkeypatch.setenv("MDTPU_FUSED", fused)
    rng = np.random.default_rng(83)
    ref_ascii, ref_codes = random_reference(rng, 5000)
    batch = simulate_batch_fast(rng, ref_codes, 120, 100)
    perm = rng.permutation(batch.n)
    batch = ReadBatch(**{
        f: ([batch.qname[i] for i in perm] if f == "qname"
            else getattr(batch, f)[perm])
        for f in ("qname", "flag", "tid", "pos", "mapq", "l_qseq", "endpos",
                  "mtid", "mpos", "xg", "nh", "seq", "qual", "refpos")})
    assert (np.diff(batch.pos) < 0).any()
    cfg = _cfg(5, min_opp)
    cfg.chunkSize = 4608
    st = sem.strand(batch.flag, batch.xg)
    it = (batch, st, np.ones(batch.n, bool), ref_ascii, 0, 0, 4608, None)
    backend = PortBackend(cfg)
    got, _host, cand = _check_window(cfg, backend, it)
    assert got[cand, :2].sum() > 100 and backend.host_routed == 0


@pytest.mark.parametrize("fused", ["v3", "v2"])
@pytest.mark.parametrize("L", [75, 151])
def test_odd_read_lengths_and_empty_tiles(monkeypatch, fused, L):
    """Odd read lengths (a pad nibble in the packed row) and a window whose
    middle tiles hold no read, --minOppositeDepth on both programs."""
    monkeypatch.setenv("MDTPU_FUSED", fused)
    rng = np.random.default_rng(90 + L)
    ref_ascii, ref_codes = random_reference(rng, 6000)
    batch = simulate_batch_fast(rng, ref_codes, 150, L)
    far = (batch.pos < 1200) | (batch.pos > 3400)
    far = far.reshape(-1, 2).all(axis=1).repeat(2)  # whole pairs
    order = np.argsort(batch.pos[far], kind="stable")
    batch = ReadBatch(**{
        f: ([q for q, k in zip(batch.qname, far) if k] if f == "qname"
            else getattr(batch, f)[far])
        for f in ("qname", "flag", "tid", "pos", "mapq", "l_qseq", "endpos",
                  "mtid", "mpos", "xg", "nh", "seq", "qual", "refpos")})
    batch = ReadBatch(**{
        f: ([batch.qname[i] for i in order] if f == "qname"
            else getattr(batch, f)[order])
        for f in ("qname", "flag", "tid", "pos", "mapq", "l_qseq", "endpos",
                  "mtid", "mpos", "xg", "nh", "seq", "qual", "refpos")})
    cfg = _cfg(5, 2)
    cfg.chunkSize = 5632
    st = sem.strand(batch.flag, batch.xg)
    it = (batch, st, np.ones(batch.n, bool), ref_ascii, 0, 0, 5632, None)
    backend = PortBackend(cfg)
    got, host, cand = _check_window(cfg, backend, it)
    assert not host[1600:3300].any() and got[cand, 2].sum() > 100
    assert backend.host_routed == 0
