"""The port's window programs (methyldackel_tpu_torch.parallel.device) on
the CPU against the JAX package's (dispatch_window_group in interpret mode)
and the exact host engine (compute_window_counters_host, at the positions
emit reads). Integer counts: every comparison is exact."""
import copy

import numpy as np
import pytest

from methyldackel_tpu.config import Config
from methyldackel_tpu.engine.extract import compute_window_counters_host
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.parallel import device as jdev
from methyldackel_tpu.utils.simulate import random_reference, simulate_batch_fast
from test_fused_v3 import _mix_batch
from test_group_dispatch import (GLEN, W, _emit_read_positions,
                                 _host_per_window, _window_items)
from test_torch_convert import PortBackend


def _port(cfg):
    return PortBackend(cfg)


def _mixed_scenario(seed, n_fast=160, n_slow=30):
    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=n_fast, n_slow=n_slow)
    batch.seq[5, 8:12] = 0  # '=' codes -> hard rows
    return ref_ascii, batch


def _assert_host_at_emit(cfg, items, got):
    host = _host_per_window(cfg, items)
    for k, g in enumerate(got):
        cand = _emit_read_positions(cfg, items[k])
        np.testing.assert_array_equal(g[cand, :2], host[k][cand, :2],
                                      err_msg=f"window {k}")
        assert not g[:, 2:].any()  # NCH=2 readback contract


@pytest.mark.parametrize("candspace", ["1", "0"])
def test_group_matches_jax_and_host(monkeypatch, candspace):
    """Candidate space and (MDTPU_CANDSPACE=0) the window-space group with
    its compacted readback; hard rows folded in on the host."""
    monkeypatch.setenv("MDTPU_CANDSPACE", candspace)
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    ref_ascii, batch = _mixed_scenario(41)
    cfg = Config()
    cfg.chunkSize = W
    starts = [0, W, 2 * W]
    hs = _port(cfg).dispatch_group(cfg, _window_items(batch, starts,
                                                      ref_ascii), pad_to=4)
    got = [h.get() for h in hs]
    want = [h.get() for h in jdev.dispatch_window_group(
        cfg, _window_items(batch, starts, ref_ascii), pad_to=4,
        interpret=True)]
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"window {k}")
    _assert_host_at_emit(cfg, _window_items(batch, starts, ref_ascii), got)
    assert sum(int(g[:, :2].sum()) for g in got) > 1000


def test_group_empty_windows_and_partial_group(monkeypatch):
    """Windows 2 and 3 empty, a 3-window group flushed with pad_to=4."""
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    rng = np.random.default_rng(43)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=60, n_slow=0)
    keepers = batch.pos < W - 200
    fields = {f: getattr(batch, f)[keepers].copy() for f in (
        "flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid", "mpos",
        "xg", "nh", "seq", "qual", "refpos")}
    fields["qname"] = [q for q, k in zip(batch.qname, keepers) if k]
    batch = type(batch)(**fields)
    cfg = Config()
    cfg.chunkSize = W
    items = _window_items(batch, [0, W, 2 * W], ref_ascii)
    assert items[1][0].n == 0 and items[2][0].n == 0
    hs = _port(cfg).dispatch_group(cfg, items, pad_to=4)
    got = [h.get() for h in hs]
    assert len(got) == 3 and not got[1].any() and not got[2].any()
    _assert_host_at_emit(cfg, _window_items(batch, [0, W, 2 * W], ref_ascii),
                         got)
    want = [h.get() for h in jdev.dispatch_window_group(
        cfg, _window_items(batch, [0, W, 2 * W], ref_ascii), pad_to=4,
        interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_lc_overflow_falls_back_to_window_space(monkeypatch):
    """A CG-repeat genome under cytosine_report (every C/G a candidate):
    150 bp reads cover > 128 slots, candidate space declines without
    touching the windows, and the window-space group is exact."""
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    rng = np.random.default_rng(13)
    glen = 2 * W + 600
    ref_ascii = np.tile(np.array([ord("C"), ord("G")], np.uint8),
                        glen // 2)[:glen]
    code = np.zeros(256, np.uint8)
    code[ord("C")], code[ord("G")] = 1, 2
    batch = simulate_batch_fast(rng, code[ref_ascii], 60, 150)
    cfg = Config()
    cfg.chunkSize = W
    cfg.cytosine_report = True
    backend = _port(cfg)
    items = _window_items(batch, [0, W], ref_ascii)
    from methyldackel_tpu_torch.parallel import host_prep as hp

    wins = []
    for (b, st, keep, ref_win, lpos2, s, e, _rs) in items:
        kidx = np.nonzero(keep)[0]
        seq, qual, refpos, pos, _lq, stp, hard = hp.prep_v3_rows(
            cfg, b, st, keep, kidx)
        wins.append({"empty": False, "W": e - s, "seq": seq, "qual": qual,
                     "refpos": refpos, "pos": pos, "st": stp, "hard": hard,
                     "ref_window": ref_win, "win_start": s,
                     "woff_rel": lpos2 - s})
    assert backend._dispatch_group_cand(cfg, wins, W) is None
    assert wins[0]["seq"] is not None  # not cleared on decline
    got = [h.get() for h in backend.dispatch_group(cfg, items, pad_to=2)]
    host = _host_per_window(cfg, _window_items(batch, [0, W], ref_ascii))
    want = [h.get() for h in jdev.dispatch_window_group(
        cfg, _window_items(batch, [0, W], ref_ascii), pad_to=2,
        interpret=True)]
    for k in range(2):
        np.testing.assert_array_equal(got[k], want[k])
        (_b, _st, _keep, ref_win, lpos2, s, e, _rs) = items[k]
        idx = np.arange(e - s) + (s - lpos2)
        idx = idx[idx < len(ref_win)]
        cg = np.nonzero(np.isin(np.asarray(ref_win)[idx],
                                [ord("C"), ord("G")]))[0]
        np.testing.assert_array_equal(got[k][cg, :2], host[k][cg, :2])


def test_single_window_matches_host_and_jax(monkeypatch):
    """Single-window dispatch (compacted readback, hard rows on the host)
    against the host engine and the JAX single-window program."""
    monkeypatch.setenv("MDTPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    ref_ascii, batch = _mixed_scenario(31, n_fast=120, n_slow=20)
    batch.seq[17, 0:4] = 0
    cfg = Config()
    cfg.chunkSize = W
    items = _window_items(batch, [0, W], ref_ascii)
    backend = _port(cfg)
    jax_backend = jdev.make_device_backend(cfg)
    for k, it in enumerate(items):
        got = backend.dispatch(cfg, *copy.deepcopy(it)).get()
        want = jax_backend(cfg, *copy.deepcopy(it))
        host = compute_window_counters_host(cfg, *copy.deepcopy(it)[:7])
        cand = _emit_read_positions(cfg, it)
        assert len(cand) > 50
        np.testing.assert_array_equal(got[cand, :2], host[cand, :2])
        np.testing.assert_array_equal(got[cand, :2], want[cand, :2])
        assert not got[:, 2:].any()
    assert backend.host_routed == 0


def test_overflow_refetches_wide_and_widens(monkeypatch):
    """Depth > 255: the u8 readback flags overflow, the window is refetched
    in u32 (exact), and the backend reads u16 from then on."""
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    rng = np.random.default_rng(19)
    glen = 700
    ref_ascii, ref_codes = random_reference(rng, glen)
    batch = simulate_batch_fast(rng, ref_codes, 2500, 100)
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, bool)
    cfg = Config()
    cfg.chunkSize = 1024
    backend = _port(cfg)
    assert backend._sat_bits == 8
    for rnd in range(2):
        got = backend.dispatch(cfg, copy.deepcopy(batch), st, keep,
                               ref_ascii, 0, 0, glen).get()
        host = compute_window_counters_host(cfg, copy.deepcopy(batch), st,
                                            keep, ref_ascii, 0, 0, glen)
        assert host[:, :2].max() > 255
        cand = _emit_read_positions(
            cfg, (None, None, None, ref_ascii, 0, 0, glen, None))
        np.testing.assert_array_equal(got[cand, :2], host[cand, :2])
        assert host[cand, :2].max() > 255
        assert backend._sat_bits == 16


def test_routed_windows_are_counted(monkeypatch, capsys):
    """No window goes to the host engine: a BED strand column and
    MDTPU_NO_PALLAS=1 take the dense dispatch on the device, counted in
    launches["dense"], equal to the host engine at every position, and
    nothing is said on stderr."""
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    ref_ascii, batch = _mixed_scenario(47, n_fast=40, n_slow=0)
    cfg = Config()
    cfg.chunkSize = W
    items = _window_items(batch, [0, W], ref_ascii)
    backend = _port(cfg)
    rs = np.zeros(W + 20, np.int8)
    rs[300:900] = 1
    rs[900:1500] = 2
    (b, st, keep, ref_win, lpos2, s, e, _rs) = copy.deepcopy(items[0])
    got = backend.dispatch(cfg, b, st, keep, ref_win, lpos2, s, e, rs).get()
    host = compute_window_counters_host(cfg, *copy.deepcopy(items[0])[:7],
                                        rs)
    np.testing.assert_array_equal(got, host)
    assert host[:, :2].sum() > 50
    assert backend.launches["dense"] == 1
    monkeypatch.setenv("MDTPU_NO_PALLAS", "1")
    hs = backend.dispatch_group(cfg, copy.deepcopy(items), pad_to=4)
    for h, it in zip(hs, items):
        np.testing.assert_array_equal(
            h.get(), compute_window_counters_host(cfg, *copy.deepcopy(it)[:7]))
    assert backend.launches["dense"] == 3 and backend.host_routed == 0
    assert "host engine" not in capsys.readouterr().err


@pytest.mark.parametrize("route", ["candspace", "window", "single"])
def test_window_without_candidates(monkeypatch, route):
    """An all-N reference stretch (assembly gap) has no candidate column:
    every program returns zeros, like the host engine."""
    monkeypatch.setenv("MDTPU_CANDSPACE", "0" if route == "window" else "1")
    rng = np.random.default_rng(3)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=60, n_slow=5)
    ref_n = np.full_like(ref_ascii, ord("N"))
    cfg = Config()
    cfg.chunkSize = W
    backend = _port(cfg)
    items = _window_items(batch, [0, W], ref_n)
    if route == "single":
        got = [backend.dispatch(cfg, *it).get() for it in items]
    else:
        got = [h.get() for h in backend.dispatch_group(cfg, items, pad_to=4)]
    host = _host_per_window(cfg, _window_items(batch, [0, W], ref_n))
    for g, h in zip(got, host):
        assert g.shape == h.shape and not g.any() and not h[:, :2].any()


def _shuffled(item, rng):
    """The same window with its reads in a random order."""
    b, st, keep, *rest = item
    perm = rng.permutation(b.n)
    fields = {f: getattr(b, f)[perm] for f in (
        "flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid", "mpos",
        "xg", "nh", "seq", "qual", "refpos")}
    fields["qname"] = [b.qname[i] for i in perm]
    return (type(b)(**fields), st[perm], keep[perm], *rest)


@pytest.mark.parametrize("candspace", ["1", "0"])
def test_group_rows_in_any_order(monkeypatch, candspace):
    """The 2-bit kernel finds a column's rows by a search over exact starts
    that do not decrease across the whole group. The group programs put the
    packed rows in that order themselves (nothing to do for
    coordinate-sorted windows), so windows whose reads come in any order
    give the same counters."""
    monkeypatch.setenv("MDTPU_CANDSPACE", candspace)
    monkeypatch.delenv("MDTPU_FUSED", raising=False)
    ref_ascii, batch = _mixed_scenario(53)
    cfg = Config()
    cfg.chunkSize = W
    starts = [0, W, 2 * W]
    rng = np.random.default_rng(5)
    want = [h.get() for h in _port(cfg).dispatch_group(
        cfg, _window_items(batch, starts, ref_ascii), pad_to=4)]
    items = [_shuffled(it, rng)
             for it in _window_items(batch, starts, ref_ascii)]
    assert any((np.diff(it[0].pos) < 0).any() for it in items)
    backend = _port(cfg)
    got = [h.get() for h in backend.dispatch_group(cfg, items, pad_to=4)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _assert_host_at_emit(cfg, _window_items(batch, starts, ref_ascii), got)
    assert backend.host_routed == 0


def test_window_programs_shed_the_tpu_layout():
    """The 2-bit program, the arbitration and the two fused window programs
    take rows that carry their start: no phase byte, offset groups, K, LP or
    pair codes in their signatures, and no helper for them in host_prep."""
    import inspect

    from methyldackel_tpu_torch.ops import arbitrate as ta
    from methyldackel_tpu_torch.ops import pileup as tpk
    from methyldackel_tpu_torch.parallel import device as pdev
    from methyldackel_tpu_torch.parallel import host_prep as hp

    gone = {"shp", "srtk", "cntk", "K", "LP", "code"}
    for fn in (tpk.pileup2_tiles, tpk.pileup2_tiles_reference, ta.arbitrate,
               ta.arbitrate_reference, pdev.fused_window_pregated2,
               pdev.fused_fast_window):
        assert not gone & set(inspect.signature(fn).parameters), fn.__name__
    assert not hasattr(hp, "shp_bytes") and not hasattr(hp, "group_tables")
