"""Window programs of ``extract`` on the card.

Port of the window programs of ``methyldackel_tpu/parallel/device.py``:

- single-window dispatch (``_fused_dispatch_v3``): NCH=2, the 2-bit program
  (``ops.pileup.pileup2_tiles``), or with ``--minOppositeDepth > 0`` NCH=4,
  the pre-gated nibble-packed 12-count program (``ops.pileup4``, nq mode);
- the K-window group of the default extract in candidate space
  (``_fused_dispatch_v3_multi_cand``) and in window space
  (``_fused_dispatch_v3_multi``);
- the v2 window program (``MDTPU_FUSED=v2``, ``_fused_dispatch``): mate
  arbitration on the card (``ops.arbitrate``), then the qual-gated 12-count
  program (``ops.pileup4``, qual mode), for NCH=2 and NCH=4;

and ``make_device_backend`` with the contract
``engine.extract.run_extract`` drives: the backend is
callable, ``.dispatch(...)`` returns a handle with ``.get()``, and
``.dispatch_group(cfg, items, pad_to)`` returns a list of handles.

The host work (row classification, pairing, arbitration for v3, packing,
row and tile tables, bitmaps) is ``host_prep``; hard rows (indels, '='
bases, and both mates of a pair holding one) are folded in on the host at
finalize.
The numpy arrays go to the device in one place, ``DeviceBackend._launch``:
the upload, the launches and the copy back into pinned host memory run on
the backend's own CUDA stream, and an event marks the copy done. ``.get()``
waits for it on the engine's drain threads.

Windows the port does not serve on the card yet (a BED strand column,
reads longer than 256 bp, ``MDTPU_NO_PALLAS=1``: the JAX package's dense
fallback) go to the exact host engine through a counted route:
``DeviceBackend.host_routed`` counts them and the first one of each reason
writes a line to stderr.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading

import numpy as np
import torch

from ..engine.extract import compute_window_counters_host
from ..ops import semantics as sem
from ..ops.arbitrate import arbitrate
from ..ops.pileup import T, pileup2_tiles
from ..ops.pileup4 import pileup4_tiles
from . import host_prep as hp


class WindowHandle:
    """Deferred window counters: ``.get()`` returns uint32 [W, 4]."""

    __slots__ = ("_fn", "_val")

    def __init__(self, fn=None, value=None):
        self._fn = fn
        self._val = value

    def get(self):
        if self._fn is not None:
            self._val = self._fn()
            self._fn = None
        return self._val


class _GroupResult:
    """Shared deferred result of one group dispatch: the first ``.get(k)``
    runs the group finalize (one readback for all windows) and later ones
    slice it. Drain threads may race the first get."""

    __slots__ = ("_fn", "_vals", "_lock")

    def __init__(self, fn):
        self._fn = fn
        self._vals = None
        self._lock = threading.Lock()

    def get(self, k):
        with self._lock:
            if self._fn is not None:
                self._vals = self._fn()
                self._fn = None
        return self._vals[k]


def fused_window_pregated2(blob, meta, *, Nb, Lq, ntiles, sat_bits,
                           dst=None, out_width=None):
    """Counterpart of ``_fused_window_pregated2`` (and, with sat_bits=32 and
    no compaction, of ``_fused_window_pregated2_wide``): the uploaded
    ``blob`` u8 = seqpack [Nb*Lq] | isc [W/8] | isg [W/8] and ``meta`` i32
    = tlo [ntiles] | thi [ntiles] | spos [Nb] through one fused kernel
    launch. Returns ``(out [2, out_width], overflow [1])``."""
    nbits = ntiles * T // 8
    a = Nb * Lq
    return pileup2_tiles(
        blob[:a].view(Nb, Lq), meta[2 * ntiles : 2 * ntiles + Nb],
        meta[:ntiles], meta[ntiles : 2 * ntiles],
        blob[a : a + nbits], blob[a + nbits : a + 2 * nbits],
        ntiles=ntiles, sat_bits=sat_bits, dst=dst, out_width=out_width)


def fused_window_pregated(blob, meta, *, Nb, Lh, ntiles, sat_bits, dst=None,
                          out_width=None):
    """Counterpart of ``_fused_window_pregated`` (and, with sat_bits=32 and
    no compaction, of ``_fused_window_pregated_wide``): the uploaded
    ``blob`` u8 = seqpack [Nb*Lh] | isc [W/8] | isg [W/8] and ``meta`` i32
    = tlo [ntiles] | thi [ntiles] | spos [Nb] through one fused kernel
    launch. Returns ``(out [4, out_width], overflow [1])``."""
    nbits = ntiles * T // 8
    a = Nb * Lh
    return pileup4_tiles(
        blob[:a].view(Nb, Lh), meta[2 * ntiles : 2 * ntiles + Nb],
        meta[:ntiles], meta[ntiles : 2 * ntiles],
        blob[a : a + nbits], blob[a + nbits : a + 2 * nbits],
        ntiles=ntiles, nch=4, sat_bits=sat_bits, dst=dst,
        out_width=out_width)


def fused_fast_window(blob, meta, *, Nb, L, P, ntiles, nch, min_phred,
                      sat_bits, dst=None, out_width=None, arbitrated=False):
    """Counterpart of ``_fused_fast_window`` + the ``_fused_window_packed``
    readback (``_fused_window_wide`` with sat_bits=32, no compaction and
    ``arbitrated``): ``blob`` u8 = seq [Nb*L] | qual [Nb*L] | isc | isg and
    ``meta`` i32 = tlo [ntiles] | thi [ntiles] | spos [Nb] | pa [P] | pb [P]
    (the P pairs to arbitrate). Unless the quals in ``blob`` are
    ``arbitrated`` already, the pairs' overlaps are arbitrated in place
    first (one launch), then the qual-gated pileup runs (one launch).
    Returns ``(out [nch, out_width], overflow [1])``."""
    nbits = ntiles * T // 8
    a = Nb * L
    seq = blob[:a].view(Nb, L)
    qual = blob[a : 2 * a].view(Nb, L)
    b0 = 2 * a
    m0 = 2 * ntiles + Nb
    spos = meta[2 * ntiles : m0]
    if not arbitrated:
        arbitrate(seq, qual, spos, meta[m0 : m0 + P],
                  meta[m0 + P : m0 + 2 * P])
    return pileup4_tiles(
        seq, spos, meta[:ntiles], meta[ntiles : 2 * ntiles],
        blob[b0 : b0 + nbits], blob[b0 + nbits : b0 + 2 * nbits],
        ntiles=ntiles, nch=nch, sat_bits=sat_bits, dst=dst,
        out_width=out_width, qual=qual, min_phred=min_phred)


def _fold_hard(out, hard, W_k, wpad1, min_phred, nch):
    """Add the host oracle's counters of a window's hard rows (indels, '='
    bases, both mates of a pair holding one) to channels [0, nch) of its
    [W, 4] output; with NCH=2 channels 2-3 stay zero, as on the card."""
    if hard is None:
        return
    hseq, hqual, hrp, hst, ref_p, woff = hard
    hc = sem.pileup_channels(hseq, hqual, hrp, hst, np.ones(hseq.shape, bool),
                             ref_p, woff, 0, wpad1, min_phred)
    out[:, :nch] += hc[:W_k, :nch].astype(np.uint32)


def _hard_rows(w, ref_p, woff):
    hrows = np.nonzero(w["hard"])[0]
    if not len(hrows):
        return None
    return (w["seq"][hrows].copy(), w["qual"][hrows].copy(),
            (w["refpos"][hrows] - w["win_start"]).astype(np.int64),
            w["st"][hrows].copy(), ref_p, woff)


def _hard_rows_v2(seq, qual, refpos, st, hard, a_np, b_np, pair_simple,
                  win_start, ref_p, woff):
    """The v2 program's hard rows with their pairs arbitrated on the host:
    ``semantics.arbitrate_overlaps`` on copies of the rows, over the pairs
    holding a hard mate (``hsel = ~pair_simple``, device.py:2691), in place
    of the JAX package's ``arbitrate_device`` on the device."""
    hrows = np.nonzero(hard)[0]
    if not len(hrows):
        return None
    hseq = seq[hrows].copy()
    hqual = qual[hrows].copy()
    hrp_abs = refpos[hrows].copy()
    hst = st[hrows].copy()
    if len(a_np):
        hremap = np.full(len(hard), -1, np.int64)
        hremap[hrows] = np.arange(len(hrows))
        hsel = ~np.asarray(pair_simple, bool)
        sem.arbitrate_overlaps(hseq, hqual, hrp_abs, hst, hremap[a_np[hsel]],
                               hremap[b_np[hsel]])
    return (hseq, hqual, (hrp_abs - win_start).astype(np.int64), hst, ref_p,
            woff)


class DeviceBackend:
    """The port's compute backend for ``run_extract`` on one device.

    ``device`` is explicit: "cuda" (or "cuda:N") runs the kernel, "cpu" runs
    its plain PyTorch version (for the CPU tests). Per-run state: the
    readback width (u8 until the first overflow, then u16 for the rest of
    the run; shared by the drain threads, so under a lock) and the count of
    windows routed to the host engine."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA device was asked for, but "
                                   "torch.cuda.is_available() is false")
            self.stream = torch.cuda.Stream(self.device)
        elif self.device.type == "cpu":
            self.stream = None
        else:
            raise ValueError(f"unsupported device {self.device}")
        self.host_routed = 0
        self._sat_bits = 8
        self._lock = threading.Lock()
        self._reasons_said: set = set()

    # ------------------------------------------------------------ contract

    def __call__(self, cfg, batch, strand_arr, keep, ref_window, win_offset,
                 win_start, win_end, rstrand=None):
        return self.dispatch(cfg, batch, strand_arr, keep, ref_window,
                             win_offset, win_start, win_end, rstrand).get()

    def dispatch(self, cfg, batch, strand_arr, keep, ref_window, win_offset,
                 win_start, win_end, rstrand=None):
        """One window (``dispatch_window_counters_fast``, v3 branch)."""
        W = win_end - win_start
        kidx = np.nonzero(keep)[0]
        if batch.n == 0 or len(kidx) == 0:
            return WindowHandle(value=np.zeros((W, 4), dtype=np.uint32))
        reason = self._route_reason(cfg, batch.seq.shape[1], rstrand)
        if reason is not None:
            self._note_routed(reason)
            return WindowHandle(value=compute_window_counters_host(
                cfg, batch, strand_arr, keep, ref_window, win_offset,
                win_start, win_end, rstrand))
        W_fixed = hp.round_up(max(int(cfg.chunkSize) + 16, W), T)
        if os.environ.get("MDTPU_FUSED", "v3") == "v2":
            seq, qual, refpos, pos, _lq, st, hard, a, b, ps = \
                hp.prep_v2_rows(cfg, batch, strand_arr, keep, kidx)
            fin = self._dispatch_v2(cfg, seq, qual, refpos, pos, st, hard, a,
                                    b, ps, ref_window, win_start,
                                    win_offset - win_start, W_fixed)
        else:
            seq, qual, refpos, pos, _lq, st, hard = hp.prep_v3_rows(
                cfg, batch, strand_arr, keep, kidx)
            fin = self._dispatch_v3(cfg, seq, qual, refpos, pos, st, hard,
                                    ref_window, win_start,
                                    win_offset - win_start, W_fixed)
        return WindowHandle(fn=lambda: fin()[:W])

    def dispatch_group(self, cfg, items, pad_to=0):
        """K windows in one launch (``dispatch_window_group``), or one
        dispatch per window when the group preconditions fail. ``pad_to``
        only decides whether a lone window rides the group program: the
        port compiles nothing per shape, so no empty slots are added."""
        if len(items) > 1 or pad_to > len(items):
            hs = self._dispatch_window_group(cfg, items)
            if hs is not None:
                return hs
        return [self.dispatch(cfg, *it) for it in items]

    # ------------------------------------------------------------- routing

    @staticmethod
    def _route_reason(cfg, L, rstrand):
        """Why a window takes the host engine (the JAX package's dense
        fallback, not ported yet), or None."""
        if rstrand is not None:
            return "a BED strand column (--keepStrand)"
        if L > 256:
            return "reads longer than 256 bp"
        if os.environ.get("MDTPU_NO_PALLAS") == "1":
            return "MDTPU_NO_PALLAS=1"
        return None

    def _note_routed(self, reason):
        with self._lock:
            self.host_routed += 1
            first = reason not in self._reasons_said
            self._reasons_said.add(reason)
        if first:
            sys.stderr.write("methyldackel_tpu_torch: windows routed to the "
                             f"host engine: {reason}\n")

    # -------------------------------------------------------------- device

    def _stream_ctx(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _upload(self, arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.stream is None:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _launch(self, blob_parts, meta_parts, program, *, nch, W, cand=None,
                wide=None):
        """Upload, launch and start the readback of one window program.

        ``blob_parts`` (u8) and ``meta_parts`` (i32) go up as one array
        each; ``program(blob, meta, sat_bits=, dst=, out_width=)`` launches
        the kernels and returns ``(out [nch, ...], overflow)``, and
        ``wide(blob, meta)`` the dense u32 refetch after an overflow
        (default: ``program`` at sat_bits=32). Returns fetch() -> uint32
        [nch, W] counters, dense; with ``cand`` the device returns only
        those columns and fetch scatters them back (other columns stay
        0)."""
        blob_np = np.concatenate([np.asarray(p, np.uint8).reshape(-1)
                                  for p in blob_parts])
        meta_np = np.concatenate([np.asarray(p, np.int32).reshape(-1)
                                  for p in meta_parts])
        if wide is None:
            def wide(b, m):
                return program(b, m, sat_bits=32)[0]
        with self._lock:
            sat_bits = self._sat_bits
        with self._stream_ctx():
            blob = self._upload(blob_np)
            meta = self._upload(meta_np)
            dst = out_width = None
            if cand is not None:
                idx = self._upload(cand.astype(np.int32))
                dst = torch.full((W,), -1, dtype=torch.int32,
                                 device=self.device)
                dst[idx.long()] = torch.arange(len(cand), dtype=torch.int32,
                                               device=self.device)
                out_width = len(cand)
            out, overflow = program(blob, meta, sat_bits=sat_bits, dst=dst,
                                    out_width=out_width)
            out_b = out.view(torch.uint8)
            if self.stream is None:
                out_h, ovf_h, done = out_b, overflow, None
            else:
                out_h = torch.empty(out_b.shape, dtype=torch.uint8,
                                    pin_memory=True)
                ovf_h = torch.empty(1, dtype=torch.int32, pin_memory=True)
                out_h.copy_(out_b, non_blocking=True)
                ovf_h.copy_(overflow, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
        # every input stays referenced by fetch until its readback is done
        inputs = (blob, meta, dst, out, overflow)
        np_dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[sat_bits]

        def fetch():
            if done is not None:
                done.synchronize()
            if int(ovf_h[0]):
                # a count did not fit: widen the readback for the rest of
                # the run and refetch this window dense in u32
                with self._lock:
                    self._sat_bits = max(self._sat_bits, 16)
                with self._stream_ctx():
                    wide_h = wide(inputs[0], inputs[1]).view(
                        torch.uint8).cpu()
                return wide_h.numpy().view(np.uint32)
            sel = out_h.numpy().view(np_dtype).astype(np.uint32)
            if cand is None:
                return sel
            cm = np.zeros((nch, W), np.uint32)
            cm[:, cand] = sel
            return cm

        return fetch

    # ------------------------------------------------------- single window

    @staticmethod
    def _window_reference(cfg, ref_window, woff_rel, wpad):
        """(ref_p, isc, isg, cand) of one window: the padded reference, its
        frame-shifted C/G bitmaps and the ctx-enabled columns, the only
        ones emit reads (``_ctx_mask_np``; with NCH=4 the four channels are
        exact there, the packed-readback contract)."""
        if not -512 <= woff_rel <= 512:
            raise ValueError(f"window/reference offset {woff_rel} out of range")
        ref_p = hp.ref_padded(ref_window, wpad + 256)
        isc, isg = hp.ref_bits(ref_p, woff_rel, wpad)
        cand = np.nonzero(hp.ctx_mask_np(
            hp.unpack_mask(isc, wpad), hp.unpack_mask(isg, wpad),
            hp.ctx_code(cfg), wpad))[0].astype(np.int64)
        return ref_p, isc, isg, cand

    @staticmethod
    def _finalize_single(fetch, hard_k, W_fixed, wpad, min_phred, nch):
        def finalize():
            cm = fetch()
            out = np.zeros((W_fixed, 4), np.uint32)
            out[:, :nch] = cm[:, :W_fixed].T
            _fold_hard(out, hard_k, W_fixed, wpad, min_phred, nch)
            return out

        return finalize

    def _dispatch_v3(self, cfg, seq, qual, refpos, pos, st, hard, ref_window,
                     win_start, woff_rel, W_fixed):
        """``_fused_dispatch_v3`` on host-arbitrated rows: NCH=2, the 2-bit
        program, or with --minOppositeDepth > 0 NCH=4, the nibble-packed
        12-count program. Returns finalize() -> uint32 [W_fixed, 4]
        (channels 2-3 zero when NCH=2: emit reads only 0-1)."""
        nch = 4 if cfg.minOppositeDepth > 0 else 2
        rows = np.nonzero(~hard)[0]
        f_pos = pos[rows] - win_start
        n = len(rows)
        L = seq.shape[1]
        wpad = hp.round_up(W_fixed, T)
        ntiles = wpad // T
        min_phred = int(cfg.minPhred)

        if nch == 2:
            Lq = (L + 3) // 4
            seqpack = np.zeros((n, Lq), np.uint8)
            pos_p = np.zeros(n, np.int32)
            parity_p = np.zeros(n, np.uint8)
            if n:
                hp.pack2_rows(seq, qual, rows, pos, st, Lq, win_start,
                              min_phred, out=(seqpack, pos_p, parity_p))
            seqpack, spos, tlo, thi = hp.packed_tables(seqpack, pos_p,
                                                       parity_p, ntiles)
            program = functools.partial(fused_window_pregated2, Nb=n, Lq=Lq,
                                        ntiles=ntiles)
            blob = [seqpack]
            meta = [tlo, thi, spos]
        else:
            Lh = (L + 1) // 2
            order, spos, tlo, thi = hp.window_tables(f_pos, st[rows] & 1,
                                                     ntiles, 2 * Lh)
            seqpack, _pos_p, _parity_p = hp.pack4bit_rows(
                seq, qual, rows[order], pos, st, Lh, win_start, min_phred)
            program = functools.partial(fused_window_pregated, Nb=n, Lh=Lh,
                                        ntiles=ntiles)
            blob = [seqpack]
            meta = [tlo, thi, spos]

        ref_p, isc, isg, cand = self._window_reference(cfg, ref_window,
                                                       woff_rel, wpad)
        hard_k = _hard_rows({"hard": hard, "seq": seq, "qual": qual,
                             "refpos": refpos, "st": st,
                             "win_start": win_start}, ref_p, woff_rel)
        fetch = self._launch([*blob, isc, isg], meta, program, nch=nch,
                             W=wpad, cand=cand)
        return self._finalize_single(fetch, hard_k, W_fixed, wpad, min_phred,
                                     nch)

    def _dispatch_v2(self, cfg, seq, qual, refpos, pos, st, hard, a_np, b_np,
                     pair_simple, ref_window, win_start, woff_rel, W_fixed):
        """``_fused_dispatch`` (MDTPU_FUSED=v2): the simple rows go up
        unshifted with their raw quals and the pair table of their simple
        pairs; on the card the overlaps are arbitrated in place and the
        qual-gated 12-count program runs (NCH=2 or 4). The hard rows and
        pairs are arbitrated and counted on the host at finalize. Returns
        finalize() -> uint32 [W_fixed, 4]."""
        nch = 4 if cfg.minOppositeDepth > 0 else 2
        rows = np.nonzero(~hard)[0]
        n = len(rows)
        L = seq.shape[1]
        wpad = hp.round_up(W_fixed, T)
        ntiles = wpad // T
        min_phred = int(cfg.minPhred)

        # sorted by start column: the pileup's precondition, and with it by
        # the aligned start the pair table is built on
        f_pos = (pos[rows] - win_start).astype(np.int64)
        order, spos, tlo, thi = hp.window_tables(f_pos, st[rows] & 1, ntiles,
                                                 L)
        src = rows[order]
        f_pos = f_pos[order]
        al_s = f_pos - (f_pos % 128)
        st_s = st[src]

        # pairs of simple rows in the sorted frame (device.py:2613-2623)
        frame = np.full(len(hard), -1, np.int64)
        frame[src] = np.arange(n)
        sp = np.asarray(pair_simple, bool)
        pa, pb = hp.v2_pair_tables(al_s, st_s, frame[a_np[sp]],
                                   frame[b_np[sp]])
        P = len(pa)
        if P and np.bincount(np.concatenate([pa, pb]), minlength=n).max() > 1:
            raise ValueError("a read is in more than one mate pair")

        ref_p, isc, isg, cand = self._window_reference(cfg, ref_window,
                                                       woff_rel, wpad)
        hard_k = _hard_rows_v2(seq, qual, refpos, st, hard, a_np, b_np,
                               pair_simple, win_start, ref_p, woff_rel)
        program = functools.partial(
            fused_fast_window, Nb=n, L=L, P=P, ntiles=ntiles, nch=nch,
            min_phred=min_phred)

        def wide(b, m):
            # the quals in the blob were arbitrated by the first launch
            return program(b, m, sat_bits=32, arbitrated=True)[0]

        fetch = self._launch([seq[src], qual[src], isc, isg],
                             [tlo, thi, spos, pa, pb], program, nch=nch, W=wpad,
                             cand=cand, wide=wide)
        return self._finalize_single(fetch, hard_k, W_fixed, wpad, min_phred,
                                     nch)

    # ------------------------------------------------------------- groups

    def _dispatch_window_group(self, cfg, items):
        """``dispatch_window_group``: a list of per-window handles, or None
        when the group preconditions fail (NCH=4, a BED strand column,
        L > 256 or mixed across windows, a window wider than the slot,
        MDTPU_FUSED=v2, MDTPU_NO_PALLAS=1)."""
        if cfg.minOppositeDepth > 0 or not items:
            return None
        if os.environ.get("MDTPU_FUSED", "v3") == "v2" \
                or os.environ.get("MDTPU_NO_PALLAS") == "1":
            return None
        Ls = set()
        for it in items:
            if it[7] is not None:  # rstrand
                return None
            if it[0].n:
                Ls.add(it[0].seq.shape[1])
        if (Ls and max(Ls) > 256) or len(Ls) > 1:
            return None
        W_fixed = hp.round_up(int(cfg.chunkSize) + 16, T)
        wins = []
        for (batch, strand_arr, keep, ref_window, win_offset, win_start,
             win_end, _rs) in items:
            W = win_end - win_start
            if hp.round_up(max(int(cfg.chunkSize) + 16, W), T) > W_fixed:
                return None  # window wider than the group slot
            kidx = np.nonzero(keep)[0]
            if batch.n == 0 or len(kidx) == 0:
                wins.append({"empty": True, "W": W})
                continue
            seq, qual, refpos, pos, _lq, st, hard = hp.prep_v3_rows(
                cfg, batch, strand_arr, keep, kidx)
            wins.append({"empty": False, "W": W, "seq": seq, "qual": qual,
                         "refpos": refpos, "pos": pos, "st": st,
                         "hard": hard, "ref_window": ref_window,
                         "win_start": win_start,
                         "woff_rel": win_offset - win_start})
        fin = self._dispatch_group_multi(cfg, wins, W_fixed)
        g = _GroupResult(fin)
        return [WindowHandle(fn=functools.partial(g.get, k))
                for k in range(len(items))]

    def _dispatch_group_multi(self, cfg, wins, W_fixed):
        """``_fused_dispatch_v3_multi``: candidate space first, window
        space when that is ineligible or MDTPU_CANDSPACE=0. Returns
        finalize() -> list of uint32 [W_k, 4]."""
        if not any(not w["empty"] for w in wins):
            Ws = [w["W"] for w in wins]
            return lambda: [np.zeros((W, 4), np.uint32) for W in Ws]
        if os.environ.get("MDTPU_CANDSPACE", "1") != "0":
            fin = self._dispatch_group_cand(cfg, wins, W_fixed)
            if fin is not None:
                return fin
        return self._dispatch_group_window(cfg, wins, W_fixed)

    def _dispatch_group_cand(self, cfg, wins, W_fixed):
        """``_fused_dispatch_v3_multi_cand``: reads re-coordinated from
        window positions to candidate slots (the ctx-enabled positions, the
        only ones emit reads), so the group's coordinate space shrinks to
        Kw * CSLOT. Returns None, without touching ``wins``, when a window
        holds more candidates than the CSLOT ladder or a read covers more
        than 128 slots."""
        live = [w for w in wins if not w["empty"]]
        L = live[0]["seq"].shape[1]
        wpad1 = hp.round_up(W_fixed, T)
        ctx = hp.ctx_code(cfg)
        min_phred = int(cfg.minPhred)
        Kw = len(wins)

        # phase A: per-window candidate geometry (no mutation yet)
        geo = [None] * Kw
        maxC = 0
        for k, w in enumerate(wins):
            if w["empty"]:
                continue
            woff = int(w["woff_rel"])
            if not -512 <= woff <= 512:
                return None
            ref_p = hp.ref_padded(w["ref_window"], wpad1 + 256)
            rb = hp.ref_bits(ref_p, woff, wpad1)
            cand, csum = hp.candidates(rb[0], rb[1], wpad1, ctx)
            geo[k] = {"ref_p": ref_p, "rb": rb, "cand": cand, "csum": csum,
                      "woff": woff}
            maxC = max(maxC, len(cand))
        CSLOT = hp.ncand_bucket(maxC, wpad1)
        if CSLOT == 0:
            return None

        # phase B: per-window slot-space row geometry + Lc bucket
        per = [None] * Kw
        n_tot = 0
        maxcnt = 0
        for k, w in enumerate(wins):
            if w["empty"]:
                continue
            csum = geo[k]["csum"]
            rows = np.nonzero(~w["hard"])[0]
            f_pos = (w["pos"][rows] - w["win_start"]).astype(np.int64)
            s0 = csum[np.clip(f_pos, 0, wpad1)].astype(np.int64)
            cnt = csum[np.clip(f_pos + L, 0, wpad1)].astype(np.int64) - s0
            if len(cnt):
                maxcnt = max(maxcnt, int(cnt.max()))
            per[k] = {"src": rows, "f_pos": f_pos, "s0": s0, "cnt": cnt,
                      "row0": n_tot}
            n_tot += len(rows)
        Lc4 = hp.lc_bucket(maxcnt)
        if Lc4 == 0:
            return None

        # group geometry in candidate-slot coordinates
        Lq = Lc4 // 4
        P = hp.round_up(CSLOT, T)  # slot pitch
        W_tot = Kw * P
        ntiles = W_tot // T

        # phase C: pack rows into candidate space + slot bitmaps (mutating
        # from here on: no fallback past this point)
        seqpack = np.zeros((n_tot, Lq), np.uint8)
        pos_p = np.zeros(n_tot, np.int32)
        parity_p = np.zeros(n_tot, np.uint8)
        isc_all = np.zeros(W_tot // 8, np.uint8)
        isg_all = np.zeros(W_tot // 8, np.uint8)
        hard = [None] * Kw
        cands = [None] * Kw
        Ws = [w["W"] for w in wins]
        for k, (w, p) in enumerate(zip(wins, per)):
            if p is None:
                continue
            g = geo[k]
            cand = g["cand"]
            cands[k] = cand
            n_k = len(p["src"])
            r0 = p["row0"]
            if n_k:
                hp.pack2_cand_rows(
                    w["seq"], w["qual"], p["src"], w["pos"], w["st"], Lq,
                    w["win_start"], min_phred, cand, g["csum"], wpad1, k * P,
                    p["f_pos"], p["s0"], p["cnt"],
                    out=(seqpack[r0 : r0 + n_k], pos_p[r0 : r0 + n_k],
                         parity_p[r0 : r0 + n_k]))
            if len(cand):
                # slot j of window k is a C-site or a G-site
                rb0, rb1 = g["rb"]
                sh7 = (7 - (cand & 7)).astype(np.int64)
                sC = np.zeros(P, bool)
                sG = np.zeros(P, bool)
                sC[: len(cand)] = ((rb0[cand >> 3] >> sh7) & 1) != 0
                sG[: len(cand)] = ((rb1[cand >> 3] >> sh7) & 1) != 0
                isc_all[k * P // 8 : (k + 1) * P // 8] = np.packbits(sC)
                isg_all[k * P // 8 : (k + 1) * P // 8] = np.packbits(sG)
            hard[k] = _hard_rows(w, g["ref_p"], g["woff"])
            w.clear()  # finalize must not pin the window's big arrays
        del wins, live, per, geo

        # a row starts at its first slot, s0 + k * P: coordinate-sorted
        # windows give starts that do not decrease across the whole group
        seqpack, spos, tlo, thi = hp.packed_tables(seqpack, pos_p, parity_p,
                                                   ntiles)
        fetch = self._launch(
            [seqpack, isc_all, isg_all], [tlo, thi, spos],
            functools.partial(fused_window_pregated2, Nb=n_tot, Lq=Lq,
                              ntiles=ntiles), nch=2, W=W_tot)

        def finalize():
            cm = fetch()
            outs = []
            for k in range(Kw):
                out = np.zeros((Ws[k], 4), np.uint32)
                cand = cands[k]
                if cand is not None and len(cand):
                    m = cand < Ws[k]
                    out[cand[m], :2] = cm[:, k * P : k * P + len(cand)].T[m]
                _fold_hard(out, hard[k], Ws[k], wpad1, min_phred, 2)
                outs.append(out)
            return outs

        return finalize

    def _dispatch_group_window(self, cfg, wins, W_fixed):
        """Window-space group: K windows in guard-separated slots of
        S = wpad + 512 columns, the readback compacted to the ctx-enabled
        columns."""
        live = [w for w in wins if not w["empty"]]
        L = live[0]["seq"].shape[1]
        Lq = (L + 3) // 4
        wpad1 = hp.round_up(W_fixed, T)
        # guard tile between slots: reads near a slot's right edge write up
        # to L-1 columns past it, where no candidate bit is set
        S = wpad1 + 512
        Kw = len(wins)
        W_tot = Kw * S
        ntiles = W_tot // T
        nbits1 = wpad1 // 8
        min_phred = int(cfg.minPhred)

        per = []
        n_tot = 0
        for w in wins:
            if w["empty"]:
                per.append(None)
                continue
            rows = np.nonzero(~w["hard"])[0]
            per.append({"src": rows, "row0": n_tot})
            n_tot += len(rows)

        seqpack = np.zeros((n_tot, Lq), np.uint8)
        pos_p = np.zeros(n_tot, np.int32)
        parity_p = np.zeros(n_tot, np.uint8)
        isc_all = np.zeros(W_tot // 8, np.uint8)
        isg_all = np.zeros(W_tot // 8, np.uint8)
        hard = [None] * Kw
        Ws = [w["W"] for w in wins]
        for k, (w, p) in enumerate(zip(wins, per)):
            if p is None:
                continue
            n_k = len(p["src"])
            r0 = p["row0"]
            if n_k:
                hp.pack2_rows(w["seq"], w["qual"], p["src"], w["pos"],
                              w["st"], Lq, w["win_start"], min_phred,
                              out=(seqpack[r0 : r0 + n_k],
                                   pos_p[r0 : r0 + n_k],
                                   parity_p[r0 : r0 + n_k]))
                pos_p[r0 : r0 + n_k] += k * S  # slot offset (multiple of 512)
            woff = int(w["woff_rel"])
            if not -512 <= woff <= 512:
                raise ValueError(f"window/reference offset {woff} out of range")
            ref_p = hp.ref_padded(w["ref_window"], wpad1 + 256)
            rb = hp.ref_bits(ref_p, woff, wpad1)
            isc_all[k * S // 8 : k * S // 8 + nbits1] = rb[0]
            isg_all[k * S // 8 : k * S // 8 + nbits1] = rb[1]
            hard[k] = _hard_rows(w, ref_p, woff)
            w.clear()
        del wins, live, per

        # per-slot context mask (period S, data extent wpad1)
        cand = np.nonzero(hp.ctx_mask_np(
            hp.unpack_mask(isc_all, W_tot), hp.unpack_mask(isg_all, W_tot),
            hp.ctx_code(cfg), (S, wpad1)))[0].astype(np.int64)
        # a row starts at f_pos + k * S (negative in slot 0 for a read that
        # begins left of its window); the guard tiles get their row ranges
        # like any tile
        seqpack, spos, tlo, thi = hp.packed_tables(seqpack, pos_p, parity_p,
                                                   ntiles)
        fetch = self._launch(
            [seqpack, isc_all, isg_all], [tlo, thi, spos],
            functools.partial(fused_window_pregated2, Nb=n_tot, Lq=Lq,
                              ntiles=ntiles), nch=2, W=W_tot, cand=cand)

        def finalize():
            cm = fetch()
            outs = []
            for k in range(Kw):
                out = np.zeros((Ws[k], 4), np.uint32)
                out[:, :2] = cm[:, k * S : k * S + Ws[k]].T
                _fold_hard(out, hard[k], Ws[k], wpad1, min_phred, 2)
                outs.append(out)
            return outs

        return finalize


def make_device_backend(cfg, device="cuda") -> DeviceBackend:
    """The backend ``run_extract`` drives, on ``device`` ("cuda" or
    "cpu"; no silent move from one to the other)."""
    return DeviceBackend(device)
