"""The device backends: the window programs of ``extract`` and the
backends of ``mbias`` and ``perRead``.

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
- the dense fallback (the slow branch of ``make_device_backend.dispatch``):
  a window with a BED strand column, reads longer than 256 bp or
  ``MDTPU_NO_PALLAS=1`` takes one dispatch of ``programs.arbitrate_device``
  and ``programs.pileup_device`` (torch ops, no hand-written kernel) over
  all of its rows. No window goes to the host engine;

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

``make_mbias_backend`` and ``make_perread_backend`` are the backends of the
two other subcommands: the host packs 2-bit codes (``io.native``), the
device reduces them (``programs._mbias_reduce``, ``programs._perread_reduce``)
and a few KB come back; rows the pack does not take are done by the numpy
oracle on the host, as in the JAX package, and inputs the pack rejects take
the programs over raw rows (``programs.mbias_device``,
``programs.perread_device``).
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading

import numpy as np
import torch

from ..engine.perread import process_reads_gapless
from ..io import native
from ..ops import semantics as sem
from ..ops.arbitrate import arbitrate
from ..ops.pileup import T, pileup2_tiles
from ..ops.pileup4 import pileup4_tiles
from . import host_prep as hp
from . import programs


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


def dense_rows(batch, strand_arr, kidx, win_start, W, rstrand):
    """The host prep of a window's raw rows for the dense programs
    (``programs.arbitrate_device``, ``programs.pileup_device``), shared by
    the dense dispatch and the mesh backend: the kept rows ``kidx`` of
    ``batch``, trimmed and gated on the host already, as (seq u8 [n, L],
    qual u8 [n, L], refpos i32 [n, L], strand i32 [n], keep_base bool
    [n, L] or None, pair_a, pair_b). ``keep_base`` is the per-base strand
    mask of a stranded BED (readStrandOverlapsBED, bed.c:56-64; the host
    path's formula), None without a strand column; the pairs are the exact
    qname pairing (``semantics.pair_mates_batch``) as indices into the kept
    rows."""
    refpos = batch.refpos[kidx]
    keep_base = None
    if rstrand is not None:
        safe = np.clip(refpos - win_start, 0, W - 1)
        rs = rstrand[safe]
        odd = (strand_arr[kidx].astype(np.int64) & 1)[:, None] == 1
        keep_base = (rs == 0) | ((rs == 1) & odd) | ((rs == 2) & ~odd)
    a_np, b_np = sem.pair_mates_batch(batch, kidx)
    return (batch.seq[kidx], batch.qual[kidx], refpos.astype(np.int32),
            strand_arr[kidx].astype(np.int32), keep_base, a_np, b_np)


class _DeviceLane:
    """What every backend holds: an explicit device ("cuda" or "cuda:N" runs
    the kernels, "cpu" their plain PyTorch versions, for the CPU tests), on
    the card a CUDA stream of its own, and a lock for the state its callers'
    threads share. Nothing here moves work from one device to the other."""

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
        self._lock = threading.Lock()

    def _stream_ctx(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _upload(self, arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.stream is None:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _readback(self, *tensors):
        """Start the copy of device ``tensors`` into pinned host memory on
        the backend's stream (call inside ``_stream_ctx``). Returns
        wait() -> the host tensors, which blocks on one event recorded
        after the copies and on nothing else. The caller keeps every input
        of the launches referenced until wait() has returned."""
        if self.stream is None:
            return lambda: tensors
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        done = torch.cuda.Event()
        done.record(self.stream)

        def wait():
            done.synchronize()
            return hosts

        return wait

    def _count(self, key):
        with self._lock:
            self.launches[key] += 1


class DeviceBackend(_DeviceLane):
    """The port's compute backend for ``run_extract`` on one device.

    Per-run state: the readback width (u8 until the first overflow, then
    u16 for the rest of the run; shared by the drain threads, so under the
    lock) and ``launches["dense"]``, the number of windows that took the
    dense fallback. ``host_routed`` is always 0 and nothing raises it: no
    window goes to the host engine. It stays for the callers that assert
    just that."""

    host_routed = 0

    def __init__(self, device):
        super().__init__(device)
        self._sat_bits = 8
        self.launches = {"dense": 0}

    # ------------------------------------------------------------ contract

    def __call__(self, cfg, batch, strand_arr, keep, ref_window, win_offset,
                 win_start, win_end, rstrand=None):
        return self.dispatch(cfg, batch, strand_arr, keep, ref_window,
                             win_offset, win_start, win_end, rstrand).get()

    def dispatch(self, cfg, batch, strand_arr, keep, ref_window, win_offset,
                 win_start, win_end, rstrand=None):
        """One window (``dispatch_window_counters_fast``, v3 branch, or the
        dense fallback)."""
        W = win_end - win_start
        kidx = np.nonzero(keep)[0]
        if batch.n == 0 or len(kidx) == 0:
            return WindowHandle(value=np.zeros((W, 4), dtype=np.uint32))
        if rstrand is not None or batch.seq.shape[1] > 256 \
                or os.environ.get("MDTPU_NO_PALLAS") == "1":
            return WindowHandle(fn=self._dispatch_dense(
                cfg, batch, strand_arr, kidx, ref_window, win_offset,
                win_start, W, rstrand))
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

    # ------------------------------------------------------ dense fallback

    def _dispatch_dense(self, cfg, batch, strand_arr, kidx, ref_window,
                        win_offset, win_start, W, rstrand):
        """The dense branch of the reference's ``dispatch``: the kept rows
        of the window, trimmed and gated on the host already, go up raw;
        on the device all mate pairs are arbitrated at once
        (``programs.arbitrate_device``) and every base is scatter-added
        into the four channels (``programs.pileup_device``), under the
        per-base strand mask of a stranded BED. Exact shapes. Returns
        fetch() -> uint32 [W, 4]."""
        seq_np, qual_np, refpos_np, st_np, keep_base_np, a_np, b_np = \
            dense_rows(batch, strand_arr, kidx, win_start, W, rstrand)
        ovw = hp.round_up(max(2 * seq_np.shape[1], 1), 128)
        with self._stream_ctx():
            seq = self._upload(seq_np)
            qual = self._upload(qual_np)
            refpos = self._upload(refpos_np)
            st = self._upload(st_np)
            keep_base = None if keep_base_np is None \
                else self._upload(keep_base_np)
            qual2 = programs.arbitrate_device(
                seq, qual, refpos, st, self._upload(a_np.astype(np.int64)),
                self._upload(b_np.astype(np.int64)), None, ovw)
            counters = programs.pileup_device(
                seq, qual2, refpos, st,
                torch.ones(len(kidx), dtype=torch.bool, device=self.device),
                keep_base, self._upload(np.asarray(ref_window, np.uint8)),
                win_offset, win_start, W, int(cfg.minPhred))
            wait = self._readback(counters)
        self._count("dense")

        def fetch():
            (out_h,) = wait()
            return out_h.numpy().view(np.uint32)

        # every tensor of the dispatch stays referenced until fetch is gone
        fetch.inputs = (seq, qual, qual2, refpos, st, keep_base, counters)
        return fetch

    # -------------------------------------------------------------- device

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
            wait = self._readback(out.view(torch.uint8), overflow)
        # every input stays referenced by fetch until its readback is done
        inputs = (blob, meta, dst, out, overflow)
        np_dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[sat_bits]

        def fetch():
            out_h, ovf_h = wait()
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


# ------------------------------------------------------------------ mbias

def _fit_cycles(out, max_len):
    """[4, 2, 2, n] counters cropped or zero-grown to ``max_len`` cycles."""
    if out.shape[3] >= max_len:
        return out[..., :max_len]
    grown = np.zeros((4, 2, 2, max_len), np.uint32)
    grown[..., : out.shape[3]] = out
    return grown


class MbiasBackend(_DeviceLane):
    """The ``mbias`` device backend (``make_mbias_backend``): per window
    the host packs 2-bit codes with the context, calling-base and window
    gates resolved against two per-position masks (``native.mbias_pack``),
    the device reduces them per (strand, read, state, cycle)
    (``programs._mbias_reduce``) and [4, 2, 2, 4 * Lq] counts come back.
    Rows that are not gapless take the numpy oracle on the host and are
    added. BED windows (a per-base keep mask), reads longer than 256 bp and
    a missing native library take ``programs.mbias_device`` over the raw
    rows. Called from the engine's worker threads with ``-@ N``: every call
    has its own tensors, and ``launches`` (``reduce``, ``legacy``) is
    counted under the lock."""

    def __init__(self, cfg, device):
        super().__init__(device)
        self.min_phred = int(cfg.minPhred)
        self.launches = {"reduce": 0, "legacy": 0}

    def __call__(self, seq, qual, refpos, strand_arr, flag, keep_base,
                 ref_window, win_offset, win_start, win_end, keep_ctx,
                 max_len, pos=None, lq=None):
        n, L = seq.shape
        if n == 0:
            return np.zeros((4, 2, 2, max_len), dtype=np.uint32)
        plain = keep_base is None or bool(keep_base.all())
        simple = None
        if pos is not None and lq is not None and plain \
                and native.available() and L <= 256:
            simple = native.v3_flags(seq, refpos, pos, lq)
        packed = None
        if simple is not None:
            rw = np.asarray(ref_window)
            ctype, _cdir = sem.classify_context(rw)
            kept = np.array([keep_ctx[0], keep_ctx[1], keep_ctx[2], 0],
                            bool)[ctype]
            rows = np.nonzero(simple)[0]
            Lq = (L + 3) // 4
            packed = native.mbias_pack(
                seq, qual, rows, pos, lq, np.asarray(strand_arr, np.int32),
                np.asarray(flag, np.uint16),
                (kept & (rw == programs.REF_C)).astype(np.uint8),
                (kept & (rw == programs.REF_G)).astype(np.uint8),
                win_offset, win_start, win_end, Lq, len(rows),
                self.min_phred)
        if packed is None:
            return self._legacy(seq, qual, refpos, strand_arr, flag,
                                keep_base, ref_window, win_offset, win_start,
                                win_end, keep_ctx, max_len)
        codes, combo = packed
        with self._stream_ctx():
            out_d = programs._mbias_reduce(self._upload(codes),
                                           self._upload(combo))
            out = out_d.cpu().numpy().view(np.uint32)
        self._count("reduce")
        hard = np.nonzero(~simple)[0]
        if len(hard):
            hc = sem.mbias_counters(
                np.ascontiguousarray(seq[hard]),
                np.ascontiguousarray(qual[hard]), refpos[hard],
                strand_arr[hard], flag[hard], np.ones((len(hard), L), bool),
                ref_window, win_offset, win_start, win_end, keep_ctx,
                self.min_phred, L)
            out[..., : hc.shape[3]] += hc.astype(np.uint32)
        return _fit_cycles(out, max_len)

    def _legacy(self, seq, qual, refpos, strand_arr, flag, keep_base,
                ref_window, win_offset, win_start, win_end, keep_ctx,
                max_len):
        """``_mbias_legacy``: the raw rows go up at their exact shapes and
        ``programs.mbias_device`` counts them."""
        if keep_base is None:
            keep_base = np.ones(seq.shape, bool)
        with self._stream_ctx():
            out_d = programs.mbias_device(
                self._upload(seq), self._upload(qual),
                self._upload(refpos.astype(np.int32)),
                self._upload(np.asarray(strand_arr).astype(np.int32)),
                self._upload(np.asarray(flag).astype(np.int32)),
                self._upload(keep_base),
                self._upload(np.asarray(ref_window, np.uint8)),
                win_offset, win_start, win_end,
                keep_ctx=tuple(bool(k) for k in keep_ctx),
                min_phred=self.min_phred)
            out = out_d.cpu().numpy().view(np.uint32)
        self._count("legacy")
        return _fit_cycles(out, max_len)


def make_mbias_backend(cfg, device="cuda") -> MbiasBackend:
    """The backend ``engine.mbias.compute_mbias`` calls per window, on
    ``device`` ("cuda" or "cpu"; no silent move from one to the other)."""
    return MbiasBackend(cfg, device)


# ---------------------------------------------------------------- perRead

class PerreadBackend(_DeviceLane):
    """The ``perRead`` device backend (``make_perread_backend``): the host
    packs 2-bit tally codes (``native.perread_pack``: CpG direction, window,
    strand and base resolved on the host), the device counts them per read
    (``programs._perread_reduce``) and two [n] vectors come back. Rows
    holding a sub-phred base (``haslow``) are redone by the exact host
    walker, so the low-qual skip quirk never reaches the packed path. Reads
    longer than 1020 bp (the pack's row buffer) and a missing native
    library take ``programs.perread_device`` over the raw rows.

    ``dispatch(...)`` returns a ``finish()`` closure, so that the engine
    keeps several windows in flight: upload, reduction and the copy back
    into pinned memory run on the backend's stream, and ``finish()`` waits
    for the one event recorded after that copy. ``launches`` (``reduce``,
    ``legacy``) and ``rows_redone`` (the ``haslow`` rows the host walker
    redid) are counted under the lock."""

    def __init__(self, cfg, device):
        super().__init__(device)
        self.cfg = cfg
        self.min_phred = int(cfg.minPhred)
        self.launches = {"reduce": 0, "legacy": 0}
        self.rows_redone = 0

    def __call__(self, *args):
        return self.dispatch(*args)()

    def dispatch(self, seq, qual, pos, lq, strand_arr, ref_window, seq_start,
                 seq_len):
        n, L = seq.shape
        if n == 0:
            z = (np.zeros(0, np.int64), np.zeros(0, np.int64))
            return lambda: z
        rw = np.asarray(ref_window)
        packed = None
        # L cap = the pack's row buffer (it rejects wider rows)
        if native.available() and L <= 1020:
            is_c = rw == programs.REF_C
            is_g = rw == programs.REF_G
            dirv = np.zeros(len(rw), np.int8)
            dirv[:-1][is_c[:-1] & is_g[1:]] = 1
            dirv[1:][is_g[1:] & is_c[:-1]] = -1
            packed = native.perread_pack(
                np.ascontiguousarray(seq), np.ascontiguousarray(qual),
                np.arange(n, dtype=np.int64), pos, lq,
                np.asarray(strand_arr, np.int32), dirv, seq_start,
                min(seq_len, len(rw)), (L + 3) // 4, n, self.min_phred)
        if packed is None:
            res = self._legacy(seq, qual, pos, lq, strand_arr, rw, seq_start,
                               seq_len)
            return lambda: res
        codes, haslow = packed
        with self._stream_ctx():
            codes_d = self._upload(codes)
            nm_d, nu_d = programs._perread_reduce(codes_d)
            wait = self._readback(nm_d, nu_d)
        self._count("reduce")

        def finish():
            nm_h, nu_h = wait()
            nm = nm_h.numpy().astype(np.int64)
            nu = nu_h.numpy().astype(np.int64)
            dirty = np.nonzero(haslow)[0]
            if len(dirty):
                with self._lock:
                    self.rows_redone += len(dirty)
                nm[dirty], nu[dirty] = process_reads_gapless(
                    self.cfg, np.ascontiguousarray(seq[dirty]),
                    np.ascontiguousarray(qual[dirty]), pos[dirty],
                    lq[dirty], strand_arr[dirty], ref_window, seq_start,
                    seq_len)
            return nm, nu

        # every tensor of the dispatch stays referenced until finish is gone
        finish.inputs = (codes_d, nm_d, nu_d)
        return finish

    def _legacy(self, seq, qual, pos, lq, strand_arr, rw, seq_start,
                seq_len):
        """``_perread_legacy``: the raw rows go up at their exact shapes
        and ``programs.perread_device`` walks them in lockstep."""
        if seq_len <= 0 or len(rw) == 0:  # no reference: nothing to tally
            return np.zeros(len(seq), np.int64), np.zeros(len(seq), np.int64)
        with self._stream_ctx():
            nm_d, nu_d = programs.perread_device(
                self._upload(seq), self._upload(qual),
                self._upload(np.asarray(pos, np.int64).astype(np.int32)),
                self._upload(np.asarray(lq, np.int32)),
                self._upload(np.asarray(strand_arr).astype(np.int32)),
                self._upload(rw[:seq_len].astype(np.uint8)),
                int(seq_start), int(seq_len), min_phred=self.min_phred)
            nm = nm_d.cpu().numpy().astype(np.int64)
            nu = nu_d.cpu().numpy().astype(np.int64)
        self._count("legacy")
        return nm, nu


def make_perread_backend(cfg, device="cuda") -> PerreadBackend:
    """The backend ``engine.perread.run_perread`` dispatches to per window,
    on ``device`` ("cuda" or "cpu"; no silent move from one to the
    other)."""
    return PerreadBackend(cfg, device)
