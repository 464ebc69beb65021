"""Multi-device execution: one process drives a (dp, sp) grid of devices.

Counterpart of ``methyldackel_tpu/parallel/mesh.py`` under the same names.
The reference's only parallelism is pthreads over a mutex-guarded genome
cursor with ticket-ordered output (main.c:7-15, extract.c:326-350,
:514-535). Here one window is cut over a 2-D grid:

- dp ("data parallel"): the window's rows are split across the grid's
  rows; each cell scatter-adds its shard's contributions and the partial
  counters of a column slice are added on the device that owns the slice —
  the add is the communication, replacing the ordered-output mutex. Mate
  pairs are co-sharded via the adjacent-mate layout (mates occupy rows 2i
  and 2i+1, and a shard starts at an even row), the analogue of the
  chunk-local overlap hash (overlaps.c:12-14).
- sp ("sequence/position parallel"): the genome-coordinate axis of the
  counter tensor is cut, so each cell owns a position slice and only its
  slice's counters are materialized — the analogue of the reference's
  1 Mb genome chunks, but across devices instead of threads.

Determinism comes from the integer counters, not from output tickets: int32
adds give the same bits in any order, so every grid shape and every schedule
is bit-identical.

There is no collective to translate: the process owns every cell. A cell is
a ``_DeviceLane`` (its device, a CUDA stream of its own, pinned uploads,
one-event readback). The work of a row shard that does not depend on the
column slice (strand, the conversion-efficiency gate, trimming, mate-overlap
arbitration: ``programs.window_front``) runs once on each device of its grid
row, the pileup once a cell on the cell's stream, the dp partials of a slice
are added on the stream of cell (0, s), and the sp slices are concatenated
on the host after the readback. Work handed from one stream to another is
ordered by an event, and its tensors are marked with ``record_stream``.

A grid may name one device many times: with ``device="cuda"`` it is filled
from ``cuda:0 .. cuda:{count-1}`` round robin, so eight shards on a machine
with one card are eight streams of that card (with ``device="cpu"`` every
cell is the CPU). Shapes are exact: shards may be uneven or empty and the
last column slice may be shorter, so neither the row count nor the window
width has to divide over the grid. Nothing here moves work to another
device: a cell whose step raises fails the window.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from . import device as dev
from . import host_prep as hp
from . import programs


def device_count(device) -> int:
    """How many devices of ``device``'s type are present: the cards for
    "cuda" (raises without one), one for "cpu"."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for, but "
                               "torch.cuda.is_available() is false")
        return torch.cuda.device_count()
    if kind == "cpu":
        return 1
    raise ValueError(f"unsupported device {device}")


class DeviceMesh:
    """A [dp, sp] grid: ``devices[d][s]`` is a ``torch.device``,
    ``lanes[d][s]`` its ``_DeviceLane`` and ``shape`` is
    ``{"dp": dp, "sp": sp}``."""

    def __init__(self, devices, dp, sp):
        self.shape = {"dp": dp, "sp": sp}
        self.devices = [list(devices[d * sp : (d + 1) * sp])
                        for d in range(dp)]
        self.lanes = [[dev._DeviceLane(x) for x in row]
                      for row in self.devices]


def make_mesh(n_devices: int | None = None, sp: int | None = None,
              device="cuda") -> DeviceMesh:
    """A grid of ``n_devices`` cells (default: the devices present) on
    ``device``'s type. Entries repeat when ``n_devices`` exceeds the devices
    present."""
    present = device_count(device)
    kind = torch.device(device).type
    n = n_devices if n_devices is not None else present
    # Prefer a 2-D (dp, sp) layout when the cell count allows it, so both
    # axes are exercised; fall back to pure data parallelism. An explicit
    # `sp` overrides.
    if sp is None:
        sp = 1
        for cand in (4, 2):
            if n % cand == 0 and n // cand >= 2:
                sp = cand
                break
    if n < 1 or sp < 1 or n % sp:
        raise ValueError(f"a grid of {n} cells cannot be cut in sp={sp}")
    if kind == "cuda":
        devices = [torch.device("cuda", i % present) for i in range(n)]
    else:
        devices = [torch.device("cpu")] * n
    return DeviceMesh(devices, n // sp, sp)


# --------------------------------------------------------- the sharded step

def _put(lane, x):
    """``x`` (a numpy array or a tensor on any device) on the lane's
    device; call inside the lane's stream context."""
    if isinstance(x, torch.Tensor):
        return x.to(lane.device, non_blocking=True)
    return lane._upload(x)


def _mark(lane):
    """An event after what the lane's stream holds so far (None on the
    CPU)."""
    if lane.stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(lane.stream)
    return ev


def _after(lane, event, *tensors):
    """The lane's stream takes up ``tensors`` made on another stream: it
    waits for ``event``, and the allocator learns of the second user."""
    if lane.stream is None:
        return
    lane.stream.wait_event(event)
    for t in tensors:
        if t is not None and t.is_cuda and t.device == lane.device:
            t.record_stream(lane.stream)


def _row_cuts(n, dp):
    """dp + 1 row boundaries over ``n`` rows, each at an even row (a pair
    boundary of the adjacent-mate layout) or at ``n``."""
    units = (n + 1) // 2
    return [min(2 * ((d * units) // dp), n) for d in range(dp)] + [n]


def _dispatch_sharded(mesh, front, rows, pair_valid, rep, win_offset,
                      win_start, wpad, min_phred):
    """Start one window step on the grid. ``rows`` holds the row-sharded
    inputs (numpy arrays or tensors, first axis the rows, None allowed),
    ``pair_valid`` one entry a row pair or None, ``rep`` the replicated
    inputs. ``front(sh, pv, rp) -> (seq, qual, refpos, strand, keep_read,
    keep_base, ref)`` is the part of the step that does not depend on the
    column slice. Returns fetch() -> uint32 [wpad, 4]."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    n = len(rows["seq"])
    cuts = _row_cuts(n, dp)
    wshard = -(-wpad // sp) if wpad > 0 else 0
    spans = [(s * wshard, max(0, min(wshard, wpad - s * wshard)))
             for s in range(sp)]
    partials = [[] for _ in range(sp)]
    held = []
    for d in range(dp):
        r0, r1 = cuts[d], cuts[d + 1]
        if r1 <= r0:
            continue
        fronts = {}
        for s, (c0, width) in enumerate(spans):
            if width <= 0:
                continue
            lane = mesh.lanes[d][s]
            if lane.device not in fronts:
                # once a device of this grid row, on its first cell's lane
                caller = None if lane.stream is None \
                    else torch.cuda.current_stream(lane.device)
                with lane._stream_ctx():
                    if caller is not None:
                        # tensors the caller made on its own stream
                        lane.stream.wait_stream(caller)
                    sh = {k: None if v is None else _put(lane, v[r0:r1])
                          for k, v in rows.items()}
                    pv = None if pair_valid is None \
                        else _put(lane, pair_valid[r0 // 2 : r1 // 2])
                    rp = {k: _put(lane, v) for k, v in rep.items()}
                    out = front(sh, pv, rp)
                    fronts[lane.device] = (out, _mark(lane), lane)
                held.append((sh, pv, rp, out))
            out, ready, made_on = fronts[lane.device]
            seq, qual, refpos, strand, keep_read, keep_base, ref = out
            with lane._stream_ctx():
                if lane is not made_on:
                    _after(lane, ready, *out)
                part = programs.pileup_device(
                    seq, qual, refpos, strand, keep_read, keep_base, ref,
                    win_offset, win_start + c0, width, min_phred)
                partials[s].append((part, _mark(lane), lane))
    waits = []
    for s, (c0, width) in enumerate(spans):
        if width <= 0:
            continue
        owner = mesh.lanes[0][s]
        with owner._stream_ctx():
            total = None
            for part, done, lane in partials[s]:
                if lane is not owner:
                    _after(owner, done, part)
                part = part.to(owner.device, non_blocking=True)
                total = part if total is None else total.add_(part)
            if total is None:  # no row in any shard
                total = torch.zeros((width, 4), dtype=torch.int32,
                                    device=owner.device)
            waits.append(owner._readback(total))
            held.append(total)
    held.append(partials)

    def fetch():
        if not waits:
            return np.zeros((wpad, 4), np.uint32)
        return np.concatenate([w()[0].numpy() for w in waits]).view(np.uint32)

    # every tensor of the step stays referenced until fetch is gone
    fetch.inputs = held
    return fetch


def sharded_window_pipeline(mesh: DeviceMesh, *, wpad: int, ovw: int,
                            min_phred: int, min_conv_eff: float,
                            use_overlaps: bool):
    """Build the multi-device window step: ``step(seq, qual, refpos, flag,
    xg, l_qseq, keep_read, ref, bounds, absolute_bounds, win_offset,
    win_start)`` -> uint32 [wpad, 4] on the host; ``step.dispatch(...)``
    starts it and returns fetch().

    Row inputs (numpy arrays or tensors) are in the adjacent-mate layout
    (mates at rows 2i/2i+1) and split over dp at even rows, so every pair is
    shard-local; a row pair is arbitrated when both flags say paired and
    mapped, as the JAX step decides it. The reference window and the bounds
    go to every device of a grid row; the counters are cut over sp."""

    def dispatch(seq, qual, refpos, flag, xg, l_qseq, keep_read, ref, bounds,
                 absolute_bounds, win_offset, win_start):
        win_offset = int(win_offset)

        def front(sh, pv, rp):
            flag = sh["flag"].to(torch.int32)
            rows = flag.shape[0]
            pair_a = torch.arange(0, rows - 1, 2, device=flag.device)
            pair_b = pair_a + 1
            pair_valid = None
            if use_overlaps:
                fa, fb = flag[pair_a], flag[pair_b]
                pair_valid = ((fa & 0x1) != 0) & ((fa & 12) == 0) \
                    & ((fb & 0x1) != 0) & ((fb & 12) == 0)
            seq, qual, strand, keep_read = programs.window_front(
                sh["seq"], sh["qual"], sh["refpos"], flag, sh["xg"],
                sh["l_qseq"], sh["keep_read"], pair_a, pair_b, pair_valid,
                rp["ref"], rp["bounds"], rp["absolute_bounds"], win_offset,
                ovw=ovw, min_phred=min_phred, min_conv_eff=min_conv_eff,
                use_overlaps=use_overlaps)
            return seq, qual, sh["refpos"], strand, keep_read, None, rp["ref"]

        rows = dict(seq=seq, qual=qual, refpos=refpos, flag=flag, xg=xg,
                    l_qseq=l_qseq, keep_read=keep_read)
        rep = dict(ref=ref, bounds=bounds, absolute_bounds=absolute_bounds)
        return _dispatch_sharded(mesh, front, rows, None, rep, win_offset,
                                 int(win_start), wpad, min_phred)

    def step(*args):
        return dispatch(*args)()

    step.dispatch = dispatch
    return step


class MeshBackend:
    """The compute backend of ``extract`` over a (dp, sp) grid.
    Signature-compatible with
    ``engine.extract.compute_window_counters_host``; ``.dispatch(...)``
    returns a handle with ``.get()``, so ``run_extract`` keeps several
    windows in flight. ``launches["sharded"]`` counts the windows that took
    the sharded step; ``host_routed`` is always 0."""

    host_routed = 0

    def __init__(self, cfg, mesh):
        self.mesh = mesh
        self.min_phred = int(cfg.minPhred)
        self.launches = {"sharded": 0}
        self._lock = threading.Lock()

    def __call__(self, cfg, batch, strand_arr, keep, ref_window, win_offset,
                 win_start, win_end, rstrand=None):
        return self.dispatch(cfg, batch, strand_arr, keep, ref_window,
                             win_offset, win_start, win_end, rstrand).get()

    def dispatch(self, cfg, batch, strand_arr, keep, ref_window, win_offset,
                 win_start, win_end, rstrand=None):
        W = win_end - win_start
        kidx = np.nonzero(keep)[0]
        if batch.n == 0 or len(kidx) == 0:
            return dev.WindowHandle(value=np.zeros((W, 4), dtype=np.uint32))
        seq, qual, refpos, st, keep_base, a_idx, b_idx = dev.dense_rows(
            batch, strand_arr, kidx, win_start, W, rstrand)
        n = len(kidx)
        # Adjacent-mate packing from the exact qname pairing: pairs at rows
        # (2i, 2i+1), singles after
        n_pairs = len(a_idx)
        paired = np.zeros(n, dtype=bool)
        paired[a_idx] = True
        paired[b_idx] = True
        perm = np.empty(n, dtype=np.int64)
        perm[0 : 2 * n_pairs : 2] = a_idx
        perm[1 : 2 * n_pairs : 2] = b_idx
        perm[2 * n_pairs :] = np.nonzero(~paired)[0]
        rows = dict(seq=seq[perm], qual=qual[perm], refpos=refpos[perm],
                    strand=st[perm],
                    keep_base=None if keep_base is None else keep_base[perm])
        pair_valid = np.zeros(n // 2, dtype=bool)
        pair_valid[:n_pairs] = True
        ovw = hp.round_up(max(2 * seq.shape[1], 1), 128)

        def front(sh, pv, rp):
            nrows = sh["seq"].shape[0]
            pair_a = torch.arange(0, nrows - 1, 2, device=sh["seq"].device)
            qual2 = programs.arbitrate_device(
                sh["seq"], sh["qual"], sh["refpos"], sh["strand"], pair_a,
                pair_a + 1, pv, ovw)
            keep_read = torch.ones(nrows, dtype=torch.bool,
                                   device=qual2.device)
            return (sh["seq"], qual2, sh["refpos"], sh["strand"], keep_read,
                    sh["keep_base"], rp["ref"])

        fetch = _dispatch_sharded(
            self.mesh, front, rows, pair_valid,
            dict(ref=np.asarray(ref_window, np.uint8)), int(win_offset),
            int(win_start), W, self.min_phred)
        with self._lock:
            self.launches["sharded"] += 1
        return dev.WindowHandle(fn=fetch)


def make_mesh_backend(cfg, n_devices=None, sp=None, device="cuda"):
    """The extract compute backend over the (dp, sp) grid — the
    multi-device replacement for the reference's `-@ N` pthread pool
    (extract.c:1479-1484) selected with MDTPU_ENGINE=mesh.

    The host has already run the read filter, the conversion-efficiency
    gate and trimming (engine.extract.prepare_window_reads); this backend
    does the rest of the hot path sharded:

    - the kept rows are packed into the adjacent-mate layout from the exact
      qname pairing (semantics.pair_mates_batch) — pairs at rows (2i, 2i+1),
      singles after — and split over dp, so every pair is shard-local;
    - per-base BED strand masks (keep_base) ride with the rows (the host
      prep is ``device.dense_rows``, shared with the dense dispatch);
    - each dp shard arbitrates its pairs and scatter-adds its 4-channel
      counters; the dp partials of a column slice are added on the slice's
      device, and the window coordinate axis is cut over sp.

    Exact shapes: no row buckets, no padded read length, no padded
    reference, nothing compiled per shape. Output is bit-identical to the
    host path.

    A grid of one cell is a degenerate sharding: with one device present
    (or ``n_devices`` 1) this returns the one-device engine,
    ``make_device_backend(cfg, device)``, which runs the tiled kernels;
    MDTPU_MESH_FORCE=1 keeps the sharded step on the (1, 1) grid, for
    measurement."""
    n_avail = n_devices if n_devices is not None else device_count(device)
    if n_avail == 1 and os.environ.get("MDTPU_MESH_FORCE") != "1":
        return dev.make_device_backend(cfg, device)
    return MeshBackend(cfg, make_mesh(n_avail, sp=sp, device=device))


def run_sharded_window(mesh, batch, ref, win_offset, win_start, wpad,
                       min_phred=5, min_conv_eff=0.0, use_overlaps=True,
                       bounds=None, absolute_bounds=None):
    """Shard a ReadBatch-style struct (adjacent-mate layout) and execute
    one multi-device window step. Returns uint32 [wpad, 4]."""
    n = batch.seq.shape[0]
    L = batch.seq.shape[1]
    ovw = ((2 * L + 127) // 128) * 128
    fn = sharded_window_pipeline(mesh, wpad=wpad, ovw=ovw, min_phred=min_phred,
                                 min_conv_eff=min_conv_eff,
                                 use_overlaps=use_overlaps)
    return fn(
        batch.seq, batch.qual, batch.refpos.astype(np.int32),
        batch.flag.astype(np.int32), batch.xg, batch.l_qseq,
        np.ones(n, dtype=bool), np.asarray(ref, np.uint8),
        np.zeros(16, np.int32) if bounds is None
        else np.asarray(bounds, np.int32),
        np.zeros(16, np.int32) if absolute_bounds is None
        else np.asarray(absolute_bounds, np.int32),
        win_offset, win_start,
    )
