#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR] [--busy] [--kernels-only] [--ptxas]
                          [--variants] [--mesh-only] [--hosts-only]

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. Device: the card's name and power limit; the three kernel sources
   (``pileup2.cu``, ``pileup4.cu``, ``arbitrate.cu``; the two pileups share
   ``staging.cuh``) are built from ``methyldackel_tpu_torch/csrc`` with
   nvcc, one process each, all started together (build times printed).
2. Each kernel against its plain PyTorch version on the card, bit-equal
   (integer counts and qual bytes, tolerance 0), at the shapes of the main
   paths: ``pileup2`` at the default extract's two group programs (4
   windows of 1 Mb at 30x-like depth) in u8, u16 and u32 plus an input built
   to overflow u8 and the staging's edge cases (arrays off 16-byte
   alignment, a tile range of several chunks, forced small chunks, 1 to 16
   lanes a column group, tiles without rows, a last tile whose tail has no
   output slot, 5,000 rows on one column); ``pileup4`` in both layouts at
   one 1 Mb window of 240k reads of 150 bp (the --minOppositeDepth and v2
   single-window programs), NCH 2 and 4, dense and compacted, all widths,
   plus an overflow input and the staging's edge cases (more than one
   chunk, a range whose first byte is not 16-byte aligned, an odd read
   length, tiles without rows, a partial last tile); ``arbitrate`` at 120k
   pairs of 150 bp (mates 0-329 apart, one pair in nine on different strand
   parities, which the host drops from the table) plus its edge cases (rows
   at odd addresses, overlaps of 1 to L bytes, every mate distance from
   -127 to L, every rule branch, no byte outside an overlap changed). Times
   are CUDA-event medians after warm-up, plain and kernel in turns, and the
   kernel's own device time from a torch.profiler trace with a cold and a
   warm L2. Beside each time stands the kernel's bound: the bytes the function must move (every input read once, every
   output written once, computed from this run's inputs) over the card's
   published 3.35 TB/s, or its integer operations over the published
   1,979 TOP/s, whichever is larger. No single PyTorch call computes any
   of the four functions (each fuses unpack, shift, strand/reference
   classification, count and narrowing), so ``library_ms`` is null.
   ``arbitrate``'s bytes are the least any implementation must move: the
   pair table, the two starts of each pair, and over each pair's overlap two
   code and two qual bytes read and the changed quals written.
   With ``--parent DIR`` (a checkout of the commit before the redesign of
   ``pileup2.cu`` and ``arbitrate.cu``: their interface with the phase byte,
   the offset groups and the pair codes, and ``pileup4.cu`` as it is now),
   that commit's three sources are built too and each kernel is timed on
   the same rows in turns with this one (parent, change, change, parent);
   the bytes they store must be equal. With ``--variants`` ``pileup2`` is
   also timed at other launch shapes than its defaults (lanes that share a
   column group, staging buffer).
   Then the device programs that are torch ops and no kernel
   (``parallel/programs.py``: ``_mbias_reduce``, ``mbias_device``,
   ``_perread_reduce``, ``perread_device``, ``arbitrate_device``,
   ``pileup_device``, ``window_pipeline``): each runs on the card and on the
   CPU device on the same seeded rows (3,000 reads of 100 bp) and must be
   equal element for element; then each is timed at one real window
   (240,000 reads of 150 bp over 1 Mb; CUDA-event median of 5 after a
   warm-up) beside the bound of its bytes (every input read once, the
   output written once).
3. The main paths end to end on a synthetic 2M-read WGBS input (written
   by a process of its own while phase 2 holds the card), through
   ``extract`` of the port (MDTPU_ENGINE=cuda, MDTPU_STEAL=0, so every
   window goes to the card): the default extract, ``--minOppositeDepth 5
   --maxVariantFrac 0.1`` (variant exclusion, the 4-channel program) and
   ``MDTPU_FUSED=v2`` (arbitration on the card). Each CpG bedGraph must be
   byte-identical to the port's exact host engine (MDTPU_ENGINE=host in
   this process; for the default path also in a process of its own), each
   path's kernels must have launched, no window may have been routed to the
   host, and the variant run must exclude positions. Port and host engine
   run in turns in this process for reads/s (the default path two a side,
   the two others cuda, host, cuda).
   With ``--busy`` each path runs once more under torch.profiler with the
   engine's stage timers on, for the device's busy share of the wall time.
   Then ``mbias`` (``--txt`` and the SVG files) and ``perRead`` (``-o``) on
   the same input, once on the card and once with the host engine
   (MDTPU_ENGINE=host) in this process, for reads/s and for the bytes:
   stdout and every file must be equal, and the backend's reduction must
   have launched. With ``--busy`` also the default extract under
   MDTPU_NO_PALLAS=1 (the dense dispatch at real windows).
3b. The product's default scheduling on the same input: ``extract`` with
   MDTPU_STEAL unset (host-lane workers beside the card lane) at -@ 1 and
   -@ 4, each byte-identical to the host engine, with the windows each lane
   took (``windows_host_steal``) and the kernel launches. Then the three
   step modes of ``methyldackel_tpu_torch.bench`` (e2e, pallas, xla) at the
   bench's sizes, each exact against the host semantics and each moving
   only its kernels' counters; their result heads as one JSON line.
4. Side routes on a small input with indel and '=' reads: single-window
   dispatch, the window-space group, CHG+CHH, the 4-channel program, v2,
   v2 with --minOppositeDepth; and a ~900x deep input whose counts overflow
   the u8 readback (u32 refetch, then u16), default and 4-channel. Each
   byte-identical to the host engine. Then the routes of the torch
   programs: ``extract --keepStrand`` with a stranded BED, ``extract`` on
   reads of 300 bp and ``extract`` under MDTPU_NO_PALLAS=1 (the dense
   dispatch; no window may go to the host engine), ``mbias`` with a BED (the
   program over raw rows) and ``perRead`` on an input with sub-phred bases
   (rows redone by the host walker); each byte-identical to the host engine
   with its device program launched.

5. The mesh engine (``parallel/mesh.py``; torch programs, no kernel of its
   own). The three gates of the JAX package's multi-chip dry run with 8
   shards as 8 streams of the one card, each three times, against the port's
   own host functions (``mesh_gates``). The sharded step at one real window
   (240,000 reads of 150 bp over 1 Mb) for (dp, sp) = (1, 1), (8, 1), (4, 2)
   and (2, 4) beside ``programs.window_pipeline`` alone, CUDA-event medians,
   every grid's counters equal to window_pipeline's. Then ``run_extract``
   with ``make_mesh_backend(cfg, n_devices=8, device="cuda")`` on the
   2M-read input and the CLI under MDTPU_ENGINE=mesh (on one card the
   one-device engine, so ``pileup2`` must launch), both byte-identical to
   the host engine, in turns with the default engine for reads/s.
6. Multi-host on the one card, every host a process of the port's CLI with
   MDTPU_ENGINE unset (the card): ``extract`` as one host, as two hosts at
   once under MDTPU_NUM_HOSTS=2 followed by ``merge-shards``, and as a live
   two-rank ``torch.distributed`` job (gloo over loopback; rank 0 merges),
   each byte-identical to the host engine, with whole-process wall times;
   ``extract --CHG --CHH``, ``perRead -o`` and ``mbias`` (two hosts, then
   MDTPU_MBIAS_FINALIZE=1) under two simulated hosts, each byte-identical
   to the one-host run on the card. Every process started here is waited
   for, or killed when another fails.

With ``--mesh-only`` (phase 5) or ``--hosts-only`` (phase 6), or both, the
other phases are left out but for the runs these compare with; the script
then exits 3 and prints no result line. Phase 5 also runs on a machine with
several cards: the grid is then filled from all of them.
The last line is ``{"ok": true, "device": {...}}``; before it come the card
line and a JSON line with each kernel's launches, error, times and bound.
Nothing here imports jax or the JAX package. Work files go to
``_chip_smoke_work/`` beside this script and are removed at the end.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_chip_smoke_work")
T = 512
REPS = 10
# published peaks of one H100 SXM at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def bound_of(nbytes, ops):
    """(bound ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the int8 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes_of(*arrays):
    return int(sum(a.numel() * a.element_size() for a in arrays
                   if a is not None))


def card_line() -> str:
    """Name and power limit as nvidia-smi gives them; several cards on one
    line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", "; ")


def cuda_ms(fn, reps=REPS):
    """Per-call device times (ms) of fn, each between two CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def turns_ms(kernel, plain, reps=REPS):
    """Median CUDA-event times (ms) of kernel() and plain(), warmed up and
    taken in turns: plain, kernel, kernel, plain."""
    import torch

    for _ in range(2):
        kernel()
        plain()
    torch.cuda.synchronize()
    p = cuda_ms(plain, reps // 2)
    k = cuda_ms(kernel, reps)
    p += cuda_ms(plain, reps - reps // 2)
    return float(np.median(k)), float(np.median(p))


def kernel_device_ms(fn, name_part, reps=REPS):
    """Device durations (ms) of the CUDA kernel whose name holds
    ``name_part`` among those ``fn()`` launches, read from a torch.profiler
    (CUPTI) trace: (median with a cold L2, median with a warm one), each
    over ``reps`` calls. Cold: a 256 MB buffer is zeroed before every call,
    as the dispatch's fresh upload would leave the 50 MB L2; warm: calls
    back to back. The kernel's own time, whatever the wrapper's host code
    and allocations cost. (None, None) when the trace holds no such
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    def trace(cold):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == DeviceType.CUDA and name_part in e.name]

    medians = []
    for cold in (True, False):
        durs = trace(cold)
        if len(durs) < reps:  # a trace can come back short: once more
            durs = max(durs, trace(cold), key=len)
        medians.append(float(np.median(durs)) if len(durs) >= 3 else None)
    if None in medians:
        medians = [None, None]
    return tuple(medians)


def timed(name, kernel_name, kernel, plain):
    """All times of one kernel: dict(ms, ms_warm, wrapper_ms, plain_ms,
    timed_by). ``wrapper_ms`` and ``plain_ms`` are CUDA-event medians
    around whole calls, in turns (they include the wrapper's host code and
    output allocation, which at these sizes can outlast the kernel);
    ``ms`` is the kernel's device time with a cold L2 and ``ms_warm`` with
    a warm one (``kernel_device_ms``). Should the profiler show no kernel,
    ``ms`` falls back to ``wrapper_ms`` and ``timed_by`` says so."""
    w_ms, p_ms = turns_ms(kernel, plain)
    cold, warm = kernel_device_ms(kernel, kernel_name)
    by = "torch.profiler kernel duration, cold L2"
    if cold is None:
        cold, warm, by = w_ms, None, "CUDA events around the wrapper"
    print(f"  {name}: kernel {cold:.4f} ms on the device with a cold L2"
          + (f", {warm:.4f} ms with a warm one" if warm is not None else "")
          + f" ({by}); wrapper call {w_ms:.4f} ms, plain version "
          f"{p_ms:.4f} ms (CUDA events, median of {REPS}, in turns; "
          f"{card_line()})", flush=True)
    return dict(ms=cold, ms_warm=warm, wrapper_ms=w_ms, plain_ms=p_ms,
                timed_by=by)


# ------------------------------------------------------- phase 2: kernel

def parent_tables(f_pos, parity, ntiles, Lc):
    """The tables of the interface before the redesign, for --parent: the
    phase byte (low 7 bits start % 128, bit 7 the parity) and the offset
    groups (group k of tile t holds the rows whose 128-aligned start is
    t*T - LP + 128*k) over rows sorted by start."""
    f_pos = np.asarray(f_pos, np.int64)
    LP = max(-(-Lc // 128) * 128, 128)
    K = (T + LP) // 128
    bounds = (np.arange(ntiles)[:, None] * T - LP
              + 128 * np.arange(K + 1)[None, :])
    flat = np.searchsorted(f_pos - f_pos % 128, bounds.reshape(-1),
                           side="left").reshape(ntiles, K + 1)
    shp = ((f_pos % 128).astype(np.uint8)
           | (np.asarray(parity, np.uint8) << 7)).astype(np.uint8)
    return dict(shp=shp, srtk=flat[:, :K].astype(np.int32).reshape(-1),
                cntk=np.diff(flat, axis=1).astype(np.int32).reshape(-1),
                K=K, LP=LP)


def group_inputs(rng, *, Kw, pitch, span, lo, n_per, Lq, ctx_slot,
                 all_cg=False):
    """Random group-program inputs: Kw windows of ``span`` columns in slots
    of ``pitch``, n_per rows each with starts in [lo, span), random 2-bit
    codes and parities, reference bitmaps of a random 42% GC genome (with
    ``all_cg``, as in candidate space, every column of a span is a C or a
    G), and the compaction map of the CpG candidates. Row and tile tables
    come from
    the dispatch's own host code; ``old`` holds the tables of the earlier
    interface for --parent."""
    from methyldackel_tpu_torch.parallel import host_prep as hp

    W_tot = Kw * pitch
    ntiles = W_tot // T
    f_pos = np.concatenate([np.sort(rng.integers(lo, span, n_per)) + k * pitch
                            for k in range(Kw)])
    n = len(f_pos)
    seqpack = rng.integers(0, 256, (n, Lq), dtype=np.uint8)
    parity = rng.integers(0, 2, n).astype(np.uint8)
    seqpack, spos, tlo, thi = hp.packed_tables(
        seqpack, f_pos.astype(np.int32), parity, ntiles)
    base = rng.choice(4, W_tot, p=[0, 0.5, 0.5, 0] if all_cg
                      else [0.29, 0.21, 0.21, 0.29])
    data = (np.arange(W_tot) % pitch) < span
    cb, gb = (base == 1) & data, (base == 2) & data
    cand = np.nonzero(hp.ctx_mask_np(cb, gb, 1, ctx_slot))[0]
    dst = np.full(W_tot, -1, np.int32)
    dst[cand] = np.arange(len(cand), dtype=np.int32)
    return dict(seqpack=seqpack, spos=spos, tlo=tlo, thi=thi,
                isc=np.packbits(cb), isg=np.packbits(gb), dst=dst,
                ncand=len(cand), ntiles=ntiles,
                old=parent_tables(f_pos, parity, ntiles, 4 * Lq))


def parent_turns(name, kernel_name, parent, change):
    """Device ms (cold L2, warm L2) of the parent commit's kernel and of
    this one, in turns in this process: parent, change, change, parent.
    Returns the parent's first pair."""
    par = [kernel_device_ms(parent, kernel_name)]
    new = [kernel_device_ms(change, kernel_name) for _ in range(2)]
    par.append(kernel_device_ms(parent, kernel_name))
    print(f"  {name}: parent commit's kernel, this one, this one, parent "
          "(ms on the device, cold L2 / warm L2): "
          + ", ".join(f"{c:.4f} / {w:.4f}" for c, w in (par[0], *new, par[1]))
          + f" ({card_line()}); stored bytes equal", flush=True)
    return par[0]


def kernel_vs_plain(name, inp, compact, parent_fn=None, variants=()):
    """Bit-equality in all three widths, then times at u8. Returns
    the times of ``timed`` plus err, bytes (every input once + the u8
    output once), ops (a compare and an add per code of every row) and,
    with ``parent_fn`` (the parent commit's ``mdtpu_pileup2``, which takes
    the ``old`` tables of the same rows and must store the same bytes),
    parent_ms. ``variants`` are further (label, kwargs) launch shapes to
    time."""
    import torch

    from methyldackel_tpu_torch.ops import pileup as pk

    dev = torch.device("cuda")
    args = [torch.from_numpy(inp[k]).to(dev)
            for k in ("seqpack", "spos", "tlo", "thi", "isc", "isg")]
    geom = dict(ntiles=inp["ntiles"])
    extra = {}
    if compact:
        extra = dict(dst=torch.from_numpy(inp["dst"]).to(dev),
                     out_width=inp["ncand"])
    err = 0
    for sat in (8, 16, 32):
        kw = dict(geom, sat_bits=sat, **(extra if sat != 32 else {}))
        got, got_ovf = pk.pileup2_tiles(*args, **kw)
        want, want_ovf = pk.pileup2_tiles_reference(*args, **kw)
        torch.cuda.synchronize()
        np_dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[sat]
        g = got.view(torch.uint8).cpu().numpy().view(np_dtype)
        w = want.view(torch.uint8).cpu().numpy().view(np_dtype)
        d = int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max()) \
            if g.size else 0
        err = max(err, d)
        print(f"  {name} u{sat}{' compacted' if kw.get('dst') is not None else ''}"
              f": out {tuple(got.shape)} max_abs_err {d} overflow "
              f"{int(got_ovf.item())}/{int(want_ovf.item())} "
              f"sum {int(g.astype(np.int64).sum())}", flush=True)
        if d != 0 or int(got_ovf.item()) != int(want_ovf.item()):
            raise AssertionError(f"{name} u{sat}: kernel != plain version")
    kw8 = dict(geom, sat_bits=8, **extra)
    print(f"  {name}: rows {len(inp['spos'])} tiles {inp['ntiles']} Lq "
          f"{inp['seqpack'].shape[1]}", flush=True)
    res = timed(name, "pileup2_",
                lambda: pk.pileup2_tiles(*args, **kw8),
                lambda: pk.pileup2_tiles_reference(*args, **kw8))
    out8, ovf8 = pk.pileup2_tiles(*args, **kw8)
    res.update(err=err, bytes=nbytes_of(*args, extra.get("dst"), out8, ovf8),
               ops=2 * inp["seqpack"].size * 4)
    for label, vkw in variants:
        vkw = dict(vkw)
        if "budget_kb" in vkw:
            vkw["chunk_rows"] = vkw.pop("budget_kb") * 1024 \
                // (inp["seqpack"].shape[1] + 4)
        got, _ = pk.pileup2_tiles(*args, **kw8, **vkw)
        torch.cuda.synchronize()
        if not torch.equal(got, out8):
            raise AssertionError(f"{name} {label}: != the default launch")
        cold, warm = kernel_device_ms(
            lambda: pk.pileup2_tiles(*args, **kw8, **vkw), "pileup2_")
        print(f"  {name} variant {label}: {cold} / {warm} ms on the "
              f"device, cold / warm L2 ({card_line()})", flush=True)
    if parent_fn is not None:
        old = inp["old"]
        o_args = [torch.from_numpy(old[k]).to(dev)
                  for k in ("shp", "srtk", "cntk")]
        o_out = torch.zeros_like(out8)
        o_ovf = torch.zeros_like(ovf8)
        stream = torch.cuda.current_stream(dev).cuda_stream
        Lq = inp["seqpack"].shape[1]
        dst = extra.get("dst")

        def parent():
            rc = parent_fn(
                args[0].data_ptr(), o_args[0].data_ptr(),
                o_args[1].data_ptr(), o_args[2].data_ptr(),
                args[4].data_ptr(), args[5].data_ptr(),
                None if dst is None else dst.data_ptr(), o_out.data_ptr(),
                o_ovf.data_ptr(), inp["ntiles"], old["K"], old["LP"], 4 * Lq,
                Lq, inp["ntiles"] * T, o_out.shape[1], 8, stream)
            if rc != 0:
                raise RuntimeError(f"parent pileup2 launch: cudaError {rc}")

        parent()
        torch.cuda.synchronize()
        if not torch.equal(o_out, out8) or int(o_ovf) != int(ovf8):
            raise AssertionError(f"{name}: parent kernel != this kernel")
        res["parent_ms"], res["parent_ms_warm"] = parent_turns(
            name, "pileup2_", parent,
            lambda: pk.pileup2_tiles(*args, **kw8))
    return res


def overflow_case(rng):
    """300 rows stacked on one column range, every code methylated: u8
    must flag, u16 and u32 must not; kernel == plain in every width."""
    import torch

    from methyldackel_tpu_torch.ops import pileup as pk
    from methyldackel_tpu_torch.parallel import host_prep as hp

    n, Lq, ntiles = 300, 38, 4
    f_pos = np.full(n, 700, np.int64)
    seqpack = np.full((n, Lq), 0x55, np.uint8)  # code 1 everywhere
    spos = hp.row_spos(f_pos, np.ones(n, np.uint8))
    tlo, thi = hp.tile_rows(f_pos, ntiles, 4 * Lq)
    isc = np.full(ntiles * T // 8, 0xFF, np.uint8)
    isg = np.zeros_like(isc)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev)
            for a in (seqpack, spos, tlo, thi, isc, isg)]
    for sat, want_flag in ((8, 1), (16, 0), (32, 0)):
        got, ovf = pk.pileup2_tiles(*args, ntiles=ntiles, sat_bits=sat)
        want, wovf = pk.pileup2_tiles_reference(*args, ntiles=ntiles,
                                                sat_bits=sat)
        torch.cuda.synchronize()
        same = np.array_equal(got.view(torch.uint8).cpu().numpy(),
                              want.view(torch.uint8).cpu().numpy())
        print(f"  overflow input u{sat}: flag {int(ovf.item())} (plain "
              f"{int(wovf.item())}), equal {same}", flush=True)
        if not same or int(ovf.item()) != want_flag \
                or int(wovf.item()) != want_flag:
            raise AssertionError(f"overflow case u{sat} failed")


def _placed(arr, shift):
    """``arr`` as a CPU tensor; with ``shift`` > 0 a view ``shift`` elements
    into a larger buffer, so that it does not start 16-byte aligned."""
    import torch

    flat = torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1)
    if not shift:
        return flat.reshape(arr.shape)
    big = torch.zeros(flat.numel() + shift + 3, dtype=flat.dtype)
    big[shift : shift + flat.numel()] = flat
    return big[shift : shift + flat.numel()].view(arr.shape)


def pileup2_edge_inputs(rng, *, Lq, ntiles=9, n=3000, deep=5000, shift=0):
    """Rows for the edge cases of ``pileup2`` (numpy, CPU): no row anywhere
    near tiles 3-4 (tiles without rows), ``deep`` rows on one start (a
    coverage spike: one column's count passes u8, and its tile range is
    longer than any default chunk), rows running past a real width that
    ends inside the last tile (its columns there have no output slot),
    starts left of column 0, and with ``shift`` > 0 seqpack and
    spos placed ``shift`` bytes / words into a larger buffer. Returns (args,
    kwargs) of ``pileup2_tiles`` on the CPU."""
    import torch

    from methyldackel_tpu_torch.parallel import host_prep as hp

    W = ntiles * T
    real_w = W - 200
    Lc = 4 * Lq
    f_pos = rng.integers(-Lc + 1, real_w + 40, n)
    f_pos = f_pos[(f_pos < 3 * T - Lc) | (f_pos >= 5 * T)]
    f_pos = np.sort(np.concatenate([f_pos, np.full(deep, 5 * T + 77)]))
    n = len(f_pos)
    seqpack = rng.integers(0, 256, (n, Lq), dtype=np.uint8)
    parity = rng.integers(0, 2, n).astype(np.uint8)
    tlo, thi = hp.tile_rows(f_pos, ntiles, Lc)
    if not (thi - tlo)[3:5].max() == 0 or (thi - tlo).max() < deep:
        raise AssertionError("edge input lost its empty or its deep tile")
    dst = np.full(W, -1, np.int32)
    cand = np.sort(rng.choice(real_w, real_w // 3, replace=False))
    dst[cand] = np.arange(len(cand), dtype=np.int32)
    args = [_placed(seqpack, shift),
            _placed(hp.row_spos(f_pos, parity), shift),
            torch.from_numpy(tlo), torch.from_numpy(thi),
            torch.from_numpy(rng.integers(0, 256, W // 8, dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, W // 8, dtype=np.uint8))]
    return args, dict(ntiles=ntiles, dst=torch.from_numpy(dst),
                      out_width=len(cand))


PILEUP2_EDGE_CASES = (
    # Lq, arrays off alignment, chunk rows, lanes a column group
    (38, 0, 8, 1), (38, 5, None, 2), (16, 3, 8, 4), (9, 5, None, 8),
    (16, 5, 100, None), (1, 3, None, 16), (38, 0, 100000, 8))


def pileup2_edge_cases(rng):
    """Kernel == plain version on the edge cases of ``pileup2_edge_inputs``
    (Lq 38 / 16 / 9 / 1 bytes a row), with staging chunks of 8 rows, 100
    rows, the default and more rows than shared memory holds (clamped), 1
    to 16 lanes a column group, arrays 3-5 bytes / words off 16-byte
    alignment;
    dense and compacted, u8 (the spike must set the overflow flag), u16
    and u32 (exact)."""
    import torch

    from methyldackel_tpu_torch.ops import pileup as pk

    for Lq, shift, chunk, split in PILEUP2_EDGE_CASES:
        args, kw = pileup2_edge_inputs(rng, Lq=Lq, shift=shift)
        d_args = [_to_cuda(a, shift if i < 2 else 0)
                  for i, a in enumerate(args)]
        compact = dict(dst=kw["dst"].cuda(), out_width=kw["out_width"])
        if shift and (d_args[0].data_ptr() % 16 == 0
                      or d_args[1].data_ptr() % 16 == 0):
            raise AssertionError("edge input is 16-byte aligned")
        for sat, want_flag in ((8, 1), (16, 0), (32, 0)):
            for extra in ({}, compact):
                k = dict(ntiles=kw["ntiles"], sat_bits=sat, **extra)
                got, govf = pk.pileup2_tiles(*d_args, chunk_rows=chunk,
                                             split=split, **k)
                want, wovf = pk.pileup2_tiles_reference(*d_args, **k)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8)) \
                        or int(govf.item()) != int(wovf.item()) \
                        or int(govf.item()) != want_flag:
                    raise AssertionError(
                        f"pileup2 edge case Lq {Lq} shift {shift} chunk "
                        f"{chunk} split {split} u{sat} "
                        f"{'compacted' if extra else 'dense'}: kernel != "
                        "plain version")
        print(f"  pileup2 edge case: Lq {Lq}, arrays {shift} off alignment, "
              f"chunk rows {chunk or 'default'}, lanes a column group "
              f"{split or 'default'}, {len(args[1])} rows with a 5,000-row "
              "spike, empty tiles, partial last tile: equal, u8 flags "
              "overflow", flush=True)


def window_inputs(rng, *, n, L, wpad, qual_mode):
    """One 1 Mb window of the single-window programs: n position-sorted
    rows of L codes (A/C/G/T/N, some 0 = gated or absent) starting anywhere
    in [-L, wpad), nibble-packed (nq) or one per byte with quals 0-41
    (qual), random parities, reference bitmaps of a random 42% GC genome,
    and the compaction map of its CpG candidates. Row and tile tables come
    from the dispatch's own host code."""
    from methyldackel_tpu_torch.parallel import host_prep as hp

    ntiles = wpad // T
    f_pos = np.sort(rng.integers(-L + 1, wpad, n))
    alphabet = np.array([1, 2, 4, 8, 15, 0], np.uint8)
    p = [0.29, 0.2, 0.2, 0.29, 0.01, 0.01]
    codes = alphabet[rng.choice(6, (n, L), p=p)]
    qual = rng.integers(0, 42, (n, L), dtype=np.uint8)
    if not qual_mode:
        codes = np.where(qual >= 5, codes, 0).astype(np.uint8)
        if L % 2:
            codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], 1)
        codes = np.ascontiguousarray(codes[:, 0::2] | (codes[:, 1::2] << 4))
    Lc = codes.shape[1] * (1 if qual_mode else 2)
    parity = rng.integers(0, 2, n).astype(np.uint8)
    tlo, thi = hp.tile_rows(f_pos, ntiles, Lc)
    base = rng.choice(4, wpad, p=[0.29, 0.21, 0.21, 0.29])
    cb, gb = base == 1, base == 2
    cand = np.nonzero(hp.ctx_mask_np(cb, gb, 1, wpad))[0]
    dst = np.full(wpad, -1, np.int32)
    dst[cand] = np.arange(len(cand), dtype=np.int32)
    return dict(codes=codes, qual=qual if qual_mode else None,
                spos=hp.row_spos(f_pos, parity), tlo=tlo, thi=thi,
                isc=np.packbits(cb), isg=np.packbits(gb), dst=dst,
                ncand=len(cand), ntiles=ntiles)


PARENT_ARGTYPES = {
    # the C interfaces of the parent commit (see --parent in the docstring)
    "pileup2": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "pileup4": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "arbitrate": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}


def parent_kernels(parent_dir):
    """The ``mdtpu_pileup2``, ``mdtpu_pileup4`` and ``mdtpu_arbitrate``
    entries of an earlier commit's sources, built in parallel with this
    checkout's build code into their own libraries. Returns {name: fn}."""
    from concurrent.futures import ThreadPoolExecutor

    from methyldackel_tpu_torch.ops import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)

    def one(name):
        src = os.path.join(parent_dir, "methyldackel_tpu_torch", "csrc",
                           f"{name}.cu")
        out = os.path.join(build.BUILD_DIR, f"lib{name}_parent.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                       check=True)
        fn = getattr(ctypes.CDLL(out), f"mdtpu_{name}")
        fn.argtypes = PARENT_ARGTYPES[name]
        fn.restype = ctypes.c_int
        return fn

    with ThreadPoolExecutor(len(PARENT_ARGTYPES)) as ex:
        return dict(zip(PARENT_ARGTYPES, ex.map(one, PARENT_ARGTYPES)))


def pileup4_vs_plain(name, inp, timed_nch, parent_fn=None):
    """Bit-equality in NCH 2 and 4, all three widths, dense and compacted;
    then times of the compacted u8 program at ``timed_nch`` (the main
    path's readback). Returns the times of ``timed`` plus err, bytes (every
    input once + the output once), ops (four channel updates per code of
    every row) and, with ``parent_fn``, parent_ms. ``parent_fn`` (the
    parent commit's ``mdtpu_pileup4``, same interface) is timed in turns
    with the kernel on the same tensors and must store the same bytes."""
    import torch

    from methyldackel_tpu_torch.ops import pileup4 as p4

    dev = torch.device("cuda")
    args = [torch.from_numpy(inp[k]).to(dev)
            for k in ("codes", "spos", "tlo", "thi", "isc", "isg")]
    mode = {}
    if inp["qual"] is not None:
        mode = dict(qual=torch.from_numpy(inp["qual"]).to(dev), min_phred=5)
    geom = dict(ntiles=inp["ntiles"], **mode)
    compact = dict(dst=torch.from_numpy(inp["dst"]).to(dev),
                   out_width=inp["ncand"])
    err = 0
    for nch in (2, 4):
        for sat in (8, 16, 32):
            for extra in ({}, compact):
                kw = dict(geom, nch=nch, sat_bits=sat, **extra)
                got, got_ovf = p4.pileup4_tiles(*args, **kw)
                want, want_ovf = p4.pileup4_tiles_reference(*args, **kw)
                torch.cuda.synchronize()
                np_dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[sat]
                g = got.view(torch.uint8).cpu().numpy().view(np_dtype)
                w = want.view(torch.uint8).cpu().numpy().view(np_dtype)
                d = int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max())
                err = max(err, d)
                if d != 0 or int(got_ovf.item()) != int(want_ovf.item()):
                    raise AssertionError(f"{name} nch{nch} u{sat}: kernel != "
                                         "plain version")
                if sat == 32 and extra:
                    print(f"  {name} nch{nch}: out {tuple(got.shape)} per "
                          f"channel sums {g.astype(np.int64).sum(axis=1)}; "
                          f"u8/u16/u32, dense and compacted: max_abs_err 0",
                          flush=True)
    kw8 = dict(geom, nch=timed_nch, sat_bits=8, **compact)
    print(f"  {name}: rows {len(inp['spos'])} tiles {inp['ntiles']} row "
          f"bytes {inp['codes'].shape[1]}, nch {timed_nch} compacted u8",
          flush=True)
    res = timed(name, "pileup4_kernel",
                lambda: p4.pileup4_tiles(*args, **kw8),
                lambda: p4.pileup4_tiles_reference(*args, **kw8))
    out8, ovf8 = p4.pileup4_tiles(*args, **kw8)
    Lc = inp["codes"].shape[1] * (1 if inp["qual"] is not None else 2)
    res.update(err=err, ops=4 * len(inp["spos"]) * Lc, bytes=nbytes_of(
        *args, mode.get("qual"), compact["dst"], out8, ovf8))
    if parent_fn is not None:
        o_out = torch.zeros_like(out8)
        o_ovf = torch.zeros_like(ovf8)
        stream = torch.cuda.current_stream(dev).cuda_stream
        qual = mode.get("qual")

        def parent():
            rc = parent_fn(
                args[0].data_ptr(),
                None if qual is None else qual.data_ptr(),
                *(a.data_ptr() for a in args[1:]), compact["dst"].data_ptr(),
                o_out.data_ptr(), o_ovf.data_ptr(), inp["ntiles"],
                len(inp["spos"]), Lc, inp["codes"].shape[1], 0,
                inp["ntiles"] * T, inp["ncand"], timed_nch, 5, 8, stream)
            if rc != 0:
                raise RuntimeError(f"parent pileup4 launch: cudaError {rc}")

        parent()
        torch.cuda.synchronize()
        if not torch.equal(o_out, out8):
            raise AssertionError(f"{name}: parent kernel != this kernel")
        res["parent_ms"], res["parent_ms_warm"] = parent_turns(
            name, "pileup4_kernel", parent,
            lambda: p4.pileup4_tiles(*args, **kw8))
    return res


def pileup4_overflow_case():
    """400 rows stacked on one span over an all-C stretch, both layouts
    (more rows than one default staging chunk in the qual layout): u8 must
    flag, u16 and u32 must not; kernel == plain in every width."""
    import torch

    from methyldackel_tpu_torch.ops import pileup4 as p4
    from methyldackel_tpu_torch.parallel import host_prep as hp

    n, L, ntiles = 400, 150, 4
    f_pos = np.full(n, 700, np.int64)
    parity = np.ones(n, np.uint8)
    parity[::3] = 0
    spos = hp.row_spos(f_pos, parity)
    tlo, thi = hp.tile_rows(f_pos, ntiles, L)
    isc = np.full(ntiles * T // 8, 0xFF, np.uint8)
    isg = np.zeros_like(isc)
    dev = torch.device("cuda")
    for qual_mode in (False, True):
        codes = np.full((n, L), 2, np.uint8) if qual_mode \
            else np.full((n, L // 2), 0x22, np.uint8)
        args = [torch.from_numpy(a).to(dev)
                for a in (codes, spos, tlo, thi, isc, isg)]
        mode = dict(qual=torch.full((n, L), 30, dtype=torch.uint8,
                                    device=dev), min_phred=5) \
            if qual_mode else {}
        for sat, want_flag in ((8, 1), (16, 0), (32, 0)):
            kw = dict(ntiles=ntiles, nch=4, sat_bits=sat, **mode)
            got, ovf = p4.pileup4_tiles(*args, **kw)
            want, wovf = p4.pileup4_tiles_reference(*args, **kw)
            torch.cuda.synchronize()
            same = np.array_equal(got.view(torch.uint8).cpu().numpy(),
                                  want.view(torch.uint8).cpu().numpy())
            print(f"  pileup4 {'qual' if qual_mode else 'nq'} overflow input "
                  f"u{sat}: flag {int(ovf.item())} (plain "
                  f"{int(wovf.item())}), equal {same}", flush=True)
            if not same or int(ovf.item()) != want_flag \
                    or int(wovf.item()) != want_flag:
                raise AssertionError(f"pileup4 overflow case u{sat} failed")


def pileup4_edge_inputs(rng, *, L, qual_mode, ntiles=8, n=3000, deep=700,
                        shift=0):
    """Rows for the staging's edge cases (numpy, CPU): an odd or even L,
    no row anywhere near tiles 3-4 (tiles without rows), ``deep`` rows on
    one start (a tile range longer than any default chunk), rows running
    past a real width that ends inside the last tile (its columns there
    have no output slot), and with ``shift`` > 0 every array placed
    ``shift`` bytes (codes, qual) or words (spos) into a larger buffer, so
    no range starts 16-byte aligned. Returns (args, kwargs) of
    ``pileup4_tiles`` on the CPU, plus the chunk-free facts to assert."""
    import torch

    from methyldackel_tpu_torch.parallel import host_prep as hp

    W = ntiles * T
    real_w = W - 200
    f_pos = rng.integers(-L + 1, real_w + 40, n)
    f_pos = f_pos[(f_pos < 3 * T - L) | (f_pos >= 5 * T)]
    f_pos = np.sort(np.concatenate([f_pos, np.full(deep, 5 * T + 77)]))
    n = len(f_pos)
    codes = np.array([0, 1, 2, 4, 8, 15, 3], np.uint8)[
        rng.integers(0, 7, (n, L))]
    qual = rng.integers(0, 42, (n, L), dtype=np.uint8)
    if not qual_mode:
        codes = np.where(qual >= 5, codes, 0).astype(np.uint8)
        if L % 2:
            codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], 1)
        codes = np.ascontiguousarray(codes[:, 0::2] | (codes[:, 1::2] << 4))
    Lc = codes.shape[1] * (1 if qual_mode else 2)
    parity = rng.integers(0, 2, n).astype(np.uint8)
    tlo, thi = hp.tile_rows(f_pos, ntiles, Lc)
    if not (thi - tlo)[3:5].max() == 0 or (thi - tlo).max() < deep:
        raise AssertionError("edge input lost its empty or its deep tile")
    dst = np.full(W, -1, np.int32)
    cand = np.sort(rng.choice(real_w, real_w // 3, replace=False))
    dst[cand] = np.arange(len(cand), dtype=np.int32)

    args = [_placed(codes, shift),
            _placed(hp.row_spos(f_pos, parity), shift),
            torch.from_numpy(tlo), torch.from_numpy(thi),
            torch.from_numpy(rng.integers(0, 256, W // 8, dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, W // 8, dtype=np.uint8))]
    kw = dict(ntiles=ntiles, dst=torch.from_numpy(dst), out_width=len(cand))
    if qual_mode:
        kw.update(qual=_placed(qual, shift), min_phred=5)
    return args, kw


def _to_cuda(t, shift):
    """A CUDA copy of ``t`` that keeps its placement ``shift`` elements
    into a larger buffer (see ``pileup4_edge_inputs``)."""
    if not shift:
        return t.cuda()
    big = t.new_zeros(t.numel() + shift + 3).cuda()
    big[shift : shift + t.numel()] = t.reshape(-1).cuda()
    return big[shift : shift + t.numel()].view(t.shape)


def pileup4_edge_cases(rng):
    """Kernel == plain version on the staging's edge cases, both layouts:
    an odd and an even read length, staging chunks of 8 rows and the
    default (the deep tile then needs several chunks too), arrays that
    start 5 bytes / 3 words off 16-byte alignment, tiles without rows, and
    a last tile whose tail has no output slot."""
    import torch

    from methyldackel_tpu_torch.ops import pileup4 as p4

    for qual_mode in (False, True):
        for L, shift, chunk in ((151, 0, 8), (151, 5, None), (150, 3, 8),
                                (36, 5, None)):
            args, kw = pileup4_edge_inputs(rng, L=L, qual_mode=qual_mode,
                                           shift=shift)
            d_args = [_to_cuda(a, shift if i < 2 else 0)
                      for i, a in enumerate(args)]
            d_kw = dict(kw, dst=kw["dst"].cuda())
            if qual_mode:
                d_kw["qual"] = _to_cuda(kw["qual"], shift)
            if shift and (d_args[0].data_ptr() % 16 == 0
                          or d_args[1].data_ptr() % 16 == 0):
                raise AssertionError("edge input is 16-byte aligned")
            for nch, sat in ((4, 16), (2, 8), (4, 32)):
                k = dict(d_kw, nch=nch, sat_bits=sat)
                got, govf = p4.pileup4_tiles(*d_args, chunk_rows=chunk, **k)
                want, wovf = p4.pileup4_tiles_reference(*d_args, **k)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8)) \
                        or int(govf.item()) != int(wovf.item()):
                    raise AssertionError(
                        f"pileup4 edge case L {L} shift {shift} chunk "
                        f"{chunk} qual {qual_mode} nch{nch} u{sat}: kernel "
                        "!= plain version")
            print(f"  pileup4 {'qual' if qual_mode else 'nq'} edge case: L "
                  f"{L}, arrays {shift} off alignment, chunk rows "
                  f"{chunk or 'default'}, {len(args[1])} rows, empty tiles, "
                  f"partial last tile: equal (sum "
                  f"{int(got.view(torch.uint8).long().sum())})", flush=True)


def arbitrate_vs_plain(rng, *, P, L, span, parent_fn=None):
    """P mate pairs over ``span`` columns, position-sorted as the v2
    program sorts them, mates 0-329 apart (block shifts 0-2 and beyond),
    one pair in nine on different strand parities, quals 0-255. Kernel and
    plain version rewrite copies of the same quals. Returns the times of
    ``timed`` plus err, bytes, ops and the bytes of the bound as it was
    computed before (``old_bytes``). bytes = the least work: the pair table,
    two starts a pair, and over each pair's overlap two code and two qual
    bytes read and the quals this input rewrites written once; ops = four
    per base of an overlap. ``parent_fn`` (the parent commit's
    ``mdtpu_arbitrate``) takes the phase bytes and the full pair table with
    its codes, built here from the same rows, and must store the same
    bytes."""
    import torch

    from methyldackel_tpu_torch.ops import arbitrate as ar
    from methyldackel_tpu_torch.parallel import host_prep as hp

    n = 2 * P
    f_pos = np.empty(n, np.int64)
    f_pos[0::2] = rng.integers(0, span, P)
    f_pos[1::2] = f_pos[0::2] + rng.integers(0, 330, P)
    order = np.argsort(f_pos, kind="stable")
    frame = np.empty(n, np.int64)
    frame[order] = np.arange(n)
    f_pos = f_pos[order]
    aligned = f_pos - f_pos % 128
    st = rng.integers(1, 3, n)
    st[1::2] = st[0::2]
    st[1::18] ^= 3
    st = st[order]
    pa, pb = hp.v2_pair_tables(aligned, st, frame[0::2], frame[1::2])
    seq = np.array([1, 2, 4, 8, 15], np.uint8)[
        rng.choice(5, (n, L), p=[0.29, 0.2, 0.2, 0.29, 0.02])]
    qual = rng.integers(0, 256, (n, L), dtype=np.uint8)
    spos = hp.row_spos(f_pos, st & 1)
    dev = torch.device("cuda")
    s_t, spos_t, pa_t, pb_t = [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (seq, spos, pa, pb)]
    q0 = torch.from_numpy(qual).to(dev)
    got, want = q0.clone(), q0.clone()
    ar.arbitrate(s_t, got, spos_t, pa_t, pb_t)
    ar.arbitrate_reference(s_t, want, spos_t, pa_t, pb_t)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    changed = int((got != q0).sum())
    d = f_pos[pb] - f_pos[pa]
    overlap = int(np.clip(np.minimum(L, L + d) - np.maximum(0, d), 0,
                          None).sum())
    print(f"  arbitrate: {P} pairs x {L}, {len(pa)} eligible, {overlap} "
          f"overlapping bases ({overlap / max(len(pa), 1):.1f} a pair), "
          f"{changed} quals rewritten, max_abs_err {err}", flush=True)
    if err != 0 or changed == 0:
        raise AssertionError("arbitrate: kernel != plain version")
    q = q0.clone()  # in place: both rewrite the same bytes each call
    res = timed(
        "arbitrate", "arbitrate_kernel",
        lambda: ar.arbitrate(s_t, q, spos_t, pa_t, pb_t),
        lambda: ar.arbitrate_reference(s_t, q, spos_t, pa_t, pb_t))
    # before: both mates' whole rows of every eligible pair, and a phase
    # byte a row and a code byte a pair instead of the starts
    old_bytes = n + 9 * P + len(pa) * 2 * L * 2 + changed
    res.update(err=err, ops=4 * overlap, old_bytes=old_bytes,
               bytes=nbytes_of(pa_t, pb_t) + 8 * len(pa) + 4 * overlap
               + changed)
    if parent_fn is not None:
        # the table before the redesign: every pair, code 3 = left alone
        fa, fb = frame[0::2], frame[1::2]
        swap = aligned[fa] > aligned[fb]
        o_pa, o_pb = np.where(swap, fb, fa), np.where(swap, fa, fb)
        sh = (aligned[o_pb] - aligned[o_pa]) // 128
        elig = (((st[o_pa] - st[o_pb]) & 1) == 0) & (sh >= 0) & (sh <= 2)
        if not (np.array_equal(o_pa[elig], pa)
                and np.array_equal(o_pb[elig], pb)):
            raise AssertionError("the two interfaces' pair tables differ")
        shp = parent_tables(f_pos, st & 1, 1, L)["shp"]
        o_t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            shp, o_pa.astype(np.int32), o_pb.astype(np.int32),
            np.where(elig, sh, 3).astype(np.uint8))]
        stream = torch.cuda.current_stream(dev).cuda_stream
        qp = q0.clone()

        def parent(qual_t=q):
            rc = parent_fn(s_t.data_ptr(), qual_t.data_ptr(),
                           *(t.data_ptr() for t in o_t), P, L, stream)
            if rc != 0:
                raise RuntimeError(f"parent arbitrate launch: cudaError {rc}")

        parent(qp)
        torch.cuda.synchronize()
        if not torch.equal(qp, got):
            raise AssertionError("arbitrate: parent kernel != this kernel")
        res["parent_ms"], res["parent_ms_warm"] = parent_turns(
            "arbitrate", "arbitrate_kernel", parent,
            lambda: ar.arbitrate(s_t, q, spos_t, pa_t, pb_t))
    return res


def arbitrate_edge_inputs(rng, *, L, shift=0):
    """Pairs for the edge cases of ``arbitrate`` (numpy, CPU): one pair for
    every mate distance d from -127 (b left of a, in one 128-block) to L (no
    overlap), so overlaps of 1, 3, 4, 5, ... L bytes at every byte alignment;
    a third of the pairs with b's bases and quals copied from a on the
    overlap (ties: b wins), N bases, code 0 (no base) in both mates, quals
    0-255, and for L >= 10 one position for every branch of the rule on the
    pair with d = 0; rows in random order; with ``shift`` > 0 seq and qual placed
    ``shift`` bytes into a larger buffer (rows of L bytes then start at odd
    addresses). Returns (seq, qual, spos, pa, pb) as CPU tensors and the
    bool mask of the qual bytes inside a pair's overlap."""
    import torch

    from methyldackel_tpu_torch.parallel import host_prep as hp

    ds = np.arange(-127, L + 1)
    P = len(ds)
    n = 2 * P + 3  # three rows in no pair
    rows = rng.permutation(n)
    ra, rb = rows[:P], rows[P : 2 * P]
    f_pos = rng.integers(0, 1000, n).astype(np.int64)
    f_pos[ra] = 1024 * np.arange(P) + np.where(ds < 0, 127, 3)
    f_pos[rb] = f_pos[ra] + ds
    seq = np.array([1, 2, 4, 8, 15, 0], np.uint8)[
        rng.choice(6, (n, L), p=[0.27, 0.2, 0.2, 0.25, 0.04, 0.04])]
    qual = rng.integers(0, 256, (n, L), dtype=np.uint8)
    i = np.arange(L)[None, :]
    in_a = (i >= ds[:, None]) & (i < L + ds[:, None])
    in_b = (i + ds[:, None] >= 0) & (i + ds[:, None] < L)
    for p in range(0, P, 3):
        ia = np.nonzero(in_a[p])[0]
        seq[rb[p], ia - ds[p]] = seq[ra[p], ia]
        qual[rb[p], ia[::2] - ds[p]] = qual[ra[p], ia[::2]]
    if L >= 10:  # (base a, qual a, base b, qual b) for every rule branch
        forced = [(2, 9, 2, 5), (2, 7, 2, 7), (4, 5, 4, 9), (1, 9, 8, 5),
                  (15, 9, 8, 5), (1, 5, 8, 9), (1, 5, 15, 9), (1, 7, 8, 7),
                  (2, 250, 2, 40), (0, 9, 2, 5)]
        p0 = int(np.nonzero(ds == 0)[0][0])
        for i, (ba, qa, bb, qb) in enumerate(forced):
            seq[ra[p0], i], qual[ra[p0], i] = ba, qa
            seq[rb[p0], i], qual[rb[p0], i] = bb, qb
    st = np.ones(n, np.int64)
    pa, pb = hp.v2_pair_tables(f_pos - f_pos % 128, st, ra, rb)
    if not (np.array_equal(pa, ra) and np.array_equal(pb, rb)):
        raise AssertionError("edge pairs lost their roles")
    inside = np.zeros((n, L), bool)
    inside[ra] = in_a
    inside[rb] = in_b
    # every branch of the rule must occur on the overlaps
    ba, qa = seq[ra][in_a].astype(int), qual[ra][in_a].astype(int)
    bb, qb = seq[rb][in_b].astype(int), qual[rb][in_b].astype(int)
    has = (ba != 0) & (bb != 0)
    branches = {
        "no base": ~has, "same, a higher": has & (ba == bb) & (qa > qb),
        "same, tie": has & (ba == bb) & (qa == qb),
        "same, b higher": has & (ba == bb) & (qa < qb),
        "differ, a higher": has & (ba != bb) & (qa > qb) & (ba != 15),
        "differ, a higher but N": has & (ba != bb) & (qa > qb) & (ba == 15),
        "differ, b higher": has & (ba != bb) & (qb > qa) & (bb != 15),
        "differ, b higher but N": has & (ba != bb) & (qb > qa) & (bb == 15),
        "differ, tie": has & (ba != bb) & (qa == qb),
        "boost past 255": has & (ba == bb) & (np.maximum(qa, qb) > 212)}
    missing = [k for k, m in branches.items() if not m.any()]
    if missing and L >= 10:
        raise AssertionError(f"edge pairs miss rule branches: {missing}")
    tensors = (_placed(seq, shift), _placed(qual, shift),
               torch.from_numpy(hp.row_spos(f_pos, st & 1)),
               torch.from_numpy(pa), torch.from_numpy(pb))
    return tensors, inside


ARBITRATE_EDGE_CASES = ((150, 1), (150, 3), (151, 0), (36, 3), (5, 1))


def arbitrate_edge_cases(rng):
    """Kernel == plain version on the pairs of ``arbitrate_edge_inputs``
    (L 150 at odd addresses, L 151 with rows at every alignment, L 36, L 5),
    and no byte outside a pair's overlap changed."""
    import torch

    from methyldackel_tpu_torch.ops import arbitrate as ar

    for L, shift in ARBITRATE_EDGE_CASES:
        (seq, qual, spos, pa, pb), inside = arbitrate_edge_inputs(
            rng, L=L, shift=shift)
        d_seq, d_q0 = _to_cuda(seq, shift), _to_cuda(qual, shift)
        rest = [t.cuda() for t in (spos, pa, pb)]
        if shift % 2 and d_q0.data_ptr() % 2 == 0:
            raise AssertionError("edge input is not at an odd address")
        got, want = d_q0.clone(), d_q0.clone()
        if shift:  # a clone is aligned again: arbitrate the placed array
            got = _to_cuda(qual, shift)
        ar.arbitrate(d_seq, got, *rest)
        ar.arbitrate_reference(d_seq, want, *rest)
        torch.cuda.synchronize()
        outside = ~torch.from_numpy(inside).cuda()
        if not torch.equal(got, want):
            raise AssertionError(f"arbitrate edge case L {L} shift {shift}: "
                                 "kernel != plain version")
        if not torch.equal(got[outside], d_q0[outside]):
            raise AssertionError(f"arbitrate edge case L {L} shift {shift}: "
                                 "a byte outside every overlap changed")
        print(f"  arbitrate edge case: L {L}, arrays {shift} off alignment, "
              f"{len(pa)} pairs with d from -127 to {L}, every rule branch: "
              f"equal, {int((got != d_q0).sum())} quals rewritten, none "
              "outside an overlap", flush=True)


# ------------------------------------------- phase 2: the torch programs

def program_cases(rng, n, L):
    """Seeded inputs of every device program of ``parallel/programs.py`` as
    CPU tensors: ``n`` reads of ``L`` bp (mate pairs on adjacent rows, mates
    0 to L-1 apart, one pair in nine on different strand parities, one row
    in fifty with a 3 bp deletion, bisulfite-converted bases of a random
    reference, quals 2-41) over a window of 1 Mb at the real depth (240,000
    reads), narrower for fewer. Returns [(name, fn, args, ops)]; ``ops`` is
    the count of compares and adds the program does as it is written."""
    import functools

    import torch

    from methyldackel_tpu_torch.parallel import programs as prog

    W = max(512, -(-n * 1_000_448 // 240_000 // 512) * 512)
    P = n // 2
    n = 2 * P
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), W + 2 * L + 8,
                     p=[0.29, 0.21, 0.21, 0.29])
    start = np.empty(n, np.int64)
    start[0::2] = rng.integers(0, W - L, P)
    start[1::2] = start[0::2] + rng.integers(0, L, P)
    refpos = (start[:, None] + np.arange(L)[None, :]).astype(np.int32)
    gap = rng.random(n) < 0.02
    refpos[gap, L // 2:] += 3
    ob = np.repeat(rng.random(P) < 0.5, 2)
    code_of = np.zeros(256, np.uint8)
    code_of[[65, 67, 71, 84]] = [1, 2, 4, 8]
    seq = code_of[ref[np.minimum(refpos, len(ref) - 1)]]
    conv = rng.random((n, L)) < 0.7
    seq[(seq == 2) & conv & ~ob[:, None]] = 8  # OT: C read as T
    seq[(seq == 4) & conv & ob[:, None]] = 1   # OB: G read as A
    qual = rng.integers(2, 42, (n, L), dtype=np.uint8)
    flag = np.where(ob, np.tile([0x53, 0xA3], P),
                    np.tile([0x63, 0x93], P)).astype(np.int32)
    strand = np.where(ob, 2, 1).astype(np.int32)
    odd_pair = np.repeat(rng.random(P) < 1 / 9, 2)
    odd_pair[0::2] = False
    strand[odd_pair] = 3 - strand[odd_pair]
    flag[odd_pair] ^= 0x10
    bounds = np.array([2, L - 5, 3, L - 4] * 4, np.int32)
    abounds = np.array([1, 2, 0, 1] * 4, np.int32)
    Lq = (L + 3) // 4
    t = torch.from_numpy
    seq, qual, refpos, flag, strand = map(t, (seq, qual, refpos, flag, strand))
    ref = t(ref)
    pa = torch.arange(0, n, 2)
    pb = pa + 1
    keep_read = t(rng.random(n) < 0.97)
    keep_base = t(rng.random((n, L)) < 0.9)
    codes = t(rng.integers(0, 256, (n, Lq), dtype=np.uint8))
    combo = t(rng.integers(0, 8, n).astype(np.uint8))
    pos = t(start.astype(np.int32))
    lq = torch.full((n,), L, dtype=torch.int32)
    xg = torch.zeros(n, dtype=torch.int8)
    mapq = torch.full((n,), 40, dtype=torch.uint8)
    ovw = -(-2 * L // 128) * 128
    return [
        ("_mbias_reduce", prog._mbias_reduce, (codes, combo), 12 * n * Lq),
        ("mbias_device", functools.partial(
            prog.mbias_device, keep_ctx=(1, 1, 1), min_phred=5),
         (seq, qual, refpos, strand, flag, keep_base, ref, 0, 0, W),
         30 * n * L),
        ("_perread_reduce", prog._perread_reduce, (codes,), 12 * n * Lq),
        ("perread_device", functools.partial(prog.perread_device,
                                             min_phred=5),
         (seq, qual, pos, lq, strand, ref, 0, len(ref)), 30 * n * L),
        ("arbitrate_device", prog.arbitrate_device,
         (seq, qual, refpos, strand, pa, pb, None, ovw), 16 * P * ovw),
        ("pileup_device", prog.pileup_device,
         (seq, qual, refpos, strand, keep_read, None, ref, 0, 0, W, 5),
         20 * n * L),
        ("window_pipeline", functools.partial(
            prog.window_pipeline, wpad=W, ovw=ovw, min_phred=5,
            min_conv_eff=0.3, use_overlaps=True),
         (seq, qual, refpos, flag, xg, lq, mapq, keep_read, keep_base, pa,
          pb, None, ref, t(bounds), t(abounds), 0, 0),
         50 * n * L + 16 * P * ovw),
    ]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def programs_card_vs_cpu(rng, n=3000, L=100):
    """Every program on the card and on the CPU device on the same rows:
    equal element for element (integers; the one float, the conversion
    efficiency inside window_pipeline, only gates reads)."""
    import torch

    for name, fn, args, _ops in program_cases(rng, n, L):
        cpu = _as_tuple(fn(*args))
        gpu = _as_tuple(fn(*[a.cuda() if isinstance(a, torch.Tensor) else a
                             for a in args]))
        torch.cuda.synchronize()
        for c, g in zip(cpu, gpu):
            if c.dtype != g.dtype or not torch.equal(c, g.cpu()):
                raise AssertionError(f"{name}: card != CPU device")
        total = sum(int(c.to(torch.int64).sum()) for c in cpu)
        if total <= 0:
            raise AssertionError(f"{name}: the input exercises nothing")
        print(f"  {name}: card == CPU device on {n} reads of {L} bp "
              f"({', '.join(str(tuple(c.shape)) for c in cpu)} "
              f"{cpu[0].dtype}, sum {total})", flush=True)


def programs_timed(rng, n=240_000, L=150):
    """CUDA-event time of every program at one real window, beside the
    bound of its bytes and operations. Returns {name: dict(ms, bound_ms,
    bound_by, bytes, peak_mb)}."""
    import torch

    out = {}
    card = card_line()
    for name, fn, args, ops in program_cases(rng, n, L):
        d_args = [a.cuda() if isinstance(a, torch.Tensor) else a
                  for a in args]
        res = _as_tuple(fn(*d_args))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms = float(np.median(cuda_ms(lambda: fn(*d_args), 5)))
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        nbytes = nbytes_of(*[a for a in d_args
                             if isinstance(a, torch.Tensor)], *res)
        b_ms, b_by = bound_of(nbytes, ops)
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         peak_mb=peak)
        print(f"  {name}: {ms:.3f} ms at {n} reads of {L} bp (CUDA events, "
              f"median of 5; torch ops, no kernel of ours) against a bound "
              f"of {b_ms * 1e3:.1f} us ({b_by}: {nbytes} bytes, {ops} "
              f"operations), share of bound {b_ms / ms:.4f}; peak device "
              f"memory above its inputs {peak:.0f} MB ({card})", flush=True)
        del d_args, res
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------- phases 3-4: the CLI

def run_port(args, cwd, env, cmd="extract"):
    """The port's ``cmd`` (extract, mbias or perRead) in this process;
    returns (seconds, backend). What mbias and perRead print goes to
    ``stdout.txt`` in ``cwd``."""
    import contextlib

    from methyldackel_tpu_torch import cli
    from methyldackel_tpu_torch.engine.mbias import mbias
    from methyldackel_tpu_torch.engine.perread import perread

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        t0 = time.perf_counter()
        if cmd == "extract":
            rc, backend = cli.extract(args)
        else:
            with open("stdout.txt", "w") as fh, \
                    contextlib.redirect_stdout(fh):
                rc, backend = {"mbias": mbias, "perRead": perread}[cmd](args)
        dt = time.perf_counter() - t0
    finally:
        os.chdir(here)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise RuntimeError(f"port {cmd} {args} returned {rc}")
    return dt, backend


def busy_share(name, args, cwd, env, cmd="extract"):
    """One more run of the port's ``cmd`` under torch.profiler (device
    activities only) with the engine's stage timers on: prints the device's
    busy time (the union of its kernel and copy intervals) beside the wall
    time, the largest device items by name, and the stage sums (the
    ``[mdtpu stats]`` block on stderr). Profiled runs are slower than plain
    ones, so this run gives no reads/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from methyldackel_tpu_torch.utils import profiling

    profiling.STATS.__init__()
    profiling.STATS.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall, _ = run_port(args, cwd, env, cmd)
    finally:
        profiling.STATS.enabled = False
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot = by_name.setdefault(e.name[:60], [0.0, 0])
        tot[0] += e.time_range.elapsed_us() / 1e3
        tot[1] += 1
    spans.sort()
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"[3] {name}: device busy {busy_us / 1e3:.3f} ms of a {wall:.3f} s "
          f"profiled run = {busy_us / 1e4 / wall:.4f}% ({len(spans)} device "
          "items; largest: "
          + "; ".join(f"{nm} {ms:.3f} ms ({cnt})" for nm, (ms, cnt) in top)
          + f") ({card_line()})", flush=True)


def run_host(args, cwd, cmd="extract"):
    """The port's exact host engine (MDTPU_ENGINE=host), in its own
    process. What mbias and perRead print goes to ``stdout.txt`` in
    ``cwd``."""
    env = dict(os.environ, MDTPU_ENGINE="host",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "methyldackel_tpu_torch.cli",
                          cmd, *args], cwd=cwd, env=env,
                         capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"host {cmd} failed: {res.stderr[-2000:]}")
    if cmd != "extract":
        with open(os.path.join(cwd, "stdout.txt"), "w") as fh:
            fh.write(res.stdout)
    return dt


def same_dirs(a_dir, b_dir):
    """Both directories hold the same files with the same bytes, and their
    output is not empty. Returns the names."""
    names = sorted(os.listdir(a_dir))
    if names != sorted(os.listdir(b_dir)):
        raise AssertionError(f"{a_dir} and {b_dir} hold different files")
    size = 0
    for nm in names:
        a = open(os.path.join(a_dir, nm), "rb").read()
        if a != open(os.path.join(b_dir, nm), "rb").read():
            raise AssertionError(f"{nm} differs between {a_dir} and {b_dir}")
        size += len(a)
    if size < 1000:
        raise AssertionError(f"{a_dir} holds no output")
    return names


def same_outputs(a_dir, b_dir, names):
    for nm in names:
        a = open(os.path.join(a_dir, nm), "rb").read()
        b = open(os.path.join(b_dir, nm), "rb").read()
        if a != b:
            raise AssertionError(f"{nm} differs between {a_dir} and {b_dir}")
        if a.count(b"\n") < 2:
            raise AssertionError(f"{nm} holds no calls")


def side_input(dirpath, seed=7):
    """A small paired-end WGBS BAM over a random genome with indel reads
    (CIGAR D/I), '=' bases and both strands, for the side routes."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util_bam import write_bam

    rng = np.random.default_rng(seed)
    glen, L = 30000, 100
    ref = rng.choice(list("ACGT"), glen, p=[0.29, 0.21, 0.21, 0.29])
    with open(os.path.join(dirpath, "g.fa"), "w") as fh:
        fh.write(">chrS\n" + "".join(ref) + "\n")
    recs = []
    for i in range(900):
        p1 = int(rng.integers(0, glen - 3 * L))
        p2 = p1 + int(rng.integers(0, L))
        ot = bool(rng.random() < 0.5)
        for mate, p in ((0, p1), (1, p2)):
            kind = rng.random()
            if kind < 0.1:
                cigar, seg = "50M3D50M", np.concatenate(
                    [ref[p : p + 50], ref[p + 53 : p + 103]])
            elif kind < 0.2:
                cigar, seg = "40M2I58M", np.concatenate(
                    [ref[p : p + 40], np.array(["A", "T"]),
                     ref[p + 40 : p + 98]])
            else:
                cigar, seg = f"{L}M", ref[p : p + L].copy()
            seg = seg.copy()
            conv = rng.random(len(seg)) < 0.7
            if ot:
                seg[(seg == "C") & conv] = "T"
            else:
                seg[(seg == "G") & conv] = "A"
            if kind > 0.97:
                seg[5:9] = "="
            if ot:
                flag = 0x63 if mate == 0 else 0x93
            else:
                flag = 0x53 if mate == 0 else 0xA3
            recs.append(dict(qname=f"p{i}", flag=flag, tid=0, pos=p,
                             cigar=cigar, seq="".join(seg),
                             qual=[int(q) for q in rng.integers(2, 42, len(seg))],
                             mtid=0, mpos=p2 if mate == 0 else p1))
    recs.sort(key=lambda r: r["pos"])
    write_bam(os.path.join(dirpath, "r.bam"), [("chrS", glen)], recs)


def default_scheduling(fa, bam, host_dir, reset_counts, read_counts):
    """Phase 3b, first half: the default ``extract`` as a user runs it,
    MDTPU_STEAL unset (``min(-@, cores - 1)`` host-lane workers beside the
    card lane), at -@ 1 and -@ 4, each byte-identical to the host engine's
    output in ``host_dir``; prints how the windows split between the lanes
    and the kernel launches."""
    from methyldackel_tpu_torch.utils import profiling

    card = card_line()
    saved = os.environ.pop("MDTPU_STEAL", None)
    try:
        for threads in (1, 4):
            d = os.path.join(WORK, f"default_at{threads}")
            os.makedirs(d)
            args = ([] if threads == 1 else ["-@", str(threads)]) \
                + [fa, bam, "-o", "out"]
            stats = profiling.STATS
            stats.__init__()
            stats.enabled = True
            reset_counts()
            try:
                dt, backend = run_port(args, d, {"MDTPU_ENGINE": "cuda"})
            finally:
                stats.enabled = False
            counts = read_counts()
            same_outputs(d, host_dir, ["out_CpG.bedGraph"])
            windows = stats.n["windows"]
            steal = stats.n["windows_host_steal"]
            print(f"[3b] default extract with MDTPU_STEAL unset, -@ "
                  f"{threads}, 2,000,000 reads: {2e6 / dt:,.0f} reads/s "
                  f"({dt:.2f} s); {windows} windows, windows_host_steal "
                  f"{steal}, card lane {windows - steal}; kernel launches "
                  f"{counts}; out_CpG.bedGraph byte-identical to the host "
                  f"engine's ({card})", flush=True)
            if backend.host_routed != 0 or steal <= 0 \
                    or (windows - steal > 0) != (counts["pileup2"] > 0):
                raise AssertionError(f"-@ {threads}: the lanes do not add "
                                     "up")
    finally:
        if saved is not None:
            os.environ["MDTPU_STEAL"] = saved


def bench_steps():
    """Phase 3b, second half: the three step modes of
    ``methyldackel_tpu_torch.bench`` on the card at the bench's sizes (50,000
    pairs of 150 bp over a 1 Mb window, 10 iterations), each checked
    against the host semantics by the bench, each moving exactly its
    kernels' launch counters. Prints the three result heads as one JSON
    line."""
    from methyldackel_tpu_torch import bench

    card = card_line()
    kernels = {"e2e": ("pileup2", "pileup4_nq"),
               "pallas": ("arbitrate", "pileup4_qual"), "xla": ()}
    heads = []
    for mode, names in kernels.items():
        ref_ascii, batch, extra = bench.step_batches(mode, 50_000, 150)
        before = bench.launch_counts()
        t0 = time.perf_counter()
        head = bench.step_bench(mode, batch, ref_ascii, bench.W_BENCH, 10,
                                device="cuda", extra=extra)
        moved = {k: v - before[k] for k, v in bench.launch_counts().items()}
        print(f"[3b] bench step {mode}: {head['value']:,.1f} reads/s, "
              f"{head['vs_baseline']}x the host window step "
              f"({head['host_window_reads_per_s']:,.1f}); exact against the "
              f"host semantics; kernel launches {moved}; "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        if any((moved[k] > 0) != (k in names) for k in moved):
            raise AssertionError(f"bench step {mode} launched {moved}")
        heads.append(head)
        del batch, extra
    print(json.dumps({"bench_steps": heads}), flush=True)


def build_all(build, sources):
    """nvcc for every kernel source at once, one process each; then load
    them. Returns {source: seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    def one(src):
        t0 = time.perf_counter()
        build.build(src)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as ex:
        secs = list(ex.map(one, sources))
    for src in sources:
        build.load(src)
    return dict(zip(sources, secs))


# ------------------------------------- phases 5-6: the mesh and multi-host

def start_input_writer():
    """A process that writes the 2M-read input and its index into WORK
    while phase 2 holds the card. At exit it is killed if it still runs,
    and WORK is removed."""
    import atexit

    code = ("import sys\n"
            "from methyldackel_tpu_torch.io.bai import build_bai\n"
            "from methyldackel_tpu_torch.io.bam import BamFile\n"
            "from methyldackel_tpu_torch.utils.simulate import "
            "write_synthetic_input\n"
            "fa, bam = write_synthetic_input(sys.argv[1], 1_000_000, 150, "
            "1 << 23, seed=0)\n"
            "build_bai(BamFile(bam), bam + '.bai')\n")
    proc = subprocess.Popen([sys.executable, "-c", code, WORK], cwd=ROOT,
                            stdout=subprocess.DEVNULL)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(WORK, ignore_errors=True)

    atexit.register(stop)
    return proc


def mesh_gates(device, n=8, rounds=3):
    """The three gates of the JAX package's multi-chip dry run, with ``n``
    shards on ``device`` ("cuda": ``n`` streams of the cards present; "cpu"
    for the CPU tests), each against the port's own host functions and each
    ``rounds`` times over (a missing dependency between two streams gives
    wrong counts sometimes, not always):

    1. ``run_sharded_window`` on 4*n pairs of 32 bp against
       ``semantics.pileup_channels`` after ``arbitrate_overlaps``. The
       conversion-efficiency gate stays off (min_conv_eff 0), as in the JAX
       gate: it is float32 and may differ from numpy by one ulp at the
       threshold;
    2. ``make_mesh_backend`` on shuffled rows (the pairing comes from the
       qnames) with a single, a dropped read and a BED strand column against
       ``compute_window_counters_host``;
    3. 10,000 pairs of 150 bp over a 128k window with minOppositeDepth 3,
       absolute trimming, 50 dropped reads and a BED strand column, for sp
       in 1, 2, 4: all equal to the host and to each other.

    Returns the counter sums of the three gates."""
    import copy

    from methyldackel_tpu_torch.config import Config
    from methyldackel_tpu_torch.engine.extract import \
        compute_window_counters_host
    from methyldackel_tpu_torch.ops import semantics as sem
    from methyldackel_tpu_torch.parallel import mesh as pm
    from methyldackel_tpu_torch.utils.simulate import (
        random_reference, simulate_batch, simulate_batch_fast)

    def same(name, want, got):
        if got.dtype != np.uint32 or got.shape != want.shape \
                or not np.array_equal(want, got):
            bad = np.nonzero((want != got).any(axis=1))[0] \
                if got.shape == want.shape else got.shape
            raise AssertionError(f"mesh gate {name}: counters diverge from "
                                 f"the host at {bad[:10]}")

    saved = os.environ.get("MDTPU_MESH_FORCE")
    os.environ["MDTPU_MESH_FORCE"] = "1"  # n = 1 keeps the sharded step
    try:
        rng = np.random.default_rng(1)
        ref, codes = random_reference(rng, 512)
        batch = simulate_batch(rng, codes, n_pairs=4 * n, read_len=32)
        st = sem.strand(batch.flag, batch.xg)
        seq, qual = batch.seq.copy(), batch.qual.copy()
        a, b = sem.pair_mates(batch.qname, batch.flag)
        sem.arbitrate_overlaps(seq, qual, batch.refpos, st, a, b)
        host1 = sem.pileup_channels(seq, qual, batch.refpos, st,
                                    np.ones(seq.shape, bool), ref, 0, 0, 512,
                                    5)
        mesh = pm.make_mesh(n, device=device)
        for _ in range(rounds):
            same("1 (run_sharded_window)", host1, pm.run_sharded_window(
                mesh, batch, ref, 0, 0, 512, min_phred=5, min_conv_eff=0.0,
                use_overlaps=True))

        rng = np.random.default_rng(5)
        ref2, codes2 = random_reference(rng, 1024)
        batch2 = simulate_batch(rng, codes2, n_pairs=3 * n, read_len=40)
        order = rng.permutation(batch2.n)
        for f in ("flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
                  "mpos", "xg", "nh", "seq", "qual", "refpos"):
            setattr(batch2, f, getattr(batch2, f)[order])
        batch2.qname = [batch2.qname[i] for i in order]
        batch2.flag = batch2.flag.copy()
        batch2.flag[1] |= 0x8  # mate unmapped: an unpaired row
        st2 = sem.strand(batch2.flag, batch2.xg)
        keep2 = np.ones(batch2.n, dtype=bool)
        keep2[2] = False
        cfg = Config()
        cfg.chunkSize = 512
        rstrand = rng.integers(0, 3, 512).astype(np.int8)
        host2 = compute_window_counters_host(
            cfg, copy.deepcopy(batch2), st2, keep2, ref2, 0, 0, 512, rstrand)
        engine = pm.make_mesh_backend(cfg, n, device=device)
        for _ in range(rounds):
            same("2 (make_mesh_backend)", host2, engine(
                cfg, copy.deepcopy(batch2), st2, keep2, ref2, 0, 0, 512,
                rstrand))

        rng = np.random.default_rng(11)
        W3 = 131072
        ref3, codes3 = random_reference(rng, W3 + 64)
        batch3 = simulate_batch_fast(rng, codes3, 10_000, 150)
        cfg3 = Config()
        cfg3.chunkSize = W3
        cfg3.minOppositeDepth = 3
        cfg3.maxVariantFrac = 0.25
        for s4 in range(4):
            cfg3.absoluteBounds[4 * s4 : 4 * s4 + 4] = [5, 140, 3, 145]
        st3 = sem.strand(batch3.flag, batch3.xg)
        sem.trim_absolute(batch3.seq, batch3.qual, batch3.l_qseq, st3,
                          batch3.flag, cfg3.absoluteBounds)
        keep3 = np.ones(batch3.n, dtype=bool)
        keep3[rng.integers(0, batch3.n, 50)] = False
        rstrand3 = rng.integers(0, 3, W3).astype(np.int8)
        host3 = compute_window_counters_host(
            cfg3, copy.deepcopy(batch3), st3, keep3, ref3, 0, 0, W3, rstrand3)
        if not (host3.sum(0) > 0).all():
            raise AssertionError("mesh gate 3: a channel is empty")
        for sp in (1, 2, 4):
            if n % sp:
                continue
            engine = pm.make_mesh_backend(cfg3, n, sp=sp, device=device)
            for _ in range(rounds):
                same(f"3 (sp {sp})", host3, engine(
                    cfg3, copy.deepcopy(batch3), st3, keep3, ref3, 0, 0, W3,
                    rstrand3))
    finally:
        if saved is None:
            os.environ.pop("MDTPU_MESH_FORCE", None)
        else:
            os.environ["MDTPU_MESH_FORCE"] = saved
    return [int(h.sum()) for h in (host1, host2, host3)]


def mesh_step_timed(rng, grids=((1, 1), (8, 1), (4, 2), (2, 4)), n=240_000,
                    L=150, reps=5):
    """The sharded step at one real window (the rows of ``program_cases``,
    resident on the card) for each (dp, sp) grid, beside
    ``programs.window_pipeline`` alone on the same rows. CUDA events on the
    caller's stream, which every lane's stream waits for at the start and
    which waits for every lane at the end; the step's time includes its
    readback into pinned memory, window_pipeline's does not. Every grid's
    counters must equal window_pipeline's. Returns {(dp, sp) or
    "window_pipeline": ms}."""
    import torch

    from methyldackel_tpu_torch.parallel import mesh as pm
    from methyldackel_tpu_torch.parallel import programs as prog

    case = [c for c in program_cases(rng, n, L)
            if c[0] == "window_pipeline"][0]
    (seq, qual, refpos, flag, xg, lq, mapq, keep_read, _kb, pa, pb, _pv, ref,
     bounds, abounds, woff, wstart) = [
        a.cuda() if isinstance(a, torch.Tensor) else a for a in case[2]]
    kw = case[1].keywords
    W = kw["wpad"]

    def whole():
        return prog.window_pipeline(
            seq, qual, refpos, flag, xg, lq, mapq, keep_read, None, pa, pb,
            None, ref, bounds, abounds, woff, wstart, **kw)

    want = whole().cpu().numpy().view(np.uint32)
    torch.cuda.synchronize()
    out = {"window_pipeline": float(np.median(cuda_ms(whole, reps)))}
    card = card_line()
    print(f"  window_pipeline alone: {out['window_pipeline']:.3f} ms at {n} "
          f"reads of {L} bp over {W} columns (CUDA events, median of {reps}; "
          f"{card})", flush=True)
    cur = torch.cuda.current_stream()
    for dp, sp in grids:
        mesh = pm.make_mesh(dp * sp, sp=sp, device="cuda")
        step = pm.sharded_window_pipeline(
            mesh, wpad=W, ovw=kw["ovw"], min_phred=kw["min_phred"],
            min_conv_eff=kw["min_conv_eff"], use_overlaps=True)
        fetches = []
        enqueue = []

        def once():
            t0 = time.perf_counter()
            fetches.append(step.dispatch(
                seq, qual, refpos, flag, xg, lq, keep_read, ref, bounds,
                abounds, woff, wstart))
            enqueue.append((time.perf_counter() - t0) * 1e3)
            for row in mesh.lanes:
                for lane in row:
                    cur.wait_stream(lane.stream)

        once()
        got = fetches.pop()()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"sharded step ({dp}, {sp}) != "
                                 "window_pipeline")
        ms = float(np.median(cuda_ms(once, reps)))
        for f in fetches:
            if not np.array_equal(f(), want):
                raise AssertionError(f"sharded step ({dp}, {sp}): a timed "
                                     "call != window_pipeline")
        out[(dp, sp)] = ms
        print(f"  sharded step (dp, sp) = ({dp}, {sp}): {ms:.3f} ms, "
              f"{ms / out['window_pipeline']:.2f}x window_pipeline alone; "
              f"the host took {float(np.median(enqueue[1:])):.3f} ms to "
              f"enqueue it; counters equal, sum {int(want.sum())} (CUDA "
              f"events, median of {reps}, readback included; {card})",
              flush=True)
        del mesh, step, fetches
        torch.cuda.empty_cache()
    return out


def run_extract_with(make_backend, fa, bam, cwd, env):
    """``engine.extract.run_extract`` on (fa, bam) with the backend
    ``make_backend(cfg)`` builds, writing ``out_CpG.bedGraph`` in ``cwd`` as
    the CLI would with ``-o out``. Returns (seconds, backend)."""
    from methyldackel_tpu_torch.config import Config
    from methyldackel_tpu_torch.engine import formats
    from methyldackel_tpu_torch.engine.extract import run_extract

    cfg = Config()
    cfg.FastaName, cfg.BAMName = fa, bam
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        backend = make_backend(cfg)
        path = os.path.join(cwd, formats.output_name(cfg, "out", "CpG"))
        t0 = time.perf_counter()
        with open(path, "w") as fh:
            fh.write(formats.header_line(cfg, "CpG", "out"))
            run_extract(cfg, [fh, None, None], compute_backend=backend)
        dt = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dt, backend


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_processes(cmd, args, cwd, envs, stdout_of=None):
    """One process of the port's CLI for each environment in ``envs``, all
    started together in ``cwd`` (MDTPU_ENGINE unset: the card). Waits for
    all, stops whatever is left when one fails, and returns the seconds from
    the first start to the last exit. ``stdout_of`` names the process whose
    stdout goes to ``stdout.txt``."""
    base = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                + os.environ.get("PYTHONPATH", ""))
    for k in ("MDTPU_ENGINE", "MDTPU_NUM_HOSTS", "MDTPU_HOST_ID",
              "MDTPU_MBIAS_FINALIZE", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE"):
        base.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "methyldackel_tpu_torch.cli", cmd, *args],
        cwd=cwd, env=dict(base, **env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for env in envs]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t0
    for k, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{cmd} process {k} of {len(envs)} failed: "
                               f"{err[-2000:]}")
        if k == stdout_of:
            with open(os.path.join(cwd, "stdout.txt"), "w") as fh:
                fh.write(out)
        elif stdout_of is not None and out:
            raise AssertionError(f"{cmd} process {k} printed a result")
    return dt


def merge_shards_cli(cwd, paths):
    """``python -m methyldackel_tpu_torch.parallel.distributed merge-shards``
    after every host has exited; no shard may be left. Returns seconds."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu_torch.parallel.distributed",
         "merge-shards", *paths], cwd=cwd, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    if res.returncode != 0 or res.stdout.count("merged ") != len(paths):
        raise RuntimeError(f"merge-shards failed: {res.stdout} {res.stderr}")
    left = [nm for nm in os.listdir(cwd) if ".w" in nm or nm.endswith(".npy")]
    if left:
        raise AssertionError(f"shards left after the merge: {left[:5]}")
    return time.perf_counter() - t0


def sim_hosts(n):
    return [{"MDTPU_NUM_HOSTS": str(n), "MDTPU_HOST_ID": str(h)}
            for h in range(n)]


def live_ranks(n):
    port = str(_free_port())
    return [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
             "RANK": str(r), "WORLD_SIZE": str(n)} for r in range(n)]


def mesh_phase(fa, bam, host_dir, reset_counts, read_counts):
    """Phase 5 on the 2M-read input. ``host_dir`` holds the host engine's
    ``out_CpG.bedGraph`` (``-o out``). Returns the kernel launch counts of
    the CLI run under MDTPU_ENGINE=mesh."""
    import torch

    from methyldackel_tpu_torch.parallel import mesh as pm

    card = card_line()
    t0 = time.perf_counter()
    sums = mesh_gates("cuda", n=8, rounds=3)
    print(f"[5] mesh gates on the card, 8 shards as 8 streams of "
          f"{torch.cuda.device_count()} card(s), 3 rounds each: "
          f"run_sharded_window == semantics.pileup_channels (sum {sums[0]}, "
          f"conversion-efficiency gate off, as in the JAX gate); "
          f"make_mesh_backend on shuffled rows with a single, a dropped "
          f"read and a BED strand column == compute_window_counters_host "
          f"(sum {sums[1]}); 10,000 pairs over 128k, minOppositeDepth 3, "
          f"absolute trimming, sp 1, 2, 4 all == the host (sum {sums[2]}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("[5] the sharded step at one real window", flush=True)
    mesh_step_timed(np.random.default_rng(0))

    d_one = os.path.join(WORK, "mesh_one")
    d_mesh = os.path.join(WORK, "mesh_8")
    d_cli = os.path.join(WORK, "mesh_cli")
    for d in (d_one, d_mesh, d_cli):
        os.makedirs(d)
    args = [fa, bam, "-o", "out"]
    steal0 = {"MDTPU_STEAL": "0"}
    # one call, in turns: default engine, 8-cell mesh, CLI mesh, default
    t_one = [run_port(args, d_one, {"MDTPU_ENGINE": "cuda", **steal0})[0]]
    t_mesh, be = run_extract_with(
        lambda cfg: pm.make_mesh_backend(cfg, n_devices=8, device="cuda"),
        fa, bam, d_mesh, steal0)
    if type(be) is not pm.MeshBackend or be.launches["sharded"] < 8 \
            or be.host_routed != 0:
        raise AssertionError("the 8-cell mesh run missed the sharded step")
    same_outputs(d_mesh, host_dir, ["out_CpG.bedGraph"])
    reset_counts()
    t_cli, be_cli = run_port(args, d_cli, {"MDTPU_ENGINE": "mesh", **steal0})
    counts = read_counts()
    t_one.append(run_port(args, d_one, {"MDTPU_ENGINE": "cuda", **steal0})[0])
    same_outputs(d_cli, host_dir, ["out_CpG.bedGraph"])
    same_outputs(d_one, host_dir, ["out_CpG.bedGraph"])
    print(f"[5] mesh extract, 2,000,000 reads of 150 bp: make_mesh_backend("
          f"cfg, n_devices=8) grid {be.mesh.shape} {2e6 / t_mesh:,.0f} "
          f"reads/s ({t_mesh:.2f} s; windows through the sharded step "
          f"{be.launches['sharded']}); the CLI under MDTPU_ENGINE=mesh "
          f"({type(be_cli).__name__}, launches {be_cli.launches}; with one "
          f"card it is the one-device engine) {2e6 / t_cli:,.0f} reads/s "
          f"({t_cli:.2f} s; kernel launches {counts}); the default engine "
          f"in the same turns "
          f"{2e6 / t_one[0]:,.0f} and {2e6 / t_one[1]:,.0f} reads/s "
          f"({t_one[0]:.2f} s, {t_one[1]:.2f} s); all out_CpG.bedGraph "
          f"byte-identical to the host engine's ({card})", flush=True)
    if torch.cuda.device_count() == 1 and (
            type(be_cli).__name__ != "DeviceBackend"
            or counts["pileup2"] <= 0 or be_cli.host_routed != 0):
        raise AssertionError("MDTPU_ENGINE=mesh on one card did not run "
                             "pileup2.cu")
    return counts


def hosts_phase(fa, bam, host_dir, pr_one, mb_one):
    """Phase 6 on the 2M-read input: every host a process of the port's CLI
    on the card. ``host_dir`` holds the host engine's ``out_CpG.bedGraph``,
    ``pr_one`` and ``mb_one`` the one-host outputs of ``perRead -o
    reads.txt`` and ``mbias --txt ... mb`` on the card."""
    card = card_line()
    args = [fa, bam, "-o", "out"]
    steal0 = {"MDTPU_STEAL": "0"}
    names = ["out_CpG.bedGraph"]
    d = {k: os.path.join(WORK, f"hosts_{k}")
         for k in ("one", "two", "live", "ctx_one", "ctx_two", "pr", "mb")}
    for v in d.values():
        os.makedirs(v)
    t_1 = run_processes("extract", args, d["one"], [steal0])
    t_2 = run_processes("extract", args, d["two"],
                        [dict(e, **steal0) for e in sim_hosts(2)])
    if os.path.getsize(os.path.join(d["two"], names[0])) > 200:
        raise AssertionError("a simulated host wrote calls to the final file")
    t_2m = merge_shards_cli(d["two"], names)
    t_live = run_processes("extract", args, d["live"],
                           [dict(e, **steal0) for e in live_ranks(2)])
    for k in ("one", "two", "live"):
        same_outputs(d[k], host_dir, names)
    print(f"[6] extract as whole CLI processes on the card (start-up "
          f"included), 2,000,000 reads: one host {t_1:.2f} s = "
          f"{2e6 / t_1:,.0f} reads/s; two hosts at once under "
          f"MDTPU_NUM_HOSTS=2 {t_2:.2f} s + merge-shards {t_2m:.2f} s = "
          f"{2e6 / (t_2 + t_2m):,.0f} reads/s; a live two-rank gloo job over "
          f"loopback (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; rank 0 "
          f"merges) {t_live:.2f} s = {2e6 / t_live:,.0f} reads/s; "
          f"out_CpG.bedGraph byte-identical to the host engine's in all "
          f"three ({card})", flush=True)

    ctx = ["--CHG", "--CHH", *args]
    ctx_names = [f"out_{c}.bedGraph" for c in ("CpG", "CHG", "CHH")]
    t_c1, _ = run_port(ctx, d["ctx_one"], {"MDTPU_ENGINE": "cuda", **steal0})
    t_c2 = run_processes("extract", ctx, d["ctx_two"],
                         [dict(e, **steal0) for e in sim_hosts(2)])
    merge_shards_cli(d["ctx_two"], ctx_names)
    same_outputs(d["ctx_two"], d["ctx_one"], ctx_names)
    print(f"[6] extract --CHG --CHH, two hosts {t_c2:.2f} s (processes), one "
          f"host in this process {t_c1:.2f} s: {', '.join(ctx_names)} "
          "byte-identical to the one-host run on the card", flush=True)

    t_p = run_processes("perRead", ["-o", "reads.txt", fa, bam], d["pr"],
                        sim_hosts(2))
    t_pm = merge_shards_cli(d["pr"], ["reads.txt"])
    same_outputs(d["pr"], pr_one, ["reads.txt"])
    margs = ["--txt", fa, bam, "mb"]
    t_m = run_processes("mbias", margs, d["mb"], sim_hosts(2))
    if sorted(os.listdir(d["mb"])) != ["mb.mbias_counters.h0.npy",
                                          "mb.mbias_counters.h1.npy"]:
        raise AssertionError("mbias hosts: expected two counter shards and "
                             f"nothing else, got {os.listdir(d['mb'])}")
    t_mf = run_processes("mbias", margs, d["mb"],
                         [{"MDTPU_MBIAS_FINALIZE": "1"}], stdout_of=0)
    names = same_dirs(d["mb"], mb_one)
    print(f"[6] perRead -o, two hosts {t_p:.2f} s + merge-shards "
          f"{t_pm:.2f} s: reads.txt byte-identical to the one-host run on "
          f"the card; mbias --txt, two hosts {t_m:.2f} s + "
          f"MDTPU_MBIAS_FINALIZE=1 {t_mf:.2f} s: {', '.join(names)} "
          f"byte-identical to the one-host run on the card ({card})",
          flush=True)


def phases_only(opts, reset_counts, read_counts):
    """--mesh-only and --hosts-only: the 2M-read input, the host engine's
    and the card's one-host outputs, then phase 5 and / or phase 6."""
    from methyldackel_tpu_torch.io.bai import build_bai
    from methyldackel_tpu_torch.io.bam import BamFile
    from methyldackel_tpu_torch.utils.simulate import write_synthetic_input

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        fa, bam = write_synthetic_input(WORK, 1_000_000, 150, 1 << 23, seed=0)
        build_bai(BamFile(bam), bam + ".bai")
        one = {k: os.path.join(WORK, k) for k in ("host0", "perRead_port",
                                                  "mbias_port")}
        for d in one.values():
            os.makedirs(d)
        run_host([fa, bam, "-o", "out"], one["host0"])
        if opts.mesh_only:
            mesh_phase(fa, bam, one["host0"], reset_counts, read_counts)
        if opts.hosts_only:
            run_port(["-o", "reads.txt", fa, bam], one["perRead_port"],
                     {"MDTPU_ENGINE": "cuda"}, "perRead")
            run_port(["--txt", fa, bam, "mb"], one["mbias_port"],
                     {"MDTPU_ENGINE": "cuda"}, "mbias")
            hosts_phase(fa, bam, one["host0"], one["perRead_port"],
                        one["mbias_port"])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print("chip_smoke: --mesh-only / --hosts-only, the phases asked for "
          "passed")
    return 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="a checkout of the "
                    "commit before the pileup2.cu and arbitrate.cu redesign, "
                    "whose three kernels are timed in turns with these in "
                    "phase 2")
    ap.add_argument("--variants", action="store_true", help="also time "
                    "pileup2 at other launch shapes (lanes a column group, "
                    "staging buffer) in phase 2")
    ap.add_argument("--kernels-only", action="store_true", help="stop "
                    "after phase 2 with exit code 3 and no result line")
    ap.add_argument("--busy", action="store_true", help="after each main "
                    "path, run it once more under torch.profiler and with "
                    "the stage timers on, and print the device's busy share")
    ap.add_argument("--ptxas", action="store_true", help="build with "
                    "-Xptxas -v and print what the compiler says")
    ap.add_argument("--mesh-only", action="store_true", help="after the "
                    "build run only phase 5 (the mesh engine) and what it "
                    "compares with; exit code 3 and no result line")
    ap.add_argument("--hosts-only", action="store_true", help="after the "
                    "build run only phase 6 (the multi-host runs) and what "
                    "it compares with; exit code 3 and no result line")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)\n")
        return 1
    # the port and its own host stack; none of it may pull in jax or the
    # JAX package
    from methyldackel_tpu_torch import bench
    from methyldackel_tpu_torch.io import native
    from methyldackel_tpu_torch.ops import arbitrate as ar
    from methyldackel_tpu_torch.ops import build
    from methyldackel_tpu_torch.ops import pileup as pk
    from methyldackel_tpu_torch.ops import pileup4 as p4

    def reset_counts():
        pk.LAUNCHES = 0
        p4.LAUNCHES["nq"] = 0
        p4.LAUNCHES["qual"] = 0
        ar.LAUNCHES = 0

    read_counts = bench.launch_counts

    # ---- phase 1: device
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch.cuda.get_device_name: "
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; nvcc {build.nvcc_path()}; triton "
          f"installed: {importlib.util.find_spec('triton') is not None}; "
          f"native host library: {native.available()}", flush=True)
    if not native.available():
        # without it mbias and perRead would time their raw-row programs
        # unawares
        raise RuntimeError("csrc/build/libmdtpu_native.so did not load")
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    if opts.ptxas:
        build.NVCC_FLAGS += ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    secs = build_all(build, [pk.SOURCE, p4.SOURCE, ar.SOURCE])
    print(f"[1] built {', '.join(f'{k} in {v:.2f} s' for k, v in secs.items())}"
          f" for sm_90a, in parallel: {time.perf_counter() - t0:.2f} s "
          f"({build.BUILD_DIR})", flush=True)
    parent = parent_kernels(opts.parent) if opts.parent else {}
    if opts.mesh_only or opts.hosts_only:
        return phases_only(opts, reset_counts, read_counts)

    if not opts.kernels_only:
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        t_input = time.perf_counter()
        input_writer = start_input_writer()

    # ---- phase 2: kernels against their plain versions
    rng = np.random.default_rng(0)
    reads_per_window = 240_000
    wpad1 = 1_000_448  # round_up(chunkSize 1e6 + 16, 512)
    cslot = 187_648    # the CSLOT ladder's 3/16 bucket of wpad1
    P = 187_904
    p2_variants = ()
    if opts.variants:
        p2_variants = [
            (f"{sp} lanes a column group, {kb} KB buffer",
             dict(split=sp, budget_kb=kb))
            for sp in (1, 2, 4, 8, 16) for kb in (8, 12, 16, 24, 32)]
    print("[2] pileup2: candidate-space group program (Kw=4, P=187904, "
          "Lc4=64)", flush=True)
    cand_in = group_inputs(rng, Kw=4, pitch=P, span=cslot, lo=0,
                           n_per=reads_per_window, Lq=16,
                           ctx_slot=(P, cslot), all_cg=True)
    r_cand = kernel_vs_plain("candidate space", cand_in, False,
                             parent.get("pileup2"), p2_variants)
    del cand_in
    print("[2] pileup2: window-space group program (Kw=4, S=1000960, L=150)",
          flush=True)
    S = wpad1 + 512
    win_in = group_inputs(rng, Kw=4, pitch=S, span=wpad1, lo=-149,
                          n_per=reads_per_window, Lq=38,
                          ctx_slot=(S, wpad1))
    r_win = kernel_vs_plain("window space", win_in, True,
                            parent.get("pileup2"), p2_variants)
    del win_in
    overflow_case(rng)
    pileup2_edge_cases(rng)
    print("[2] pileup4 nq: the --minOppositeDepth single-window program "
          "(1 Mb, 240k reads of 150 bp)", flush=True)
    inp = window_inputs(rng, n=reads_per_window, L=150, wpad=wpad1,
                        qual_mode=False)
    r_nq = pileup4_vs_plain("pileup4 nq", inp, 4, parent.get("pileup4"))
    print("[2] pileup4 qual: the v2 single-window program (1 Mb, 240k reads "
          "of 150 bp)", flush=True)
    inp = window_inputs(rng, n=reads_per_window, L=150, wpad=wpad1,
                        qual_mode=True)
    r_q = pileup4_vs_plain("pileup4 qual", inp, 2, parent.get("pileup4"))
    del inp
    pileup4_overflow_case()
    pileup4_edge_cases(rng)
    print("[2] arbitrate: the v2 program's pairs (1 Mb, 120k pairs of "
          "150 bp)", flush=True)
    r_ar = arbitrate_vs_plain(rng, P=reads_per_window // 2, L=150,
                              span=wpad1, parent_fn=parent.get("arbitrate"))
    arbitrate_edge_cases(rng)
    torch.cuda.empty_cache()
    r_cand["err"] = max(r_cand["err"], r_win["err"])
    results = {"pileup2": r_cand, "pileup4_nq": r_nq, "pileup4_qual": r_q,
               "arbitrate": r_ar}
    for key, r in results.items():
        r["bound_ms"], r["bound_by"] = bound_of(r["bytes"], r["ops"])
        print(f"[2] {key}: {r['ms']:.4f} ms against a bound of "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: {r['bytes']} "
              f"bytes at 3.35 TB/s; {r['ops']} integer operations at 1,979 "
              f"TOP/s), share of bound {r['bound_ms'] / r['ms']:.3f}"
              + (f"; parent commit's kernel {r['parent_ms']:.4f} ms"
                 if "parent_ms" in r else "")
              + (f"; the bound as computed before, over both mates' whole "
                 f"rows: {r['old_bytes']} bytes = "
                 f"{r['old_bytes'] / HBM_BYTES_PER_S * 1e6:.2f} us"
                 if "old_bytes" in r else "")
              + f"; no library call computes it ({card})", flush=True)
        if r["bound_ms"] > r["ms"]:
            raise AssertionError(f"{key}: faster than its bound")
    print("[2] torch programs (parallel/programs.py) on the card against "
          "the CPU device", flush=True)
    programs_card_vs_cpu(rng)
    print("[2] torch programs at one real window", flush=True)
    program_times = programs_timed(rng)
    if opts.kernels_only:
        print("chip_smoke: --kernels-only, stopping after phase 2")
        return 3

    # ---- phase 3: the main paths end to end
    paths = (
        ("default extract", [], {}, ("pileup2",)),
        ("--minOppositeDepth 5 --maxVariantFrac 0.1",
         ["--minOppositeDepth", "5", "--maxVariantFrac", "0.1"], {},
         ("pileup4_nq",)),
        ("MDTPU_FUSED=v2", [], {"MDTPU_FUSED": "v2"},
         ("pileup4_qual", "arbitrate")),
    )
    launches = {}
    try:
        from methyldackel_tpu_torch.utils.simulate import \
            write_synthetic_input

        if input_writer.wait(timeout=600) != 0:
            raise RuntimeError("writing the 2M-read input failed")
        fa, bam = os.path.join(WORK, "sim.fa"), os.path.join(WORK, "sim.bam")
        print(f"[3] 2,000,000 reads of 150 bp over 8 Mb, written by a "
              f"process of its own during phase 2, ready "
              f"{time.perf_counter() - t_input:.1f} s after its start",
              flush=True)
        calls = {}
        for k, (name, extra, env, kernels) in enumerate(paths):
            dirs = [os.path.join(WORK, f"{d}{k}")
                    for d in ("port", "host", "hostin")]
            for d in dirs:
                os.makedirs(d)
            args = [*extra, fa, bam, "-o", "out"]
            cuda_env = {"MDTPU_ENGINE": "cuda", "MDTPU_STEAL": "0", **env}
            host_env = {"MDTPU_ENGINE": "host"}
            reset_counts()
            t_cuda = [run_port(args, dirs[0], cuda_env)]
            counts = read_counts()
            backend = t_cuda[0][1]
            # the exact host engine in this process too (same run_extract,
            # no backend), in turns with the port: the default path cuda,
            # host, host, cuda and the host engine once more in a process
            # of its own; the two other paths cuda, host, cuda
            t_host = [run_port(args, dirs[2], host_env)
                      for _ in range(2 if k == 0 else 1)]
            t_cuda.append(run_port(args, dirs[0], cuda_env))
            same_outputs(dirs[0], dirs[2], ["out_CpG.bedGraph"])
            own = ""
            if k == 0:
                dt_ref = run_host(args, dirs[1])
                same_outputs(dirs[0], dirs[1], ["out_CpG.bedGraph"])
                own = (f"; the port's CLI process with MDTPU_ENGINE=host "
                       f"{dt_ref:.2f} s = {2e6 / dt_ref:,.0f} reads/s")
            calls[name] = open(os.path.join(dirs[0], "out_CpG.bedGraph"),
                               "rb").read().count(b"\n") - 1
            print(f"[3] {name}, 2,000,000 reads of 150 bp: port cuda "
                  + " and ".join(f"{2e6 / t:,.0f}" for t, _ in t_cuda)
                  + " reads/s ("
                  + ", ".join(f"{t:.2f} s" for t, _ in t_cuda)
                  + f"; kernel launches {counts}, host-routed windows "
                  f"{backend.host_routed}); host engine in process "
                  + " and ".join(f"{2e6 / t:,.0f}" for t, _ in t_host)
                  + " reads/s ("
                  + ", ".join(f"{t:.2f} s" for t, _ in t_host) + ")" + own
                  + f"; out_CpG.bedGraph byte-identical, {calls[name]} CpG "
                  f"lines ({card})", flush=True)
            if backend.host_routed != 0 \
                    or any(counts[kn] <= 0 for kn in kernels):
                raise AssertionError(f"{name} did not run on the card")
            for kn in kernels:
                launches[kn] = counts[kn]
            if opts.busy:
                busy_share(name, args, dirs[0], cuda_env)
        excluded = calls[paths[0][0]] - calls[paths[1][0]]
        print(f"[3] variant exclusion: {excluded} CpG lines of "
              f"{calls[paths[0][0]]} excluded against the default run",
              flush=True)
        if excluded <= 0:
            raise AssertionError("--minOppositeDepth excluded nothing")

        subcommands = (
            ("mbias", ["--txt", fa, bam, "mb"]),
            ("perRead", ["-o", "reads.txt", fa, bam]),
        )
        for cmd, args in subcommands:
            dirs = [os.path.join(WORK, f"{cmd}_{d}") for d in ("port", "host")]
            for d in dirs:
                os.makedirs(d)
            t_cuda, backend = run_port(args, dirs[0],
                                       {"MDTPU_ENGINE": "cuda"}, cmd)
            t_host, _ = run_port(args, dirs[1], {"MDTPU_ENGINE": "host"}, cmd)
            names = same_dirs(dirs[0], dirs[1])
            print(f"[3] {cmd}, 2,000,000 reads of 150 bp: port cuda "
                  f"{2e6 / t_cuda:,.0f} reads/s ({t_cuda:.2f} s; device "
                  f"program launches {backend.launches}"
                  + (f", rows redone on the host {backend.rows_redone}"
                     if cmd == "perRead" else "")
                  + f"); host engine in process {2e6 / t_host:,.0f} reads/s "
                  f"({t_host:.2f} s); {', '.join(names)} byte-identical "
                  f"({card})", flush=True)
            if backend.launches["reduce"] <= 0 \
                    or backend.launches["legacy"] != 0:
                raise AssertionError(f"{cmd} did not take the packed path "
                                     "on the card")
            if opts.busy:
                busy_share(cmd, args, dirs[0], {"MDTPU_ENGINE": "cuda"}, cmd)
        if opts.busy:
            # the dense dispatch at real windows: the default extract with
            # the tiled kernels switched off
            d_dense = os.path.join(WORK, "dense_port")
            os.makedirs(d_dense)
            args = [fa, bam, "-o", "out"]
            env = {"MDTPU_ENGINE": "cuda", "MDTPU_STEAL": "0",
                   "MDTPU_NO_PALLAS": "1"}
            t_dense, backend = run_port(args, d_dense, env)
            same_outputs(d_dense, os.path.join(WORK, "host0"),
                         ["out_CpG.bedGraph"])
            print(f"[3] extract under MDTPU_NO_PALLAS=1 (the dense dispatch), "
                  f"2,000,000 reads of 150 bp: port cuda "
                  f"{2e6 / t_dense:,.0f} reads/s ({t_dense:.2f} s; device "
                  f"program launches {backend.launches}, host-routed windows "
                  f"{backend.host_routed}); out_CpG.bedGraph byte-identical "
                  f"to the host engine's ({card})", flush=True)
            if backend.launches["dense"] <= 0 or backend.host_routed != 0:
                raise AssertionError("the dense route missed its program")
            busy_share("dense dispatch", args, d_dense, env)

        # ---- phase 3b: the product's default scheduling, the bench's steps
        default_scheduling(fa, bam, os.path.join(WORK, "host0"),
                           reset_counts, read_counts)
        t0 = time.perf_counter()
        bench_steps()
        print(f"[3b] the bench's three step modes took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # ---- phase 4: side routes
        side = os.path.join(WORK, "side")
        os.makedirs(side)
        side_input(side)
        # ~900x coverage: counts pass 255, so the u8 readback overflows, the
        # drain thread refetches the window or group in u32 and the run
        # reads u16
        deep = os.path.join(WORK, "deep")
        os.makedirs(deep)
        write_synthetic_input(deep, 4000, 100, 1000, seed=5)
        opp = ["--minOppositeDepth", "2"]
        v2 = {"MDTPU_FUSED": "v2"}
        routes = (
            ("single-window", side, {"MDTPU_BATCH_WINDOWS": "1"}, [],
             ("pileup2",)),
            ("window-space group", side, {"MDTPU_CANDSPACE": "0"}, [],
             ("pileup2",)),
            ("CHG+CHH", side, {}, ["--CHG", "--CHH"], ("pileup2",)),
            ("4-channel", side, {}, opp, ("pileup4_nq",)),
            ("v2", side, v2, [], ("pileup4_qual", "arbitrate")),
            ("v2 4-channel", side, v2, opp, ("pileup4_qual", "arbitrate")),
            ("deep coverage", deep, {}, [], ("pileup2",)),
            # at ~900x the simulator's 1% errors put a variant at every
            # CpG, so the default fraction 0 would exclude all of them
            ("deep coverage 4-channel", deep, {},
             [*opp, "--maxVariantFrac", "0.1"], ("pileup4_nq",)),
        )
        for name, src, env, extra, kernels in routes:
            d_port = os.path.join(src, name.replace(" ", "_") + "_port")
            d_host = os.path.join(src, name.replace(" ", "_") + "_host")
            os.makedirs(d_port)
            os.makedirs(d_host)
            inputs = (["../g.fa", "../r.bam"] if src == side
                      else ["../sim.fa", "../sim.bam"])
            a = ["--chunkSize", "5000" if src == side else "300", *extra,
                 *inputs, "-o", "o"]
            reset_counts()
            _, be = run_port(a, d_port, {"MDTPU_ENGINE": "cuda",
                                         "MDTPU_STEAL": "0", **env})
            counts = read_counts()
            run_host(a, d_host)
            names = ["o_CpG.bedGraph"] + (
                ["o_CHG.bedGraph", "o_CHH.bedGraph"] if "--CHG" in extra
                else [])
            same_outputs(d_port, d_host, names)
            print(f"[4] {name}: byte-identical to the host engine "
                  f"({', '.join(names)}; kernel launches {counts}, "
                  f"host-routed {be.host_routed}, readback width "
                  f"u{be._sat_bits})", flush=True)
            if be.host_routed != 0 or any(counts[k] <= 0 for k in kernels):
                raise AssertionError(f"side route {name} missed the card")
            if src == deep and be._sat_bits != 16:
                raise AssertionError(f"{name} did not overflow u8")

        # the routes of the torch programs: each names the count that must
        # have risen on its backend
        long_reads = os.path.join(WORK, "long")
        os.makedirs(long_reads)
        write_synthetic_input(long_reads, 600, 300, 30000, seed=11)
        bed = os.path.join(side, "regions.bed")
        with open(bed, "w") as fh:
            fh.write("chrS\t500\t9000\ta\t0\t+\n"
                     "chrS\t11000\t19000\tb\t0\t-\n"
                     "chrS\t21000\t29500\tc\t0\t.\n")
        chunk = ["--chunkSize", "5000"]
        bam_side = ["../g.fa", "../r.bam"]
        torch_routes = (
            ("extract --keepStrand with a stranded BED", "extract", side, {},
             [*chunk, "-l", bed, "--keepStrand", *bam_side, "-o", "o"],
             "dense"),
            ("extract on reads of 300 bp", "extract", long_reads, {},
             [*chunk, "../sim.fa", "../sim.bam", "-o", "o"], "dense"),
            ("extract under MDTPU_NO_PALLAS=1", "extract", side,
             {"MDTPU_NO_PALLAS": "1"}, [*chunk, *bam_side, "-o", "o"],
             "dense"),
            ("mbias with a BED", "mbias", side, {},
             ["--txt", *chunk, "-l", bed, "--keepStrand", *bam_side, "mb"],
             "legacy"),
            ("perRead with sub-phred bases", "perRead", side, {},
             [*chunk, *bam_side], "reduce"),
        )
        for k, (name, cmd, src, env, a, key) in enumerate(torch_routes):
            d_port = os.path.join(src, f"torch{k}_port")
            d_host = os.path.join(src, f"torch{k}_host")
            os.makedirs(d_port)
            os.makedirs(d_host)
            reset_counts()
            _, be = run_port(a, d_port, {"MDTPU_ENGINE": "cuda",
                                         "MDTPU_STEAL": "0", **env}, cmd)
            counts = read_counts()
            run_host(a, d_host, cmd)
            names = same_dirs(d_port, d_host)
            print(f"[4] {name}: byte-identical to the host engine "
                  f"({', '.join(names)}; device program launches "
                  f"{be.launches}, kernel launches {counts}"
                  + (f", host-routed {be.host_routed}" if cmd == "extract"
                     else "")
                  + (f", rows redone on the host {be.rows_redone}"
                     if cmd == "perRead" else "") + ")", flush=True)
            if be.launches[key] <= 0 or getattr(be, "host_routed", 0) != 0:
                raise AssertionError(f"side route {name} missed its device "
                                     "program")
            if key == "dense" and any(counts.values()):
                raise AssertionError(f"side route {name} launched a tiled "
                                     "kernel")
            if cmd == "perRead" and be.rows_redone <= 0:
                raise AssertionError(f"{name}: no row was redone")

        # ---- phases 5-6: the mesh engine and the multi-host runs
        mesh_counts = mesh_phase(fa, bam, os.path.join(WORK, "host0"),
                                 reset_counts, read_counts)
        hosts_phase(fa, bam, os.path.join(WORK, "host0"),
                    os.path.join(WORK, "perRead_port"),
                    os.path.join(WORK, "mbias_port"))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print("[7] kernel ms (device, cold L2 / wrapper call / plain version): "
          + "; ".join(f"{nm} {r['ms']:.4f} / {r['wrapper_ms']:.4f} / "
                      f"{r['plain_ms']:.4f}" for nm, r in (
                          ("pileup2 candidate space", r_cand),
                          ("pileup2 window space", r_win),
                          ("pileup4 nq", r_nq), ("pileup4 qual", r_q),
                          ("arbitrate", r_ar)))
          + " (the JSON line reports pileup2's candidate-space program, the "
          f"default path's); whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "methyldackel_tpu"))
    if leaked:
        raise AssertionError(f"jax or the JAX package was imported: {leaked}")

    csrc = "methyldackel_tpu_torch/csrc/"
    kernels = [
        ("pileup2_tiles", "pileup2.cu", "pileup_pallas.py:354", "pileup2"),
        ("pileup4_tiles_nq", "pileup4.cu", "pileup_pallas.py:247",
         "pileup4_nq"),
        ("pileup4_tiles_qual", "pileup4.cu", "pileup_pallas.py:164",
         "pileup4_qual"),
        ("arbitrate", "arbitrate.cu", "arbitrate_pallas.py:100", "arbitrate"),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": csrc + source,
        "replaces": "methyldackel_tpu/ops/" + replaces,
        "launches": launches[key],
        "launches_mesh_cli": mesh_counts[key],
        "max_abs_err": results[key]["err"],
        "ms": results[key]["ms"],
        "plain_ms": results[key]["plain_ms"],
        "bound_ms": results[key]["bound_ms"],
        "bound_by": results[key]["bound_by"],
        "library_ms": None,
        "bytes": results[key]["bytes"],
        "ms_warm_l2": results[key]["ms_warm"],
        "wrapper_ms": results[key]["wrapper_ms"],
        "timed_by": results[key]["timed_by"],
        "share_of_bound": results[key]["bound_ms"] / results[key]["ms"],
    } for name, source, replaces, key in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
