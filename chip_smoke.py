#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR] [--busy]

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. Device: the card's name and power limit; the three kernel sources
   (``pileup2.cu``, ``pileup4.cu``, ``arbitrate.cu``) are built from
   ``methyldackel_tpu_torch/csrc`` with nvcc, one process each, all started
   together (build times printed).
2. Each kernel against its plain PyTorch version on the card, bit-equal
   (integer counts and qual bytes, tolerance 0), at the shapes of the main
   paths: ``pileup2`` at the default extract's two group programs (4
   windows of 1 Mb at 30x-like depth) in u8, u16 and u32 plus an input built
   to overflow u8; ``pileup4`` in both layouts at one 1 Mb window of 240k
   reads of 150 bp (the --minOppositeDepth and v2 single-window programs),
   NCH 2 and 4, dense and compacted, all widths, plus an overflow input and
   the staging's edge cases (more than one chunk, a range whose first byte
   is not 16-byte aligned, an odd read length, tiles without rows, a
   partial last tile); ``arbitrate`` at 120k pairs of 150 bp with block
   shifts 0-2 and ineligible pairs. Times are CUDA-event medians after
   warm-up, plain and kernel in turns. Beside each time stands the kernel's
   bound: the bytes the function must move (every input read once, every
   output written once, computed from this run's inputs) over the card's
   published 3.35 TB/s, or its integer operations over the published
   1,979 TOP/s, whichever is larger. No single PyTorch call computes any
   of the four functions (each fuses unpack, shift, strand/reference
   classification, count and narrowing), so ``library_ms`` is null.
   With ``--parent DIR`` (a checkout of an earlier commit), that commit's
   ``pileup4.cu`` is built too and timed on the same inputs in turns with
   this one (parent, change, change, parent).
3. The main paths end to end on a synthetic 2M-read WGBS input, through
   ``extract`` of the port (MDTPU_ENGINE=cuda, MDTPU_STEAL=0, so every
   window goes to the card): the default extract, ``--minOppositeDepth 5
   --maxVariantFrac 0.1`` (variant exclusion, the 4-channel program) and
   ``MDTPU_FUSED=v2`` (arbitration on the card). Each CpG bedGraph must be
   byte-identical to the port's exact host engine (MDTPU_ENGINE=host, in
   its own process), each path's kernels must have launched, no window
   may have been routed to the host, and the variant run must exclude
   positions. Port and host engine run in turns in this process for reads/s.
   With ``--busy`` each path runs once more under torch.profiler with the
   engine's stage timers on, for the device's busy share of the wall time.
4. Side routes on a small input with indel and '=' reads: single-window
   dispatch, the window-space group, CHG+CHH, the 4-channel program, v2,
   v2 with --minOppositeDepth; and a ~900x deep input whose counts overflow
   the u8 readback (u32 refetch, then u16), default and 4-channel. Each
   byte-identical to the host engine.

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
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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

def group_inputs(rng, *, Kw, pitch, span, lo, n_per, Lq, LP, ctx_slot):
    """Random group-program inputs: Kw windows of ``span`` columns in slots
    of ``pitch``, n_per rows each with starts in [lo, span), random 2-bit
    codes and parities, reference bitmaps of a random 42% GC genome, and
    the compaction map of the CpG candidates. Group tables come from the
    dispatch's own host code."""
    from methyldackel_tpu_torch.parallel import host_prep as hp

    W_tot = Kw * pitch
    ntiles = W_tot // T
    K = (T + LP) // 128
    f_pos = np.concatenate([np.sort(rng.integers(lo, span, n_per)) + k * pitch
                            for k in range(Kw)])
    aligned = f_pos - f_pos % 128
    srtk, cntk = hp.group_tables(aligned, ntiles, K, LP)
    n = len(f_pos)
    seqpack = rng.integers(0, 256, (n, Lq), dtype=np.uint8)
    shp = hp.shp_bytes(f_pos.astype(np.int32),
                       rng.integers(0, 2, n).astype(np.uint8))
    base = rng.choice(4, W_tot, p=[0.29, 0.21, 0.21, 0.29])
    data = (np.arange(W_tot) % pitch) < span
    cb, gb = (base == 1) & data, (base == 2) & data
    cand = np.nonzero(hp.ctx_mask_np(cb, gb, 1, ctx_slot))[0]
    dst = np.full(W_tot, -1, np.int32)
    dst[cand] = np.arange(len(cand), dtype=np.int32)
    return dict(seqpack=seqpack, shp=shp, srtk=srtk, cntk=cntk,
                isc=np.packbits(cb), isg=np.packbits(gb), dst=dst,
                ncand=len(cand), ntiles=ntiles, K=K, LP=LP)


def kernel_vs_plain(name, inp, compact):
    """Bit-equality in all three widths, then times at u8. Returns
    the times of ``timed`` plus err, bytes (every input once + the u8
    output once) and ops (a compare and an add per code of every row)."""
    import torch

    from methyldackel_tpu_torch.ops import pileup as pk

    dev = torch.device("cuda")
    args = [torch.from_numpy(inp[k]).to(dev)
            for k in ("seqpack", "shp", "srtk", "cntk", "isc", "isg")]
    geom = dict(ntiles=inp["ntiles"], K=inp["K"], LP=inp["LP"])
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
    print(f"  {name}: rows {len(inp['shp'])} tiles {inp['ntiles']} K "
          f"{inp['K']} Lq {inp['seqpack'].shape[1]}", flush=True)
    res = timed(name, "pileup2_kernel",
                lambda: pk.pileup2_tiles(*args, **kw8),
                lambda: pk.pileup2_tiles_reference(*args, **kw8))
    out8, ovf8 = pk.pileup2_tiles(*args, **kw8)
    res.update(err=err, bytes=nbytes_of(*args, extra.get("dst"), out8, ovf8),
               ops=2 * inp["seqpack"].size * 4)
    return res


def overflow_case(rng):
    """300 rows stacked on one column range, every code methylated: u8
    must flag, u16 and u32 must not; kernel == plain in every width."""
    import torch

    from methyldackel_tpu_torch.ops import pileup as pk
    from methyldackel_tpu_torch.parallel import host_prep as hp

    n, Lq, LP, ntiles = 300, 38, 256, 4
    K = (T + LP) // 128
    f_pos = np.full(n, 700, np.int64)
    srtk, cntk = hp.group_tables(f_pos - f_pos % 128, ntiles, K, LP)
    seqpack = np.full((n, Lq), 0x55, np.uint8)  # code 1 everywhere
    shp = hp.shp_bytes(f_pos.astype(np.int32), np.ones(n, np.uint8))
    isc = np.full(ntiles * T // 8, 0xFF, np.uint8)
    isg = np.zeros_like(isc)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev)
            for a in (seqpack, shp, srtk, cntk, isc, isg)]
    for sat, want_flag in ((8, 1), (16, 0), (32, 0)):
        got, ovf = pk.pileup2_tiles(*args, ntiles=ntiles, K=K, LP=LP,
                                    sat_bits=sat)
        want, wovf = pk.pileup2_tiles_reference(*args, ntiles=ntiles, K=K,
                                                LP=LP, sat_bits=sat)
        torch.cuda.synchronize()
        same = np.array_equal(got.view(torch.uint8).cpu().numpy(),
                              want.view(torch.uint8).cpu().numpy())
        print(f"  overflow input u{sat}: flag {int(ovf.item())} (plain "
              f"{int(wovf.item())}), equal {same}", flush=True)
        if not same or int(ovf.item()) != want_flag \
                or int(wovf.item()) != want_flag:
            raise AssertionError(f"overflow case u{sat} failed")


def window_inputs(rng, *, n, L, wpad, qual_mode):
    """One 1 Mb window of the single-window programs: n position-sorted
    rows of L codes (A/C/G/T/N, some 0 = gated or absent) starting anywhere
    in [-L, wpad), nibble-packed (nq) or one per byte with quals 0-41
    (qual), random parities, reference bitmaps of a random 42% GC genome,
    and the compaction map of its CpG candidates. Row and tile tables come
    from the dispatch's own host code; ``old`` holds the tables of the
    earlier interface (phase byte and offset groups) for --parent."""
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
    LP = hp.round_up(max(4 * ((L + 3) // 4), 128), 128)
    K = (T + LP) // 128
    srtk, cntk = hp.group_tables(f_pos - f_pos % 128, ntiles, K, LP)
    old = dict(shp=hp.shp_bytes(f_pos.astype(np.int32), parity), srtk=srtk,
               cntk=cntk, K=K, LP=LP)
    return dict(codes=codes, qual=qual if qual_mode else None,
                spos=hp.row_spos(f_pos, parity), tlo=tlo, thi=thi,
                isc=np.packbits(cb), isg=np.packbits(gb), dst=dst,
                ncand=len(cand), ntiles=ntiles, old=old)


def parent_pileup4(parent_dir):
    """The ``mdtpu_pileup4`` entry of an earlier commit's ``pileup4.cu``
    (the interface with the phase byte and the offset groups), built with
    this checkout's build code into its own directory."""
    from methyldackel_tpu_torch.ops import build

    src = os.path.join(parent_dir, "methyldackel_tpu_torch", "csrc",
                       "pileup4.cu")
    out = os.path.join(build.BUILD_DIR, "libpileup4_parent.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True)
    fn = ctypes.CDLL(out).mdtpu_pileup4
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pileup4_vs_plain(name, inp, timed_nch, parent_fn=None):
    """Bit-equality in NCH 2 and 4, all three widths, dense and compacted;
    then times of the compacted u8 program at ``timed_nch`` (the main
    path's readback). Returns the times of ``timed`` plus err, bytes (every
    input once + the output once), ops (four channel updates per code of
    every row) and, with ``parent_fn``, parent_ms. ``parent_fn`` (see
    ``parent_pileup4``) is timed in turns with the kernel on the same
    rows and must store the same bytes."""
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
        old = inp["old"]
        o_args = [torch.from_numpy(old[k]).to(dev)
                  for k in ("shp", "srtk", "cntk")]
        o_out = torch.zeros_like(out8)
        o_ovf = torch.zeros_like(ovf8)
        stream = torch.cuda.current_stream(dev).cuda_stream
        qual = mode.get("qual")

        def parent():
            rc = parent_fn(
                args[0].data_ptr(),
                None if qual is None else qual.data_ptr(),
                o_args[0].data_ptr(), o_args[1].data_ptr(),
                o_args[2].data_ptr(), args[4].data_ptr(), args[5].data_ptr(),
                compact["dst"].data_ptr(), o_out.data_ptr(),
                o_ovf.data_ptr(), inp["ntiles"], old["K"], old["LP"], Lc,
                inp["codes"].shape[1], inp["ntiles"] * T, inp["ncand"],
                timed_nch, 5, 8, stream)
            if rc != 0:
                raise RuntimeError(f"parent pileup4 launch: cudaError {rc}")

        parent()
        torch.cuda.synchronize()
        if not torch.equal(o_out, out8):
            raise AssertionError(f"{name}: parent kernel != this kernel")
        # parent, change, change, parent
        par = [kernel_device_ms(parent, "pileup4_kernel")]
        new = [kernel_device_ms(lambda: p4.pileup4_tiles(*args, **kw8),
                                "pileup4_kernel") for _ in range(2)]
        par.append(kernel_device_ms(parent, "pileup4_kernel"))
        res["parent_ms"], res["parent_ms_warm"] = par[0]
        print(f"  {name}: parent commit's kernel, this one, this one, "
              f"parent (ms on the device, cold L2 / warm L2): "
              + ", ".join(f"{c:.4f} / {w:.4f}"
                          for c, w in (par[0], *new, par[1]))
              + f" ({card_line()}); stored bytes equal", flush=True)
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

    def placed(arr):
        flat = torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1)
        if not shift:
            return flat.reshape(arr.shape)
        big = torch.zeros(flat.numel() + shift + 3, dtype=flat.dtype)
        big[shift : shift + flat.numel()] = flat
        return big[shift : shift + flat.numel()].view(arr.shape)

    args = [placed(codes), placed(hp.row_spos(f_pos, parity)),
            torch.from_numpy(tlo), torch.from_numpy(thi),
            torch.from_numpy(rng.integers(0, 256, W // 8, dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, W // 8, dtype=np.uint8))]
    kw = dict(ntiles=ntiles, dst=torch.from_numpy(dst), out_width=len(cand))
    if qual_mode:
        kw.update(qual=placed(qual), min_phred=5)
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


def arbitrate_vs_plain(rng, *, P, L, span):
    """P mate pairs over ``span`` columns, position-sorted as the v2
    program sorts them, mates 0-329 apart (block shifts 0-2 and beyond),
    one pair in nine on different strand parities, quals 0-255. Kernel and
    plain version rewrite copies of the same quals. Returns the times of
    ``timed`` plus err, bytes and ops: bytes = the tables, both mates' codes and quals
    of the eligible pairs (block shift 0-2) read once and the quals this
    input rewrites written once; ops = four per base of an eligible
    pair."""
    import torch

    from methyldackel_tpu_torch.ops import arbitrate as ar
    from methyldackel_tpu_torch.parallel import host_prep as hp

    n = 2 * P
    f_pos = np.empty(n, np.int64)
    f_pos[0::2] = rng.integers(0, span, P)
    f_pos[1::2] = f_pos[0::2] + rng.integers(0, 330, P)
    aligned = f_pos - f_pos % 128
    order = np.argsort(aligned, kind="stable")
    frame = np.empty(n, np.int64)
    frame[order] = np.arange(n)
    st = rng.integers(1, 3, n)
    st[1::2] = st[0::2]
    st[1::18] ^= 3
    pa, pb, code = hp.v2_pair_tables(aligned[order], st[order], frame[0::2],
                                     frame[1::2])
    seq = np.array([1, 2, 4, 8, 15], np.uint8)[
        rng.choice(5, (n, L), p=[0.29, 0.2, 0.2, 0.29, 0.02])]
    qual = rng.integers(0, 256, (n, L), dtype=np.uint8)
    shp = hp.shp_bytes(f_pos[order].astype(np.int32),
                       (st[order] & 1).astype(np.uint8))
    dev = torch.device("cuda")
    s_t, shp_t, pa_t, pb_t, code_t = [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (seq, shp, pa, pb, code)]
    q0 = torch.from_numpy(qual).to(dev)
    got, want = q0.clone(), q0.clone()
    ar.arbitrate(s_t, got, shp_t, pa_t, pb_t, code_t)
    ar.arbitrate_reference(s_t, want, shp_t, pa_t, pb_t, code_t)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    changed = int((got != q0).sum())
    counts = np.bincount(code, minlength=4)
    print(f"  arbitrate: {P} pairs x {L} (codes 0/1/2/3: {counts.tolist()}), "
          f"{changed} quals rewritten, max_abs_err {err}", flush=True)
    if err != 0 or changed == 0:
        raise AssertionError("arbitrate: kernel != plain version")
    q = q0.clone()  # in place: both rewrite the same bytes each call
    res = timed(
        "arbitrate", "arbitrate_kernel",
        lambda: ar.arbitrate(s_t, q, shp_t, pa_t, pb_t, code_t),
        lambda: ar.arbitrate_reference(s_t, q, shp_t, pa_t, pb_t, code_t))
    eligible = int((code < 3).sum())
    res.update(err=err, ops=4 * eligible * L,
               bytes=nbytes_of(shp_t, pa_t, pb_t, code_t)
               + eligible * 2 * L * 2 + changed)
    return res


# ---------------------------------------------------- phases 3-4: the CLI

def run_port(args, cwd, env):
    """The port's extract in this process; returns (seconds, backend)."""
    from methyldackel_tpu_torch import cli

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        t0 = time.perf_counter()
        rc, backend = cli.extract(args)
        dt = time.perf_counter() - t0
    finally:
        os.chdir(here)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise RuntimeError(f"port extract {args} returned {rc}")
    return dt, backend


def busy_share(name, args, cwd, env):
    """One more run of the port's extract under torch.profiler (device
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
            wall, _ = run_port(args, cwd, env)
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


def run_host(args, cwd):
    """The port's exact host engine (MDTPU_ENGINE=host), in its own
    process."""
    env = dict(os.environ, MDTPU_ENGINE="host",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "methyldackel_tpu_torch.cli",
                          "extract", *args], cwd=cwd, env=env,
                         capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"host extract failed: {res.stderr[-2000:]}")
    return dt


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="a checkout of an "
                    "earlier commit whose pileup4.cu is timed in turns with "
                    "this one in phase 2")
    ap.add_argument("--kernels-only", action="store_true", help="stop "
                    "after phase 2 with exit code 3 and no result line")
    ap.add_argument("--busy", action="store_true", help="after each main "
                    "path, run it once more under torch.profiler and with "
                    "the stage timers on, and print the device's busy share")
    ap.add_argument("--ptxas", action="store_true", help="build with "
                    "-Xptxas -v and print what the compiler says")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)\n")
        return 1
    # the port and its own host stack; none of it may pull in jax or the
    # JAX package
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

    def read_counts():
        return {"pileup2": pk.LAUNCHES, "pileup4_nq": p4.LAUNCHES["nq"],
                "pileup4_qual": p4.LAUNCHES["qual"], "arbitrate": ar.LAUNCHES}

    # ---- phase 1: device
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch.cuda.get_device_name: "
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; nvcc {build.nvcc_path()}; triton "
          f"installed: {importlib.util.find_spec('triton') is not None}; "
          f"native host library: {native.available()}", flush=True)
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    if opts.ptxas:
        build.NVCC_FLAGS += ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    secs = build_all(build, [pk.SOURCE, p4.SOURCE, ar.SOURCE])
    print(f"[1] built {', '.join(f'{k} in {v:.2f} s' for k, v in secs.items())}"
          f" for sm_90a, in parallel: {time.perf_counter() - t0:.2f} s "
          f"({build.BUILD_DIR})", flush=True)
    parent_fn = parent_pileup4(opts.parent) if opts.parent else None

    # ---- phase 2: kernels against their plain versions
    rng = np.random.default_rng(0)
    reads_per_window = 240_000
    wpad1 = 1_000_448  # round_up(chunkSize 1e6 + 16, 512)
    cslot = 187_648    # the CSLOT ladder's 3/16 bucket of wpad1
    P = 187_904
    print("[2] pileup2: candidate-space group program (Kw=4, P=187904, "
          "Lc4=64)", flush=True)
    cand_in = group_inputs(rng, Kw=4, pitch=P, span=cslot, lo=0,
                           n_per=reads_per_window, Lq=16, LP=128,
                           ctx_slot=(P, cslot))
    r_cand = kernel_vs_plain("candidate space", cand_in, compact=False)
    del cand_in
    print("[2] pileup2: window-space group program (Kw=4, S=1000960, L=150)",
          flush=True)
    S = wpad1 + 512
    win_in = group_inputs(rng, Kw=4, pitch=S, span=wpad1, lo=-149,
                          n_per=reads_per_window, Lq=38, LP=256,
                          ctx_slot=(S, wpad1))
    r_win = kernel_vs_plain("window space", win_in, compact=True)
    del win_in
    overflow_case(rng)
    print("[2] pileup4 nq: the --minOppositeDepth single-window program "
          "(1 Mb, 240k reads of 150 bp)", flush=True)
    inp = window_inputs(rng, n=reads_per_window, L=150, wpad=wpad1,
                        qual_mode=False)
    r_nq = pileup4_vs_plain("pileup4 nq", inp, 4, parent_fn)
    print("[2] pileup4 qual: the v2 single-window program (1 Mb, 240k reads "
          "of 150 bp)", flush=True)
    inp = window_inputs(rng, n=reads_per_window, L=150, wpad=wpad1,
                        qual_mode=True)
    r_q = pileup4_vs_plain("pileup4 qual", inp, 2, parent_fn)
    del inp
    pileup4_overflow_case()
    pileup4_edge_cases(rng)
    print("[2] arbitrate: the v2 program's pairs (1 Mb, 120k pairs of "
          "150 bp)", flush=True)
    r_ar = arbitrate_vs_plain(rng, P=reads_per_window // 2, L=150,
                              span=wpad1)
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
              + f"; no library call computes it ({card})", flush=True)
    if opts.kernels_only:
        print("chip_smoke: --kernels-only, stopping after phase 2")
        return 3

    # ---- phase 3: the main paths end to end
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
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
        from methyldackel_tpu_torch.io.bai import build_bai
        from methyldackel_tpu_torch.io.bam import BamFile
        from methyldackel_tpu_torch.utils.simulate import \
            write_synthetic_input

        t0 = time.perf_counter()
        fa, bam = write_synthetic_input(WORK, 1_000_000, 150, 1 << 23, seed=0)
        build_bai(BamFile(bam), bam + ".bai")
        print(f"[3] wrote 2,000,000 reads of 150 bp over 8 Mb in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
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
            # no backend), in turns with the port: cuda, host, host, cuda
            t_host = [run_port(args, dirs[2], host_env) for _ in range(2)]
            t_cuda.append(run_port(args, dirs[0], cuda_env))
            dt_ref = run_host(args, dirs[1])
            same_outputs(dirs[0], dirs[1], ["out_CpG.bedGraph"])
            same_outputs(dirs[2], dirs[1], ["out_CpG.bedGraph"])
            calls[name] = open(os.path.join(dirs[0], "out_CpG.bedGraph"),
                               "rb").read().count(b"\n") - 1
            rate = [2e6 / t for t, _ in t_cuda]
            hrate = [2e6 / t for t, _ in t_host]
            print(f"[3] {name}, 2,000,000 reads of 150 bp: port cuda "
                  f"{rate[0]:,.0f} and {rate[1]:,.0f} reads/s "
                  f"({t_cuda[0][0]:.2f} s, {t_cuda[1][0]:.2f} s; kernel "
                  f"launches {counts}, host-routed windows "
                  f"{backend.host_routed}); host engine in process "
                  f"{hrate[0]:,.0f} and {hrate[1]:,.0f} reads/s "
                  f"({t_host[0][0]:.2f} s, {t_host[1][0]:.2f} s); the port's "
                  f"CLI process with MDTPU_ENGINE=host {dt_ref:.2f} s = "
                  f"{2e6 / dt_ref:,.0f} reads/s; out_CpG.bedGraph "
                  f"byte-identical, {calls[name]} CpG lines ({card})",
                  flush=True)
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
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print("[5] kernel ms (device, cold L2 / wrapper call / plain version): "
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
