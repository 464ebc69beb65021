"""12-count pileup with the 4-channel epilogue (``--minOppositeDepth`` and
the ``MDTPU_FUSED=v2`` window program).

``pileup4_tiles`` launches ``csrc/pileup4.cu``, one kernel in two code
layouts, the Hopper port of two TPU kernels of
``methyldackel_tpu/ops/pileup_pallas.py``:

- *nq* (``qual`` is None): pre-gated 4-bit codes packed two to a byte
  (``[Nb, Lh]``, code 2j in the low nibble of byte j), as
  ``_fused_window_pregated`` uploads them; a base counts when its code is
  not 0. Port of ``_kernel_nq``.
- *qual*: one code per byte plus a qual array (``[Nb, L]`` each); a base
  counts when its code is not 0 and ``qual >= min_phred``. Port of
  ``_kernel``. The TPU kernel gated on the qual alone and so, at
  ``min_phred`` 0, also counted the zero pad bytes of its phase-aligned rows
  in the per-parity totals; here code 0 (outside the read: the fast path
  never holds an '=' base) is inert, as in the host engine.

Both fuse ``counts_to_channels`` (meth, unmeth, opposite-strand depth,
opposite-strand variants; extract.c:420-441), the optional candidate
compaction and the saturating u8/u16/u32 cast with its overflow flag into
the store. ``pileup4_tiles_reference`` is the plain PyTorch version; the
wrapper takes it only for tensors on the CPU.

The window space is ``ntiles`` tiles of ``T = 512`` columns. Rows are sorted
by their start column and carry it: ``spos`` int32 [Nb] holds ``2 * start +
parity`` (``host_prep.row_spos``), and ``tlo``/``thi`` int32 [ntiles] the
row range that can reach each tile (``host_prep.tile_rows``, which checks
the order). The TPU layout's phase byte, offset groups and ``K``/``LP`` are
not part of this interface; ``ops.pileup`` (the 2-bit program) keeps them.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .build import load
from .pileup import _OUT_DTYPES, _CHUNK_ELEMS, T, _check, _narrow, unpack_bits

SOURCE = "pileup4.cu"
# Incremented once per kernel launch (never for the plain version), per
# code layout.
LAUNCHES = {"nq": 0, "qual": 0}
_COUNT_LOCK = threading.Lock()

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 1, 2, 4, 8, 15
# base code -> row of the per-parity block (total, A, C, G, T, N); -1: none
_BASE_ROW = [-1] * 16
for _row, _code in enumerate((BASE_A, BASE_C, BASE_G, BASE_T, BASE_N), 1):
    _BASE_ROW[_code] = _row


def pileup4_counts_reference(codes: torch.Tensor, spos: torch.Tensor,
                             tlo: torch.Tensor, thi: torch.Tensor, *,
                             ntiles: int, qual=None,
                             min_phred: int = 0) -> torch.Tensor:
    """Plain per-column counters: int32 [12, ntiles*T], per parity (odd
    rows 0-5, even rows 6-11) the total and the counts of A, C, G, T, N —
    rows 0-11 of ``pileup_pallas._pileup_tiles_nq_interpret`` (nq) and of
    ``_pileup_tiles_interpret`` (qual, whenever min_phred >= 1). Tile by
    tile like the kernel: each tile adds the codes of its rows
    [tlo[t], thi[t]) that fall on its own columns."""
    dev = codes.device
    W = ntiles * T
    Lc = codes.shape[1] * (2 if qual is None else 1)
    counts = torch.zeros(12 * W, dtype=torch.int64, device=dev)
    cnt = (thi - tlo).long()
    total = int(cnt.sum())
    if total == 0:
        return counts.view(12, W).int()
    # one entry per (tile, row) listing; entry e of tile t is row
    # tlo[t] + (e - first[t])
    tid = torch.repeat_interleave(torch.arange(ntiles, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    lo_rows = tlo.long()
    j = torch.arange(Lc, device=dev)
    base_row = torch.tensor(_BASE_ROW, dtype=torch.int64, device=dev)
    step = max(1, _CHUNK_ELEMS // Lc)
    for e0 in range(0, total, step):
        t = tid[e0 : e0 + step]
        e = torch.arange(e0, e0 + t.numel(), device=dev)
        r = lo_rows[t] + (e - first[t])
        s = spos[r].long()
        lo = t * T
        col = (s >> 1)[:, None] + j[None, :]
        if qual is None:
            c = (codes[r].long()[:, j >> 1] >> (4 * (j & 1))[None, :]) & 15
            act = c != 0
        else:
            c = codes[r].long() & 15
            act = (c != 0) & (qual[r].long() >= min_phred)
        keep = (col >= lo[:, None]) & (col < (lo + T)[:, None]) & act
        blk = (6 * (1 - (s & 1)))[:, None].expand_as(col)
        counts += torch.bincount((blk * W + col)[keep], minlength=12 * W)
        br = base_row[c]
        kb = keep & (br >= 0)
        counts += torch.bincount(((blk + br) * W + col)[kb],
                                 minlength=12 * W)
    return counts.view(12, W).int()


def counts_to_channels(counts: torch.Tensor, isc: torch.Tensor,
                       isg: torch.Tensor, W: int) -> torch.Tensor:
    """The 12 per-parity counts -> int64 [4, W] (meth, unmeth, opposite
    depth, opposite variants), ``pileup_pallas.counts_to_channels`` with the
    reference's C/G classes taken from host-packed, frame-shifted bitmaps
    (``host_prep.ref_bits``) instead of the reference bytes."""
    c = counts[:12, :W].long()
    odd, even = c[0:6], c[6:12]
    is_c = unpack_bits(isc, W)
    is_g = unpack_bits(isg, W)
    zero = torch.zeros((), dtype=torch.int64, device=c.device)
    meth = torch.where(is_c, odd[2], torch.where(is_g, even[3], zero))
    unmeth = torch.where(is_c, odd[4], torch.where(is_g, even[1], zero))
    var_odd = odd[0] - odd[3] - odd[5]
    var_even = even[0] - even[2] - even[5]
    off = torch.where(is_c, even[0],
                      torch.where(is_g, odd[0], odd[0] + even[0]))
    var = torch.where(is_c, var_even,
                      torch.where(is_g, var_odd, var_odd + var_even))
    return torch.stack([meth, unmeth, off, var])


def pileup4_tiles_reference(codes, spos, tlo, thi, isc, isg, *, ntiles: int,
                            nch: int, sat_bits: int, dst=None,
                            out_width=None, qual=None, min_phred: int = 0,
                            chunk_rows=None):
    """Plain PyTorch version of ``pileup4_tiles`` (same arguments, same
    result; ``chunk_rows`` only sizes the kernel's staging)."""
    W = ntiles * T
    counts = pileup4_counts_reference(codes, spos, tlo, thi, ntiles=ntiles,
                                      qual=qual, min_phred=min_phred)
    ch = counts_to_channels(counts, isc, isg, W)[:nch]
    if dst is not None:
        kept = dst >= 0
        sel = torch.zeros((nch, out_width), dtype=torch.int64,
                          device=ch.device)
        sel[:, dst[kept].long()] = ch[:, kept]
        ch = sel
    return _narrow(ch, sat_bits)


def _kernel_fn():
    fn = load(SOURCE).mdtpu_pileup4
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pileup4_tiles(codes, spos, tlo, thi, isc, isg, *, ntiles: int, nch: int,
                  sat_bits: int, dst=None, out_width=None, qual=None,
                  min_phred: int = 0, chunk_rows=None):
    """Fused 12-count pileup + ``counts_to_channels`` (+ compaction) +
    narrowing.

    codes u8 [Nb, Lh] nibble-packed (nq mode, ``qual`` None) or [Nb, L] with
    qual u8 [Nb, L] (qual mode); spos i32 [Nb] = 2 * start + parity, starts
    not decreasing; tlo/thi i32 [ntiles] from ``host_prep.tile_rows``;
    isc/isg u8 [ntiles*T/8]; dst (optional) i32 [ntiles*T] mapping a column
    to its output slot or -1. Returns ``(out, overflow)``: out [nch,
    out_width] (default ntiles*T) of uint8/uint16/uint32 for sat_bits
    8/16/32, channels meth, unmeth, opposite depth, opposite variants (the
    first ``nch``), values clamped to the width; overflow int32 [1] set to 1
    when a value did not fit. ``chunk_rows`` (default: chosen from the row
    width) is the number of rows the kernel stages at a time. CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream."""
    W = ntiles * T
    if out_width is None:
        if dst is not None:
            raise ValueError("a compaction map needs out_width")
        out_width = W
    if sat_bits not in _OUT_DTYPES:
        raise ValueError(f"sat_bits must be 8, 16 or 32, not {sat_bits}")
    if nch not in (2, 4):
        raise ValueError(f"nch must be 2 or 4, not {nch}")
    if chunk_rows is not None and chunk_rows < 1:
        raise ValueError(f"chunk_rows must be at least 1, not {chunk_rows}")
    dev = codes.device
    if codes.dim() != 2 or codes.shape[1] < 1:
        raise ValueError("codes must be [Nb, Lh] or [Nb, L]")
    Nb, width = codes.shape
    _check("codes", codes, torch.uint8, dev, (Nb, width))
    if qual is not None:
        _check("qual", qual, torch.uint8, dev, (Nb, width))
    _check("spos", spos, torch.int32, dev, (Nb,))
    _check("tlo", tlo, torch.int32, dev, (ntiles,))
    _check("thi", thi, torch.int32, dev, (ntiles,))
    _check("isc", isc, torch.uint8, dev, (W // 8,))
    _check("isg", isg, torch.uint8, dev, (W // 8,))
    if dst is not None:
        _check("dst", dst, torch.int32, dev, (W,))
    if dev.type == "cpu":
        return pileup4_tiles_reference(
            codes, spos, tlo, thi, isc, isg, ntiles=ntiles, nch=nch,
            sat_bits=sat_bits, dst=dst, out_width=out_width, qual=qual,
            min_phred=min_phred)
    if dev.type != "cuda":
        raise ValueError(f"pileup4_tiles runs on cpu or cuda, not {dev}")
    nbytes = sat_bits // 8
    out = torch.zeros((nch, out_width * nbytes), dtype=torch.uint8,
                      device=dev).view(_OUT_DTYPES[sat_bits])
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    Lc = width * (2 if qual is None else 1)
    rc = _kernel_fn()(
        codes.data_ptr(), None if qual is None else qual.data_ptr(),
        spos.data_ptr(), tlo.data_ptr(), thi.data_ptr(), isc.data_ptr(),
        isg.data_ptr(), None if dst is None else dst.data_ptr(),
        out.data_ptr(), overflow.data_ptr(), ntiles, Nb, Lc, width,
        0 if chunk_rows is None else int(chunk_rows), W, out_width, nch,
        int(min_phred), sat_bits, stream)
    if rc != 0:
        raise RuntimeError(f"pileup4 kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES["nq" if qual is None else "qual"] += 1
    return out, overflow


def pileup_window(seq, qual, pos_rel, strand, ref_window, win_offset_rel, W,
                  min_phred=5, device="cuda"):
    """Qual-gated pileup of gapless reads over one window: uint32 [W, 4],
    equal to ``ops.semantics.pileup_channels``. Counterpart of
    ``pileup_pallas.pileup_pallas`` without its GMAX cap (it never returns
    None). ``seq``/``qual`` u8 [N, L], ``pos_rel`` the window-relative
    starts (any order), ``strand`` the rows' strand codes, the reference's
    index of window column i being ``i - win_offset_rel``. Runs on
    ``device``: the card by default, the CPU (the plain version) only when
    asked."""
    from ..parallel import host_prep as hp

    seq = np.asarray(seq, np.uint8)
    qual = np.asarray(qual, np.uint8)
    N, L = seq.shape
    wpad = hp.round_up(W, T)
    ntiles = wpad // T
    order, spos, tlo, thi = hp.window_tables(
        pos_rel, np.asarray(strand) & 1, ntiles, L)
    isc, isg = hp.ref_bits(np.asarray(ref_window, np.uint8),
                           int(win_offset_rel), wpad)
    dev = torch.device(device)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (seq[order], spos, tlo, thi, isc, isg, qual[order])]
    out, _ = pileup4_tiles(*args[:6], ntiles=ntiles, nch=4, sat_bits=32,
                           qual=args[6], min_phred=min_phred)
    return out.view(torch.uint8).cpu().numpy().view(np.uint32).T[:W].copy()
