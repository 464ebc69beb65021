"""2-bit semantic pileup for the default extract path.

``pileup2_tiles`` launches ``csrc/pileup2.cu``, the Hopper port of
``methyldackel_tpu/ops/pileup_pallas.py:_kernel_nq2`` fused with the
epilogue of ``methyldackel_tpu/parallel/device.py:_fused_window_pregated2``
(the ``channels_nch2`` select, the optional candidate compaction and the
narrowing cast with its overflow flag). ``pileup2_tiles_reference`` is its
plain PyTorch version; the wrapper takes it only for tensors on the CPU.

Geometry: the column space is ``ntiles`` tiles of ``T = 512`` columns. Rows
are sorted by their start column and carry it: ``spos`` int32 [Nb] holds
``2 * start + parity`` (``host_prep.row_spos``), and ``tlo``/``thi`` int32
[ntiles] the row range that can reach each tile (``host_prep.tile_rows``,
which checks the order). A row's ``Lc = 4*Lq`` codes are packed four to a
byte in ``seqpack [Nb, Lq]``; code j lies on column ``start + j``. A tile
counts only its own columns, so a row listed by two tiles is counted once
per column.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .build import load

T = 512
SOURCE = "pileup2.cu"
# Incremented once per kernel launch (never for the plain version).
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_OUT_DTYPES = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}
_SIGNED = {8: torch.uint8, 16: torch.int16, 32: torch.int32}
_CAPS = {8: 0xFF, 16: 0xFFFF, 32: 0xFFFFFFFF}
_CHUNK_ELEMS = 1 << 24  # bounds the plain version's [rows, L4] temporaries


def unpack_bits(packed: torch.Tensor, W: int) -> torch.Tensor:
    """[ceil(W/8)] np.packbits (MSB-first) bytes -> bool [W]
    (``pileup_pallas.unpack_bits_device``)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:W] != 0


def channels_nch2(counts: torch.Tensor, isc: torch.Tensor, isg: torch.Tensor,
                  W: int) -> torch.Tensor:
    """Odd-strand counts at reference C, even-strand counts at reference G
    (``pileup_pallas.channels_nch2``): counts rows 0-3 are odd_meth,
    odd_unmeth, even_meth, even_unmeth -> int64 [2, W] (meth, unmeth)."""
    counts = counts[:4, :W].long()
    is_c = unpack_bits(isc, W)
    is_g = unpack_bits(isg, W)
    zero = torch.zeros((), dtype=torch.int64, device=counts.device)
    meth = torch.where(is_c, counts[0], torch.where(is_g, counts[2], zero))
    unmeth = torch.where(is_c, counts[1], torch.where(is_g, counts[3], zero))
    return torch.stack([meth, unmeth])


def pileup2_counts_reference(seqpack: torch.Tensor, spos: torch.Tensor,
                             tlo: torch.Tensor, thi: torch.Tensor, *,
                             ntiles: int) -> torch.Tensor:
    """Plain per-column counters: int32 [4, ntiles*T] (odd_meth, odd_unmeth,
    even_meth, even_unmeth), the values of
    ``pileup_pallas._pileup_tiles_nq2_interpret`` rows 0-3. Tile by tile
    like the kernel: each tile adds the codes of its rows [tlo[t], thi[t])
    that fall on its own columns."""
    dev = seqpack.device
    W = ntiles * T
    Lq = seqpack.shape[1]
    L4 = 4 * Lq
    counts = torch.zeros(4 * W, dtype=torch.int64, device=dev)
    cnt = (thi - tlo).long()
    total = int(cnt.sum())
    if total == 0:
        return counts.view(4, W).int()
    # one entry per (tile, row) listing; entry e of tile t is row
    # tlo[t] + (e - first[t])
    tid = torch.repeat_interleave(torch.arange(ntiles, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    lo_rows = tlo.long()
    j = torch.arange(L4, device=dev)
    step = max(1, _CHUNK_ELEMS // L4)
    for e0 in range(0, total, step):
        t = tid[e0 : e0 + step]
        e = torch.arange(e0, e0 + t.numel(), device=dev)
        r = lo_rows[t] + (e - first[t])
        s = spos[r].long()
        lo = t * T
        col = (s >> 1)[:, None] + j[None, :]
        codes = (seqpack[r].long()[:, j >> 2] >> (2 * (j & 3))[None, :]) & 3
        keep = ((col >= lo[:, None]) & (col < (lo + T)[:, None])
                & ((codes == 1) | (codes == 2)))
        chan = (2 * (1 - (s & 1)))[:, None] + (codes - 1)
        counts += torch.bincount((chan * W + col)[keep], minlength=4 * W)
    return counts.view(4, W).int()


def _narrow(values: torch.Tensor, sat_bits: int):
    """Clamp to the output width, flag overflow, store as u8/u16/u32."""
    cap = _CAPS[sat_bits]
    overflow = (values > cap).any().to(torch.int32).reshape(1)
    stored = values.clamp(max=cap).to(_SIGNED[sat_bits])
    return stored.view(_OUT_DTYPES[sat_bits]), overflow


def pileup2_tiles_reference(seqpack, spos, tlo, thi, isc, isg, *,
                            ntiles: int, sat_bits: int, dst=None,
                            out_width=None, chunk_rows=None, split=None):
    """Plain PyTorch version of ``pileup2_tiles`` (same arguments, same
    result; ``chunk_rows`` and ``split`` only shape the kernel's launch)."""
    W = ntiles * T
    counts = pileup2_counts_reference(seqpack, spos, tlo, thi, ntiles=ntiles)
    ch2 = channels_nch2(counts, isc, isg, W)
    if dst is not None:
        kept = dst >= 0
        sel = torch.zeros((2, out_width), dtype=torch.int64,
                          device=ch2.device)
        sel[:, dst[kept].long()] = ch2[:, kept]
        ch2 = sel
    return _narrow(ch2, sat_bits)


def _check(name, t, dtype, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _kernel_fn():
    fn = load(SOURCE).mdtpu_pileup2
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pileup2_tiles(seqpack, spos, tlo, thi, isc, isg, *, ntiles: int,
                  sat_bits: int, dst=None, out_width=None, chunk_rows=None,
                  split=None):
    """Fused 2-bit pileup + channel select (+ compaction) + narrowing.

    seqpack u8 [Nb, Lq]; spos i32 [Nb] = 2 * start + parity, starts not
    decreasing; tlo/thi i32 [ntiles] from ``host_prep.tile_rows``; isc/isg
    u8 [ntiles*T/8]; dst (optional) i32 [ntiles*T] mapping a column to its
    output slot or -1. Returns ``(out, overflow)``: out [2, out_width]
    (default ntiles*T) of uint8/uint16/uint32 for sat_bits 8/16/32 (meth,
    unmeth; values clamped to the width), overflow int32 [1] set to 1 when a
    value did not fit. ``chunk_rows`` (rows staged at a time) and ``split``
    (lanes that share sixteen columns: 1, 2, 4, 8, 16) default to the
    kernel's own choice from the row density. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream."""
    global LAUNCHES
    W = ntiles * T
    if out_width is None:
        if dst is not None:
            raise ValueError("a compaction map needs out_width")
        out_width = W
    if sat_bits not in _OUT_DTYPES:
        raise ValueError(f"sat_bits must be 8, 16 or 32, not {sat_bits}")
    for name, v in (("chunk_rows", chunk_rows), ("split", split)):
        if v is not None and v < 1:
            raise ValueError(f"{name} must be at least 1, not {v}")
    dev = seqpack.device
    if seqpack.dim() != 2 or seqpack.shape[1] < 1:
        raise ValueError("seqpack must be [Nb, Lq]")
    Nb, Lq = seqpack.shape
    _check("seqpack", seqpack, torch.uint8, dev, (Nb, Lq))
    _check("spos", spos, torch.int32, dev, (Nb,))
    _check("tlo", tlo, torch.int32, dev, (ntiles,))
    _check("thi", thi, torch.int32, dev, (ntiles,))
    _check("isc", isc, torch.uint8, dev, (W // 8,))
    _check("isg", isg, torch.uint8, dev, (W // 8,))
    if dst is not None:
        _check("dst", dst, torch.int32, dev, (W,))
    if dev.type == "cpu":
        return pileup2_tiles_reference(
            seqpack, spos, tlo, thi, isc, isg, ntiles=ntiles,
            sat_bits=sat_bits, dst=dst, out_width=out_width)
    if dev.type != "cuda":
        raise ValueError(f"pileup2_tiles runs on cpu or cuda, not {dev}")
    nbytes = sat_bits // 8
    # zeroed: the kernel stores only the columns that are C or G and kept
    out = torch.zeros((2, out_width * nbytes), dtype=torch.uint8,
                      device=dev).view(_OUT_DTYPES[sat_bits])
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn()(
        seqpack.data_ptr(), spos.data_ptr(), tlo.data_ptr(), thi.data_ptr(),
        isc.data_ptr(), isg.data_ptr(),
        None if dst is None else dst.data_ptr(), out.data_ptr(),
        overflow.data_ptr(), ntiles, Nb, Lq,
        0 if chunk_rows is None else int(chunk_rows), W, out_width, sat_bits,
        0 if split is None else int(split), stream)
    if rc != 0:
        raise RuntimeError(f"pileup2 kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out, overflow
