"""Mate-overlap quality arbitration of the ``MDTPU_FUSED=v2`` window program.

``arbitrate`` launches ``csrc/arbitrate.cu``, the Hopper port of
``methyldackel_tpu/ops/arbitrate_pallas.py:_arb_kernel`` with the row gather
and the ``final_src`` take around it
(``methyldackel_tpu/parallel/device.py:_fused_fast_window``): it rewrites the
quals of both mates of every eligible pair in place, in the array the
qual-gated pileup (``ops.pileup4``, qual mode) then reads.
``arbitrate_reference`` is its plain PyTorch version; the wrapper takes it
only for tensors on the CPU.

Rows are unshifted ``[Nb, L]`` and carry their start: ``spos`` int32 [Nb]
holds ``2 * start + parity`` (``host_prep.row_spos``, the table the pileup
reads too). Pair p's mates are rows ``pa[p]`` and ``pb[p]``; the host lists
only the pairs to arbitrate and fixes the roles
(``host_prep.v2_pair_tables``): b wins a qual tie on the same base. Base i
of a faces base ``i - d`` of b, ``d = start_b - start_a`` (negative when b
starts left of a). A read is in at most one pair.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .build import load
from .pileup import _check

SOURCE = "arbitrate.cu"
# Incremented once per kernel launch (never for the plain version).
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
BASE_N = 15
_CHUNK_ELEMS = 1 << 22


def _boost(q):
    """floor(1.2 q) through the C's u8 store (overlaps.c)."""
    return (q + q // 5) & 0xFF


def arbitrate_reference(seq, qual, spos, pa, pb):
    """Plain PyTorch version of ``arbitrate`` (same arguments; rewrites
    ``qual`` in place and returns it). Mirrors ``_arb_kernel`` and its XLA
    twin ``device.arbitrate_prealigned`` on the shared positions."""
    L = seq.shape[1]
    if pa.numel() == 0 or L == 0:
        return qual
    i = torch.arange(L, device=seq.device)
    step = max(1, _CHUNK_ELEMS // L)
    for p0 in range(0, pa.numel(), step):
        a = pa[p0 : p0 + step].long()
        b = pb[p0 : p0 + step].long()
        d = (spos[b].long() >> 1) - (spos[a].long() >> 1)
        j = i[None, :] - d[:, None]
        inb = (j >= 0) & (j < L)
        jc = j.clamp(0, L - 1)
        rb = b[:, None].expand_as(jc)
        ba = seq[a].long() & 15
        bb = seq[rb, jc].long() & 15
        qa = qual[a].long()
        qb = qual[rb, jc].long()
        has = inb & (ba != 0) & (bb != 0)
        differ = ba != bb
        awins_d = differ & (qa > qb) & (ba != BASE_N)
        bwins_d = differ & ~awins_d & (qb > qa) & (bb != BASE_N)
        awins_s = ~differ & (qa > qb)
        bwins_s = ~differ & ~awins_s
        zero = torch.zeros_like(qa)
        na = torch.where(awins_d, qa - qb,
                         torch.where(awins_s, _boost(qa), zero))
        nb = torch.where(bwins_d, qb - qa,
                         torch.where(bwins_s, _boost(qb), zero))
        qual[a] = torch.where(has, na, qa).to(torch.uint8)
        qual[rb[has], jc[has]] = nb[has].to(torch.uint8)
    return qual


def _kernel_fn():
    fn = load(SOURCE).mdtpu_arbitrate
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def arbitrate(seq, qual, spos, pa, pb):
    """Arbitrate the mate overlaps of the pairs (pa, pb) in place.

    seq/qual u8 [Nb, L], spos i32 [Nb] = 2 * start + parity, pa/pb i32 [P].
    Returns ``qual``. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    global LAUNCHES
    dev = seq.device
    if seq.dim() != 2:
        raise ValueError("seq must be [Nb, L]")
    Nb, L = seq.shape
    P = pa.shape[0] if pa.dim() == 1 else -1
    _check("seq", seq, torch.uint8, dev, (Nb, L))
    _check("qual", qual, torch.uint8, dev, (Nb, L))
    _check("spos", spos, torch.int32, dev, (Nb,))
    _check("pa", pa, torch.int32, dev, (P,))
    _check("pb", pb, torch.int32, dev, (P,))
    if dev.type == "cpu":
        return arbitrate_reference(seq, qual, spos, pa, pb)
    if dev.type != "cuda":
        raise ValueError(f"arbitrate runs on cpu or cuda, not {dev}")
    if P == 0 or L == 0:
        return qual  # nothing to launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn()(seq.data_ptr(), qual.data_ptr(), spos.data_ptr(),
                      pa.data_ptr(), pb.data_ptr(), P, L, stream)
    if rc != 0:
        raise RuntimeError(f"arbitrate kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return qual
