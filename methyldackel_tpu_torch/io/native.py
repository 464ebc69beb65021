"""Loader for the optional native (C++) ingest accelerators.

The hot host-side cost of this framework is BGZF inflation + BAM record
decode (the role htslib plays for the reference). csrc/ contains a small C++
library exposing a C ABI consumed here via ctypes. Everything degrades
gracefully to the pure-Python implementations when the library has not been
built.
"""
from __future__ import annotations

import ctypes
import os

_LIB = None
_TRIED = False
_NTHREADS = None  # None = os.cpu_count()


def set_threads(n) -> None:
    """Cap the native kernels' internal thread count. The engine sets this
    to cpu_count // n_workers under -@ worker pools: every kernel spawning
    cpu_count threads per call from every worker oversubscribes a small
    host catastrophically (measured: -@4 on 2 cores ran 4x SLOWER than
    -@2 before this cap)."""
    global _NTHREADS
    _NTHREADS = max(1, int(n)) if n else None


def _nthreads() -> int:
    if _NTHREADS is not None:
        return _NTHREADS
    return os.cpu_count() or 1


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "csrc", "build", "libmdtpu_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.mdtpu_bgzf_bound.restype = ctypes.c_int64
        lib.mdtpu_bgzf_bound.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.mdtpu_bgzf_decompress.restype = ctypes.c_int64
        lib.mdtpu_bgzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int,
        ]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.mdtpu_bam_scan.restype = ctypes.c_int
        lib.mdtpu_bam_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p, i64p,
        ]
        lib.mdtpu_bam_decode.restype = ctypes.c_int
        lib.mdtpu_bam_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int] + [
            ctypes.c_void_p
        ] * 19
        lib.mdtpu_pad_batch.restype = ctypes.c_int
        lib.mdtpu_pad_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.mdtpu_pileup.restype = ctypes.c_int
        lib.mdtpu_pileup.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.mdtpu_arbitrate.restype = ctypes.c_int64
        lib.mdtpu_arbitrate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.mdtpu_format_float_rows.restype = ctypes.c_int64
        lib.mdtpu_format_float_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.mdtpu_format_methylkit.restype = ctypes.c_int64
        lib.mdtpu_format_methylkit.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.mdtpu_format_cytosine.restype = ctypes.c_int64
        lib.mdtpu_format_cytosine.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.mdtpu_format_bedgraph.restype = ctypes.c_int64
        lib.mdtpu_format_bedgraph.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        try:  # newer symbols: optional so a stale artifact degrades softly
            lib.mdtpu_v3_flags.restype = ctypes.c_int
            lib.mdtpu_v3_flags.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int,
            ]
            lib.mdtpu_v3_pack.restype = ctypes.c_int
            lib.mdtpu_v3_pack.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,
            ]
            lib.mdtpu_v3_pack2.restype = ctypes.c_int
            lib.mdtpu_v3_pack2.argtypes = lib.mdtpu_v3_pack.argtypes
            lib._has_v3 = True
        except AttributeError:
            lib._has_v3 = False
        try:
            lib.mdtpu_v3_flags64.restype = ctypes.c_int
            lib.mdtpu_v3_flags64.argtypes = lib.mdtpu_v3_flags.argtypes
            lib.mdtpu_v3_refbits.restype = ctypes.c_int
            lib.mdtpu_v3_refbits.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.mdtpu_arbitrate64.restype = ctypes.c_int64
            lib.mdtpu_arbitrate64.argtypes = lib.mdtpu_arbitrate.argtypes
            lib.mdtpu_arbitrate2.restype = ctypes.c_int
            lib.mdtpu_arbitrate2_32.restype = ctypes.c_int
            lib.mdtpu_arbitrate2.argtypes = lib.mdtpu_arbitrate2_32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int,
            ]
            lib.mdtpu_pileup64.restype = ctypes.c_int
            lib.mdtpu_pileup64.argtypes = lib.mdtpu_pileup.argtypes
            lib.mdtpu_perread_pack.restype = ctypes.c_int
            lib.mdtpu_perread_pack.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.mdtpu_pair_mates.restype = ctypes.c_int64
            lib.mdtpu_pair_mates.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib._has_pair = True
            lib.mdtpu_mbias_pack.restype = ctypes.c_int
            lib.mdtpu_mbias_pack.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib._has_v3b = True
        except AttributeError:
            lib._has_v3b = False
        try:  # candidate-space group pack
            lib.mdtpu_v3_pack2_cand.restype = ctypes.c_int
            lib.mdtpu_v3_pack2_cand.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.mdtpu_v3_candidates.restype = ctypes.c_int64
            lib.mdtpu_v3_candidates.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib._has_v3c = True
        except AttributeError:
            lib._has_v3c = False
        _LIB = lib
    except (OSError, AttributeError) as exc:
        # The artifact exists but can't be loaded (missing runtime dep, ABI
        # mismatch, stale build). Warn once: silently dropping to the pure
        # Python paths is a large, invisible performance regression.
        import sys

        print(
            f"[methyldackel_tpu_torch] WARNING: native library {path} exists but "
            f"failed to load ({exc}); falling back to pure-Python kernels "
            f"(rebuild with `make -C csrc`)",
            file=sys.stderr,
        )
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def bgzf_decompress(data: bytes) -> bytes:
    lib = _load()
    bound = lib.mdtpu_bgzf_bound(data, len(data))
    if bound < 0:
        raise ValueError("malformed BGZF stream")
    out = ctypes.create_string_buffer(bound)
    n = lib.mdtpu_bgzf_decompress(data, len(data), out, bound, _nthreads())
    if n < 0:
        raise ValueError("BGZF inflation failed")
    return out.raw[:n]


def bam_decode(data: bytes, start: int):
    """Decode all records from `start` → dict of numpy SoA arrays, or None
    if the native decoder is unavailable/fails."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    bases = ctypes.c_int64()
    cigars = ctypes.c_int64()
    qnames = ctypes.c_int64()
    if lib.mdtpu_bam_scan(data, len(data), start, ctypes.byref(n),
                          ctypes.byref(bases), ctypes.byref(cigars),
                          ctypes.byref(qnames)) != 0:
        return None
    N, B, C, Q = n.value, bases.value, cigars.value, qnames.value
    out = {
        "flag": np.empty(N, np.uint16),
        "tid": np.empty(N, np.int32),
        "pos": np.empty(N, np.int64),
        "mapq": np.empty(N, np.uint8),
        "l_qseq": np.empty(N, np.int32),
        "endpos": np.empty(N, np.int64),
        "mtid": np.empty(N, np.int32),
        "mpos": np.empty(N, np.int64),
        "xg": np.empty(N, np.int8),
        "nh": np.empty(N, np.int32),
        "offsets": np.empty(N + 1, np.int64),
        "cigar_offsets": np.empty(N + 1, np.int64),
        "qname_offsets": np.empty(N + 1, np.int64),
        "record_offsets": np.empty(N + 1, np.int64),
        "seq_flat": np.empty(B, np.uint8),
        "qual_flat": np.empty(B, np.uint8),
        "refpos_flat": np.empty(B, np.int32),
        "cigar_flat": np.empty(C, np.uint32),
        "qname_blob": np.empty(Q, np.uint8),
    }

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_bam_decode(
        data, len(data), start, _nthreads(),
        ptr(out["flag"]), ptr(out["tid"]), ptr(out["pos"]), ptr(out["mapq"]),
        ptr(out["l_qseq"]), ptr(out["endpos"]), ptr(out["mtid"]),
        ptr(out["mpos"]), ptr(out["xg"]), ptr(out["nh"]),
        ptr(out["offsets"]), ptr(out["cigar_offsets"]),
        ptr(out["qname_offsets"]), ptr(out["record_offsets"]),
        ptr(out["seq_flat"]), ptr(out["qual_flat"]), ptr(out["refpos_flat"]),
        ptr(out["cigar_flat"]), ptr(out["qname_blob"]),
    )
    if rc != 0:
        return None
    return out


def pad_batch(offsets, idx, seq_flat, qual_flat, refpos_flat, L):
    """Ragged→padded [N, L] batch via the native row-memcpy kernel, or None
    if the library isn't built. Arrays must be contiguous with the decoder's
    dtypes (offsets/idx int64, seq/qual uint8, refpos int32)."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, np.int64)
    n = len(idx)
    seq = np.empty((n, L), np.uint8)
    qual = np.empty((n, L), np.uint8)
    refpos = np.empty((n, L), np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_pad_batch(ptr(offsets), ptr(idx), n, L, ptr(seq_flat),
                             ptr(qual_flat), ptr(refpos_flat), ptr(seq),
                             ptr(qual), ptr(refpos), _nthreads())
    if rc != 0:
        return None
    return seq, qual, refpos


def format_bedgraph(chrom: str, start, end, val, nm=None, nu=None):
    """Concatenated "chrom\\tstart\\tend\\tval[\\tnm\\tnu]\\n" rows (the
    writeCall integer layouts, extract.c:48-63) via the native formatter.
    Returns a str, or None if the library isn't built. All columns must be
    int64 arrays of equal length; nm/nu omitted = the --counts layout."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    if (nm is None) != (nu is None):
        raise ValueError("format_bedgraph: nm and nu must both be given "
                         "or both be None")
    start = np.ascontiguousarray(start, np.int64)
    end = np.ascontiguousarray(end, np.int64)
    val = np.ascontiguousarray(val, np.int64)
    n = len(start)
    cb = chrom.encode()
    cap = n * (len(cb) + 6 + 5 * 20) + 1
    out = np.empty(cap, np.uint8)  # no memset (create_string_buffer zeroes)

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    if nm is not None:
        nm = np.ascontiguousarray(nm, np.int64)
        nu = np.ascontiguousarray(nu, np.int64)
    w = lib.mdtpu_format_bedgraph(cb, len(cb), ptr(start), ptr(end),
                                  ptr(val), ptr(nm), ptr(nu), n,
                                  out.ctypes.data_as(ctypes.c_char_p), cap)
    if w < 0:
        return None
    return out[:w].tobytes().decode("ascii")


def pileup_channels(seq, qual, refpos, strand_arr, keep_base, ref_window,
                    win_offset, win_start, win_end, min_phred):
    """Fused native pileup, bit-equal to ops/semantics.pileup_channels
    (parity-tested). Returns uint32 [W, 4], or None if the library isn't
    built / inputs need the numpy path."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    n, l = seq.shape
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    if (refpos.dtype == np.int64 and refpos.flags.c_contiguous
            and getattr(lib, "_has_v3b", False)):
        entry = lib.mdtpu_pileup64  # no 70 MB astype for decoder output
    else:
        refpos = np.ascontiguousarray(refpos, np.int32)
        entry = lib.mdtpu_pileup
    strand = np.ascontiguousarray(strand_arr, np.int32)
    ref_window = np.ascontiguousarray(ref_window, np.uint8)
    kb = None
    if keep_base is not None and not keep_base.all():
        kb = np.ascontiguousarray(keep_base, np.uint8)
    W = win_end - win_start
    counters = np.zeros((W, 4), np.uint32)

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    rc = entry(ptr(seq), ptr(qual), ptr(refpos), ptr(strand),
               ptr(kb), n, l, ptr(ref_window), len(ref_window),
               win_offset, win_start, win_end, int(min_phred),
               ptr(counters), _nthreads())
    if rc != 0:
        return None
    return counters


def arbitrate(seq, qual, refpos, strand_arr, a_idx, b_idx):
    """Native mate-overlap arbitration for gapless pairs (bit-equal to the
    semantics oracle; parity-tested). Mutates qual in place. Returns the
    indices (into a_idx/b_idx) of pairs needing the exact per-pair Python
    path, or None if the library isn't built / inputs are unsupported."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    if not (seq.flags.c_contiguous and qual.flags.c_contiguous
            and seq.dtype == np.uint8 and qual.dtype == np.uint8):
        return None
    if (refpos.dtype == np.int64 and refpos.flags.c_contiguous
            and getattr(lib, "_has_v3b", False)):
        entry = lib.mdtpu_arbitrate64  # no 70 MB astype for decoder output
    else:
        refpos = np.ascontiguousarray(refpos, np.int32)
        entry = lib.mdtpu_arbitrate
    strand = np.ascontiguousarray(strand_arr, np.int32)
    a_idx = np.ascontiguousarray(a_idx, np.int64)
    b_idx = np.ascontiguousarray(b_idx, np.int64)
    p = len(a_idx)
    fb = np.empty(p, np.int64)
    n, l = seq.shape

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    nfb = entry(ptr(seq), ptr(qual), ptr(refpos), ptr(strand),
                n, l, ptr(a_idx), ptr(b_idx), p, ptr(fb))
    if nfb < 0:
        return None
    return fb[:nfb]


def pair_mates(qname_hash, flag, blob, off, parent_idx):
    """Exact dict-semantics mate pairing (overlaps.c:121-139) with inline
    byte-exact name comparison (hash collisions handled like the khash, no
    fallback). Returns (a_idx, b_idx) local row indices in pop order, or
    None if the library isn't built."""
    import numpy as np

    lib = _load()
    if lib is None or not getattr(lib, "_has_pair", False):
        return None
    qname_hash = np.ascontiguousarray(qname_hash, np.uint64)
    flag = np.ascontiguousarray(flag, np.uint16)
    off = np.ascontiguousarray(off, np.int64)
    parent_idx = np.ascontiguousarray(parent_idx, np.int64)
    blob = np.ascontiguousarray(np.frombuffer(blob, np.uint8)
                                if isinstance(blob, (bytes, bytearray))
                                else blob, np.uint8)
    nk = len(qname_hash)
    out_a = np.empty(nk // 2 + 1, np.int64)
    out_b = np.empty(nk // 2 + 1, np.int64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    np_pairs = lib.mdtpu_pair_mates(ptr(qname_hash), ptr(flag), ptr(blob),
                                    ptr(off), ptr(parent_idx), nk,
                                    ptr(out_a), ptr(out_b))
    if np_pairs < 0:
        return None
    return out_a[:np_pairs].copy(), out_b[:np_pairs].copy()


def arbitrate2(seq, qual, refpos, strand_arr, lq, simple, a_idx, b_idx):
    """Threaded arbitration with caller-provided gapless flags (skips the
    per-row refpos scans for simple pairs). Mutates qual in place. Returns
    the fallback pair indices, or None when unsupported."""
    import numpy as np

    lib = _load()
    if lib is None or not getattr(lib, "_has_v3b", False):
        return None
    if not (seq.flags.c_contiguous and qual.flags.c_contiguous
            and seq.dtype == np.uint8 and qual.dtype == np.uint8
            and refpos.flags.c_contiguous):
        return None
    if refpos.dtype == np.int64:
        entry = lib.mdtpu_arbitrate2
    elif refpos.dtype == np.int32:
        entry = lib.mdtpu_arbitrate2_32
    else:
        return None
    strand = np.ascontiguousarray(strand_arr, np.int32)
    lq = np.ascontiguousarray(lq, np.int32)
    simple = np.ascontiguousarray(simple, np.uint8)
    a_idx = np.ascontiguousarray(a_idx, np.int64)
    b_idx = np.ascontiguousarray(b_idx, np.int64)
    p = len(a_idx)
    fb = np.zeros(p, np.uint8)
    n, l = seq.shape

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = entry(ptr(seq), ptr(qual), ptr(refpos), ptr(strand),
               ptr(lq), ptr(simple), n, l, ptr(a_idx),
               ptr(b_idx), p, ptr(fb), _nthreads())
    if rc != 0:
        return None
    return np.nonzero(fb)[0]


def v3_flags(seq, refpos, pos, lq):
    """Fused gapless + no-'=' row eligibility (the v3 fast-path split), or
    None if the library isn't built. Arrays must be the decoder's dtypes
    (seq uint8 [N,L] C-contiguous, refpos int32 [N,L], pos int64, lq
    int32)."""
    import numpy as np
    import os

    lib = _load()
    if lib is None or not lib._has_v3:
        return None
    if not (seq.flags.c_contiguous and seq.dtype == np.uint8
            and refpos.flags.c_contiguous):
        return None
    if refpos.dtype == np.int64 and getattr(lib, "_has_v3b", False):
        entry = lib.mdtpu_v3_flags64
    elif refpos.dtype == np.int32:
        entry = lib.mdtpu_v3_flags
    elif refpos.dtype == np.int64:
        refpos = np.ascontiguousarray(refpos, np.int32)
        entry = lib.mdtpu_v3_flags
    else:
        return None
    pos = np.ascontiguousarray(pos, np.int64)
    lq = np.ascontiguousarray(lq, np.int32)
    n, L = seq.shape
    out = np.empty(n, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = entry(ptr(seq), ptr(refpos), ptr(pos), ptr(lq), n, L,
               ptr(out), _nthreads())
    if rc != 0:
        return None
    return out.astype(bool)


def v3_refbits(ref_p, woff_rel, wpad):
    """Packed (MSB-first, np.packbits-compatible) candidate bitmaps for the
    v3 2-bit program: returns (bits_c, bits_g) u8 [wpad//8] where bit i
    says window position i has ref base C / G after the woff_rel frame
    shift. None if the library isn't built."""
    import numpy as np

    lib = _load()
    if lib is None or not getattr(lib, "_has_v3b", False) or wpad % 8:
        return None
    ref_p = np.ascontiguousarray(ref_p, np.uint8)
    out_c = np.empty(wpad // 8, np.uint8)
    out_g = np.empty(wpad // 8, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_v3_refbits(ptr(ref_p), len(ref_p), int(woff_rel),
                              int(wpad), ptr(out_c), ptr(out_g))
    if rc != 0:
        return None
    return out_c, out_g


def v3_pack(seq, qual, src_rows, pos, strand, Lh, nf_cap, win_start,
            min_phred):
    """Fused gather + phred pre-gate + nibble pack into the v3 upload
    layout: (seqpack [nf_cap, Lh] u8, pos_p int32 [nf_cap], parity_p u8
    [nf_cap]) with rows >= len(src_rows) zero-padded. Returns None if the
    library isn't built / inputs are unsupported."""
    import numpy as np
    import os

    lib = _load()
    if lib is None or not lib._has_v3:
        return None
    if not (seq.flags.c_contiguous and seq.dtype == np.uint8
            and qual.flags.c_contiguous and qual.dtype == np.uint8):
        return None
    src_rows = np.ascontiguousarray(src_rows, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    strand = np.ascontiguousarray(strand, np.int32)
    n, L = seq.shape
    nf = len(src_rows)
    seqpack = np.zeros((nf_cap, Lh), np.uint8)
    pos_p = np.zeros(nf_cap, np.int32)
    parity_p = np.zeros(nf_cap, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_v3_pack(ptr(seq), ptr(qual), ptr(src_rows), ptr(pos),
                           ptr(strand), nf, L, Lh, win_start, int(min_phred),
                           ptr(seqpack), ptr(pos_p), ptr(parity_p),
                           _nthreads())
    if rc != 0:
        return None
    return seqpack, pos_p, parity_p


def v3_pack2(seq, qual, src_rows, pos, strand, Lq, nf_cap, win_start,
             min_phred, out=None):
    """Fused gather + phred pre-gate + SEMANTIC 2-bit pack (meth=1,
    unmeth=2 per the row's strand parity; 4 codes/byte) into the v3 NCH=2
    upload layout. Returns (seqpack2 [nf_cap, Lq] u8, pos_p int32,
    parity_p u8) or None. `out` = caller-provided (seqpack, pos_p,
    parity_p) C-contiguous destination views (the K-window batched
    dispatch packs each window straight into its row slice of the group
    upload buffer)."""
    import numpy as np
    import os

    lib = _load()
    if lib is None or not lib._has_v3:
        return None
    if not (seq.flags.c_contiguous and seq.dtype == np.uint8
            and qual.flags.c_contiguous and qual.dtype == np.uint8):
        return None
    src_rows = np.ascontiguousarray(src_rows, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    strand = np.ascontiguousarray(strand, np.int32)
    n, L = seq.shape
    nf = len(src_rows)
    if out is not None:
        seqpack, pos_p, parity_p = out
        assert seqpack.flags.c_contiguous and len(seqpack) == nf_cap
        assert pos_p.flags.c_contiguous and parity_p.flags.c_contiguous
    else:
        seqpack = np.zeros((nf_cap, Lq), np.uint8)
        pos_p = np.zeros(nf_cap, np.int32)
        parity_p = np.zeros(nf_cap, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_v3_pack2(ptr(seq), ptr(qual), ptr(src_rows), ptr(pos),
                            ptr(strand), nf, L, Lq, win_start,
                            int(min_phred), ptr(seqpack), ptr(pos_p),
                            ptr(parity_p), _nthreads())
    if rc != 0:
        return None
    return seqpack, pos_p, parity_p


def v3_pack2_cand(seq, qual, src_rows, pos, strand, Lq, win_start,
                  min_phred, cand, csum, wpad, slot0, out):
    """Candidate-space SEMANTIC 2-bit pack (csrc mdtpu_v3_pack2_cand):
    row r's candidate slots [csum[fp0], csum[fp1]) get the read's 2-bit
    codes at the candidate reference offsets; pos_p gets the global slot
    coordinate csum[fp0] + slot0. `out` = (seqpack [*, Lq] u8, pos_p i32,
    parity_p u8) zero-initialized C-contiguous destination views. Returns
    True on success, None if the library isn't built (caller falls back
    to the numpy twin)."""
    import numpy as np

    lib = _load()
    if lib is None or not getattr(lib, "_has_v3c", False):
        return None
    if not (seq.flags.c_contiguous and seq.dtype == np.uint8
            and qual.flags.c_contiguous and qual.dtype == np.uint8):
        return None
    src_rows = np.ascontiguousarray(src_rows, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    strand = np.ascontiguousarray(strand, np.int32)
    cand = np.ascontiguousarray(cand, np.int64)
    csum = np.ascontiguousarray(csum, np.int32)
    n, L = seq.shape
    nf = len(src_rows)
    seqpack, pos_p, parity_p = out
    assert seqpack.flags.c_contiguous and seqpack.shape[1] == Lq
    assert pos_p.flags.c_contiguous and parity_p.flags.c_contiguous
    assert len(csum) == wpad + 1

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_v3_pack2_cand(
        ptr(seq), ptr(qual), ptr(src_rows), ptr(pos), ptr(strand), nf, L,
        Lq, win_start, int(min_phred), ptr(cand), ptr(csum), int(wpad),
        int(slot0), ptr(seqpack), ptr(pos_p), ptr(parity_p), _nthreads())
    if rc != 0:
        return None
    return True


def v3_candidates(isc, isg, wpad, ctx):
    """Candidate mask + prefix sums + index list (csrc
    mdtpu_v3_candidates; _ctx_mask_np twin for period == data == wpad).
    Returns (cand int64 [C], csum int32 [wpad+1]) or None if the library
    isn't built."""
    import numpy as np

    lib = _load()
    if lib is None or not getattr(lib, "_has_v3c", False) or wpad % 8:
        return None
    isc = np.ascontiguousarray(isc, np.uint8)
    isg = np.ascontiguousarray(isg, np.uint8)
    cand = np.empty(wpad, np.int64)
    csum = np.empty(wpad + 1, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    c = lib.mdtpu_v3_candidates(ptr(isc), ptr(isg), int(wpad), int(ctx),
                                ptr(cand), ptr(csum))
    if c < 0:
        return None
    return cand[:c], csum


def perread_pack(seq, qual, src_rows, pos, lq, strand, dirv, seq_start,
                 seq_len, Lq, nf_cap, min_phred):
    """Fused perRead tally-code pack (csrc mdtpu_perread_pack): returns
    (seqpack [nf_cap, Lq] u8 2-bit codes, haslow u8 [nf]) or None."""
    import numpy as np

    lib = _load()
    if lib is None or not getattr(lib, "_has_v3b", False):
        return None
    if not (seq.flags.c_contiguous and seq.dtype == np.uint8
            and qual.flags.c_contiguous and qual.dtype == np.uint8):
        return None
    src_rows = np.ascontiguousarray(src_rows, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    lq = np.ascontiguousarray(lq, np.int32)
    strand = np.ascontiguousarray(strand, np.int32)
    dirv = np.ascontiguousarray(dirv, np.int8)
    n, L = seq.shape
    nf = len(src_rows)
    seqpack = np.zeros((nf_cap, Lq), np.uint8)
    haslow = np.zeros(nf, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_perread_pack(ptr(seq), ptr(qual), ptr(src_rows), ptr(pos),
                                ptr(lq), ptr(strand), ptr(dirv),
                                int(seq_len), int(seq_start), nf, L, Lq,
                                int(min_phred), ptr(seqpack), ptr(haslow),
                                _nthreads())
    if rc != 0:
        return None
    return seqpack, haslow


def mbias_pack(seq, qual, src_rows, pos, lq, strand, flag, ok_odd, ok_even,
               win_offset, win_start, win_end, Lq, nf_cap, min_phred):
    """Fused mbias code pack (csrc mdtpu_mbias_pack): returns
    (seqpack [nf_cap, Lq] u8 2-bit codes, combo u8 [nf_cap]) or None."""
    import numpy as np

    lib = _load()
    if lib is None or not getattr(lib, "_has_v3b", False):
        return None
    if not (seq.flags.c_contiguous and seq.dtype == np.uint8
            and qual.flags.c_contiguous and qual.dtype == np.uint8):
        return None
    src_rows = np.ascontiguousarray(src_rows, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    lq = np.ascontiguousarray(lq, np.int32)
    strand = np.ascontiguousarray(strand, np.int32)
    flag = np.ascontiguousarray(flag, np.uint16)
    ok_odd = np.ascontiguousarray(ok_odd, np.uint8)
    ok_even = np.ascontiguousarray(ok_even, np.uint8)
    n, L = seq.shape
    nf = len(src_rows)
    seqpack = np.zeros((nf_cap, Lq), np.uint8)
    combo = np.zeros(nf_cap, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.mdtpu_mbias_pack(ptr(seq), ptr(qual), ptr(src_rows), ptr(pos),
                              ptr(lq), ptr(strand), ptr(flag), ptr(ok_odd),
                              ptr(ok_even), len(ok_odd), int(win_offset),
                              int(win_start), int(win_end), nf, L, Lq,
                              int(min_phred), ptr(seqpack), ptr(combo),
                              _nthreads())
    if rc != 0:
        return None
    return seqpack, combo


def format_cytosine(chrom: str, pos, direction, nm, nu, ctype, tnc_idx):
    """Concatenated cytosine-report rows (writeCall's cytosine_report
    branch, extract.c:93-98). direction: +1 → '+', else '-'; ctype indexes
    {CG, CHG, CHH}; tnc_idx the 25-entry trinucleotide table. Returns a
    str, or None if the library isn't built."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.int64)
    direction = np.ascontiguousarray(direction, np.int8)
    nm = np.ascontiguousarray(nm, np.int64)
    nu = np.ascontiguousarray(nu, np.int64)
    ctype = np.ascontiguousarray(ctype, np.int8)
    tnc_idx = np.ascontiguousarray(tnc_idx, np.int8)
    n = len(pos)
    cb = chrom.encode()
    cap = n * (len(cb) + 7 + 3 * 20 + 7) + 1
    out = np.empty(cap, np.uint8)  # no memset

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    w = lib.mdtpu_format_cytosine(cb, len(cb), ptr(pos), ptr(direction),
                                  ptr(nm), ptr(nu), ptr(ctype), ptr(tnc_idx),
                                  n, out.ctypes.data_as(ctypes.c_char_p), cap)
    if w < 0:
        return None
    return out[:w].tobytes().decode("ascii")


def format_float_rows(chrom: str, start, end, val):
    """Concatenated "chrom\\tstart\\tend\\t%f\\n" rows (--fraction/--logit
    layouts, extract.c:57-67); val is float64 (±inf allowed). Returns a
    str, or None if the library isn't built."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    start = np.ascontiguousarray(start, np.int64)
    end = np.ascontiguousarray(end, np.int64)
    val = np.ascontiguousarray(val, np.float64)
    n = len(start)
    cb = chrom.encode()
    cap = n * (len(cb) + 4 + 2 * 20 + 348) + 1
    out = np.empty(cap, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    w = lib.mdtpu_format_float_rows(cb, len(cb), ptr(start), ptr(end),
                                    ptr(val), n,
                                    out.ctypes.data_as(ctypes.c_char_p), cap)
    if w < 0:
        return None
    return out[:w].tobytes().decode("ascii")


def format_methylkit(chrom: str, pos1, strand_f, nm, nu):
    """Concatenated methylKit rows (writeCall's methylKit branch,
    extract.c:68-92). strand_f nonzero → 'F'. Returns a str, or None if
    the library isn't built."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    pos1 = np.ascontiguousarray(pos1, np.int64)
    strand_f = np.ascontiguousarray(strand_f, np.uint8)
    nm = np.ascontiguousarray(nm, np.int64)
    nu = np.ascontiguousarray(nu, np.int64)
    n = len(pos1)
    cb = chrom.encode()
    cap = n * (2 * len(cb) + 8 + 3 * 20 + 2 * 32) + 1
    out = np.empty(cap, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    w = lib.mdtpu_format_methylkit(cb, len(cb), ptr(pos1), ptr(strand_f),
                                   ptr(nm), ptr(nu), n,
                                   out.ctypes.data_as(ctypes.c_char_p), cap)
    if w < 0:
        return None
    return out[:w].tobytes().decode("ascii")
