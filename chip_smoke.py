#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. Device: the card's name and power limit; the kernels are built from
   ``methyldackel_tpu_torch/csrc`` with nvcc (build time printed).
2. Kernel against its plain PyTorch version on the card, at the shapes of
   the default extract's two group programs (candidate space and window
   space, 4 windows of 1 Mb at 30x-like depth): bit-equal (integer counts,
   tolerance 0) in u8, u16 and u32 outputs, plus an input built to overflow
   u8. Times are CUDA-event medians of 10 launches after warm-up.
3. The main path end to end: ``extract`` through the port
   (MDTPU_ENGINE=cuda, MDTPU_STEAL=0, so every window goes to the card) on
   a synthetic 2M-read WGBS input; its CpG bedGraph must be byte-identical
   to the reference CLI's exact host engine (MDTPU_ENGINE=host), the kernel
   must have launched and no window may have been routed to the host.
4. Side routes on a small input with indel and '=' reads: single-window
   dispatch, the window-space group, and CHG+CHH output; and a ~900x deep
   input whose counts overflow the u8 readback (u32 refetch, then u16).
   Each byte-identical to the host engine.

The last line is ``{"ok": true, "device": {...}}``; before it come the card
line and a JSON line with each kernel's launches, error and times. Nothing
here imports jax. Work files go to ``_chip_smoke_work/`` beside this script
and are removed at the end.
"""
from __future__ import annotations

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
    (max_abs_err, kernel ms, plain ms)."""
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
    for _ in range(2):  # warm-up
        pk.pileup2_tiles(*args, **kw8)
        pk.pileup2_tiles_reference(*args, **kw8)
    torch.cuda.synchronize()
    plain = cuda_ms(lambda: pk.pileup2_tiles_reference(*args, **kw8), REPS // 2)
    kern = cuda_ms(lambda: pk.pileup2_tiles(*args, **kw8), REPS)
    plain += cuda_ms(lambda: pk.pileup2_tiles_reference(*args, **kw8),
                     REPS - REPS // 2)
    k_ms, p_ms = float(np.median(kern)), float(np.median(plain))
    print(f"  {name}: rows {len(inp['shp'])} tiles {inp['ntiles']} K "
          f"{inp['K']} Lq {inp['seqpack'].shape[1]}: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms (median of {REPS}; {card_line()})",
          flush=True)
    return err, k_ms, p_ms


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


def run_host(args, cwd):
    """The reference CLI's exact host engine, in its own process."""
    env = dict(os.environ, MDTPU_ENGINE="host",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "methyldackel_tpu.cli",
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)\n")
        return 1
    # the port and its host modules; none of them may pull in jax
    from methyldackel_tpu.io import native
    from methyldackel_tpu_torch.ops import build
    from methyldackel_tpu_torch.ops import pileup as pk

    # ---- phase 1: device
    card = card_line()
    print(f"[1] card: {card}; torch.cuda.get_device_name: "
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; nvcc {build.nvcc_path()}; triton "
          f"installed: {importlib.util.find_spec('triton') is not None}; "
          f"native host library: {native.available()}", flush=True)
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    build.load(pk.SOURCE)
    print(f"[1] built {pk.SOURCE} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({build.library_path(pk.SOURCE)})", flush=True)

    # ---- phase 2: kernel against its plain version
    rng = np.random.default_rng(0)
    reads_per_window = 240_000
    wpad1 = 1_000_448  # round_up(chunkSize 1e6 + 16, 512)
    cslot = 187_648    # the CSLOT ladder's 3/16 bucket of wpad1
    P = 187_904
    print("[2] candidate-space group program (Kw=4, P=187904, Lc4=64)",
          flush=True)
    cand_in = group_inputs(rng, Kw=4, pitch=P, span=cslot, lo=0,
                           n_per=reads_per_window, Lq=16, LP=128,
                           ctx_slot=(P, cslot))
    e1, k1, p1 = kernel_vs_plain("candidate space", cand_in, compact=False)
    del cand_in
    print("[2] window-space group program (Kw=4, S=1000960, L=150)",
          flush=True)
    S = wpad1 + 512
    win_in = group_inputs(rng, Kw=4, pitch=S, span=wpad1, lo=-149,
                          n_per=reads_per_window, Lq=38, LP=256,
                          ctx_slot=(S, wpad1))
    e2, k2, p2 = kernel_vs_plain("window space", win_in, compact=True)
    del win_in
    overflow_case(rng)
    torch.cuda.empty_cache()

    # ---- phase 3: the main path end to end
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        from methyldackel_tpu.io.bai import build_bai
        from methyldackel_tpu.io.bam import BamFile
        from methyldackel_tpu.utils.simulate import write_synthetic_input

        t0 = time.perf_counter()
        fa, bam = write_synthetic_input(WORK, 1_000_000, 150, 1 << 23, seed=0)
        build_bai(BamFile(bam), bam + ".bai")
        print(f"[3] wrote 2,000,000 reads of 150 bp over 8 Mb in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for d in ("port", "host", "hostin"):
            os.makedirs(os.path.join(WORK, d))
        args = [fa, bam, "-o", "out"]
        cuda_env = {"MDTPU_ENGINE": "cuda", "MDTPU_STEAL": "0"}
        host_env = {"MDTPU_ENGINE": "host"}
        pk.LAUNCHES = 0
        t_cuda = [run_port(args, os.path.join(WORK, "port"), cuda_env)]
        launches = pk.LAUNCHES
        backend = t_cuda[0][1]
        # the exact host engine in this process too (same run_extract,
        # no backend), in turns with the port: cuda, host, host, cuda
        t_host = [run_port(args, os.path.join(WORK, "hostin"), host_env)
                  for _ in range(2)]
        t_cuda.append(run_port(args, os.path.join(WORK, "port"), cuda_env))
        dt_ref = run_host(args, os.path.join(WORK, "host"))
        same_outputs(os.path.join(WORK, "port"), os.path.join(WORK, "host"),
                     ["out_CpG.bedGraph"])
        same_outputs(os.path.join(WORK, "hostin"),
                     os.path.join(WORK, "host"), ["out_CpG.bedGraph"])
        rate = [2e6 / t for t, _ in t_cuda]
        hrate = [2e6 / t for t, _ in t_host]
        print(f"[3] default extract, 2,000,000 reads of 150 bp: port cuda "
              f"{rate[0]:,.0f} and {rate[1]:,.0f} reads/s "
              f"({t_cuda[0][0]:.2f} s, {t_cuda[1][0]:.2f} s; kernel launches "
              f"{launches}, host-routed windows {backend.host_routed}); host "
              f"engine in process {hrate[0]:,.0f} and {hrate[1]:,.0f} reads/s "
              f"({t_host[0][0]:.2f} s, {t_host[1][0]:.2f} s); reference CLI "
              f"process (MDTPU_ENGINE=host) {dt_ref:.2f} s = "
              f"{2e6 / dt_ref:,.0f} reads/s; out_CpG.bedGraph byte-identical "
              f"({card})", flush=True)
        if launches <= 0 or backend.host_routed != 0:
            raise AssertionError("the main path did not run on the card")

        # ---- phase 4: side routes
        side = os.path.join(WORK, "side")
        os.makedirs(side)
        side_input(side)
        # ~900x coverage: counts pass 255, so the u8 readback overflows, the
        # drain thread refetches the group in u32 and the run reads u16
        deep = os.path.join(WORK, "deep")
        os.makedirs(deep)
        write_synthetic_input(deep, 4000, 100, 1000, seed=5)
        routes = (
            ("single-window", side, {"MDTPU_BATCH_WINDOWS": "1"}, []),
            ("window-space group", side, {"MDTPU_CANDSPACE": "0"}, []),
            ("CHG+CHH", side, {}, ["--CHG", "--CHH"]),
            ("deep coverage", deep, {}, []),
        )
        for name, src, env, extra in routes:
            d_port = os.path.join(src, name.replace(" ", "_") + "_port")
            d_host = os.path.join(src, name.replace(" ", "_") + "_host")
            os.makedirs(d_port)
            os.makedirs(d_host)
            inputs = (["../g.fa", "../r.bam"] if src == side
                      else ["../sim.fa", "../sim.bam"])
            a = ["--chunkSize", "5000" if src == side else "300", *extra,
                 *inputs, "-o", "o"]
            before = pk.LAUNCHES
            _, be = run_port(a, d_port, {"MDTPU_ENGINE": "cuda",
                                         "MDTPU_STEAL": "0", **env})
            run_host(a, d_host)
            names = ["o_CpG.bedGraph"] + (
                ["o_CHG.bedGraph", "o_CHH.bedGraph"] if extra else [])
            same_outputs(d_port, d_host, names)
            n = pk.LAUNCHES - before
            print(f"[4] {name}: byte-identical to the host engine "
                  f"({', '.join(names)}; kernel launches {n}, host-routed "
                  f"{be.host_routed}, readback width u{be._sat_bits})",
                  flush=True)
            if n <= 0 or be.host_routed != 0:
                raise AssertionError(f"side route {name} missed the card")
            if src == deep and be._sat_bits != 16:
                raise AssertionError("deep coverage did not overflow u8")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(f"[5] pileup2_tiles ms (kernel / plain): candidate space "
          f"{k1:.4f} / {p1:.4f}, window space {k2:.4f} / {p2:.4f} "
          f"(the JSON line reports the candidate-space program, the main "
          f"path's)", flush=True)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m in ("methyldackel_tpu.parallel.device",
                             "methyldackel_tpu.ops.pileup_pallas"))
    if leaked:
        raise AssertionError(f"jax code was imported: {leaked}")

    print(json.dumps({"kernels": [{
        "name": "pileup2_tiles",
        "route": "cuda",
        "source": "methyldackel_tpu_torch/csrc/pileup2.cu",
        "replaces": "methyldackel_tpu/ops/pileup_pallas.py:279",
        "launches": launches,
        "max_abs_err": max(e1, e2),
        "ms": k1,
        "plain_ms": p1,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
