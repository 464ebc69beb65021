"""The port's own host stack (its copies of config, io, ops.semantics,
engine.{extract,formats,scheduler,merge_context}, utils.simulate and its
CLI) against the JAX package's on the CPU: the same numpy inputs made from a
seed (or the same tests/util_bam.py files) go through both, and every array,
byte and file must be equal (integers and bytes, tolerance 0)."""
import copy
import dataclasses
import os

import numpy as np
import pytest

from methyldackel_tpu import cli as jcli
from methyldackel_tpu.engine import extract as jextract
from methyldackel_tpu.io import bai as jbai
from methyldackel_tpu.io import bam as jbam
from methyldackel_tpu.io import bed as jbed
from methyldackel_tpu.io import fasta as jfasta
from methyldackel_tpu.ops import semantics as jsem
from methyldackel_tpu.utils import simulate as jsim
from methyldackel_tpu_torch import cli as pcli
from methyldackel_tpu_torch.engine import extract as pextract
from methyldackel_tpu_torch.io import bai as pbai
from methyldackel_tpu_torch.io import bam as pbam
from methyldackel_tpu_torch.io import bed as pbed
from methyldackel_tpu_torch.io import fasta as pfasta
from methyldackel_tpu_torch.ops import semantics as psem
from methyldackel_tpu_torch.utils import simulate as psim

from test_fused_v3 import _mix_batch
from test_synthetic_e2e import write_fa
from test_torch_convert import port_batch, port_config
from util_bam import write_bam


def _same(a, b, what=""):
    """Equal results, array for array (tuples and None allowed)."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{k}]")
    elif a is None:
        assert b is None, what
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, what
        np.testing.assert_array_equal(x, y, err_msg=what)


def _batch(seed, n_fast=120, n_slow=24):
    """A seeded batch of pairs with indel reads, '=' bases and an XG-tagged
    read, sorted by position, and its reference."""
    rng = np.random.default_rng(seed)
    ref_ascii, ref_codes = jsim.random_reference(rng, 4000)
    batch = _mix_batch(rng, ref_codes, n_fast=n_fast, n_slow=n_slow)
    batch.seq[3, 5:9] = 0
    batch.xg[7] = 2
    return ref_ascii, batch


# ------------------------------------------------------------ ops.semantics

def _case_strand(sem, ref, b):
    return sem.strand(b.flag, b.xg)


def _case_context(sem, ref, b):
    return sem.classify_context(ref)


def _case_pairing(sem, ref, b):
    kidx = np.arange(b.n)
    a, c = sem.pair_mates_batch(b, kidx)
    return (a, c, *sem.touching_pairs(b.pos, b.endpos, a, c),
            *sem.pair_mates(b.qname, b.flag))


def _case_arbitrate(sem, ref, b):
    st = sem.strand(b.flag, b.xg)
    a, c = sem.pair_mates_batch(b, np.arange(b.n))
    a, c = sem.touching_pairs(b.pos, b.endpos, a, c)
    qual = b.qual.copy()
    sem.arbitrate_overlaps(b.seq, qual, b.refpos, st, a, c)
    loop = b.qual.copy()
    sem._arbitrate_pairs_loop(b.seq, loop, b.refpos, st, a, c)
    assert (qual != b.qual).sum() > 100
    return qual, loop


def _case_pileup(sem, ref, b):
    st = sem.strand(b.flag, b.xg)
    keep = np.ones(b.seq.shape, bool)
    keep[::7, ::3] = False
    full = sem.pileup_channels(b.seq, b.qual, b.refpos, st,
                               np.ones(b.seq.shape, bool), ref, 0, 0, 4000, 5)
    part = sem.pileup_channels(b.seq, b.qual, b.refpos, st, keep, ref[100:],
                               100, 512, 2560, 20)
    assert full[:, 2].sum() > 1000
    return full, part


def _case_filter_and_trim(sem, ref, b):
    cfg = type(b).__module__.startswith("methyldackel_tpu_torch")
    from methyldackel_tpu import config as jc
    from methyldackel_tpu_torch import config as pc

    c = (pc if cfg else jc).Config()
    c.minMapq, c.keepDiscordant = 20, 1
    c.bounds[0], c.bounds[1], c.absoluteBounds[6] = 3, 90, 4
    st = sem.strand(b.flag, b.xg)
    b = copy.deepcopy(b)
    b.mapq[::5] = 3
    b.flag[2] |= 0x400
    keep, flag = sem.filter_reads(c, b, st)
    seq, qual = b.seq.copy(), b.qual.copy()
    sem.trim_alignment(seq, qual, b.l_qseq, st, b.flag, c.bounds)
    sem.trim_absolute(seq, qual, b.l_qseq, st, b.flag, c.absoluteBounds)
    return keep, flag, seq, qual


def _case_meth_state_and_efficiency(sem, ref, b):
    st = sem.strand(b.flag, b.xg)
    return (sem.meth_state(b.seq, b.qual, st, 10),
            *np.atleast_1d(sem.conversion_efficiency(
                b.seq, b.qual, b.refpos, st, ref, 0, 5)))


def _case_mbias(sem, ref, b):
    st = sem.strand(b.flag, b.xg)
    return sem.mbias_counters(
        b.seq, b.qual, b.refpos, st, b.flag, np.ones(b.seq.shape, bool), ref,
        0, 0, 4000, (1, 1, 0), 5, b.seq.shape[1])


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("case", [
    _case_strand, _case_context, _case_pairing, _case_arbitrate, _case_pileup,
    _case_filter_and_trim, _case_meth_state_and_efficiency, _case_mbias])
def test_semantics_copy_equals_jax_package(case, seed):
    ref, batch = _batch(seed)
    want = case(jsem, ref, copy.deepcopy(batch))
    got = case(psem, ref, port_batch(copy.deepcopy(batch)))
    _same(got, want, case.__name__)


# ------------------------------------------- compute_window_counters_host

@pytest.mark.parametrize("min_opp,keep_all", [(0, True), (2, True),
                                              (0, False)])
@pytest.mark.parametrize("win", [(0, 1024), (1024, 2048), (2048, 4000)])
def test_window_counters_host_window_for_window(win, min_opp, keep_all):
    ref, batch = _batch(21)
    from methyldackel_tpu.config import Config

    cfg = Config()
    cfg.minOppositeDepth = min_opp
    st = jsem.strand(batch.flag, batch.xg)
    keep = (batch.pos < win[1]) & (batch.endpos > win[0])
    if not keep_all:
        keep[::4] = False
    idx = np.nonzero(keep)[0]
    sub = dataclasses.replace(
        batch, qname=[batch.qname[i] for i in idx],
        **{f.name: getattr(batch, f.name)[idx]
           for f in dataclasses.fields(batch)
           if f.name not in ("qname", "qname_hash")})
    sub_keep = np.ones(sub.n, bool)
    if not keep_all:
        sub_keep[::3] = False
    off = max(win[0] - 2, 0)
    args = (st[idx], sub_keep, ref[off:], off, win[0], win[1])
    want = jextract.compute_window_counters_host(cfg, copy.deepcopy(sub),
                                                 *args)
    got = pextract.compute_window_counters_host(
        port_config(cfg), port_batch(copy.deepcopy(sub)), *args)
    _same(got, want)
    assert want.shape == (win[1] - win[0], 4) and want.sum() > 500


# ------------------------------------------------------------------ readers

def _reader_files(d):
    """A two-contig FASTA, a BAM with paired, reverse, indel, soft-clipped,
    XG- and NH-tagged reads (tests/util_bam.py), and a BED with strands."""
    rng = np.random.default_rng(5)
    seqs = [("chrA", "".join(rng.choice(list("ACGT"), 300))),
            ("chrB", "".join(rng.choice(list("ACGTN"), 170)))]
    with open(d / "g.fa", "w") as fh:
        for name, s in seqs:
            fh.write(f">{name}\n")
            for i in range(0, len(s), 60):
                fh.write(s[i : i + 60] + "\n")
    a = seqs[0][1]
    recs = []
    for i in range(40):
        p = int(rng.integers(0, 200))
        q = p + int(rng.integers(0, 40))
        recs.append(dict(qname=f"p{i}", flag=0x63, tid=0, pos=p,
                         seq=a[p : p + 50], mtid=0, mpos=q,
                         qual=[int(v) for v in rng.integers(2, 41, 50)]))
        recs.append(dict(qname=f"p{i}", flag=0x93, tid=0, pos=q,
                         seq=a[q : q + 50], mtid=0, mpos=p))
    recs.append(dict(qname="del", flag=0, tid=0, pos=10, cigar="20M5D20M",
                     seq=a[10:30] + a[35:55], mtid=-1, mpos=-1))
    recs.append(dict(qname="clip", flag=0x10, tid=0, pos=60, cigar="3S30M2I8M",
                     seq="GGG" + a[60:90] + "AA" + a[90:98], mtid=-1,
                     mpos=-1))
    recs.append(dict(qname="b1", flag=0, tid=1, pos=5, seq=seqs[1][1][5:65],
                     mtid=-1, mpos=-1, tags=b"XGZGA\x00NHC\x02"))
    recs.append(dict(qname="b2", flag=0x10, tid=1, pos=40,
                     seq=seqs[1][1][40:100], mtid=-1, mpos=-1,
                     tags=b"NHC\x01XGZCT\x00"))
    recs.sort(key=lambda r: (r["tid"], r["pos"]))
    write_bam(d / "r.bam", [(n, len(s)) for n, s in seqs], recs)
    with open(d / "r.bed", "w") as fh:
        fh.write("chrA\t20\t90\tx\t0\t+\nchrA\t150\t260\ty\t0\t-\n"
                 "chrB\t0\t100\tz\t0\t.\n")
    return seqs


_BAM_ARRAYS = ("flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
               "mpos", "xg", "nh", "offsets", "seq_flat", "qual_flat",
               "refpos_flat", "cigar_offsets", "cigar_flat", "order")


@pytest.mark.parametrize("what", ["bam_arrays", "read_batch", "bai_bytes",
                                  "streaming_bam", "fasta", "bed"])
def test_readers_copy_equals_jax_package(tmp_path, what):
    seqs = _reader_files(tmp_path)
    path = str(tmp_path / "r.bam")
    jb, pb = jbam.BamFile(path), pbam.BamFile(path)
    if what == "bam_arrays":
        for name in _BAM_ARRAYS:
            _same(getattr(pb, name), getattr(jb, name), name)
        assert list(pb.qname) == list(jb.qname) and pb.n_reads == 84
        assert pb.header.names == jb.header.names
        assert list(pb.header.lengths) == list(jb.header.lengths)
        _same(pb.qname_hashes(), jb.qname_hashes())
        assert sorted(set(pb.xg.tolist())) == [0, 1, 2]
        assert sorted(set(pb.nh.tolist())) == [-1, 1, 2]
    elif what == "read_batch":
        idx = jb.overlapping(0, 30, 120)
        _same(pb.overlapping(0, 30, 120), idx)
        want, got = jb.batch(idx), pb.batch(idx)
        assert type(got) is pbam.ReadBatch and got.n == len(idx) > 20
        for f in dataclasses.fields(want):
            if f.name == "qname":
                assert list(got.qname) == list(want.qname)
            else:
                _same(getattr(got, f.name), getattr(want, f.name), f.name)
    elif what == "bai_bytes":
        jbai.build_bai(jb, str(tmp_path / "j.bai"))
        pbai.build_bai(pb, str(tmp_path / "p.bai"))
        pbai.build_bai_streaming(path, str(tmp_path / "ps.bai"))
        want = (tmp_path / "j.bai").read_bytes()
        assert (tmp_path / "p.bai").read_bytes() == want
        assert (tmp_path / "ps.bai").read_bytes() == want and len(want) > 50
    elif what == "streaming_bam":
        jbai.build_bai(jb, path + ".bai")
        js, ps = jbam.StreamingBamFile(path), pbam.StreamingBamFile(path)
        for tid, s, e in ((0, 0, 100), (0, 90, 300), (1, 0, 170)):
            want, got = js.window_soa(tid, s, e), ps.window_soa(tid, s, e)
            for name in ("flag", "pos", "endpos", "seq_flat", "qual_flat",
                         "refpos_flat", "offsets"):
                _same(getattr(got, name), getattr(want, name), name)
    elif what == "fasta":
        jf = jfasta.FastaFile(str(tmp_path / "g.fa"))
        os.remove(str(tmp_path / "g.fa.fai"))
        pf = pfasta.FastaFile(str(tmp_path / "g.fa"))
        for name, s in seqs:
            for a, b in ((0, len(s)), (7, 131), (59, 61), (len(s) - 5,
                                                           len(s) + 9)):
                _same(pf.fetch(name, a, b), jf.fetch(name, a, b))
        assert pf.fetch("nope", 0, 5) is None
        assert bytes(pf.fetch("chrA", 0, 300)).decode() == seqs[0][1]
    else:
        for keep_strand in (False, True):
            want = jbed.parse_bed(str(tmp_path / "r.bed"), jb.header,
                                  keep_strand)
            got = pbed.parse_bed(str(tmp_path / "r.bed"), pb.header,
                                 keep_strand)
            assert type(got) is pbed.BedRegions and got.n == want.n == 3
            for f in dataclasses.fields(want):
                _same(getattr(got, f.name), getattr(want, f.name), f.name)
            for tid, pos in ((0, 0), (0, 95), (0, 200), (1, 50)):
                assert pbed.lower_bound(got, tid, pos) == \
                    jbed.lower_bound(want, tid, pos)


def test_simulator_copy_equals_jax_package(tmp_path):
    """utils.simulate (the source of chip_smoke.py's inputs): same seed,
    same batch and the same files."""
    a = jsim.simulate_batch_fast(np.random.default_rng(3),
                                 jsim.random_reference(
                                     np.random.default_rng(2), 3000)[1], 50,
                                 80)
    b = psim.simulate_batch_fast(np.random.default_rng(3),
                                 psim.random_reference(
                                     np.random.default_rng(2), 3000)[1], 50,
                                 80)
    assert type(b) is pbam.ReadBatch
    for f in dataclasses.fields(a):
        if f.name != "qname":
            _same(getattr(b, f.name), getattr(a, f.name), f.name)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jsim.write_synthetic_input(str(tmp_path / "j"), 200, 60, 5000, seed=4)
    psim.write_synthetic_input(str(tmp_path / "p"), 200, 60, 5000, seed=4)
    for name in ("sim.fa", "sim.bam"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


# --------------------------------------------------- both CLIs, host engine

def _sc_multi_contig(d):
    write_fa(d / "g.fa", [("chrA", "ACGTACGTAC"), ("chrB", "TTCGTTTTTT")])
    write_bam(d / "r.bam", [("chrA", 10), ("chrB", 10)], [
        dict(qname="a", flag=0, tid=0, pos=0, seq="ACGTACGTAC", mtid=-1,
             mpos=-1),
        dict(qname="b", flag=0, tid=1, pos=0, seq="TTCGTTTTTT", mtid=-1,
             mpos=-1)])


def _sc_ob_strand(d):
    write_fa(d / "g.fa", [("c", "ACGTTTCGTT")])
    write_bam(d / "r.bam", [("c", 10)], [
        dict(qname="r", flag=0x10, tid=0, pos=0, seq="ACGTTTCATT", mtid=-1,
             mpos=-1)])


def _sc_indel(d):
    write_fa(d / "g.fa", [("c", "AACGTTTTTTCGTTTT")])
    write_bam(d / "r.bam", [("c", 16)], [
        dict(qname="r", flag=0, tid=0, pos=0, cigar="4M6D4M", seq="AACGCGTT",
             mtid=-1, mpos=-1)])


def _sc_clip_insertion(d):
    write_fa(d / "g.fa", [("c", "TTCGTTTTTT")])
    write_bam(d / "r.bam", [("c", 10)], [
        dict(qname="r", flag=0, tid=0, pos=0, cigar="2S4M2I2M",
             seq="GGTTCGAATT", mtid=-1, mpos=-1)])


def _sc_chg_chh(d):
    write_fa(d / "g.fa", [("c", "CAGCTTA")])
    write_bam(d / "r.bam", [("c", 7)], [
        dict(qname="r", flag=0, tid=0, pos=0, seq="CAGTTTA", mtid=-1,
             mpos=-1)])


def _sc_three_reads(d):
    write_fa(d / "g.fa", [("c", "TTCGTTTTTT")])
    write_bam(d / "r.bam", [("c", 10)], [
        dict(qname=q, flag=0, tid=0, pos=0, seq=s, mtid=-1, mpos=-1)
        for q, s in (("a", "TTCGTTTTTT"), ("b", "TTTGTTTTTT"),
                     ("d", "TTTGTTTTTT"))])


def _sc_xg_tag(d):
    write_fa(d / "g.fa", [("c", "ACGTTTCGTT")])
    write_bam(d / "r.bam", [("c", 10)], [
        dict(qname="r", flag=0, tid=0, pos=0, seq="ACGTTTCATT", mtid=-1,
             mpos=-1, tags=b"XGZGA\x00"),
        dict(qname="s", flag=0x10, tid=0, pos=0, seq="ATGTTTCGTT", mtid=-1,
             mpos=-1, tags=b"XGZCT\x00NHC\x01")])


def _sc_pairs(d):
    """200 overlapping pairs with conversions, indels and both strands over
    a 1.5 kb contig and a second contig, plus a BED file."""
    rng = np.random.default_rng(8)
    glen, L = 1500, 50
    ref = rng.choice(list("ACGT"), glen, p=[0.25, 0.25, 0.25, 0.25])
    write_fa(d / "g.fa", [("c", "".join(ref)), ("e", "".join(ref[:300]))])
    recs = []
    for i in range(200):
        p1 = int(rng.integers(0, glen - 3 * L))
        p2 = p1 + int(rng.integers(0, L))
        ot = bool(rng.random() < 0.5)
        for mate, p in ((0, p1), (1, p2)):
            if rng.random() < 0.1:
                cigar, seg = "20M3D30M", np.concatenate(
                    [ref[p : p + 20], ref[p + 23 : p + 53]])
            else:
                cigar, seg = f"{L}M", ref[p : p + L].copy()
            seg = seg.copy()
            conv = rng.random(len(seg)) < 0.6
            seg[((seg == "C") if ot else (seg == "G")) & conv] = \
                "T" if ot else "A"
            snp = rng.random(len(seg)) < 0.03
            seg[snp] = rng.choice(list("ACGT"), int(snp.sum()))
            flag = (0x63 if mate == 0 else 0x93) if ot \
                else (0x53 if mate == 0 else 0xA3)
            recs.append(dict(
                qname=f"p{i}", flag=flag, tid=0, pos=p, cigar=cigar,
                seq="".join(seg), mtid=0, mpos=p2 if mate == 0 else p1,
                qual=[int(q) for q in rng.integers(2, 41, len(seg))]))
    recs.append(dict(qname="e1", flag=0, tid=1, pos=3,
                     seq="".join(ref[3:63]), mtid=-1, mpos=-1))
    recs.sort(key=lambda r: (r["tid"], r["pos"]))
    write_bam(d / "r.bam", [("c", glen), ("e", 300)], recs)
    with open(d / "r.bed", "w") as fh:
        fh.write("c\t100\t400\tx\t0\t+\nc\t600\t1100\ty\t0\t-\ne\t0\t200\n")


_EXTRACT_CASES = [
    ("multi_contig", _sc_multi_contig, []),
    ("ob_strand", _sc_ob_strand, []),
    ("indel", _sc_indel, []),
    ("clip_insertion", _sc_clip_insertion, []),
    ("chg_chh", _sc_chg_chh, ["--CHG", "--CHH"]),
    ("methylkit", _sc_three_reads, ["--methylKit"]),
    ("xg_tag", _sc_xg_tag, []),
    ("pairs", _sc_pairs, ["--chunkSize", "400"]),
    ("pairs_threads", _sc_pairs, ["--chunkSize", "64", "-@", "3"]),
    ("pairs_merge_context", _sc_pairs,
     ["--mergeContext", "--CHG", "--chunkSize", "333"]),
    ("pairs_bed", _sc_pairs, ["-l", "../r.bed"]),
    ("pairs_bed_keep_strand", _sc_pairs, ["-l", "../r.bed", "--keepStrand"]),
    ("pairs_region", _sc_pairs, ["-r", "c:200-900"]),
    ("pairs_chg_chh", _sc_pairs, ["--CHG", "--CHH", "--noCpG"]),
    ("pairs_min_opposite_depth", _sc_pairs,
     ["--minOppositeDepth", "2", "--maxVariantFrac", "0.2"]),
    ("pairs_cytosine_report", _sc_pairs, ["--cytosine_report"]),
    ("pairs_fraction", _sc_pairs, ["--fraction", "-d", "2"]),
    ("pairs_counts", _sc_pairs, ["--counts", "-p", "20", "-q", "5"]),
    ("pairs_logit", _sc_pairs, ["--logit"]),
    ("pairs_trim", _sc_pairs, ["--OT", "3,45,2,0", "--nOB", "1,2,3,4",
                               "--keepDupes", "--ignoreFlags", "0xD00"]),
]


def _run_cli(monkeypatch, cli, d, args):
    d.mkdir()
    monkeypatch.chdir(d)
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    return cli.main(args)


@pytest.mark.parametrize("name,scenario,extra", _EXTRACT_CASES,
                         ids=[c[0] for c in _EXTRACT_CASES])
def test_host_engine_files_equal_through_both_clis(tmp_path, monkeypatch,
                                                   capfd, name, scenario,
                                                   extra):
    """`extract` with MDTPU_ENGINE=host through the JAX package's CLI and
    through the port's: the same files, byte for byte, and the same
    messages."""
    scenario(tmp_path)
    args = ["extract", *extra, "../g.fa", "../r.bam", "-o", "o"]
    assert _run_cli(monkeypatch, jcli, tmp_path / "jax", args) == 0
    j_out = capfd.readouterr()
    assert _run_cli(monkeypatch, pcli, tmp_path / "port", args) == 0
    p_out = capfd.readouterr()
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files and files == sorted(os.listdir(tmp_path / "port"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    # the first run builds the missing .bai and says so; the second finds it
    j_err = j_out.err.replace("Couldn't load the index for ../r.bam, will "
                              "attempt to build it.\n", "")
    assert p_out.out == j_out.out and p_out.err == j_err
    if name.startswith("pairs") and "region" not in name:
        assert max(os.path.getsize(tmp_path / "jax" / f) for f in files) > 500


@pytest.mark.parametrize("argv", [
    ["extract"], ["extract", "-h"], ["extract", "--bogus", "g.fa", "r.bam"],
    ["extract", "g.fa"], ["extract", "--noCpG", "g.fa", "r.bam"],
    ["extract", "--fraction", "--counts", "g.fa", "r.bam"],
    ["extract", "-d", "0", "g.fa", "r.bam"],
    ["extract", "--methylKit", "--mergeContext", "g.fa", "r.bam"],
    ["extract", "-p", "0", "-q", "-3", "--chunkSize", "0", "g.fa", "r.bam"],
    ["mergeContext"], ["bogus"]])
def test_cli_parsing_equals_jax_package(tmp_path, monkeypatch, capfd, argv):
    """Usage, errors and return codes of the copied getopt tables. The two
    usage texts name their own program and differ in nothing else."""
    _sc_three_reads(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    want = jcli.main(list(argv))
    j_out = capfd.readouterr()
    got = pcli.main(list(argv))
    p_out = capfd.readouterr()
    assert got == want

    def neutral(text):
        lines = text.replace("methyldackel-tpu-torch", "methyldackel-tpu")
        return [ln for ln in lines.split("\n")
                if "TPU chips" not in ln and "MDTPU_ENGINE=mesh" not in ln
                and "Worker threads" not in ln]

    if argv != ["bogus"]:
        assert neutral(p_out.err) == neutral(j_out.err)
    assert p_out.out == j_out.out


@pytest.mark.parametrize("extra", [[], ["--CHG"]])
def test_merge_context_equal_through_both_clis(tmp_path, monkeypatch, extra):
    _sc_pairs(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    ctx = "CHG" if extra else "CpG"
    assert pcli.main(["extract", *extra, "g.fa", "r.bam", "-o", "o"]) == 0
    src = f"o_{ctx}.bedGraph"
    assert jcli.main(["mergeContext", "-o", "j.bedGraph", "g.fa", src]) == 0
    assert pcli.main(["mergeContext", "-o", "p.bedGraph", "g.fa", src]) == 0
    merged = (tmp_path / "p.bedGraph").read_bytes()
    assert merged == (tmp_path / "j.bedGraph").read_bytes()
    assert merged.count(b"\n") > 20
