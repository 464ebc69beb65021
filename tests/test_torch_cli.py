"""The port's CLI (methyldackel_tpu_torch.cli) with its backend on the CPU
(the kernel's plain version) must write byte-identical files to the
reference CLI's exact host engine (MDTPU_ENGINE=host), and must run
without jax."""
import os
import subprocess
import sys

import pytest

from methyldackel_tpu import cli as ref_cli
from methyldackel_tpu.io.bai import build_bai
from methyldackel_tpu.io.bam import BamFile
from methyldackel_tpu.utils.simulate import write_synthetic_input
from methyldackel_tpu_torch import cli as port_cli
from methyldackel_tpu_torch.parallel import select_backend
from methyldackel_tpu_torch.utils import profiling
from util_bam import write_bam
from test_synthetic_e2e import write_fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scenario_multi_contig(d):
    write_fa(d / "g.fa", [("chrA", "ACGTACGTAC"), ("chrB", "TTCGTTTTTT")])
    write_bam(d / "r.bam", [("chrA", 10), ("chrB", 10)], [
        dict(qname="a", flag=0, tid=0, pos=0, seq="ACGTACGTAC", mtid=-1,
             mpos=-1),
        dict(qname="b", flag=0, tid=1, pos=0, seq="TTCGTTTTTT", mtid=-1,
             mpos=-1),
    ])
    return []


def _scenario_ob_strand(d):
    write_fa(d / "g.fa", [("c", "ACGTTTCGTT")])
    write_bam(d / "r.bam", [("c", 10)], [
        dict(qname="r", flag=0x10, tid=0, pos=0, seq="ACGTTTCATT", mtid=-1,
             mpos=-1),
    ])
    return []


def _scenario_indel(d):
    write_fa(d / "g.fa", [("c", "AACGTTTTTTCGTTTT")])
    write_bam(d / "r.bam", [("c", 16)], [
        dict(qname="r", flag=0, tid=0, pos=0, cigar="4M6D4M", seq="AACGCGTT",
             mtid=-1, mpos=-1),
        dict(qname="s", flag=0, tid=0, pos=2, seq="CGTTTTTTCG", mtid=-1,
             mpos=-1),
    ])
    return []


def _scenario_chg_chh(d):
    write_fa(d / "g.fa", [("c", "CAGCTTA")])
    write_bam(d / "r.bam", [("c", 7)], [
        dict(qname="r", flag=0, tid=0, pos=0, seq="CAGTTTA", mtid=-1,
             mpos=-1),
    ])
    return ["--CHG", "--CHH"]


def _scenario_methylkit(d):
    write_fa(d / "g.fa", [("c", "TTCGTTTTTT")])
    write_bam(d / "r.bam", [("c", 10)], [
        dict(qname=q, flag=0, tid=0, pos=0, seq=s, mtid=-1, mpos=-1)
        for q, s in (("a", "TTCGTTTTTT"), ("b", "TTTGTTTTTT"),
                     ("d", "TTTGTTTTTT"))
    ])
    return ["--methylKit"]


def _run_both(monkeypatch, d, args, port_env=None):
    """Reference host engine in d/host, the port (CPU backend; every window
    on the device lane unless ``port_env`` sets MDTPU_STEAL, or unsets it
    with None for the product's default hybrid) in d/port, same -o prefix.
    Returns the port's backend."""
    (d / "host").mkdir()
    (d / "port").mkdir()
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    monkeypatch.chdir(d / "host")
    assert ref_cli.main(["extract", *args]) == 0
    monkeypatch.setenv("MDTPU_STEAL", "0")
    for k, v in (port_env or {}).items():
        if v is None:
            monkeypatch.delenv(k)
        else:
            monkeypatch.setenv(k, v)
    monkeypatch.chdir(d / "port")
    rc, backend = port_cli.extract(args, device="cpu")
    assert rc == 0
    host_files = sorted(os.listdir(d / "host"))
    assert host_files == sorted(os.listdir(d / "port")) and host_files
    for name in host_files:
        assert (d / "port" / name).read_bytes() == \
            (d / "host" / name).read_bytes(), name
    return backend


@pytest.mark.parametrize("scenario", [
    _scenario_multi_contig, _scenario_ob_strand, _scenario_indel,
    _scenario_chg_chh, _scenario_methylkit])
def test_port_cli_matches_host_engine(tmp_path, monkeypatch, scenario):
    extra = scenario(tmp_path)
    backend = _run_both(monkeypatch, tmp_path,
                        [*extra, "../g.fa", "../r.bam", "-o", "o"])
    assert backend.host_routed == 0


def _host_lane_workers(env, args):
    """The host-lane workers run_extract starts: MDTPU_STEAL as set (0 when
    _run_both leaves it), or when it is unset min(-@, cores - 1)."""
    steal = env.get("MDTPU_STEAL", "0")
    if steal is not None:
        return max(0, int(steal))
    threads = int(args[args.index("-@") + 1]) if "-@" in args else 1
    return min(threads, max(0, (os.cpu_count() or 1) - 1))


@pytest.fixture(scope="module")
def synthetic_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("syn")
    fa, bam = write_synthetic_input(str(d), 3000, 100, 30000, seed=3)
    build_bai(BamFile(bam), bam + ".bai")
    return fa, bam


@pytest.mark.parametrize("env,extra", [
    ({}, []),
    ({"MDTPU_BATCH_WINDOWS": "1"}, []),
    ({"MDTPU_CANDSPACE": "0"}, []),
    ({"MDTPU_STEAL": "1"}, ["-@", "2"]),
    # the product's default scheduling: MDTPU_STEAL unset starts
    # min(-@, cores - 1) host-lane workers beside the device lane
    ({"MDTPU_STEAL": None}, []),
    ({"MDTPU_STEAL": None}, ["-@", "4"]),
    ({}, ["--CHG", "--CHH", "--mergeContext"]),
    ({}, ["--cytosine_report"]),
    ({"MDTPU_FUSED": "v2"}, []),
    ({}, ["--minOppositeDepth", "2", "--maxVariantFrac", "0.1"]),
    ({"MDTPU_FUSED": "v2"}, ["--minOppositeDepth", "2", "--maxVariantFrac",
                             "0.1"]),
])
def test_port_cli_synthetic_windows(tmp_path, monkeypatch, synthetic_input,
                                    env, extra):
    """Ten windows of a simulated WGBS run through every group route; the
    host lane takes windows exactly when MDTPU_STEAL is not 0."""
    fa, bam = synthetic_input
    stats = profiling.Stats()
    stats.enabled = True
    monkeypatch.setattr(profiling, "STATS", stats)
    backend = _run_both(monkeypatch, tmp_path,
                        ["--chunkSize", "3000", *extra, fa, bam, "-o", "o"],
                        port_env=env)
    assert backend.host_routed == 0
    assert stats.n["windows"] == 10
    stolen = stats.n["windows_host_steal"]
    assert (stolen > 0) == (_host_lane_workers(env, extra) > 0), stolen


def test_min_opposite_depth_is_routed_and_counted(tmp_path, monkeypatch,
                                                  capsys, synthetic_input):
    """--minOppositeDepth windows take the 4-channel program on the
    device lane (none is routed to the host engine), byte-identical."""
    fa, bam = synthetic_input
    backend = _run_both(monkeypatch, tmp_path,
                        ["--chunkSize", "3000", "--minOppositeDepth", "1",
                         fa, bam, "-o", "o"])
    assert backend.host_routed == 0 and backend.launches["dense"] == 0
    assert "routed to the host engine" not in capsys.readouterr().err


def _extract_without_jax(tmp_path, extra=(), port_env=None):
    """The port's extract in a fresh process (conftest imports jax into
    this one), which must leave jax out of sys.modules."""
    fa, bam = write_synthetic_input(str(tmp_path), 300, 100, 6000, seed=1)
    code = (
        "import sys\n"
        "from methyldackel_tpu_torch.cli import extract\n"
        f"rc, be = extract(['--chunkSize', '2000', *{list(extra)!r}, {fa!r}, "
        f"{bam!r}, '-o', 'o'], device='cpu')\n"
        "assert rc == 0 and be.host_routed == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'methyldackel_tpu')]\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n")
    env = dict(os.environ, MDTPU_STEAL="0", **(port_env or {}),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("MDTPU_TRACE_DIR", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "no-jax-ok" in res.stdout
    assert (tmp_path / "o_CpG.bedGraph").stat().st_size > 100


def test_port_extract_imports_no_jax(tmp_path):
    _extract_without_jax(tmp_path)


@pytest.mark.parametrize("env,extra", [
    ({}, ["--minOppositeDepth", "1", "--maxVariantFrac", "0.2"]),
    ({"MDTPU_FUSED": "v2"}, [])])
def test_port_routes_import_no_jax(tmp_path, env, extra):
    """The 4-channel program and the v2 program import no jax either."""
    _extract_without_jax(tmp_path, extra, env)


def test_select_backend_modes(monkeypatch):
    """host is the numpy engine; cuda (also the default) needs a card and
    raises without one; auto is no mode of the port, like any unknown
    value: nothing moves a run to the CPU unasked."""
    import torch

    from methyldackel_tpu_torch.config import Config

    cfg = Config()
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    assert select_backend(cfg) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MDTPU_ENGINE", "auto")
    with pytest.raises(ValueError, match="auto"):
        select_backend(cfg)
    monkeypatch.setenv("MDTPU_ENGINE", "cuda")
    with pytest.raises(RuntimeError, match="MDTPU_ENGINE=host"):
        select_backend(cfg)
    monkeypatch.delenv("MDTPU_ENGINE")
    with pytest.raises(RuntimeError, match="MDTPU_ENGINE=host"):
        select_backend(cfg)
    monkeypatch.setenv("MDTPU_ENGINE", "jax")
    with pytest.raises(ValueError):
        select_backend(cfg)


def test_merge_context_and_unported_commands(tmp_path, monkeypatch, capsys):
    """mergeContext runs the port's copy of the host code, byte-identical
    to the JAX package's. No command is left unported: mbias and perRead run
    through the port's main, equal to the JAX package's on the host engine,
    and the usage text carries the reference's lines under the port's
    name."""
    _scenario_indel(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    assert port_cli.main(["extract", "g.fa", "r.bam", "-o", "o"]) == 0
    assert port_cli.main(["mergeContext", "-o", "m.bedGraph", "g.fa",
                          "o_CpG.bedGraph"]) == 0
    assert ref_cli.main(["mergeContext", "-o", "r.bedGraph", "g.fa",
                         "o_CpG.bedGraph"]) == 0
    merged = (tmp_path / "m.bedGraph").read_bytes()
    assert merged == (tmp_path / "r.bedGraph").read_bytes()
    assert merged.count(b"\n") > 1
    capsys.readouterr()
    outs = {}
    for name, cli in (("port", port_cli), ("ref", ref_cli)):
        assert cli.main(["mbias", "--txt", "g.fa", "r.bam", name]) == 0
        assert cli.main(["perRead", "g.fa", "r.bam"]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["ref"] and outs["port"].count("\n") > 4
    assert "not ported" not in capsys.readouterr().err
    assert (tmp_path / "port_OT.svg").read_bytes() == \
        (tmp_path / "ref_OT.svg").read_bytes()
    assert port_cli.main([]) == 0
    port_usage = capsys.readouterr().err
    assert ref_cli.main([]) == 0
    ref_usage = capsys.readouterr().err
    for line in ref_usage.splitlines()[2:]:  # from "Usage:" on, by command
        if line.startswith("Usage:"):
            line = line.replace("methyldackel-tpu", "methyldackel-tpu-torch")
        assert line in port_usage.splitlines(), line
    assert "Version: " in port_usage and "methyldackel_tpu_torch" in port_usage
    assert port_cli.main(["nonsense"]) == -1
