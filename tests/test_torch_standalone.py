"""The port stands on its own host stack: no file of methyldackel_tpu_torch/
and not chip_smoke.py imports jax, the JAX package or a submodule of either
(statically, by an ast walk over every import statement and every literal
import_module/__import__ call, at module scope or inside a function), a
whole extract through the port leaves neither in sys.modules, and the
default entry point never runs on the CPU without being asked."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from util_bam import write_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "methyldackel_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "methyldackel_tpu")

PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
    if os.sep + "_build" + os.sep not in p) + ["chip_smoke.py"]


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def _bad_imports(path):
    """(line, module) of every import of a forbidden package in ``path``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr",
                                                                  "")
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) \
                    and _forbidden(node.args[0].value):
                bad.append((node.lineno, node.args[0].value))
    return bad


def test_port_file_list_is_whole():
    """The walk below sees the whole package: its subpackages and the copied
    host stack are there."""
    names = set(PORT_FILES)
    for rel in ("__init__.py", "cli.py", "config.py", "io/native.py",
                "io/bam.py", "io/cram.py", "engine/extract.py",
                "engine/merge_context.py", "engine/mbias.py",
                "engine/perread.py", "engine/svg.py", "ops/semantics.py",
                "ops/pileup4.py", "parallel/device.py",
                "parallel/programs.py", "parallel/mesh.py",
                "parallel/distributed.py", "utils/profiling.py",
                "utils/simulate.py"):
        assert os.path.join("methyldackel_tpu_torch", rel) in names, rel
    assert len(PORT_FILES) >= 44


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_import_of_jax_or_the_jax_package(rel):
    assert _bad_imports(os.path.join(REPO, rel)) == []


def test_the_walk_finds_what_it_looks_for(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os, jax.numpy as jnp\n"
        "from methyldackel_tpu.io import native\n"
        "from methyldackel_tpu_torch.io import native as ok\n"
        "from . import sibling\n"
        "def f():\n"
        "    import methyldackel_tpu.cli\n"
        "    import importlib\n"
        "    importlib.import_module('jax')\n"
        "    __import__('methyldackel_tpu.config')\n")
    assert _bad_imports(str(src)) == [
        (1, "jax.numpy"), (2, "methyldackel_tpu.io"),
        (6, "methyldackel_tpu.cli"), (8, "jax"),
        (9, "methyldackel_tpu.config")]


def _small_input(d):
    """A write_bam input: a paired-end OT pair with an overlap, an OB read
    and an indel read over a 60 bp contig."""
    ref = "AACGTTCGATTCGACCGGTTAACGCGTATTCGGATCCGTTAGCGCATTACGGTTCGAACGT"
    with open(d / "g.fa", "w") as fh:
        fh.write(f">c\n{ref}\n")
    write_bam(d / "r.bam", [("c", len(ref))], [
        dict(qname="p", flag=0x63, tid=0, pos=0, seq=ref[0:30], mtid=0,
             mpos=12),
        dict(qname="q", flag=0, tid=0, pos=4, cigar="10M3D12M",
             seq=ref[4:14] + ref[17:29], mtid=-1, mpos=-1),
        dict(qname="p", flag=0x93, tid=0, pos=12, seq=ref[12:44], mtid=0,
             mpos=0),
        dict(qname="r", flag=0x10, tid=0, pos=25, seq=ref[25:58], mtid=-1,
             mpos=-1),
    ])


_CHILD = (
    "import sys\n"
    "from methyldackel_tpu_torch.cli import extract\n"
    "rc, be = extract(['--minOppositeDepth', {mod}, 'g.fa', 'r.bam', '-o', "
    "'o'], device={device})\n"
    "assert rc == 0, rc\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'methyldackel_tpu'))\n"
    "assert not bad, bad\n"
    "print('standalone-ok', type(be).__name__)\n")


@pytest.mark.parametrize("engine,device,mod,backend", [
    ("cuda", "'cpu'", "'0'", "DeviceBackend"),
    ("cuda", "'cpu'", "'1'", "DeviceBackend"),
    ("host", "None", "'0'", "NoneType"),
    ("host", "None", "'1'", "NoneType")])
def test_extract_leaves_jax_and_the_jax_package_out(tmp_path, engine, device,
                                                    mod, backend):
    """The port's extract in a fresh process, on the CPU device and with
    MDTPU_ENGINE=host: neither jax nor methyldackel_tpu gets imported, and
    both write the same bytes."""
    _small_input(tmp_path)
    env = dict(os.environ, MDTPU_ENGINE=engine, MDTPU_STEAL="0",
               PYTHONPATH=REPO)
    env.pop("MDTPU_TRACE_DIR", None)
    res = subprocess.run(
        [sys.executable, "-c", _CHILD.format(mod=mod, device=device)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"standalone-ok {backend}" in res.stdout
    assert (tmp_path / "o_CpG.bedGraph").read_text().count("\n") > 3


_SUB_CHILD = (
    "import sys\n"
    "from methyldackel_tpu_torch.engine.{module} import {fn}\n"
    "rc, be = {fn}({argv}, device={device})\n"
    "assert rc == 0, rc\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'methyldackel_tpu'))\n"
    "assert not bad, bad\n"
    "print('standalone-ok', type(be).__name__, file=sys.stderr)\n")


@pytest.mark.parametrize("module,fn,argv,out", [
    ("mbias", "mbias", ["--txt", "g.fa", "r.bam", "p"], "p_OT.svg"),
    ("perread", "perread", ["-o", "reads.txt", "g.fa", "r.bam"],
     "reads.txt")])
@pytest.mark.parametrize("engine,device,backend", [
    ("cuda", "'cpu'", "Backend"), ("host", "None", "NoneType")])
def test_subcommands_leave_jax_and_the_jax_package_out(
        tmp_path, module, fn, argv, out, engine, device, backend):
    """mbias and perRead of the port in a fresh process, on the CPU device
    and with MDTPU_ENGINE=host: neither jax nor methyldackel_tpu gets
    imported."""
    _small_input(tmp_path)
    env = dict(os.environ, MDTPU_ENGINE=engine, PYTHONPATH=REPO)
    env.pop("MDTPU_TRACE_DIR", None)
    code = _SUB_CHILD.format(module=module, fn=fn, argv=argv, device=device)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "standalone-ok" in res.stderr and backend in res.stderr
    assert (tmp_path / out).stat().st_size > 50


def test_trace_dir_writes_a_torch_profiler_trace(tmp_path):
    """MDTPU_TRACE_DIR: the JAX package's span was jax.profiler; the port's
    is a torch.profiler span, written as one Chrome trace when the process
    ends, and still imports no jax."""
    import json

    _small_input(tmp_path)
    env = dict(os.environ, MDTPU_STEAL="0", MDTPU_TRACE_DIR="trace",
               PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _CHILD.format(mod="'0'", device="'cpu'")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "standalone-ok DeviceBackend" in res.stdout
    (trace,) = list((tmp_path / "trace").iterdir())
    assert trace.name.startswith("mdtpu.") and trace.suffix == ".json"
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "window_dispatch" in names


def test_default_engine_needs_a_card(monkeypatch):
    """MDTPU_ENGINE unset is the card: without one select_backend raises
    and names the two ways to the CPU; auto is no mode."""
    import torch

    from methyldackel_tpu_torch.config import Config
    from methyldackel_tpu_torch.parallel import select_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MDTPU_ENGINE", raising=False)
    with pytest.raises(RuntimeError) as err:
        select_backend(Config())
    assert "MDTPU_ENGINE=host" in str(err.value)
    assert "device='cpu'" in str(err.value)
    monkeypatch.setenv("MDTPU_ENGINE", "auto")
    with pytest.raises(ValueError, match="auto"):
        select_backend(Config())
    monkeypatch.setenv("MDTPU_ENGINE", "host")
    assert select_backend(Config()) is None


def test_cli_without_card_fails_loudly(tmp_path):
    """`python -m methyldackel_tpu_torch.cli extract` with MDTPU_ENGINE
    unset on a machine without a card ends non-zero with the message, and
    writes no calls."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _small_input(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MDTPU_ENGINE", None)
    res = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu_torch.cli", "extract",
         "g.fa", "r.bam", "-o", "o"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "MDTPU_ENGINE=host" in res.stderr
    out = tmp_path / "o_CpG.bedGraph"
    assert not out.exists() or out.read_text().count("\n") <= 1


def test_multi_host_extract_is_refused(tmp_path, monkeypatch):
    """What this test once refused now runs, through the port's own
    parallel.distributed (the ast walk above covers it): run_extract with
    nHosts > 1 writes the shards of its windows
    through the port's own parallel.distributed, and the shards of both
    hosts merge to the one-host file."""
    from methyldackel_tpu_torch.config import Config
    from methyldackel_tpu_torch.engine.extract import run_extract
    from methyldackel_tpu_torch.parallel.distributed import merge_shards

    _small_input(tmp_path)

    def run(n_hosts, host_id, path):
        cfg = Config()
        cfg.FastaName = str(tmp_path / "g.fa")
        cfg.BAMName = str(tmp_path / "r.bam")
        cfg.chunkSize = 10
        cfg.nHosts, cfg.hostId = n_hosts, host_id
        cfg.out_paths = [str(path), None, None]
        with open(path, "a") as fh:
            run_extract(cfg, [fh if host_id == 0 else None, None, None])

    run(1, 0, tmp_path / "one.bedGraph")
    for h in (1, 0):
        run(2, h, tmp_path / "two.bedGraph")
    assert (tmp_path / "two.bedGraph").read_text() == ""
    shards = [p.name for p in tmp_path.glob("two.bedGraph.h*.w*")]
    assert {n.split(".")[2] for n in shards} == {"h0", "h1"}
    assert merge_shards(str(tmp_path / "two.bedGraph")) == len(shards)
    want = (tmp_path / "one.bedGraph").read_text()
    assert want.count("\n") > 3
    assert (tmp_path / "two.bedGraph").read_text() == want


def test_kernel_build_depends_on_included_headers(tmp_path):
    """The library name carries a hash of the source and of the csrc headers
    it includes, so that an edit of ``staging.cuh`` rebuilds both pileups."""
    from methyldackel_tpu_torch.ops import build

    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "h.cuh"\n')
    (tmp_path / "other.cu").write_text("int x;\n")
    (tmp_path / "h.cuh").write_text('#include "deep.cuh"\nint a;\n')
    (tmp_path / "deep.cuh").write_text("int b;\n")
    d = str(tmp_path)
    before = build.source_digest("k.cu", d), build.source_digest("other.cu", d)
    (tmp_path / "deep.cuh").write_text("int b = 1;\n")
    after = build.source_digest("k.cu", d), build.source_digest("other.cu", d)
    assert before[0] != after[0] and before[1] == after[1]
    for src in ("pileup2.cu", "pileup4.cu"):
        with open(os.path.join(build.CSRC_DIR, src), "rb") as fh:
            assert b'#include "staging.cuh"' in fh.read()
    assert build.library_path("pileup2.cu") != build.library_path("pileup4.cu")
