"""The port's multi-host run (methyldackel_tpu_torch.parallel.distributed and
the multi-host branches of cli.extract, engine.extract, engine.mbias and
engine.perread) on the CPU: hosts simulated by MDTPU_NUM_HOSTS /
MDTPU_HOST_ID, then merge-shards; a live torch.distributed job (gloo over
loopback); the live branches under a mocked process group; merge_shards
under two mergers at once. Every output is compared byte for byte with the
port's one-host run and with the JAX package's MDTPU_ENGINE=host on the same
files (tests/util_bam.py, the port's utils.simulate). Text and integer
counters: tolerance 0."""
import ast
import contextlib
import fcntl
import inspect
import io
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from methyldackel_tpu import cli as jcli
from methyldackel_tpu.parallel import distributed as jdist
from methyldackel_tpu_torch import cli as pcli
from methyldackel_tpu_torch.engine import mbias as pmbias
from methyldackel_tpu_torch.engine import perread as pperread
from methyldackel_tpu_torch.io.bai import build_bai
from methyldackel_tpu_torch.io.bam import BamFile
from methyldackel_tpu_torch.parallel import distributed as pdist
from methyldackel_tpu_torch.utils.simulate import write_synthetic_input

from test_distributed_e2e import _make_input

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--chunkSize", "50", "-q", "0", "-p", "1"]
INPUTS = ["../g.fa", "../r.bam"]
# (MDTPU_ENGINE, device handed to the entry point, further environment):
# the host engine, and the device backend on the CPU with and without the
# steal lanes (the pipelined scheduler of run_extract)
ENGINES = [
    pytest.param("host", None, {}, id="host"),
    pytest.param("cuda", "cpu", {"MDTPU_STEAL": "0"}, id="cpu-device"),
    pytest.param("cuda", "cpu", {}, id="cpu-device-steal"),
]
MULTI_VARS = ("MDTPU_NUM_HOSTS", "MDTPU_HOST_ID", "MDTPU_MBIAS_FINALIZE",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "MDTPU_STEAL", "MDTPU_MESH_FORCE")


@contextlib.contextmanager
def _in(cwd, **env):
    """Run a block in ``cwd`` under ``env``, with no multi-host variable
    left over from the caller."""
    here = os.getcwd()
    saved = {k: os.environ.get(k) for k in (*MULTI_VARS, "MDTPU_ENGINE")}
    for k in MULTI_VARS:
        os.environ.pop(k, None)
    os.environ.update(env)
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        yield
    finally:
        os.chdir(here)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _port(cmd, argv, cwd, engine="host", device=None, **env):
    """The port's ``cmd`` in this process; returns (rc, stdout)."""
    fn = {"extract": pcli.extract, "mbias": pmbias.mbias,
          "perRead": pperread.perread}[cmd]
    out = io.StringIO()
    with _in(cwd, MDTPU_ENGINE=engine, **env), contextlib.redirect_stdout(out):
        rc, _backend = fn(list(argv), device)
    return rc, out.getvalue()


def _jax_one_host(cmd, argv, cwd):
    """The JAX package's CLI, one host, MDTPU_ENGINE=host; returns stdout."""
    out = io.StringIO()
    with _in(cwd, MDTPU_ENGINE="host"), contextlib.redirect_stdout(out):
        assert jcli.main([cmd, *argv]) == 0
    return out.getvalue()


def _merge(cwd, paths):
    """`python -m methyldackel_tpu_torch.parallel.distributed merge-shards`
    in its own process, after every host has exited."""
    r = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu_torch.parallel.distributed",
         "merge-shards", *paths], cwd=cwd, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert r.returncode == 0, r.stderr
    assert not [p.name for p in cwd.iterdir() if ".w" in p.name]
    return r.stdout


def _extract_hosts(root, name, n_hosts, extra, engine, device, env, outputs):
    d = root / name
    for h in range(n_hosts):
        rc, _ = _port("extract", [*BASE, *extra, "-o", "out", *INPUTS], d,
                      engine, device, MDTPU_NUM_HOSTS=str(n_hosts),
                      MDTPU_HOST_ID=str(h), **env)
        assert rc == 0
    said = _merge(d, outputs)
    assert said.count("merged ") == len(outputs)
    return d


def _same_files(dirs, names):
    want = [(dirs[0] / n).read_bytes() for n in names]
    assert all(len(w) > 100 for w in want), names
    for d in dirs[1:]:
        for n, w in zip(names, want):
            assert (d / n).read_bytes() == w, (d.name, n)


# ------------------------------------------------------------ the repair

def test_multihost_nonzero_host_writes_no_final_files(tmp_path):
    """MDTPU_NUM_HOSTS=2 MDTPU_HOST_ID=1 through the port's CLI, in its own
    process: the shards of its windows and no final file (the port once
    ignored both variables and wrote the whole output from every host)."""
    _make_input(tmp_path)
    d = tmp_path / "h1only"
    d.mkdir()
    r = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu_torch.cli", "extract",
         *BASE, "-o", "out", *INPUTS], cwd=d, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, MDTPU_ENGINE="host",
                 MDTPU_NUM_HOSTS="2", MDTPU_HOST_ID="1"), timeout=300)
    assert r.returncode == 0, r.stderr
    assert not (d / "out_CpG.bedGraph").exists()
    shards = sorted(p.name for p in d.iterdir() if ".w" in p.name)
    assert shards and all(".h1.w" in s for s in shards)
    assert all(int(s.rsplit(".w", 1)[1]) % 2 == 1 for s in shards)


# ------------------------------------------- simulated hosts, every engine

@pytest.mark.parametrize("engine,device,env", ENGINES)
def test_multihost_byte_invariance(tmp_path, engine, device, env):
    _make_input(tmp_path)
    argv = [*BASE, "-o", "out", *INPUTS]
    _jax_one_host("extract", argv, tmp_path / "jax")
    assert _port("extract", argv, tmp_path / "single", engine, device,
                 **env)[0] == 0
    dirs = [tmp_path / "jax", tmp_path / "single"]
    for n_hosts in (2, 3):
        dirs.append(_extract_hosts(tmp_path, f"hosts{n_hosts}", n_hosts, [],
                                   engine, device, env, ["out_CpG.bedGraph"]))
    _same_files(dirs, ["out_CpG.bedGraph"])


@pytest.mark.parametrize("threads", ["1", "3"])
def test_multihost_thread_pool_and_serial_schedulers(tmp_path, threads):
    """The host engine's two schedulers (-@ 1: the serial loop, -@ 3: the
    thread pool) hand drain() the window's global index."""
    _make_input(tmp_path)
    argv = [*BASE, "-o", "out", *INPUTS]
    _jax_one_host("extract", argv, tmp_path / "jax")
    d = _extract_hosts(tmp_path, "hosts3", 3, ["-@", threads], "host", None,
                       {}, ["out_CpG.bedGraph"])
    _same_files([tmp_path / "jax", d], ["out_CpG.bedGraph"])


@pytest.mark.parametrize("engine,device,env", ENGINES[:2])
def test_multihost_all_contexts_and_merge(tmp_path, engine, device, env):
    _make_input(tmp_path)
    extra = ["--CHG", "--CHH", "--mergeContext"]
    names = [f"out_{c}.bedGraph" for c in ("CpG", "CHG", "CHH")]
    _jax_one_host("extract", [*BASE, *extra, "-o", "out", *INPUTS],
                  tmp_path / "jax")
    assert _port("extract", [*BASE, *extra, "-o", "out", *INPUTS],
                 tmp_path / "single", engine, device, **env)[0] == 0
    d = _extract_hosts(tmp_path, "hosts3", 3, extra, engine, device, env,
                       names)
    _same_files([tmp_path / "jax", tmp_path / "single", d], names)


@pytest.mark.parametrize("engine,device,env", ENGINES[:2])
def test_multihost_cytosine_report(tmp_path, engine, device, env):
    _make_input(tmp_path)
    extra = ["--cytosine_report"]
    names = ["out.cytosine_report.txt"]
    _jax_one_host("extract", [*BASE, *extra, "-o", "out", *INPUTS],
                  tmp_path / "jax")
    d = _extract_hosts(tmp_path, "hosts2", 2, extra, engine, device, env,
                       names)
    _same_files([tmp_path / "jax", d], names)


def test_multihost_methylkit_header_once(tmp_path):
    """Only host 0 writes a header: the merged methylKit file has one."""
    _make_input(tmp_path)
    extra = ["--methylKit"]
    names = ["out_CpG.methylKit"]
    _jax_one_host("extract", [*BASE, *extra, "-o", "out", *INPUTS],
                  tmp_path / "jax")
    d = _extract_hosts(tmp_path, "hosts3", 3, extra, "host", None, {}, names)
    _same_files([tmp_path / "jax", d], names)
    assert (d / names[0]).read_text().count("chrBase") == 1


@pytest.mark.parametrize("engine,device,env", ENGINES[:2])
def test_multihost_perread(tmp_path, engine, device, env):
    _make_input(tmp_path)
    argv = [*BASE, "-o", "pr.txt", *INPUTS]
    _jax_one_host("perRead", argv, tmp_path / "jax")
    assert _port("perRead", argv, tmp_path / "single", engine, device)[0] == 0
    d = tmp_path / "hosts3"
    for h in range(3):
        rc, said = _port("perRead", argv, d, engine, device,
                         MDTPU_NUM_HOSTS="3", MDTPU_HOST_ID=str(h))
        assert rc == 0 and said == ""
        assert (d / "pr.txt").exists()  # host 0 opened it, and only host 0
    _merge(d, ["pr.txt"])
    _same_files([tmp_path / "jax", tmp_path / "single", d], ["pr.txt"])


def test_multihost_perread_without_o_on_one_host(tmp_path):
    """Without -o one host prints to stdout, the same rows as with -o."""
    _make_input(tmp_path)
    want = _jax_one_host("perRead", [*BASE, *INPUTS], tmp_path / "jax")
    rc, got = _port("perRead", [*BASE, *INPUTS], tmp_path / "port")
    assert rc == 0 and got == want and got.count("\n") > 50


def test_multihost_perread_requires_o(tmp_path, capfd):
    _make_input(tmp_path)
    rc, _ = _port("perRead", INPUTS, tmp_path / "x", MDTPU_NUM_HOSTS="2",
                  MDTPU_HOST_ID="0")
    assert rc != 0
    assert "requires -o" in capfd.readouterr().err


@pytest.mark.parametrize("engine,device,env", ENGINES[:2])
def test_multihost_mbias(tmp_path, engine, device, env, capfd):
    _make_input(tmp_path)
    argv = ["--txt", "--noSVG", *BASE, *INPUTS]
    want = _jax_one_host("mbias", argv, tmp_path / "jax")
    rc, single = _port("mbias", argv, tmp_path / "single", engine, device)
    assert rc == 0 and single == want and want.count("\n") > 20
    d = tmp_path / "hosts2"
    for h in range(2):
        rc, said = _port("mbias", argv, d, engine, device,
                         MDTPU_NUM_HOSTS="2", MDTPU_HOST_ID=str(h))
        assert rc == 0 and said == ""  # no rendering until finalize
        assert "MDTPU_MBIAS_FINALIZE=1" in capfd.readouterr().err
    assert len(list((tmp_path).glob("*.mbias_counters.h*.npy"))) == 2
    rc, merged = _port("mbias", argv, d, engine, device,
                       MDTPU_MBIAS_FINALIZE="1")
    assert rc == 0 and merged == want
    assert not list(tmp_path.glob("*.npy")) and not list(d.glob("*.npy"))
    rc, _ = _port("mbias", argv, d, engine, device, MDTPU_MBIAS_FINALIZE="1")
    assert rc == 1 and "No counter shards" in capfd.readouterr().err


# ------------------------------------------------- host_role and the env

def test_host_role_reads_the_simulated_job_first(monkeypatch):
    for k in MULTI_VARS:
        monkeypatch.delenv(k, raising=False)
    assert pdist.host_role() == (0, 1)
    monkeypatch.setenv("MDTPU_NUM_HOSTS", "4")
    assert pdist.host_role() == (0, 4)
    monkeypatch.setenv("MDTPU_HOST_ID", "3")
    # the simulated job wins over a live job's variables, which stay unread
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert pdist.host_role() == (3, 4)
    assert not pdist._live()


def test_init_distributed_without_a_job(monkeypatch):
    """No address: (0, 1) and no group. The JAX package's variables are not
    read, and a job of one process starts no group either."""
    for k in MULTI_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:9")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    assert pdist.init_distributed() == (0, 1)
    assert pdist.host_role() == (0, 1)
    assert pdist.init_distributed("127.0.0.1:9", 1, 0) == (0, 1)
    assert not pdist._live()
    assert list(inspect.signature(pdist.init_distributed).parameters) == \
        list(inspect.signature(jdist.init_distributed).parameters)


def test_owned_windows_and_merge_host_outputs(tmp_path):
    wins = [("c", i * 10, i * 10 + 10) for i in range(7)]
    for n in (1, 2, 3):
        got = [list(pdist.owned_windows(iter(wins), h, n)) for h in range(n)]
        assert got == [list(jdist.owned_windows(iter(wins), h, n))
                       for h in range(n)]
        assert sorted(i for g in got for i, _ in g) == list(range(7))
    out = tmp_path / "o.txt"
    out.write_text("head\n")
    for i in (0, 1, 2, 4):
        (tmp_path / f"o.h{i % 3}.w{i}").write_text(f"w{i}\n")
    pdist.merge_host_outputs(str(tmp_path / "o"), str(out), 3, 6)
    assert out.read_text() == "head\nw0\nw1\nw2\nw4\n"
    assert not list(tmp_path.glob("o.h*"))


def _code_of(module, name, rename=None):
    """The function's code as an ast dump without its docstring (comments
    are no part of an ast)."""
    fn = ast.parse(textwrap.dedent(inspect.getsource(
        getattr(module, name)))).body[0]
    if isinstance(fn.body[0], ast.Expr) and isinstance(
            fn.body[0].value, ast.Constant):
        fn.body = fn.body[1:]
    dump = ast.dump(fn)
    return dump.replace(*rename) if rename else dump


@pytest.mark.parametrize("name", ["owned_windows", "merge_host_outputs",
                                  "merge_shards", "_main"])
def test_copied_functions_equal_the_jax_package(name):
    """The four functions without JAX in them are the JAX package's code;
    _main names its own module and differs in nothing else."""
    assert _code_of(pdist, name, ("methyldackel_tpu_torch",
                                  "methyldackel_tpu")) == _code_of(jdist, name)


def test_main_usage_and_merge(tmp_path, capsys):
    assert pdist._main([]) == 1
    assert "merge-shards" in capsys.readouterr().out
    out = tmp_path / "a b.txt"  # glob.escape: a path with a space
    (tmp_path / "a b.txt.h1.w3").write_text("three\n")
    (tmp_path / "a b.txt.h0.w10").write_text("ten\n")
    (tmp_path / "a b.txt.h0.w2").write_text("two\n")
    assert pdist._main(["merge-shards", str(out)]) == 0
    assert "merged 3 shards" in capsys.readouterr().out
    assert out.read_text() == "two\nthree\nten\n"  # by number, not by name


# ----------------------------------------- two mergers at the same time

def test_merge_shards_while_another_merger_holds_the_lock(tmp_path):
    out = tmp_path / "o.bedGraph"
    out.write_text("header\n")
    (tmp_path / "o.bedGraph.h0.w0").write_text("w0\n")
    fd = os.open(str(out) + ".merge.lock", os.O_CREAT | os.O_WRONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        assert pdist.merge_shards(str(out)) == 0  # bails out, touches nothing
        assert out.read_text() == "header\n"
        assert (tmp_path / "o.bedGraph.h0.w0").exists()
    finally:
        os.close(fd)
    assert pdist.merge_shards(str(out)) == 1
    assert out.read_text() == "header\nw0\n"


def test_merge_shards_two_concurrent_mergers(tmp_path):
    """Two processes merge the same 600 shards at once: every shard lands
    once, in window order, whichever merger took it."""
    out = tmp_path / "o.txt"
    out.write_text("header\n")
    n = 600
    for i in range(n):
        (tmp_path / f"o.txt.h{i % 3}.w{i}").write_text(f"{i}\n" * 200)
    code = ("import sys, time\n"
            "from methyldackel_tpu_torch.parallel.distributed import "
            "merge_shards\n"
            "while time.time() < float(sys.argv[2]): pass\n"
            "print(merge_shards(sys.argv[1]))\n")
    import time

    go = str(time.time() + 3.0)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out), go],
                              env=dict(os.environ, PYTHONPATH=REPO),
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    merged = [int(p.communicate(timeout=120)[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert sum(merged) == n
    assert out.read_text() == "header\n" + "".join(f"{i}\n" * 200
                                                   for i in range(n))
    assert not list(tmp_path.glob("o.txt.h*"))


# ------------------------------------------ the live branches, mocked group

@pytest.fixture()
def live_group(monkeypatch):
    """A process group that is 'initialized' without one: barrier() is
    recorded, the rank is settable."""
    import torch.distributed as dist

    state = {"calls": [], "rank": 0}
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "barrier",
                        lambda *a, **k: state["calls"].append("barrier"))
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: state["rank"])
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    return state


def test_barrier_and_merge_host0_merges(tmp_path, live_group):
    out = tmp_path / "out.bedGraph"
    out.write_text("header\n")
    (tmp_path / "out.bedGraph.h0.w0").write_text("w0\n")
    (tmp_path / "out.bedGraph.h1.w1").write_text("w1\n")
    (tmp_path / "out.bedGraph.h0.w2").write_text("w2\n")
    pdist.barrier_and_merge([str(out), None])
    assert out.read_text() == "header\nw0\nw1\nw2\n"
    assert live_group["calls"] == ["barrier", "barrier"]
    assert not list(tmp_path.glob("*.h*.w*"))


def test_barrier_and_merge_nonzero_host_waits_only(tmp_path, live_group):
    out = tmp_path / "out.bedGraph"
    out.write_text("header\n")
    shard = tmp_path / "out.bedGraph.h1.w0"
    shard.write_text("w0\n")
    live_group["rank"] = 1
    pdist.barrier_and_merge([str(out)])
    assert out.read_text() == "header\n" and shard.exists()
    assert live_group["calls"] == ["barrier", "barrier"]
    assert pdist.host_role() == (1, 2)  # a group the caller made is read


def test_barrier_and_merge_noop_without_a_group(tmp_path):
    out = tmp_path / "o.bedGraph"
    out.write_text("x\n")
    (tmp_path / "o.bedGraph.h0.w0").write_text("y\n")
    pdist.barrier_and_merge([str(out)])
    assert out.read_text() == "x\n"


def test_barrier_failure_raises(tmp_path, live_group, monkeypatch):
    """A failed barrier is the job's failure: nothing is merged."""
    import torch.distributed as dist

    def broken(*a, **k):
        raise RuntimeError("rank 1 is gone")

    monkeypatch.setattr(dist, "barrier", broken)
    out = tmp_path / "o.bedGraph"
    out.write_text("x\n")
    (tmp_path / "o.bedGraph.h0.w0").write_text("y\n")
    with pytest.raises(RuntimeError, match="rank 1 is gone"):
        pdist.barrier_and_merge([str(out)])
    assert out.read_text() == "x\n"


def test_mbias_live_finalize_matches_single_host(tmp_path, live_group, capfd):
    """mbias in a live job: every host writes its counter shard, waits at
    the barrier, and host 0 sums the shards and renders; host 1 renders
    nothing. Equal to one host and to the JAX package's one-host text."""
    _make_input(tmp_path)
    argv = ["--txt", "--noSVG", *BASE, *INPUTS]
    want = _jax_one_host("mbias", argv, tmp_path / "jax")
    d = tmp_path / "live"
    live_group["rank"] = 1
    rc, said = _port("mbias", argv, d, MDTPU_NUM_HOSTS="2", MDTPU_HOST_ID="1")
    assert rc == 0 and said == ""
    assert len(list(tmp_path.glob("*.mbias_counters.h1.npy"))) == 1
    live_group["rank"] = 0
    rc, said = _port("mbias", argv, d, MDTPU_NUM_HOSTS="2", MDTPU_HOST_ID="0")
    assert rc == 0 and said == want
    assert live_group["calls"] == ["barrier", "barrier"]
    assert not list(tmp_path.glob("*.npy"))


# --------------------------------------------- a live gloo job, two ranks

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_LIVE_CHILD = (
    "import sys\n"
    "from methyldackel_tpu_torch.cli import extract\n"
    "rc, be = extract(sys.argv[1:], device='cpu')\n"
    "assert type(be).__name__ == 'DeviceBackend', be\n"
    "import torch.distributed as dist\n"
    "assert dist.is_initialized() and dist.get_backend() == 'gloo'\n"
    "sys.exit(rc)\n")


@pytest.fixture(scope="module")
def live_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("live")
    fa, bam = write_synthetic_input(str(d), 1500, 100, 1 << 18, seed=9)
    build_bai(BamFile(bam), bam + ".bai")
    return d, fa, bam


def _live_job(cmd_of, cwd, n=2):
    """Start ``n`` ranks of one gloo job over loopback, wait for all with a
    timeout, and fail on any rank's failure."""
    cwd.mkdir(exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(n))
        for k in ("MDTPU_NUM_HOSTS", "MDTPU_HOST_ID"):
            env.pop(k, None)
        env.update(cmd_of[1])
        procs.append(subprocess.Popen(cmd_of[0], cwd=cwd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return outs


@pytest.mark.parametrize("engine", ["host", "cpu-device"])
def test_live_two_rank_extract_byte_identical(tmp_path, live_input, engine):
    """Two real processes join a gloo group over loopback (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE), split the windows by residue class,
    meet at the barrier, and rank 0 merges: the bytes of one process and of
    the JAX package's host engine."""
    _d, fa, bam = live_input
    argv = ["--chunkSize", "32768", fa, bam, "-o", "out"]
    _jax_one_host("extract", argv, tmp_path / "jax")
    if engine == "host":
        cmd = ([sys.executable, "-m", "methyldackel_tpu_torch.cli", "extract",
                *argv], {"MDTPU_ENGINE": "host"})
        assert _port("extract", argv, tmp_path / "single")[0] == 0
    else:
        cmd = ([sys.executable, "-c", _LIVE_CHILD, *argv],
               {"MDTPU_STEAL": "0"})
        assert _port("extract", argv, tmp_path / "single", "cuda", "cpu",
                     MDTPU_STEAL="0")[0] == 0
    _live_job(cmd, tmp_path / "multi")
    _same_files([tmp_path / "jax", tmp_path / "single", tmp_path / "multi"],
                ["out_CpG.bedGraph"])
    assert not [p.name for p in (tmp_path / "multi").iterdir()
                if ".w" in p.name]


def test_live_two_rank_mbias_and_perread(tmp_path, live_input):
    _d, fa, bam = live_input
    host = {"MDTPU_ENGINE": "host"}
    cli = [sys.executable, "-m", "methyldackel_tpu_torch.cli"]
    margv = ["--txt", "--noSVG", "--chunkSize", "32768", fa, bam, "mb"]
    want = _jax_one_host("mbias", margv, tmp_path / "jax")
    outs = _live_job(([*cli, "mbias", *margv], host), tmp_path / "mbias")
    assert outs[0][0] == want and outs[1][0] == "" and len(want) > 200
    assert not list((tmp_path / "mbias").glob("*.npy"))
    pargv = ["--chunkSize", "32768", "-o", "pr.txt", fa, bam]
    _jax_one_host("perRead", pargv, tmp_path / "jax")
    _live_job(([*cli, "perRead", *pargv], host), tmp_path / "perread")
    _same_files([tmp_path / "jax", tmp_path / "perread"], ["pr.txt"])
