"""Card-only tests of the port: the CUDA kernel against its plain PyTorch
version, and the port CLI on the card against the host engine. They import
no jax (the card's machine has none) and skip without a CUDA device:

    python -m pytest tests/test_torch_card.py -m cuda
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from methyldackel_tpu_torch.ops import pileup as tpk
from methyldackel_tpu_torch.parallel import host_prep as hp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 512


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,LP", [(38, 256), (16, 128)])
def test_kernel_matches_plain_on_card(Lq, LP):
    """All three widths, dense and compacted, rows straddling both ends."""
    _need_card()
    rng = np.random.default_rng(Lq)
    ntiles, n = 16, 4000
    K = (T + LP) // 128
    W = ntiles * T
    f_pos = np.sort(rng.integers(-4 * Lq - 130, W + 40, n))
    srtk, cntk = hp.group_tables(f_pos - f_pos % 128, ntiles, K, LP)
    host = (rng.integers(0, 256, (n, Lq), dtype=np.uint8),
            hp.shp_bytes(f_pos.astype(np.int32),
                         rng.integers(0, 2, n).astype(np.uint8)),
            srtk, cntk, rng.integers(0, 256, W // 8, dtype=np.uint8),
            rng.integers(0, 256, W // 8, dtype=np.uint8))
    args = [torch.from_numpy(a).cuda() for a in host]
    cand = np.sort(rng.choice(W, W // 7, replace=False))
    dst = np.full(W, -1, np.int32)
    dst[cand] = np.arange(len(cand), dtype=np.int32)
    for sat in (8, 16, 32):
        for extra in ({}, dict(dst=torch.from_numpy(dst).cuda(),
                               out_width=len(cand))):
            kw = dict(ntiles=ntiles, K=K, LP=LP, sat_bits=sat, **extra)
            before = tpk.LAUNCHES
            got, gov = tpk.pileup2_tiles(*args, **kw)
            want, wov = tpk.pileup2_tiles_reference(*args, **kw)
            torch.cuda.synchronize()
            assert tpk.LAUNCHES == before + 1
            assert torch.equal(got.view(torch.uint8).cpu(),
                               want.view(torch.uint8).cpu())
            assert int(gov) == int(wov)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [{}, {"MDTPU_BATCH_WINDOWS": "1"},
                                 {"MDTPU_CANDSPACE": "0"}])
def test_cli_on_card_matches_host_engine(tmp_path, env):
    """`python -m methyldackel_tpu_torch.cli extract` with MDTPU_ENGINE=cuda
    writes the host engine's bytes."""
    _need_card()
    from methyldackel_tpu.utils.simulate import write_synthetic_input

    fa, bam = write_synthetic_input(str(tmp_path), 4000, 120, 40000, seed=9)
    base = dict(os.environ, MDTPU_STEAL="0",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = {}
    for engine in ("cuda", "host"):
        d = tmp_path / engine
        d.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu_torch.cli", "extract",
             "--chunkSize", "7000", fa, bam, "-o", "o"],
            cwd=d, env=dict(base, MDTPU_ENGINE=engine, **env),
            capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
        assert "routed to the host engine" not in res.stderr
        outs[engine] = (d / "o_CpG.bedGraph").read_bytes()
    assert outs["cuda"] == outs["host"] and outs["host"].count(b"\n") > 100
