"""Backend selection for the port (``methyldackel_tpu/parallel/__init__.py``
``select_backend``, ``select_mbias_backend``, ``select_perread_backend``,
under the same ``MDTPU_ENGINE`` variable), one rule for all three
subcommands:

- ``cuda`` (the default, also when the variable is unset): the card; raises
  when ``torch.cuda.is_available()`` is false. The port never moves a run to
  the CPU by itself.
- ``mesh``: for ``extract`` the (dp, sp) grid over every card present
  (``mesh.make_mesh_backend``; with one card that is the ``cuda`` backend
  unless ``MDTPU_MESH_FORCE=1``), for ``mbias`` and ``perRead`` the card's
  backend (their per-window counters merge by an associative add already).
  Raises without a card, as ``cuda`` does.
- ``host``: None, the port's exact numpy engine (``engine.extract``,
  ``engine.mbias``, ``engine.perread``).

Anything else, ``auto`` included, is rejected. The port's device programs
run on the CPU (each kernel's plain PyTorch version) only when a caller
builds the backend on it: ``make_device_backend(cfg, "cpu")``, which is what
``cli.extract(argv, device="cpu")`` does (under ``MDTPU_ENGINE=mesh``:
``make_mesh_backend(cfg, device="cpu")``; likewise ``engine.mbias.mbias`` and
``engine.perread.perread``).
"""
from __future__ import annotations

import os


def _select(cfg, make_fn_name):
    mode = os.environ.get("MDTPU_ENGINE", "cuda")
    if mode == "host":
        return None
    if mode not in ("cuda", "mesh"):
        raise ValueError(f"MDTPU_ENGINE={mode!r}: the port runs 'cuda' (the "
                         "default), 'mesh' or 'host'")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device, but torch.cuda.is_available() "
            "is false. Set MDTPU_ENGINE=host for the exact numpy engine, or "
            "pass the CPU device explicitly (cli.extract(argv, device='cpu')"
            f" / {make_fn_name}(cfg, 'cpu')) to run the kernels' plain "
            "PyTorch versions.")
    if mode == "mesh" and make_fn_name == "make_device_backend":
        from .mesh import make_mesh_backend

        return make_mesh_backend(cfg, device="cuda")
    from . import device

    return getattr(device, make_fn_name)(cfg, "cuda")


def select_backend(cfg):
    """The compute backend of ``extract`` (None: the host engine)."""
    return _select(cfg, "make_device_backend")


def select_mbias_backend(cfg):
    """Device compute for the mbias counter tensor (None: host numpy)."""
    return _select(cfg, "make_mbias_backend")


def select_perread_backend(cfg):
    """Device tallies for perRead's gapless rows (None: host numpy)."""
    return _select(cfg, "make_perread_backend")
