"""Backend selection for the port (``methyldackel_tpu/parallel/__init__.py``
``select_backend``, under the same ``MDTPU_ENGINE`` variable):

- ``cuda`` (the default, also when the variable is unset): the card; raises
  when ``torch.cuda.is_available()`` is false. The port never moves a run to
  the CPU by itself.
- ``host``: None, the port's exact numpy engine (``engine.extract``).

Anything else, ``auto`` included, is rejected. The port's device programs
run on the CPU (each kernel's plain PyTorch version) only when a caller
builds the backend on it: ``make_device_backend(cfg, "cpu")``, which is what
``cli.extract(argv, device="cpu")`` does.
"""
from __future__ import annotations

import os


def select_backend(cfg):
    mode = os.environ.get("MDTPU_ENGINE", "cuda")
    if mode == "host":
        return None
    if mode != "cuda":
        raise ValueError(f"MDTPU_ENGINE={mode!r}: the port runs 'cuda' (the "
                         "default) or 'host'")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device, but torch.cuda.is_available() "
            "is false. Set MDTPU_ENGINE=host for the exact numpy engine, or "
            "pass the CPU device explicitly (cli.extract(argv, device='cpu')"
            " / make_device_backend(cfg, 'cpu')) to run the kernels' plain "
            "PyTorch versions.")
    from .device import make_device_backend

    return make_device_backend(cfg, "cuda")
