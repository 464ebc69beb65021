"""Backend selection for the port (``methyldackel_tpu/parallel/__init__.py``
``select_backend``, under the same ``MDTPU_ENGINE`` variable):

- ``host``: None, the reference's exact numpy engine;
- ``cuda``: the card; raises when ``torch.cuda.is_available()`` is false;
- ``auto`` (default): ``cuda`` when a card is present, else ``host``.
"""
from __future__ import annotations

import os


def select_backend(cfg):
    mode = os.environ.get("MDTPU_ENGINE", "auto")
    if mode == "host":
        return None
    if mode not in ("cuda", "auto"):
        raise ValueError(f"MDTPU_ENGINE={mode!r}: the port runs 'host', "
                         "'cuda' or 'auto'")
    import torch

    if not torch.cuda.is_available():
        if mode == "cuda":
            raise RuntimeError("MDTPU_ENGINE=cuda, but torch.cuda."
                               "is_available() is false")
        return None
    from .device import make_device_backend

    return make_device_backend(cfg, "cuda")
