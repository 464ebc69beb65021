"""Build and load the port's CUDA kernels.

Each kernel source under ``methyldackel_tpu_torch/csrc/`` has a plain C
interface. On first use it is compiled with ``nvcc`` for ``sm_90a`` into
``methyldackel_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded
with ``ctypes``. The library name carries a hash of the source and of the
headers of ``csrc/`` it includes, so an edited source or header is never
served by a stale build. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_digest(source: str, csrc_dir: str = CSRC_DIR) -> str:
    """Hash of csrc/<source> and, in the order met, of every header of
    ``csrc_dir`` it includes with quotes (headers of headers too)."""
    h = hashlib.sha256()
    todo, seen = [source], set()
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(csrc_dir, name), "rb") as fh:
            text = fh.read()
        h.update(name.encode() + b"\0" + text + b"\0")
        todo += [m.decode() for m in _INCLUDE.findall(text)
                 if os.path.exists(os.path.join(csrc_dir, m.decode()))]
    return h.hexdigest()[:16]


def library_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{source_digest(source)}.so")


def build(source: str) -> str:
    """Compile csrc/<source> unless its library exists; return the path."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} (rc={res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    if res.stdout or res.stderr:  # warnings, or -Xptxas -v in NVCC_FLAGS
        sys.stderr.write(f"nvcc {source}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _LIBS[source] = lib
        return lib
