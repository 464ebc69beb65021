"""methyldackel_tpu_torch: the PyTorch/CUDA port of methyldackel_tpu.

The JAX package ``methyldackel_tpu`` stays the reference. This package imports
nothing of it: it carries its own copies, under the same names, of the host
stack (``config``, ``io``, ``ops.semantics``, ``engine.{extract,scheduler,
formats,merge_context}``, ``utils.{profiling,simulate}``) over the same
native host library (``csrc/build/libmdtpu_native.so``), and replaces the
device layer:

- ``ops``: hand-written Hopper kernels (``csrc/*.cu``, built with ``nvcc`` on
  first use) beside their plain PyTorch versions.
- ``parallel``: the window programs and the backend that
  ``engine.extract.run_extract`` drives.
- ``cli``: the command-line entry point.

Nothing here imports jax, and nothing imports triton or builds a kernel when
a module is imported.
"""

__version__ = "0.1.0"

# The MethylDackel version whose behavior the outputs reproduce.
REFERENCE_VERSION = "0.6.1"


def _tune_malloc():
    """Keep glibc from mmap()ing every large numpy buffer.

    The window pipeline keeps several ~100 MB padded read batches alive at
    once (pipelined windows + the steal lane). With glibc's default
    M_MMAP_THRESHOLD each batch allocation is a fresh mmap and each free a
    munmap, so every window re-faults and kernel-zeroes ~100 MB. Raising
    the mmap/trim thresholds lets freed blocks recycle hot heap pages.
    mallopt() at import covers every entry point (CLI, tests) without
    needing env vars at process start. MDTPU_NO_MALLOC_TUNE=1 disables.
    (Carried over from ``methyldackel_tpu/__init__.py``.)"""
    import ctypes
    import os

    if os.environ.get("MDTPU_NO_MALLOC_TUNE") == "1":
        return
    try:
        libc = ctypes.CDLL(None)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return  # non-glibc platform: defaults stand
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
    GiB = 1 << 30
    mallopt(M_MMAP_THRESHOLD, GiB)
    mallopt(M_TRIM_THRESHOLD, GiB)


_tune_malloc()
del _tune_malloc
