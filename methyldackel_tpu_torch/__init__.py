"""methyldackel_tpu_torch: the PyTorch/CUDA port of methyldackel_tpu.

The JAX package ``methyldackel_tpu`` stays the reference. This package reuses
its JAX-free host modules (``io``, ``ops.semantics``, ``config``,
``engine.extract``/``scheduler``/``formats``, ``utils``) and replaces its
device layer:

- ``ops``: hand-written Hopper kernels (``csrc/*.cu``, built with ``nvcc`` on
  first use) beside their plain PyTorch versions.
- ``parallel``: the window programs and the backend that
  ``methyldackel_tpu.engine.extract.run_extract`` drives.
- ``cli``: the command-line entry point.

Nothing here imports jax, and nothing imports triton or builds a kernel when
a module is imported.
"""

__version__ = "0.1.0"
