"""Observability (SURVEY §5: the reference has none beyond stderr prints).

- Stats: per-stage wall time + reads/bases counters, reported at exit when
  MDTPU_STATS=1 (reads/s per host — the production counterpart of the
  reference's silent pthread workers).
- trace(): a named span of a process-wide torch.profiler trace when
  MDTPU_TRACE_DIR is set (counterpart of the jax.profiler span of
  methyldackel_tpu/utils/profiling.py).
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import defaultdict


class Stats:
    def __init__(self):
        self.enabled = os.environ.get("MDTPU_STATS") == "1"
        self.t = defaultdict(float)
        self.n = defaultdict(int)
        self._start = time.perf_counter()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def timer(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.t[name] += dt

    def count(self, name: str, n: int = 1):
        if self.enabled:
            with self._lock:
                self.n[name] += n

    def report(self, out=None):
        if not self.enabled:
            return
        out = out or sys.stderr
        total = time.perf_counter() - self._start
        out.write("[mdtpu stats]\n")
        for k in sorted(self.t):
            out.write(f"  {k:<24s} {self.t[k]:8.3f}s\n")
        for k in sorted(self.n):
            out.write(f"  {k:<24s} {self.n[k]:>12d}")
            if total > 0:
                out.write(f"  ({self.n[k] / total:,.0f}/s)")
            out.write("\n")
        out.write(f"  {'total':<24s} {total:8.3f}s\n")


STATS = Stats()
_TRACE_LOCK = threading.Lock()
_PROFILER = None


def _start_profiler(trace_dir: str) -> None:
    """Start the process-wide torch.profiler once; its Chrome trace is
    written to ``<trace_dir>/mdtpu.<pid>.json`` when the process exits."""
    global _PROFILER
    with _TRACE_LOCK:
        if _PROFILER is not None:
            return
        import atexit

        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
        _PROFILER = prof

        def _stop():
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(
                os.path.join(trace_dir, f"mdtpu.{os.getpid()}.json"))

        atexit.register(_stop)


@contextlib.contextmanager
def trace(label: str = "mdtpu"):
    """A named span (``torch.profiler.record_function``) of one
    process-wide torch.profiler trace (CPU and, with a card, CUDA
    activities) when MDTPU_TRACE_DIR is set; a no-op otherwise. Spans nest
    and may run on several threads; host ops are recorded for the thread
    that opened the first span, device activity for all."""
    trace_dir = os.environ.get("MDTPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import record_function

    _start_profiler(trace_dir)
    with record_function(label):
        yield
