"""Tracing / profiling helpers.

Parity with the reference's observability (SURVEY.md §5): NVTX ranges
around every phase of the drivers (``cupy.cuda.nvtx RangePush/RangePop``,
test_mref_gpu_align.py:89,329,...) and cudaEvent timing in the C mains
(cuda/gpu_aln_noref.cu:2540-2550).  Here that is ``jax.profiler``:
``trace()`` captures a TensorBoard-readable trace, ``annotate()`` names a
phase (shows up on the trace timeline), and ``DeviceTimer`` gives
wall-per-step numbers around ``force`` (``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace into ``logdir`` (view in TensorBoard
    or xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named range on the device timeline (NVTX RangePush equivalent)."""
    return jax.profiler.TraceAnnotation(name)


def force(tree) -> None:
    """Completion barrier: wait until every leaf of ``tree`` is computed
    (leaves may come from different executables)."""
    jax.block_until_ready(tree)


class DeviceTimer:
    """Wall-clock phase timer with completion barriers.

    Usage::

        t = DeviceTimer()
        with t.phase("align"):
            out = step(...)
            force(out)
        print(t.report())
    """

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in self.times:
            lines.append(f"{k}: {self.times[k] * 1e3:.1f} ms"
                         f" ({self.counts[k]} calls)")
        return "\n".join(lines)
