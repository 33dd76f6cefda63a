"""Profiling and step-timing utilities.

The reference instruments hot paths with ad-hoc ``time.time()`` deltas
(``gprf.py:417,432,493``); the equivalents here are (a) a
``jax.profiler`` trace context producing TensorBoard/Perfetto traces of the
device timeline, and (b) a lightweight section timer for host-side phase
accounting in drivers.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class SectionTimer:
    """Accumulating named section timer for host-side phase breakdowns."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "; ".join(
            "%s %.3fs/%d" % (k, v, self.counts[k]) for k, v in rows
        )
