"""Profiling hooks (the reference's tracing subsystem, grown up).

The reference's only instrumentation is one millisecond timer around the
compute span (SURVEY.md §5.1).  Here:

* :func:`trace` — context manager writing a jax.profiler trace (viewable in
  TensorBoard / Perfetto) around any span;
* :class:`StageTimer` — per-stage wall-clock breakdown, each span ended
  by a host fetch of its result;
* :func:`throughput` — MP/s measurement helper used by bench.py and the
  scaling harness.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(logdir: str = "/tmp/srcnn_trace"):
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulates named spans; device results are fenced by host fetch."""

    def __init__(self) -> None:
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, fetch=None):
        t0 = time.monotonic()
        try:
            yield
        finally:
            if fetch is not None:
                np.asarray(fetch() if callable(fetch) else fetch)
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.monotonic() - t0) * 1e3

    def report(self) -> str:
        total = sum(self.spans.values())
        lines = [f"{k:24s} {v:8.1f} ms ({v / max(total, 1e-9):5.1%})"
                 for k, v in self.spans.items()]
        lines.append(f"{'TOTAL':24s} {total:8.1f} ms")
        return "\n".join(lines)


def throughput(fn, out_px: int, iters: int = 6, repeats: int = 3) -> float:
    """Best-of sustained MP/s of ``fn()`` (fn returns a device array)."""
    out = fn()
    np.asarray(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.monotonic()
        for _ in range(iters):
            out = fn()
        np.asarray(out)
        best = min(best, (time.monotonic() - t0) / iters)
    return out_px / 1e6 / best
