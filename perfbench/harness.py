"""One run of one cell: set-up, the measured window, the check, the metrics.

:func:`run` does everything after the look for a chip, so that a test can
drive a whole run on the CPU at a small size.  The order matters:

1. set-up: the seeded frame pool, the weights on the device, the driver,
   and a warm-up over every shape the window uses; ``setup_s`` runs from
   the start of the process to the first timed request;
2. the window, with the profiler on for part of it when ``trace``;
3. the device's peak memory, read before anything else runs on it;
4. the sampled answers are fetched, the program's state is freed, and only
   then the reference runs, one answer at a time, and the comparison;
5. each metric's reader, found by name, reads the records and the trace.
"""

from __future__ import annotations

import dataclasses
import gc
import resource
import time

import numpy as np

from . import check, frames, loop, reference, spec, trace as tr

#: the traced part of a ``--trace 1`` window: from this far in, this long
TRACE_FROM_S, TRACE_FOR_S = 1.0, 4.0


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: spec.Cell
    #: ``(t_submit, t_done, out_pixels)`` of every completed request
    requests: list
    setup_s: float
    #: the chip's row of ``peaks.json`` (None without a trace)
    peak: dict | None
    trace: tr.Trace | None = None
    #: the traced window on the host's monotonic clock
    traced: tuple | None = None

    @property
    def chips(self) -> int:
        return self.cell.chips

    def traced_requests(self) -> list:
        """Requests that completed inside the traced window."""
        t_on, t_off = self.traced
        return [r for r in self.requests if t_on <= r[1] <= t_off]


def _host_per_request(before, after, n: int) -> dict:
    """The process's host CPU time per request in the window, user and
    system: a host-fed cell's rate follows it from process to process."""
    n = max(n, 1)
    return {"user_ms": (after.ru_utime - before.ru_utime) * 1e3 / n,
            "sys_ms": (after.ru_stime - before.ru_stime) * 1e3 / n}


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, peak: dict | None) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    import jax
    from srcnn_cpp_tpu.weights import SRCNNWeights

    cfg, traffic = cell.config, cell.traffic
    devices = jax.devices()[:cell.chips]
    pool = frames.pool(seed, traffic["pool"], tuple(cfg["in_hw"]))
    w_ref = reference.load_weights()
    sample = loop.Reservoir(traffic["sample"],
                            np.random.default_rng([int(seed) % 2**64, 1]))
    driver = spec.driver(traffic["driver"], cell.root)(
        cell, SRCNNWeights(**w_ref), pool, devices, sample)
    driver.warm()

    capture = None
    t0 = time.monotonic()
    if trace:
        capture = tr.Capture(t0 + min(TRACE_FROM_S, seconds / 4),
                             t0 + min(TRACE_FROM_S, seconds / 4)
                             + min(TRACE_FOR_S, seconds / 2))
    setup_s = t0 - t_start
    usage = resource.getrusage(resource.RUSAGE_SELF)
    window = driver.run(seconds, capture)
    host = _host_per_request(usage, resource.getrusage(resource.RUSAGE_SELF),
                             len(window.requests))
    if capture is not None:
        capture.close()
    memory_peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                      for d in devices)

    answers = driver.answers()
    del driver, sample
    gc.collect()
    ctx = Context(cell, window.requests, setup_s, peak)
    if capture is not None:
        ctx.trace, ctx.traced = capture.read(), (capture.t_on, capture.t_off)

    refs = {}
    for k, _ in answers:
        if k not in refs:
            refs[k] = reference.upscale(pool[k], cfg["scale"], w_ref)
    numbers = check.compare((out, refs[k]) for k, out in answers)
    correct, report = check.verdict(numbers, cfg["check"], window.failed)

    metrics = {}
    for m in cell.metrics:
        value = spec.reader(m["name"], cell.root)(ctx) if window.requests \
            else None
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = devices[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "memory_peak_bytes": memory_peak}
    result = {"correct": correct,
              "attempted": len(window.requests) + window.failed,
              "failed": window.failed, "metrics": metrics, "device": device,
              "host_per_request": host}
    if ctx.trace is not None:
        chips = range(cell.chips)
        device["busy_s"] = float(np.mean([tr.busy_s(ctx.trace, d)
                                          for d in chips]))
        device["window_s"] = ctx.trace.window_s
        result["breakdown"] = {
            "device_ops": tr.top_ops(ctx.trace, chips),
            "idle_gaps": tr.idle_by_host_span(ctx.trace, chips)}
    result["checked"] = report
    return result
