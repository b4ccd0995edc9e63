"""Rate and latency arithmetic over every request of a window.

A request is ``(t_submit, t_done, out_pixels)`` on the host's monotonic
clock, in seconds.  A run stops submitting when ``--seconds`` have passed
and waits for what is in flight, so the window runs from the first
submission to the last completion and holds every request that was
submitted: rates are all the work over all that time, and tails are the
tails of all requests.
"""

from __future__ import annotations

import math


def window_s(requests) -> float:
    return max(r[1] for r in requests) - min(r[0] for r in requests)


def throughput_mps(requests) -> float:
    """Output megapixels completed over the window."""
    return sum(r[2] for r in requests) / 1e6 / window_s(requests)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``% of
    the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def latency_ms(requests, q: float) -> float:
    return 1e3 * percentile([r[1] - r[0] for r in requests], q)
