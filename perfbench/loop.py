"""What every driver shares: the closed loop, the sample of answers, spans.

A driver is a file ``drivers/<name>.py`` that a traffic file names under
``driver``; :func:`perfbench.spec.driver` finds it by that name.  It
exports a class ``Driver(cell, weights, pool, devices, sample)`` with

* ``warm()``: every shape the window uses, once;
* ``run(seconds, capture) -> Window``: the measured window.  It stops
  submitting once ``seconds`` have passed and waits for what is in flight;
* ``answers()``: ``(pool index, output image)`` pairs of the sampled
  answers, on the host.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.n))
            if j < self.k:
                self.items[j] = item


@dataclasses.dataclass
class Window:
    #: ``(t_submit, t_done, out_pixels)`` of every request that completed
    requests: list
    #: requests that raised
    failed: int


def span(name: str):
    """A host span in the profiler's trace, named for the idle gaps."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def report_failure(driver: str) -> None:
    print(f"perfbench: a request failed in {driver}:", file=sys.stderr)
    traceback.print_exc()


def closed_loop(seconds: float, capture, issue) -> None:
    """Call ``issue(i)`` for i = 0, 1, ... until ``seconds`` have passed."""
    t_end = time.monotonic() + seconds
    i = 0
    while True:
        now = time.monotonic()
        if capture is not None:
            capture.poll(now)
        if now >= t_end:
            return
        issue(i)
        i += 1


def weights_on(weights, devices, mesh=None):
    """The weights on the first device, or replicated over ``mesh``."""
    import jax

    if mesh is None:
        return jax.device_put(weights, devices[0])
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(weights, NamedSharding(mesh, P()))
