"""Device-resident batches, device in and device out.

The traffic's pool of frames is staged once on the device as HWC uint8
batches of ``batch``; request ``i`` is ``pipeline.upscale_bgr_batch`` on
batch ``i % batches``, with at most ``inflight`` requests in flight: the
oldest is fenced with ``block_until_ready`` first.  Closed loop, one client.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from perfbench import loop


class Driver:
    def __init__(self, cell, weights, pool, devices, sample: loop.Reservoir):
        import jax
        from srcnn_cpp_tpu.pipeline import upscale_bgr_batch

        b = cell.traffic["batch"]
        self.scale = float(cell.config["scale"])
        self.depth = int(cell.traffic["inflight"])
        self.px = b * int(np.prod(cell.config["out_hw"]))
        self.weights = loop.weights_on(weights, devices)
        self.batches = [jax.device_put(pool[i:i + b], devices[0])
                        for i in range(0, len(pool), b)]
        self.entry = upscale_bgr_batch
        self.sample, self.batch = sample, b

    def warm(self) -> None:
        for x in self.batches:
            self.entry(x, self.scale, self.weights).block_until_ready()

    def run(self, seconds: float, capture) -> loop.Window:
        inflight = collections.deque()
        done, failed = [], 0

        def complete():
            nonlocal failed
            t0, k, out = inflight.popleft()
            try:
                with loop.span("bench.fetch"):
                    out.block_until_ready()
            except Exception:
                failed += 1
                loop.report_failure("device_batch")
                return
            done.append((t0, time.monotonic(), self.px))
            self.sample.offer((k, out))

        def issue(i):
            nonlocal failed
            while len(inflight) >= self.depth:
                complete()
            k = i % len(self.batches)
            t0 = time.monotonic()
            try:
                with loop.span("bench.submit"):
                    out = self.entry(self.batches[k], self.scale, self.weights)
            except Exception:
                failed += 1
                loop.report_failure("device_batch")
                return
            inflight.append((t0, k, out))

        loop.closed_loop(seconds, capture, issue)
        while inflight:
            complete()
        return loop.Window(done, failed)

    def answers(self) -> list:
        out = []
        for k, batch in self.sample.items:
            host = np.asarray(batch)
            out += [(k * self.batch + j, host[j]) for j in range(len(host))]
        return out
