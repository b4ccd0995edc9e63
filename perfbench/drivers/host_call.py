"""One host still per request, from host numpy to host numpy.

Request ``i`` is the runner of ``configs.<entry>`` (built once, on the mesh
``mesh`` when the traffic gives one) called on still ``i % pool``; the one
client waits for the numpy result.  Closed loop.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import loop


class Driver:
    def __init__(self, cell, weights, pool, devices, sample: loop.Reservoir):
        from srcnn_cpp_tpu import configs

        mesh = None
        if "mesh" in cell.traffic:
            from srcnn_cpp_tpu.parallel import make_mesh

            mesh = make_mesh(**cell.traffic["mesh"], devices=devices)
        kw = {"mesh": mesh} if mesh is not None else {}
        self.entry = getattr(configs, cell.traffic["entry"])(
            weights=loop.weights_on(weights, devices, mesh),
            scale=float(cell.config["scale"]), **kw)
        self.pool, self.sample = pool, sample
        self.px = int(np.prod(cell.config["out_hw"]))

    def warm(self) -> None:
        for img in self.pool:
            self.entry(img)

    def run(self, seconds: float, capture) -> loop.Window:
        done, failed = [], 0

        def issue(i):
            nonlocal failed
            k = i % len(self.pool)
            t0 = time.monotonic()
            try:
                with loop.span("bench.call"):
                    out = self.entry(self.pool[k])
            except Exception:
                failed += 1
                loop.report_failure("host_call")
                return
            done.append((t0, time.monotonic(), self.px))
            self.sample.offer((k, out))

        loop.closed_loop(seconds, capture, issue)
        return loop.Window(done, failed)

    def answers(self) -> list:
        return list(self.sample.items)
