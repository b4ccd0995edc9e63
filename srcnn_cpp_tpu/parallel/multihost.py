"""Multi-host slice support + scaling-efficiency harness.

The reference is strictly single-process (SURVEY.md §2 C18); here the
pipeline spans hosts with ``jax.distributed`` + a GSPMD mesh whose ``row``
(spatial) axis stays within a host and whose ``data`` axis can cross hosts
(frames are independent, so the only cross-device traffic is halo rows on
the row axis — keep ``row`` within a host).

Real multi-host runs call :func:`initialize` once per process before any
jax API; the scaling harness also runs on one host over any device count
(virtual CPU devices in CI), measuring frames/s at n=1..N to report linear
scaling efficiency (BASELINE.md target: >=0.9 to N>=2 hosts).
"""

from __future__ import annotations

import time

import numpy as np

from .mesh import make_mesh
from .tiling import srcnn_y_tiled


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """``jax.distributed.initialize`` wrapper (env-driven when args None).

    Canonical implementation lives in :mod:`.distributed` (exercised by the
    2-process integration tests, tests/test_distributed.py).
    """
    from .distributed import initialize as _init

    _init(coordinator_address=coordinator_address,
          num_processes=num_processes, process_id=process_id)


def scaling_efficiency(weights, image_hw=(256, 256), batch: int = 4,
                       device_counts=None, iters: int = 4) -> dict:
    """Throughput of the tiled conv path at increasing device counts.

    Returns {n_devices: MP/s} plus the linear-scaling efficiency of the
    largest count vs single-device.  Uses row-sharding only (data=1) so the
    measurement stresses the halo-exchange path, the part whose scaling is
    nontrivial.

    NOTE: on virtual CPU devices (CI) every mesh element shares one
    physical machine, so throughput saturates regardless of n — that mode
    validates the harness plumbing, not hardware scaling; the >=0.9
    efficiency target is meaningful only on a real multi-chip slice.
    """
    import jax

    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devs)]
    h, w = image_hw
    y = np.random.default_rng(0).integers(0, 256, (batch, h, w),
                                          dtype=np.uint8)
    results = {}
    for n in device_counts:
        mesh = make_mesh(data=1, row=n, devices=devs[:n])
        out = srcnn_y_tiled(y, weights, mesh)       # compile
        np.asarray(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.monotonic()
            for _ in range(iters):
                out = srcnn_y_tiled(y, weights, mesh)
            np.asarray(out)
            best = min(best, (time.monotonic() - t0) / iters)
        results[n] = batch * h * w / 1e6 / best
    n_max = max(results)
    eff = results[n_max] / (results[1] * n_max) if 1 in results else None
    return {"mps": results, "n_max": n_max, "efficiency": eff}
