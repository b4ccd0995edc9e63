"""Throughput benchmark: megapixels/sec of super-resolution on one GPU.

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline",
"device"}``.  Exits non-zero, with no result, when JAX finds no GPU.

Config: 960x540 BGR frames (tests/data/eval/test.png, wrap-padded to
that size) upscaled x2 to 1920x1080 through the full pipeline (color
convert + bicubic x3 channels + SRCNN on Y + merge), ``BENCH_BATCH``
frames per dispatch, ``BENCH_ITERS`` dispatches chained on a data
dependency and ended by ``block_until_ready``.  ``vs_baseline`` is the
speedup over the reference binary's own throughput on a CPU host
(BASELINE.md).

    python bench.py                       # x2, kernel auto
    BENCH_KERNEL=xla BENCH_SCALE=3 python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

# reference-binary throughput per scale (4 OpenMP cores, BASELINE.md)
_BASELINE_MPS = {0.75: 0.0685, 1.25: 0.0664, 1.5: 0.0653, 2.0: 0.0707,
                 3.0: 0.0801}
SCALE = float(os.environ.get("BENCH_SCALE", "2"))
# 16 frames of 1080p output (33 MP) fit one 80 GB card on every conv path
# (the XLA stack holds about 400 B of live features per output pixel)
BATCH = int(os.environ.get("BENCH_BATCH", "16"))
ITERS = int(os.environ.get("BENCH_ITERS", "12"))
KERNEL = os.environ.get("BENCH_KERNEL", "auto")
RESIZE = os.environ.get("BENCH_RESIZE", "auto")
FRAME = Path(__file__).resolve().parent / "tests" / "data" / "eval" / "test.png"


def main() -> int:
    import jax
    import jax.numpy as jnp

    from srcnn_cpp_tpu.imageio import imread_bgr
    from srcnn_cpp_tpu.ops.resize import scaled_size
    from srcnn_cpp_tpu.pipeline import _upscale_planar_jit
    from srcnn_cpp_tpu.runtime import (enable_compilation_cache,
                                       resolve_kernel, resolve_resize)
    from srcnn_cpp_tpu.weights import load_weights

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform!r}); refusing to "
              f"report a number", file=sys.stderr)
        return 1
    enable_compilation_cache()
    kernel, resize = resolve_kernel(KERNEL), resolve_resize(RESIZE)
    img = imread_bgr(FRAME)
    if img is None:
        print(f"bench: cannot read {FRAME}", file=sys.stderr)
        return 1
    frame = np.pad(img, ((0, max(0, 540 - img.shape[0])),
                         (0, max(0, 960 - img.shape[1])), (0, 0)),
                   mode="wrap")[:540, :960]
    weights = jax.device_put(load_weights())
    batch = jax.device_put(jnp.asarray(np.ascontiguousarray(
        np.moveaxis(np.broadcast_to(frame, (BATCH,) + frame.shape), -1, 1))))
    ow, oh = scaled_size(960, 540, SCALE)

    @jax.jit
    def step(x, dep):
        # the chaining dependency folds into the jitted program
        return _upscale_planar_jit(x.at[0, 0, 0, 0].add(dep), weights,
                                   (oh, ow), kernel, resize)

    def chain(n):
        dep = jnp.zeros((), jnp.uint8)
        for _ in range(n):
            out = step(batch, dep)
            dep = out[0, 0, 0, 0] * 0
        return dep.block_until_ready()

    chain(2)                                   # compile + warm up
    t0 = time.perf_counter()
    chain(ITERS)
    dt = time.perf_counter() - t0
    mps = BATCH * ITERS * (oh * ow) / 1e6 / dt
    print(json.dumps({
        "metric": f"x{SCALE:g}_sr_throughput_1gpu",
        "value": mps,
        "unit": "MP/s",
        "vs_baseline": mps / _BASELINE_MPS.get(SCALE, _BASELINE_MPS[2.0]),
        "kernel": kernel,
        "batch": BATCH,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
