"""Named production configurations (the BASELINE.json workload suite).

Three deployment shapes the framework is sized for, with the knobs that
matter pre-picked.  Each returns a callable runner; all share the planar
jitted pipeline underneath.

* ``batch_1080p_to_4k`` — throughput batches of 1080p-class frames x2
  (bench.py's headline config is the single-chip instance of this; on a
  mesh the batch shards over the ``data`` axis);
* ``single_8k`` — one very large frame (e.g. 4K->8K), spatially tiled
  across the mesh via halo exchange when one is provided;
* ``stream_4k30`` — the streaming config: frames in flight with host I/O
  overlapped (see stream.StreamUpscaler).
"""

from __future__ import annotations

import numpy as np

from .weights import SRCNNWeights, load_weights


def batch_1080p_to_4k(weights: SRCNNWeights | None = None, batch: int = 4,
                      kernel: str = "auto", resize: str = "auto"):
    """Runner: BGR uint8 [B,H,W,3] -> x2 on the bit-exact resize path.

    ``batch`` is the per-dispatch chunk; larger inputs (e.g. the 64-image
    BASELINE config) are processed as chained dispatches of that size.
    The default fits one 80 GB card on every conv path: the XLA conv
    stack holds about 400 B of live features per output pixel, so 4
    frames of 1080p->4K (33 MP out) need about 13 GB, while 32 would need
    over 100 GB.
    """
    from .pipeline import upscale_bgr_batch

    weights = weights if weights is not None else load_weights()

    def run(frames: np.ndarray):
        assert frames.ndim == 4, "expect [B, H, W, 3]"
        outs = [np.asarray(upscale_bgr_batch(frames[i:i + batch], 2.0,
                                             weights, kernel=kernel,
                                             resize=resize))
                for i in range(0, len(frames), batch)]
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    run.batch = batch
    return run


def single_8k(weights: SRCNNWeights | None = None, mesh=None,
              scale: float = 2.0, kernel: str = "auto",
              resize: str = "auto"):
    """Runner: one huge frame; rows tile over the mesh when given.

    On the mesh path every stage is sharded: the whole pipeline is one
    jitted program with row-sharding constraints on the color/resize/merge
    stages (GSPMD inserts the resize's boundary comms) and the explicit
    halo-exchange tiling for the conv (parallel/tiling.py), which runs
    ``kernel`` on each device's tile.
    """
    from .runtime import resolve_kernel, resolve_resize

    kernel = resolve_kernel(kernel)
    resize = resolve_resize(resize)
    weights = weights if weights is not None else load_weights()
    step = spec = None
    if mesh is not None:
        import jax
        from functools import partial

        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel.tiling import (merge_sharded, pre_upscale_sharded,
                                      upscale_y_tiled)

        spec = NamedSharding(mesh, P(None, "row", None))

        @partial(jax.jit, static_argnames=("out_hw",))
        def step(planar, w, out_hw):
            up = pre_upscale_sharded(planar, out_hw, spec, resize)
            y_sr = upscale_y_tiled(up[0], w, mesh, kernel)   # [oh, ow]
            return merge_sharded(y_sr, up, spec)

    def run(bgr: np.ndarray):
        if mesh is None:
            from .pipeline import upscale_bgr

            return np.asarray(upscale_bgr(bgr, scale, weights,
                                          kernel=kernel, resize=resize))
        import jax

        from .ops.resize import scaled_size

        h, w = bgr.shape[:2]
        ow, oh = scaled_size(w, h, scale)
        host = np.ascontiguousarray(np.moveaxis(np.asarray(bgr), -1, 0))
        # device_put rejects uneven shardings; the in-jit constraint
        # handles those (GSPMD pads internally), so fall back to a plain
        # put when H does not divide the row axis
        planar = jax.device_put(
            host, spec if h % mesh.shape["row"] == 0 else None)
        return np.moveaxis(np.asarray(step(planar, weights, (oh, ow))), 0, -1)

    run.step = step   # exposed for sharding introspection in tests
    run.spec = spec
    return run


def stream_4k30(weights: SRCNNWeights | None = None, scale: float = 2.0,
                depth: int = 3, kernel: str = "auto",
                resize: str = "auto"):
    """Runner: the pipelined video upscaler (push/drain protocol)."""
    from .stream import StreamUpscaler

    return StreamUpscaler(scale, weights=weights, kernel=kernel, depth=depth,
                          resize=resize)


def stream_4k30_distributed(mesh=None, weights: SRCNNWeights | None = None,
                            scale: float = 2.0, depth: int = 2):
    """Runner: the multi-host frame stream (BASELINE config 5).

    Shards frames over the mesh's ``data`` axis and each frame's rows over
    ``row`` with ppermute halo exchange; every process pushes its local
    slab (parallel.DistributedStream.push_local).  Call
    ``parallel.initialize()`` once per process first on a real multi-host
    deployment.
    """
    from .parallel.distributed import DistributedStream, frame_mesh

    if mesh is None:
        import jax

        mesh = frame_mesh(data=max(1, jax.process_count()))
    return DistributedStream(scale, mesh, weights=weights, depth=depth)
