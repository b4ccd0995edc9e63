"""Multi-process distributed frame-stream runtime (BASELINE config 5).

The reference's only concurrency is one worker pthread wrapping the
pipeline (reference src/srcnn.cpp:717-724); its generalization here
is a *multi-process* frame stream: a ``(data, row)`` device mesh spanning
N processes/hosts, where

* whole frames shard over the ``data`` axis (independent work — the axis
  that may cross hosts),
* each frame's rows shard over the ``row`` axis and the conv stack's
  receptive field is stitched with ``lax.ppermute`` halo exchange
  (:mod:`.tiling`),
* every pipeline stage (fixed-point color conversion, bit-exact bicubic,
  conv1+2+3, merge, inverse color) runs on device inside ONE jitted
  program per dispatch; several dispatches stay in flight so host feed
  overlaps device compute (the stream analogue of
  :class:`srcnn_cpp_tpu.stream.StreamUpscaler`).

Per-process data feed uses ``jax.make_array_from_process_local_data``:
each process contributes only the slab its devices own, so no host ever
materializes traffic for another host's shard.  Launch one process per
host with :func:`initialize` (``jax.distributed``), then push local slabs.

The module doubles as the multi-process integration binary::

    python -m srcnn_cpp_tpu.parallel.distributed \
        --coordinator=127.0.0.1:9911 --num-processes=2 --process-id=K \
        --local-devices=2 --frames=4 --size=96x64 --check

``--check`` verifies every locally-owned output row range bit-exactly
against the monolithic single-device pipeline (tests/test_distributed.py
spawns two such processes on the CPU backend).
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from functools import partial

import numpy as np

from ..runtime import KERNELS
from ..weights import SRCNNWeights, load_weights
from .mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_count: int | None = None,
               platform: str | None = None) -> None:
    """Start this process's slice of the distributed runtime.

    Must run before any JAX backend initialization.  ``platform``/
    ``local_device_count`` pin the backend (e.g. ``cpu`` with N virtual
    devices for hermetic multi-process tests); None leaves the
    environment's choice.
    """
    import jax

    if platform is not None:
        jax.config.update("jax_platforms", platform)
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", int(local_device_count))
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def frame_mesh(data: int | None = None, devices=None):
    """(data, row) mesh over the global device list, process-major.

    Device order is process-major, so ``data=jax.process_count()`` gives
    each process whole frames (halos intra-process); ``data=1`` spans one
    frame's rows across every process (halos cross the process boundary —
    the configuration the bit-exactness test stresses).
    """
    return make_mesh(data=data, row=None, devices=devices)


def _stream_step_fn(kernel: str):
    """Build the jitted full-pipeline step lazily (imports jax on call).

    The GSPMD-sharded XLA colour and resize engines, then ``kernel`` (a
    concrete conv path) on each device's halo-extended row block.
    """
    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.quantize import quantize_trunc_u8
    from .tiling import _srcnn_rows_f32, merge_sharded, pre_upscale_sharded

    @partial(jax.jit, static_argnames=("out_hw", "mesh"))
    def step(bgr_p, weights, out_hw, mesh):
        """Planar BGR u8 [B,3,H,W] (data,row-sharded) -> [B,3,oh,ow]."""
        spec = NamedSharding(mesh, P("data", None, "row", None))
        up = pre_upscale_sharded(bgr_p, out_hw, spec)
        conv = shard_map(
            lambda w, x: quantize_trunc_u8(_srcnn_rows_f32(x, w,
                                                           kernel=kernel)),
            mesh=mesh,
            in_specs=(P(), P("data", "row", None)),
            out_specs=P("data", "row", None),
            # pallas_call's out_shape carries no varying-mesh-axes info
            check_vma=kernel != "pallas",
        )
        return merge_sharded(conv(weights, up[:, 0]), up, spec)

    return step


def _local_bounds(sharding, shape, dims=(0, 2)):
    """(start, stop) of this process's owned block along ``dims``."""
    idx_map = sharding.addressable_devices_indices_map(tuple(shape))
    out = {}
    for d in dims:
        starts, stops = [], []
        for idx in idx_map.values():
            s = idx[d]
            starts.append(s.start or 0)
            stops.append(shape[d] if s.stop is None else s.stop)
        out[d] = (min(starts), max(stops))
    return out


class DistributedStream:
    """Pipelined multi-process frame upscaler over a ``(data, row)`` mesh.

    ``push_local`` takes this process's slab of the global input batch —
    planar BGR uint8 ``[B_local, 3, H_local, W]`` where ``B_local``/
    ``H_local`` are the process's share of the ``data``/``row`` axes —
    and returns a completed *output* slab once ``depth`` dispatches are
    in flight (ordered, like stream.StreamUpscaler).
    """

    def __init__(self, scale: float, mesh, weights: SRCNNWeights | None = None,
                 depth: int = 2, gather: str = "local",
                 kernel: str = "auto"):
        import jax

        from ..runtime import resolve_kernel

        self.scale = float(scale)
        self.mesh = mesh
        self.depth = int(depth)
        self.weights = weights if weights is not None else load_weights()
        self._q: collections.deque = collections.deque()
        self.kernel = resolve_kernel(kernel)
        self._step = _stream_step_fn(self.kernel)
        from jax.sharding import NamedSharding, PartitionSpec as P

        self._in_spec = NamedSharding(mesh, P("data", None, "row", None))
        ndata, nrow = mesh.shape["data"], mesh.shape["row"]
        self._global_batch = None  # inferred on first push
        self._axis_sizes = (ndata, nrow)
        # gather="full": pop/drain return the FULL output batch on every
        # process (XLA all-gather via a replicated out-sharding) instead of
        # this process's local block — used by the video front-end, where
        # process 0 encodes whole ordered frames
        if gather not in ("local", "full"):
            raise ValueError(f"gather must be 'local' or 'full', not "
                             f"{gather!r}")
        self.gather = gather
        self._replicate = jax.jit(
            lambda x: x, out_shardings=NamedSharding(mesh, P()))

    def push_local(self, local_bgr_p: np.ndarray):
        import jax

        from ..ops.resize import scaled_size

        garr = jax.make_array_from_process_local_data(
            self._in_spec, np.ascontiguousarray(local_bgr_p))
        b, _, h, w = garr.shape
        ow, oh = scaled_size(w, h, self.scale)
        ndata, nrow = self._axis_sizes
        if b % ndata or oh % nrow:
            raise ValueError(f"global batch {b} / output height {oh} not "
                             f"divisible by mesh {ndata}x{nrow}")
        out = self._step(garr, self.weights, (oh, ow), self.mesh)
        self._q.append(out)
        if len(self._q) > self.depth:
            return self._fetch(self._q.popleft())
        return None

    def drain(self):
        while self._q:
            yield self._fetch(self._q.popleft())

    def _fetch(self, garr) -> np.ndarray:
        """Assemble this process's contiguous local block of the output."""
        if self.gather == "full":
            return np.asarray(self._replicate(garr))
        shape = garr.shape
        b = _local_bounds(garr.sharding, shape, dims=(0, 2))
        (b0, b1), (r0, r1) = b[0], b[2]
        out = np.empty((b1 - b0, shape[1], r1 - r0, shape[3]), garr.dtype)
        for s in garr.addressable_shards:
            idx = s.index
            db = idx[0].start or 0
            dr = idx[2].start or 0
            blk = np.asarray(s.data)
            out[db - b0: db - b0 + blk.shape[0], :,
                dr - r0: dr - r0 + blk.shape[2], :] = blk
        return out


def run_synthetic(frames: int, size: tuple[int, int], scale: float, mesh,
                  weights: SRCNNWeights | None = None, depth: int = 2,
                  check: bool = False, seed: int = 0,
                  kernel: str = "auto") -> dict:
    """Per-process synthetic stream benchmark; optional bit-exact check.

    Every process generates the same seeded global frames, feeds only its
    local slab, and (with ``check``) compares its output block against the
    monolithic single-device pipeline on the full frame.
    """
    import jax

    from ..ops.resize import scaled_size
    from ..pipeline import _upscale_planar_jit

    weights = weights if weights is not None else load_weights()
    h, w = size
    ndata, nrow = mesh.shape["data"], mesh.shape["row"]
    ow, oh = scaled_size(w, h, scale)
    if h % nrow or oh % nrow:
        raise ValueError(f"H {h} / output H {oh} must divide row axis {nrow}")
    stream = DistributedStream(scale, mesh, weights, depth=depth,
                               kernel=kernel)
    in_b = _local_bounds(stream._in_spec, (ndata, 3, h, w), dims=(0, 2))
    (ib0, ib1), (ir0, ir1) = in_b[0], in_b[2]

    def global_frames(i):
        rng = np.random.default_rng(seed + i)
        return rng.integers(0, 256, (ndata, 3, h, w), dtype=np.uint8)

    # warm-up/compile
    g0 = global_frames(0)
    out0 = stream.push_local(g0[ib0:ib1, :, ir0:ir1, :])
    blocks = [out0] if out0 is not None else []
    blocks += list(stream.drain())

    t0 = time.monotonic()
    outs = []
    for i in range(frames):
        r = stream.push_local(global_frames(i)[ib0:ib1, :, ir0:ir1, :])
        if r is not None:
            outs.append(r)
    outs += list(stream.drain())
    dt = time.monotonic() - t0

    result = {
        "process": jax.process_index(),
        "processes": jax.process_count(),
        "mesh": dict(mesh.shape),
        "frames": frames * ndata,
        "seconds": dt,
        "fps": frames * ndata / dt,
        "mps": frames * ndata * oh * ow / 1e6 / dt,
    }
    if check:
        ok = True
        worst = 0
        # the oracle is the monolithic single-device pipeline on the same
        # conv path
        for i, blk in enumerate(outs):
            full = global_frames(i)
            mono = np.asarray(_upscale_planar_jit(
                full, weights, (oh, ow), stream.kernel, "exact"))
            ob = _local_bounds(stream._in_spec, (ndata, 3, oh, ow),
                               dims=(0, 2))
            (ob0, ob1), (or0, or1) = ob[0], ob[2]
            want = mono[ob0:ob1, :, or0:or1, :]
            diff = int(np.abs(blk.astype(int) - want.astype(int)).max())
            worst = max(worst, diff)
            ok = ok and diff == 0
        result["bitexact"] = ok
        result["max_abs_diff"] = worst
    return result


def run_train(steps: int, size: tuple[int, int], mesh,
              weights: SRCNNWeights | None = None, seed: int = 0,
              lr: float = 1e-4) -> dict:
    """Multi-process sharded training (dp + sp) with per-process feed.

    Every process builds the same seeded global batch, feeds only its
    local (data, row) slab via ``jax.make_array_from_process_local_data``,
    and runs :func:`..train.make_sharded_train_step` — gradients flow
    backward through the cross-process ppermute halo exchange (the one
    collective path with no process-boundary test until round 3).

    Returns per-step losses and final-weight fingerprints for
    cross-configuration comparison.  Compare with fp tolerance, not
    bitwise: XLA:CPU reduction order varies with the local device count.
    """
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..train import make_sharded_train_step

    weights = weights if weights is not None else load_weights()
    h, w = size
    ndata, nrow = mesh.shape["data"], mesh.shape["row"]
    if h % nrow:
        raise ValueError(f"H {h} must divide row axis {nrow}")
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (2 * ndata, h, w), dtype=np.uint8)
    t = np.clip(x.astype(np.float32) * 1.01 - 1.0, 0, 255)
    spec = NamedSharding(mesh, P("data", "row", None))
    lb = _local_bounds(spec, x.shape, dims=(0, 1))
    (b0, b1), (r0, r1) = lb[0], lb[1]

    def feed(a):
        return jax.make_array_from_process_local_data(
            spec, np.ascontiguousarray(a[b0:b1, r0:r1]))

    # adam: the 0-255-domain gradients are huge (raw sgd diverges at any
    # useful step size); adam's normalized steps descend stably
    opt = optax.adam(lr)
    step = make_sharded_train_step(mesh, opt)
    state = opt.init(weights)
    wts = weights
    losses = []
    gx, gt = feed(x), feed(t)
    for _ in range(steps):
        wts, state, loss = step(wts, state, gx, gt)
        losses.append(float(loss))
    fp = {k: float(jnp.sum(jnp.abs(jnp.asarray(getattr(wts, k)))))
          for k in ("conv1_w", "conv1_b", "conv2_w", "conv3_w")}
    return {"process": jax.process_index(), "mesh": dict(mesh.shape),
            "losses": losses, "weight_fingerprint": fp}


def run_video(src: str, dst: str | None, scale: float, mesh,
              weights: SRCNNWeights | None = None, depth: int = 2,
              check: bool = False, codec: str = "FFV1",
              max_frames: int | None = None,
              kernel: str = "auto") -> dict:
    """Distributed video super-resolution (BASELINE config 5 end-to-end).

    Real frame I/O through the multi-process stream: every process decodes
    the same input file (decode is a trivial fraction of the pipeline work;
    re-decoding per process beats inventing a host-to-host side channel and
    matches the "per-process file offsets" deployment mode — each process
    skips straight to the slab it owns), groups frames along the ``data``
    mesh axis, and pushes ONLY its local slab of each group.  Outputs are
    gathered to every process via an XLA all-gather (replicated
    out-sharding) and process 0 encodes the ordered result with a LOSSLESS
    codec by default (FFV1) so the written file is bit-faithful.

    ``check`` compares every output frame against the monolithic
    single-device pipeline on the same decoded input frame — order AND
    bit-exactness.  Returns a stats dict (frames, fps, mps, bitexact).
    """
    import cv2
    import jax

    from ..ops.resize import scaled_size
    from ..pipeline import _upscale_planar_jit

    weights = weights if weights is not None else load_weights()
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {src!r}")
    in_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    ndata, nrow = mesh.shape["data"], mesh.shape["row"]
    stream = DistributedStream(scale, mesh, weights, depth=depth,
                               gather="full", kernel=kernel)
    write_here = dst is not None and jax.process_index() == 0
    writer = None
    pending: collections.deque = collections.deque()  # (n_valid, inputs|None)
    stats = {"frames": 0, "bitexact": True, "max_abs_diff": 0}
    oh = ow = None

    def emit(out_g):
        nonlocal writer
        n_valid, inputs = pending.popleft()
        for k in range(n_valid):
            if check:
                mono = np.asarray(_upscale_planar_jit(
                    inputs[k:k + 1], weights, (oh, ow), stream.kernel,
                    "exact"))[0]
                diff = int(np.abs(out_g[k].astype(int)
                                  - mono.astype(int)).max())
                stats["max_abs_diff"] = max(stats["max_abs_diff"], diff)
                stats["bitexact"] = stats["bitexact"] and diff == 0
            if write_here:
                if writer is None:
                    writer = cv2.VideoWriter(
                        dst, cv2.VideoWriter_fourcc(*codec), in_fps,
                        (ow, oh))
                    if not writer.isOpened():
                        raise RuntimeError(
                            f"cannot open video writer for {dst!r} "
                            f"(codec {codec!r} unavailable?)")
                # HWC copy only where it is actually written
                writer.write(np.ascontiguousarray(
                    np.moveaxis(out_g[k], 0, -1)))
            stats["frames"] += 1

    group: list[np.ndarray] = []
    bounds = None
    t0 = time.monotonic()
    while True:
        ok, frame = cap.read()
        if ok and max_frames is not None and stats["frames"] + len(
                pending) * ndata + len(group) >= max_frames:
            ok = False
        if ok:
            group.append(np.moveaxis(frame, -1, 0))   # planar [3, H, W]
        elif not group:
            break
        if len(group) == ndata or (not ok and group):
            n_valid = len(group)
            while len(group) < ndata:                 # pad the last group
                group.append(group[-1])
            batch = np.stack(group)                   # [ndata, 3, H, W]
            group = []
            if bounds is None:
                h, w = batch.shape[2:]
                ow, oh = scaled_size(w, h, scale)
                b = _local_bounds(stream._in_spec, batch.shape, dims=(0, 2))
                bounds = (b[0], b[2])
            (b0, b1), (r0, r1) = bounds
            pending.append((n_valid, batch if check else None))
            out = stream.push_local(batch[b0:b1, :, r0:r1, :])
            if out is not None:
                emit(out)
        if not ok:
            break
    for out in stream.drain():
        emit(out)
    cap.release()
    if writer is not None:
        writer.release()
    dt = time.monotonic() - t0
    stats.update({
        "process": jax.process_index(),
        "seconds": dt,
        "fps": stats["frames"] / max(dt, 1e-9),
        "mps": stats["frames"] * (oh or 0) * (ow or 0) / 1e6 / max(dt, 1e-9),
    })
    if not check:
        stats.pop("bitexact"), stats.pop("max_abs_diff")
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srcnn-distributed",
        description="multi-process distributed frame-stream runner")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="virtual CPU devices per process")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu) before init")
    ap.add_argument("--data", type=int, default=None,
                    help="data-axis size (default: 1, rows span everything)")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", default="96x64", help="frame WxH")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--kernel", default="auto", choices=list(KERNELS),
                    help="conv path on each device (runtime.resolve_kernel)")
    ap.add_argument("--check", action="store_true",
                    help="bit-exact check vs the monolithic pipeline")
    ap.add_argument("--video-in", default=None,
                    help="stream a real video file instead of synthetic "
                         "frames (every process decodes it)")
    ap.add_argument("--video-out", default=None,
                    help="output video path (written by process 0; "
                         "lossless FFV1 by default)")
    ap.add_argument("--codec", default="FFV1", help="fourcc for --video-out")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="stop after N input frames of --video-in")
    ap.add_argument("--train", action="store_true",
                    help="run the sharded trainer instead of inference "
                         "(gradients cross the process boundary)")
    ap.add_argument("--train-steps", type=int, default=3)
    args = ap.parse_args(argv)

    initialize(coordinator_address=args.coordinator,
               num_processes=args.num_processes,
               process_id=args.process_id,
               local_device_count=args.local_devices,
               platform=args.platform)
    import jax

    mesh = frame_mesh(data=args.data or 1)
    if args.train:
        w, h = (int(t) for t in args.size.lower().split("x"))
        r = run_train(args.train_steps, (h, w), mesh)
    elif args.video_in:
        r = run_video(args.video_in, args.video_out, args.scale, mesh,
                      kernel=args.kernel,
                      depth=args.depth, check=args.check, codec=args.codec,
                      max_frames=args.max_frames)
    else:
        w, h = (int(t) for t in args.size.lower().split("x"))
        r = run_synthetic(args.frames, (h, w), args.scale, mesh,
                          kernel=args.kernel,
                          depth=args.depth, check=args.check)
    print(json.dumps(r), flush=True)
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("srcnn-distributed-done")
    jax.distributed.shutdown()
    if not args.check:
        return 0
    return 0 if r.get("bitexact") else 1


if __name__ == "__main__":
    sys.exit(main())
