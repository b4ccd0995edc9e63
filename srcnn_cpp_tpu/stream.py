"""Streaming/video super-resolution with host/device overlap.

The reference processes one still image per process run; this module adds
the streaming capability its architecture implies (SURVEY.md §5.8 "video
stream config"): a pipelined upscaler that keeps several frames in flight on
the device so host-side decode/encode overlaps device compute, plus a CLI:

    python -m srcnn_cpp_tpu.stream --scale=2 in.mp4 out.mp4
    python -m srcnn_cpp_tpu.stream --scale=2 --synthetic=120 --size=1920x1080

Dispatch is asynchronous in JAX: ``push`` enqueues the jitted pipeline and
returns immediately; results materialize on ``pop`` (device->host fetch),
which only blocks once the pipeline depth is reached.

A stream run round-trips every frame through host memory by design
(decode in, encode out); ``--device-resident`` measures the device's
sustained rate without that transfer.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np

from .runtime import KERNELS, RESIZE_MODES, enable_compilation_cache
from .weights import SRCNNWeights, load_weights


class StreamUpscaler:
    """Pipelined frame upscaler with a fixed number of dispatches in flight.

    ``batch`` > 1 micro-batches consecutive frames into one dispatch to
    amortize per-dispatch overhead.  Outputs are bit-identical to batch=1
    (every stage is per-frame vectorized), and frame order is preserved.
    Latency grows by up to ``batch-1`` frames.
    """

    def __init__(self, scale: float, weights: SRCNNWeights | None = None,
                 kernel: str = "auto", depth: int = 3, batch: int = 1,
                 resize: str = "auto"):
        self.scale = float(scale)
        self.kernel = kernel
        self.resize = resize
        self.depth = int(depth)
        self.batch = max(1, int(batch))
        self.weights = weights if weights is not None else load_weights()
        self._pending: list[np.ndarray] = []
        self._inflight: collections.deque = collections.deque()
        self._ready: collections.deque = collections.deque()

    def _dispatch(self) -> None:
        from .pipeline import upscale_bgr_batch

        self._inflight.append(upscale_bgr_batch(
            np.stack(self._pending), self.scale, self.weights,
            kernel=self.kernel, resize=self.resize))
        self._pending = []

    def _complete_oldest(self) -> None:
        self._ready.extend(np.asarray(self._inflight.popleft()))

    def push(self, frame_bgr: np.ndarray) -> np.ndarray | None:
        """Enqueue one frame; returns a completed frame or None."""
        self._pending.append(np.asarray(frame_bgr))
        if len(self._pending) == self.batch:
            self._dispatch()
        if len(self._inflight) > self.depth:
            self._complete_oldest()
        return self._ready.popleft() if self._ready else None

    def drain(self):
        """Yield all remaining frames in order."""
        if self._pending:
            self._dispatch()
        while self._inflight:
            self._complete_oldest()
        while self._ready:
            yield self._ready.popleft()


def run_synthetic(n: int, size: tuple[int, int], scale: float,
                  kernel: str, batch: int = 1, resize: str = "auto") -> dict:
    """Throughput benchmark over synthetic frames; returns fps/MP/s."""
    h, w = size
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    up = StreamUpscaler(scale, kernel=kernel, batch=batch, resize=resize)
    for _ in range(up.batch):  # compile the full-batch dispatch shape
        up.push(frame)
    for _ in up.drain():
        pass
    # avoid compiling a second (partial-batch) shape, but never round the
    # run down to zero frames — n < batch still benchmarks one full batch
    n = max(n - n % up.batch, up.batch)
    t0 = time.monotonic()
    done = 0
    for i in range(n):
        if up.push(frame) is not None:
            done += 1
    for _ in up.drain():
        done += 1
    dt = time.monotonic() - t0
    from .ops.resize import scaled_size

    ow, oh = scaled_size(w, h, scale)   # float32-floor rule (srcnn.cpp:573-575)
    mp = done * oh * ow / 1e6
    return {"frames": done, "seconds": dt, "fps": done / dt, "mps": mp / dt}


def run_synthetic_device(n: int, size: tuple[int, int], scale: float,
                         kernel: str = "auto", batch: int = 4,
                         depth: int = 3, resize: str = "auto") -> dict:
    """Device-resident sustained-rate benchmark of the stream config.

    Measures the device's sustained frame rate under the stream's
    scheduling semantics (``depth`` micro-batch dispatches in flight,
    oldest fenced once the pipeline is full, dispatches chained on a
    data dependency) with the frame batch already device-resident —
    i.e. the compute span of BASELINE config 5 (4K30 streaming) without
    host decode, encode and transfer.  The default ``batch`` of 4 frames
    at 1080p->4K (33 MP out) fits one 80 GB card on every conv path.
    Returns sustained fps / MP/s.
    """
    import jax
    import jax.numpy as jnp

    from .ops.resize import scaled_size
    from .pipeline import _upscale_planar_jit
    from .runtime import resolve_kernel, resolve_resize

    h, w = size
    rng = np.random.default_rng(0)
    weights = jax.device_put(load_weights())
    xb = jax.device_put(jnp.asarray(
        rng.integers(0, 256, (batch, 3, h, w), dtype=np.uint8)))
    ow, oh = scaled_size(w, h, scale)
    rz = resolve_resize(resize)
    kernel = resolve_kernel(kernel)

    @jax.jit
    def dispatch(dep):
        # the chain dependency folds into the jitted program: an eager
        # .at[].add would add a full input copy and an extra dispatch of
        # scaffolding per iteration
        return _upscale_planar_jit(xb.at[0, 0, 0, 0].add(dep), weights,
                                   (oh, ow), kernel, rz)

    out = dispatch(jnp.zeros((), jnp.uint8))        # warm-up / compile
    np.asarray(out[0, 0, 0, 0])
    inflight: collections.deque = collections.deque()
    nb = -(-n // batch)   # whole batches, at least n frames measured
    done = 0
    t0 = time.monotonic()
    dep = jnp.zeros((), jnp.uint8)
    for _ in range(nb):
        out = dispatch(dep)
        dep = out[0, 0, 0, 0] * 0
        inflight.append(dep)
        if len(inflight) > depth:
            np.asarray(inflight.popleft())          # fence the oldest
            done += batch
    while inflight:
        np.asarray(inflight.popleft())
        done += batch
    dt = time.monotonic() - t0
    mp = done * oh * ow / 1e6
    return {"frames": done, "seconds": dt, "fps": done / dt, "mps": mp / dt}


def run_video(src: str, dst: str, scale: float, kernel: str,
              verbose: bool = True, batch: int = 1,
              resize: str = "auto", codec: str = "FFV1") -> int:
    """Upscale a video file through the pipelined stream.

    ``codec`` is the output fourcc.  The default is LOSSLESS (FFV1, same
    as the distributed runner, parallel/distributed.py): the compute path
    is bit-exact end to end, so the default writer should not be the place
    fidelity silently ends — pass e.g. ``mp4v``/``avc1`` explicitly when a
    lossy delivery format is wanted.
    """
    try:
        import cv2
    except Exception:
        print("stream: cv2 unavailable for video I/O", file=sys.stderr)
        return 2
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        print(f"stream: cannot open {src!r}", file=sys.stderr)
        return 1
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    up = StreamUpscaler(scale, kernel=kernel, batch=batch, resize=resize)
    writer = None
    n = 0

    def emit(out):
        nonlocal writer, n
        if writer is None:
            oh, ow = out.shape[:2]
            writer = cv2.VideoWriter(
                dst, cv2.VideoWriter_fourcc(*codec), fps, (ow, oh))
            if not writer.isOpened():
                raise RuntimeError(f"cannot open video writer for {dst!r} "
                                   f"(codec {codec!r} unavailable?)")
        writer.write(out)
        n += 1

    t0 = time.monotonic()
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out = up.push(frame)
        if out is not None:
            emit(out)
    for out in up.drain():
        emit(out)
    cap.release()
    if writer is not None:
        writer.release()
    dt = time.monotonic() - t0
    if verbose:
        print(f"stream: {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)"
              f" -> {dst}")
    return 0 if n else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="srcnn-stream", description=__doc__)
    ap.add_argument("src", nargs="?")
    ap.add_argument("dst", nargs="?")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--kernel", default="auto", choices=list(KERNELS))
    ap.add_argument("--synthetic", type=int, default=0,
                    help="benchmark N synthetic frames instead of a file")
    ap.add_argument("--device-resident", action="store_true",
                    help="with --synthetic: measure the device's sustained "
                         "rate (frames pre-staged on device, fenced "
                         "completion) instead of timing host I/O too")
    ap.add_argument("--size", default="1920x1080",
                    help="synthetic frame WxH")
    ap.add_argument("--resize", default="auto", choices=list(RESIZE_MODES),
                    help="pre-upscale engine: auto (exact), exact, or fast "
                         "banded matmul")
    ap.add_argument("--batch", type=int, default=1,
                    help="micro-batch size per dispatch (bit-identical; "
                         "higher throughput, +batch-1 frames latency)")
    ap.add_argument("--codec", default="FFV1",
                    help="output fourcc (default FFV1, lossless — pass "
                         "mp4v/avc1 etc. for lossy delivery formats)")
    args = ap.parse_args(argv)

    enable_compilation_cache()

    if args.synthetic:
        w, h = (int(t) for t in args.size.lower().split("x"))
        if args.device_resident:
            r = run_synthetic_device(args.synthetic, (h, w), args.scale,
                                     args.kernel, batch=max(1, args.batch),
                                     resize=args.resize)
        else:
            r = run_synthetic(args.synthetic, (h, w), args.scale,
                              args.kernel, batch=args.batch,
                              resize=args.resize)
        print(f"synthetic {r['frames']} frames {args.size} x{args.scale:g}: "
              f"{r['fps']:.1f} fps  ({r['mps']:.0f} MP/s output)")
        return 0
    if not args.src or not args.dst:
        ap.print_help()
        return 1
    return run_video(args.src, args.dst, args.scale, args.kernel,
                     batch=args.batch, resize=args.resize, codec=args.codec)


if __name__ == "__main__":
    sys.exit(main())
