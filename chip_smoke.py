#!/usr/bin/env python3
"""On-card smoke test of the super-resolution pipeline, in one process.

    python3 chip_smoke.py                # one GPU: every single-card phase
    python3 chip_smoke.py --four-cards   # four GPUs: the mesh phases only

Single-card phases:

* ``cli`` — ``cli.main`` on tests/data/eval/butterfly.png at x1.5, x2, x3;
* ``goldens`` — ``upscale_bgr`` / ``upscale_bgr_batch`` against the
  reference binary's outputs in tests/golden (max <= 2 LSB, < 1% of
  pixels differing);
* ``conv`` — every conv path on 1920x1080 Y planes against ``srcnn_y`` at
  ``Precision.HIGHEST`` (max <= 1 LSB) and against the NumPy oracle on a
  crop, plus an audit of the precision of every product;
* ``steady`` — the bench geometry (960x540 -> 1920x1080, batch 32): each
  conv path, the XLA pre-pass and post-pass, the whole step and its
  ``memory_analysis()``; then ``configs.batch_1080p_to_4k``,
  ``configs.single_8k`` and ``configs.stream_4k30`` (``StreamUpscaler``);
* ``train`` — three train steps with a finite loss.

Four-card phases: ``configs.single_8k`` on ``make_mesh(data=1, row=4)``
with a 3840x2160 frame against the one-card output, and the
``DistributedStream`` with its own check against the one-card pipeline.

Prints the card's name and power limit before any number, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when JAX finds no GPU or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
EVAL_DIR = ROOT / "tests" / "data" / "eval"
BUTTERFLY = EVAL_DIR / "butterfly.png"
GOLDEN_SCALES = ("1.5", "1.25", "0.75", "2", "3")
BENCH_BATCH, BENCH_IN, BENCH_OUT = 32, (540, 960), (1080, 1920)
# the XLA conv path holds ~400 B of live features per output pixel, so
# the conv paths are compared at 8 frames of 1080p (16.6 MP)
CONV_BATCH = 8
KERNELS = ("pallas", "xla")
MESH_FRAME = (2160, 3840)      # single_8k on four cards: 4K -> 8K
STREAM_FRAME = (1080, 1920)    # DistributedStream: 1080p -> 4K


def lsb_diff(a, b) -> tuple[int, float]:
    """(max |a - b|, fraction of differing elements) of two u8 arrays."""
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def check_golden(out, ref, what: str) -> None:
    mx, frac = lsb_diff(out, ref)
    print(f"  {what}: max {mx} LSB, {frac:.3e} of values differ")
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert mx <= 2 and frac < 0.01, f"{what}: {mx} LSB / {frac:.3e}"


def timed(fn, *args, n: int = 5) -> tuple[float, object]:
    """Median wall ms of ``fn(*args)`` ended by ``block_until_ready``
    (after one warm-up call), and the last output."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def card_line() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for line in out.strip().splitlines():
        print(f"card: {line.strip()}", flush=True)


def read_golden(tag: str):
    from srcnn_cpp_tpu.imageio import imread_bgr

    ref = imread_bgr(GOLDEN / f"butterfly_x{tag}_ref.png")
    assert ref is not None, f"cannot read golden x{tag}"
    return ref


def phase_cli() -> None:
    from srcnn_cpp_tpu import cli
    from srcnn_cpp_tpu.imageio import imread_bgr

    with tempfile.TemporaryDirectory() as td:
        for tag in ("1.5", "2", "3"):
            dst = Path(td) / f"butterfly_x{tag}.png"
            t0 = time.perf_counter()
            rc = cli.main([f"--scale={tag}", "--noverbose", str(BUTTERFLY),
                           str(dst)])
            ms = (time.perf_counter() - t0) * 1e3
            assert rc == 0, f"cli x{tag} exited {rc}"
            out = imread_bgr(dst)
            assert out is not None, f"cli x{tag} wrote no image"
            print(f"  cli x{tag}: rc 0, {out.shape[1]}x{out.shape[0]}, "
                  f"{ms:.1f} ms with compile")
            check_golden(out, read_golden(tag), f"cli x{tag} vs binary")


def phase_goldens() -> None:
    from srcnn_cpp_tpu.imageio import imread_bgr
    from srcnn_cpp_tpu.pipeline import upscale_bgr, upscale_bgr_batch

    bfly = imread_bgr(BUTTERFLY)
    for tag in GOLDEN_SCALES:
        out = np.asarray(upscale_bgr(bfly, float(tag)))
        check_golden(out, read_golden(tag), f"upscale_bgr x{tag} vs binary")
    pair = np.stack([bfly, bfly[::-1]])
    outs = np.asarray(upscale_bgr_batch(pair, 2.0))
    check_golden(outs[0], read_golden("2"), "upscale_bgr_batch x2 [0]")
    single = np.asarray(upscale_bgr(bfly[::-1], 2.0))
    assert np.array_equal(outs[1], single), "batch != single frame"
    print("  upscale_bgr_batch [1] == upscale_bgr of the same frame")
    print("  test_x2_ref.png: not compared; its input (the reference's "
          "test.jpg) is not in the repository")


_OP_RE = re.compile(r"stablehlo\.(convolution|dot_general)")
_TYPES_RE = re.compile(r"\(tensor<(?:[^>]*x)?(\w+)>, tensor<(?:[^>]*x)?(\w+)>\)")


def audit_precision(name: str, lowered_text: str) -> None:
    """Print each conv/dot of a lowered program with its operand types and
    precision; fail on an f32 product that does not state HIGHEST (it may
    run in TF32 on this card)."""
    bad = 0
    for line in lowered_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        types = _TYPES_RE.search(line)
        lhs, rhs = types.groups() if types else ("?", "?")
        prec = re.findall(r"\b(HIGHEST|HIGH|DEFAULT)\b", line) or ["unstated"]
        print(f"  {name}: {m.group(1)} {lhs} x {rhs}, precision "
              f"{'/'.join(prec)}")
        if "f32" in (lhs, rhs) and "HIGHEST" not in prec:
            bad += 1
    assert bad == 0, f"{name}: {bad} f32 products without HIGHEST"


def phase_conv() -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from srcnn_cpp_tpu import oracle
    from srcnn_cpp_tpu.models import SRCNN
    from srcnn_cpp_tpu.ops.pallas_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.train.step import mse_loss
    from srcnn_cpp_tpu.weights import load_weights

    w = load_weights()
    planes = jnp.asarray(np.random.default_rng(0).integers(
        0, 256, (4,) + BENCH_OUT, dtype=np.uint8))
    ref = np.asarray(jax.jit(
        lambda y: srcnn_y(y, w, precision=lax.Precision.HIGHEST))(planes))
    out = np.asarray(jax.jit(lambda y: srcnn_y_fused(y, w))(planes))
    mx, frac = lsb_diff(out, ref)
    print(f"  pallas vs srcnn_y(HIGHEST), 4x1920x1080: max {mx} LSB, "
          f"{frac:.3e} of pixels differ")
    assert mx <= 1, f"pallas: {mx} LSB"
    crop = np.asarray(planes[0, 500:564, 900:996])
    want = oracle.srcnn_y_ref(crop, w)
    for name, fn in (("xla", srcnn_y), ("pallas", srcnn_y_fused)):
        mx, frac = lsb_diff(np.asarray(fn(crop, w)), want)
        print(f"  {name} vs NumPy oracle, 96x64 crop: max {mx} LSB, "
              f"{frac:.3e} differ")
        assert mx <= 1, f"{name} vs oracle: {mx} LSB"
    print("  pallas kernel products: conv1 bf16 input (exact for u8) x bf16 "
          "hi+lo filter, 2 products; conv2 and conv3 bf16 hi/lo x hi/lo, "
          "3 products; all accumulate in f32")
    y = planes[:1, :64, :128]
    audit_precision("xla", jax.jit(lambda y: srcnn_y(y, w)).lower(y).as_text())
    t = y.astype(jnp.float32)
    audit_precision("train grad", jax.jit(jax.grad(mse_loss)).lower(
        w, y, t).as_text())
    gen = SRCNN(f2=3)
    gw = gen.init(jax.random.PRNGKey(0))
    audit_precision("SRCNN 9-3-5", jax.jit(gen.apply).lower(gw, t).as_text())


def phase_steady() -> None:
    import jax
    import jax.numpy as jnp

    from srcnn_cpp_tpu import configs
    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar, ycrcb2bgr_u8_planar
    from srcnn_cpp_tpu.ops.resize import resize_bicubic_u8
    from srcnn_cpp_tpu.pipeline import _srcnn, _upscale_planar_jit, upscale_bgr
    from srcnn_cpp_tpu.runtime import resolve_kernel
    from srcnn_cpp_tpu.weights import load_weights

    w = jax.device_put(load_weights())
    kernel = resolve_kernel("auto")
    rng = np.random.default_rng(1)
    x = jax.device_put(rng.integers(0, 256, (BENCH_BATCH, 3) + BENCH_IN,
                                    dtype=np.uint8))
    mp = BENCH_BATCH * BENCH_OUT[0] * BENCH_OUT[1] / 1e6
    print(f"  bench geometry: batch {BENCH_BATCH}, {BENCH_IN[1]}x{BENCH_IN[0]}"
          f" -> {BENCH_OUT[1]}x{BENCH_OUT[0]} ({mp:.1f} MP out), auto kernel "
          f"= {kernel}")

    step = jax.jit(lambda x, w: _upscale_planar_jit(x, w, BENCH_OUT, kernel,
                                                    "exact"))
    t_step, _ = timed(step, x, w)
    print(f"  step ({kernel}): {t_step:.3f} ms, {mp / t_step * 1e3:.1f} MP/s")
    print(f"  step memory_analysis: "
          f"{step.lower(x, w).compile().memory_analysis()}")

    pre = jax.jit(lambda x: resize_bicubic_u8(bgr2ycrcb_u8_planar(x),
                                              BENCH_OUT))
    t_pre, up = timed(pre, x)
    post = jax.jit(lambda y, up: ycrcb2bgr_u8_planar(
        jnp.stack([y, up[:, 1], up[:, 2]], axis=1)))
    t_post, _ = timed(post, up[:, 0], up)
    for name, ms, nbytes in (("pre-pass", t_pre, x.nbytes + up.nbytes),
                             ("post-pass", t_post, 2 * up.nbytes)):
        print(f"  XLA {name}: {ms:.3f} ms, {ms / t_step:.1%} of the step, "
              f"{nbytes / ms / 1e6:.1f} GB/s of input+output")

    yplanes = up[:CONV_BATCH, 0]
    del up
    mp8 = mp * CONV_BATCH / BENCH_BATCH
    for k in KERNELS:
        t_k, _ = timed(jax.jit(lambda y, w, k=k: _srcnn(y, w, k)), yplanes, w,
                       n=3)
        print(f"  conv {k}, batch {CONV_BATCH}: {t_k:.3f} ms, "
              f"{mp8 / t_k * 1e3:.1f} MP/s")
    del yplanes
    xla_step = jax.jit(lambda x, w: _upscale_planar_jit(x, w, BENCH_OUT,
                                                        "xla", "exact"))
    print(f"  xla step, batch {CONV_BATCH}, memory_analysis: "
          f"{xla_step.lower(x[:CONV_BATCH], w).compile().memory_analysis()}")
    del x

    frames = rng.integers(0, 256, (8, 1080, 1920, 3), dtype=np.uint8)
    run = configs.batch_1080p_to_4k()
    run(frames)
    t0 = time.perf_counter()
    out = run(frames)
    ms = (time.perf_counter() - t0) * 1e3
    assert out.shape == (8, 2160, 3840, 3), out.shape
    print(f"  configs.batch_1080p_to_4k(batch={run.batch}): {ms:.1f} ms for "
          f"8 frames with host transfer, {8 * 3840 * 2160 / 1e3 / ms:.1f} "
          f"MP/s")

    frame = rng.integers(0, 256, (2160, 3840, 3), dtype=np.uint8)
    big = configs.single_8k()
    big(frame)
    t0 = time.perf_counter()
    out = big(frame)
    ms = (time.perf_counter() - t0) * 1e3
    assert out.shape == (4320, 7680, 3), out.shape
    print(f"  configs.single_8k: 3840x2160 -> 7680x4320 in {ms:.1f} ms with "
          f"host transfer")

    small = rng.integers(0, 256, (6,) + BENCH_IN + (3,), dtype=np.uint8)
    stream = configs.stream_4k30()
    got = [o for f in small if (o := stream.push(f)) is not None]
    got += list(stream.drain())
    assert len(got) == len(small)
    for f, o in zip(small, got):
        assert np.array_equal(o, np.asarray(upscale_bgr(f, 2.0))), \
            "stream frame != upscale_bgr"
    stream = configs.stream_4k30()
    t0 = time.perf_counter()
    n = 0
    for f in np.concatenate([small] * 4):
        n += stream.push(f) is not None
    n += len(list(stream.drain()))
    dt = time.perf_counter() - t0
    print(f"  StreamUpscaler (configs.stream_4k30): {n} frames 960x540 -> "
          f"1920x1080 in order, equal to upscale_bgr; {n / dt:.1f} fps with "
          f"host transfer")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_train() -> None:
    from srcnn_cpp_tpu.train.trainer import fit

    _, losses = fit(EVAL_DIR, scale=2.0, steps=3, batch=16, verbose=False)
    print(f"  train losses: {losses}")
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)


def phase_single_8k_mesh() -> None:
    import jax

    from srcnn_cpp_tpu import configs
    from srcnn_cpp_tpu.parallel import make_mesh

    mesh = make_mesh(data=1, row=4)
    print(f"  mesh {dict(mesh.shape)} over {len(jax.devices())} devices")
    h, w = MESH_FRAME
    frame = np.random.default_rng(2).integers(0, 256, (h, w, 3),
                                              dtype=np.uint8)
    sharded = configs.single_8k(mesh=mesh)
    mono = configs.single_8k()
    want = mono(frame)
    got = sharded(frame)
    assert got.shape == want.shape == (2 * h, 2 * w, 3), got.shape
    mx, frac = lsb_diff(got, want)
    print(f"  single_8k {w}x{h} -> {2 * w}x{2 * h} on 4 cards vs 1 card: "
          f"max {mx} LSB, {frac:.3e} of values differ")
    assert mx <= 2 and frac < 0.01
    for name, run in (("1 card", mono), ("4 cards", sharded)):
        t0 = time.perf_counter()
        run(frame)
        print(f"  single_8k {name}: {(time.perf_counter() - t0) * 1e3:.1f} "
              f"ms with host transfer")


def phase_distributed_stream() -> None:
    from srcnn_cpp_tpu.parallel.distributed import frame_mesh, run_synthetic

    mesh = frame_mesh(data=1)
    h, w = STREAM_FRAME
    r = run_synthetic(4, (h, w), 2.0, mesh, depth=2, check=True)
    print(f"  DistributedStream {r['mesh']}: {r['frames']} frames {w}x{h} "
          f"-> {2 * w}x{2 * h}, {r['fps']:.2f} fps, bitexact "
          f"{r['bitexact']}, max {r['max_abs_diff']} LSB vs the one-card "
          f"pipeline")
    assert r["max_abs_diff"] <= 2


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            ok = False
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
            continue
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 2
    try:
        from srcnn_cpp_tpu.runtime import enable_compilation_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the package ({e}); run it from "
              f"the repository root", file=sys.stderr)
        return 2
    card_line()
    print(f"compile cache: {enable_compilation_cache()}")
    print(f"jax {jax.__version__}, devices: "
          f"{[d.device_kind for d in devs]}", flush=True)
    if args.four_cards:
        phases = [("single_8k_mesh", phase_single_8k_mesh),
                  ("distributed_stream", phase_distributed_stream)]
    else:
        phases = [("cli", phase_cli), ("goldens", phase_goldens),
                  ("conv", phase_conv), ("steady", phase_steady),
                  ("train", phase_train)]
    if not run_phases(phases):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
