"""Evaluation harness and streaming pipeline (CPU, small sizes)."""

import numpy as np
import pytest


def test_evaluate_image_gains_on_smooth_structure(weights):
    # a structured synthetic image: SRCNN should at least roughly track
    # bicubic (exact gains are content-dependent); sanity: finite, ordered
    from srcnn_cpp_tpu.evaluate import evaluate_image

    x = np.indices((64, 64)).sum(0)
    img = np.stack([x % 256, (x * 3) % 256, (x * 7) % 256], -1).astype(np.uint8)
    m = evaluate_image(img, 2.0, weights)
    for k, v in m.items():
        assert np.isfinite(v), k
    assert 10 < m["psnr_bicubic"] < 100
    assert 10 < m["psnr_srcnn"] < 100


def test_evaluate_cli_json(tmp_path):
    cv2 = pytest.importorskip("cv2")
    import json

    from srcnn_cpp_tpu.evaluate import main

    img = np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    p = tmp_path / "t.png"
    cv2.imwrite(str(p), img)
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--scale=2", "--json", str(p)])
    assert rc == 0
    data = json.loads(buf.getvalue())
    assert data["images"][0]["image"] == "t.png"
    assert data["decode"]["decoder"] == "cv2"


def test_eval_decode_provenance_matches_recorded():
    # EVAL.md numbers were minted with this exact decoder; on a drifted
    # host the eval CLI already warns (evaluate.py), so the suite SKIPS
    # rather than fails — the hard pin only holds on the minting host
    from srcnn_cpp_tpu.evaluate import EVAL_DECODE_PROVENANCE
    from srcnn_cpp_tpu.imageio import decode_provenance

    got = decode_provenance()
    if got != EVAL_DECODE_PROVENANCE:
        pytest.skip(f"decoder drifted ({got} != {EVAL_DECODE_PROVENANCE}); "
                    "EVAL.md numbers are only reproducible after re-minting")


def test_stream_upscaler_pipelines_in_order(weights):
    from srcnn_cpp_tpu.stream import StreamUpscaler

    up = StreamUpscaler(1.5, weights=weights, kernel="xla", depth=2)
    frames = [np.full((16, 16, 3), i * 10, dtype=np.uint8) for i in range(6)]
    outs = []
    for f in frames:
        r = up.push(f)
        if r is not None:
            outs.append(r)
    outs += list(up.drain())
    assert len(outs) == 6
    assert all(o.shape == (24, 24, 3) for o in outs)
    # order: constant frames map to near-constant outputs, increasing
    means = [o.mean() for o in outs]
    assert means == sorted(means)


def test_stream_synthetic_benchmark(weights):
    from srcnn_cpp_tpu.stream import run_synthetic

    r = run_synthetic(4, (32, 32), 2.0, "xla")
    assert r["frames"] == 4
    assert r["fps"] > 0


def test_stream_video_lossless_default(tmp_path, weights):
    # run_video's default codec is LOSSLESS (FFV1, matching the distributed
    # runner): the decoded output must be bit-identical to the pipeline on
    # the decoded input — fidelity must not silently end at the encoder
    cv2 = pytest.importorskip("cv2")
    from srcnn_cpp_tpu.pipeline import upscale_bgr
    from srcnn_cpp_tpu.stream import run_video

    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
              for _ in range(3)]
    src, dst = tmp_path / "in.avi", tmp_path / "out.avi"
    wr = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"FFV1"), 30.0,
                         (32, 24))
    if not wr.isOpened():
        pytest.skip("lossless FFV1 writer unavailable")
    for f in frames:
        wr.write(f)
    wr.release()

    assert run_video(str(src), str(dst), 2.0, "xla", verbose=False) == 0
    cap = cv2.VideoCapture(str(dst))
    for f in frames:
        ok, got = cap.read()
        assert ok
        want = np.asarray(upscale_bgr(f, 2.0, weights, kernel="xla"))
        np.testing.assert_array_equal(got, want)
    cap.release()


def test_stream_synthetic_uses_float_floor_geometry(weights):
    # the MP/s denominator must follow scaled_size's float32-floor rule
    # (srcnn.cpp:573-575), not int(h*scale): at 30x30 x2.1 they differ
    # (float32 30*2.1 = 62.999996 -> 62, double -> 63)
    from srcnn_cpp_tpu.ops.resize import scaled_size
    from srcnn_cpp_tpu.stream import run_synthetic

    h = w = 30
    ow, oh = scaled_size(w, h, 2.1)
    assert (oh, ow) == (62, 62) != (int(h * 2.1), int(w * 2.1))
    r = run_synthetic(2, (h, w), 2.1, "xla")
    mp_per_frame = r["mps"] * r["seconds"] / r["frames"]
    assert mp_per_frame == pytest.approx(oh * ow / 1e6, rel=1e-9)


def test_evaluate_default_kernel_matches_cli_default():
    import inspect

    from srcnn_cpp_tpu.cli import parse_args
    from srcnn_cpp_tpu.evaluate import evaluate_image

    cli_default = parse_args(["x.png"])["kernel"]
    eval_default = inspect.signature(evaluate_image).parameters["kernel"].default
    assert eval_default == cli_default


def test_stream_micro_batch_bit_identical_and_ordered(weights):
    # batch=3 micro-batching must emit the same frames in the same order
    # as batch=1 (the packed conv is bitwise equal to per-frame runs)
    from srcnn_cpp_tpu.stream import StreamUpscaler

    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
              for _ in range(7)]

    def collect(batch):
        up = StreamUpscaler(1.5, weights=weights, batch=batch, depth=1)
        outs = [o for f in frames if (o := up.push(f)) is not None]
        outs.extend(up.drain())
        return outs

    a, b = collect(1), collect(3)
    assert len(a) == len(b) == len(frames)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_stream_fused_resize_mode(weights):
    # the resize="fast" knob rides the banded-matmul pre-pass; outputs
    # must stay within its 1-LSB boundary flips (amplified to 2 by the
    # conv and the inverse colour transform) of the exact path
    from srcnn_cpp_tpu.stream import StreamUpscaler

    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (16, 64, 3), dtype=np.uint8)
              for _ in range(3)]

    def collect(resize):
        up = StreamUpscaler(2.0, weights=weights, depth=1, resize=resize)
        outs = [o for f in frames if (o := up.push(f)) is not None]
        outs.extend(up.drain())
        return outs

    a, b = collect("exact"), collect("fast")
    assert len(a) == len(b) == len(frames)
    for x, y in zip(a, b):
        d = np.abs(x.astype(int) - y.astype(int))
        assert d.max() <= 2 and (d > 0).mean() < 1e-3


def test_run_synthetic_device_smoke():
    # device-resident sustained-rate harness (config 5 record machinery):
    # tiny geometry smoke — frames accounted, rates positive
    from srcnn_cpp_tpu.stream import run_synthetic_device

    r = run_synthetic_device(4, (16, 144), 2.0, batch=2, depth=1)
    assert r["frames"] == 4 and r["fps"] > 0 and r["mps"] > 0
