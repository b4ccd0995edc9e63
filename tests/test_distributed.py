"""Multi-process distributed runtime integration tests.

Spawns real OS processes that each call ``jax.distributed.initialize`` on
the CPU backend (2 processes x 2 virtual devices) and stream frames through
the full sharded pipeline with cross-process halo exchange — the hermetic
stand-in for a 2-host slice (SURVEY.md §4d, §5.8).  The ``--check`` flag
makes every process verify its locally-owned output block bit-exactly
against the monolithic single-device pipeline.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(port, pid, nprocs, extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-m", "srcnn_cpp_tpu.parallel.distributed",
         f"--coordinator=127.0.0.1:{port}",
         f"--num-processes={nprocs}", f"--process-id={pid}",
         "--local-devices=2", "--platform=cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO)


def _run_all(nprocs, extra, timeout=600):
    port = _free_port()
    procs = [_spawn(port, pid, nprocs, extra) for pid in range(nprocs)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\nstdout:{o}\nstderr:{e}"
    # Gloo interleaves its own progress lines on stdout: take the JSON line
    return [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("{"))) for o, _ in outs]


def test_two_process_stream_bitexact_row_spanning():
    """Rows of one frame span both processes: halos cross the process
    boundary and the stitched result must equal the monolith bit-for-bit."""
    rows = _run_all(2, ["--frames=3", "--size=64x48", "--scale=2", "--check"])
    for r in rows:
        assert r["processes"] == 2
        assert r["mesh"]["row"] == 4
        assert r["bitexact"] is True
        assert r["max_abs_diff"] == 0


def test_two_process_stream_bitexact_data_parallel():
    """data=2: each process owns whole frames; rows shard intra-process."""
    rows = _run_all(2, ["--data=2", "--frames=2", "--size=48x64",
                        "--scale=1.5", "--check"])
    for r in rows:
        assert r["mesh"] == {"data": 2, "row": 2, "col": 1}
        assert r["bitexact"] is True


def _write_video(path, frames) -> bool:
    """Write uint8 BGR frames losslessly (FFV1); False if unsupported."""
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), 30.0,
                         (w, h))
    if not wr.isOpened():
        return False
    for f in frames:
        wr.write(f)
    wr.release()
    return True


def _read_video(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


def _video_frames(n, h, w, seed=0):
    """Distinct per-frame content (stripe index) so ordering bugs surface."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        f = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        f[:2, :, :] = (i * 29) % 256
        frames.append(f)
    return frames


@pytest.mark.parametrize("data", [1, 2])
def test_two_process_video_stream_bitexact(tmp_path, data):
    """BASELINE config 5 end-to-end: REAL frame I/O through the 2-process
    stream — every process decodes the file, pushes its local slab, process
    0 encodes ordered lossless output; --check pins order + bit-exactness
    against the monolith per decoded frame."""
    import cv2  # noqa: F401 — skip early when cv2 is absent

    src = tmp_path / "in.avi"
    frames = _video_frames(8, 64, 96)
    if not _write_video(src, frames):
        pytest.skip("lossless FFV1 writer unavailable")
    dst = tmp_path / "out.avi"
    rows = _run_all(2, [f"--data={data}", f"--video-in={src}",
                        f"--video-out={dst}", "--scale=2", "--check"])
    for r in rows:
        assert r["frames"] == 8
        assert r["bitexact"] is True, r
        assert r["max_abs_diff"] == 0
    # the written file is faithful and ordered: decode and compare to the
    # monolithic pipeline frame for frame.  Bit-exactness proper is pinned
    # by the subprocess --check above (same process environment); ACROSS
    # environments XLA:CPU conv reductions can differ by 1 f32 ulp (the
    # host-platform device count changes intra-op threading), which can
    # flip a truncation boundary — so this cross-process comparison allows
    # <=1 LSB, and order is pinned by requiring every other frame to be
    # grossly different (each input frame carries a distinct stripe).
    from srcnn_cpp_tpu.pipeline import upscale_bgr
    from srcnn_cpp_tpu.weights import load_weights

    out_frames = _read_video(dst)
    assert len(out_frames) == 8
    w = load_weights()
    monos = [np.asarray(upscale_bgr(f, 2.0, w, kernel="xla"))
             for f in frames]
    for i, out in enumerate(out_frames):
        diffs = [np.abs(out.astype(int) - m.astype(int)).max()
                 for m in monos]
        assert diffs[i] <= 1, f"frame {i}: {diffs[i]}"
        assert all(d > 1 for j, d in enumerate(diffs) if j != i), \
            f"frame {i} order ambiguity: {diffs}"


@pytest.mark.slow
def test_two_process_video_stream_4k(tmp_path):
    """>=8 real 4K-output frames (1080p x2) through 2 processes with
    ordered bit-exact output (VERDICT r2 item 4).  Heavyweight on CPU
    (~90 s compile + tens of seconds per frame group) -> slow-marked;
    run with ``-m slow``."""
    import cv2  # noqa: F401

    src = tmp_path / "in4k.avi"
    frames = _video_frames(8, 1080, 1920, seed=1)
    if not _write_video(src, frames):
        pytest.skip("lossless FFV1 writer unavailable")
    dst = tmp_path / "out4k.avi"
    rows = _run_all(2, ["--data=2", f"--video-in={src}",
                        f"--video-out={dst}", "--scale=2", "--check"],
                    timeout=3000)
    for r in rows:
        assert r["frames"] == 8
        assert r["bitexact"] is True, r
    out_frames = _read_video(dst)
    assert len(out_frames) == 8
    assert out_frames[0].shape == (2160, 3840, 3)


def test_two_process_training_matches_single_process(weights):
    """Gradients flow backward through a CROSS-PROCESS ppermute (the halo
    exchange transpose) and psum: losses and updated weights from the
    2-process run must match the same mesh shape run in one process.
    FP tolerance, not bitwise: XLA:CPU reduction order differs with the
    local device count (see test_two_process_video_stream_bitexact)."""
    import jax

    from srcnn_cpp_tpu.parallel import make_mesh
    from srcnn_cpp_tpu.parallel.distributed import run_train

    # data=1: the row axis spans both processes, so halo grads cross the
    # process boundary; data=2 keeps rows intra-process (both covered)
    for data in (1, 2):
        rows = _run_all(2, ["--train", "--train-steps=3", "--size=32x32",
                            f"--data={data}"])
        mesh = make_mesh(data=data, row=4 // data,
                         devices=jax.devices()[:4])
        ref = run_train(3, (32, 32), mesh, weights=weights)
        assert ref["losses"][2] < ref["losses"][0]   # it actually learns
        for r in rows:
            assert r["mesh"]["data"] == data
            np.testing.assert_allclose(r["losses"], ref["losses"],
                                       rtol=1e-4)
            for k, v in ref["weight_fingerprint"].items():
                got = r["weight_fingerprint"][k]
                np.testing.assert_allclose(got, v, rtol=1e-5,
                                           err_msg=f"{data=} {k}")


def test_single_process_stream_on_virtual_mesh(weights):
    """The same runner degenerates to one process on the 8-device mesh."""
    from srcnn_cpp_tpu.parallel.distributed import frame_mesh, run_synthetic

    mesh = frame_mesh(data=2)
    r = run_synthetic(2, (48, 64), 2.0, mesh, weights=weights, depth=1,
                      check=True)
    assert r["bitexact"] is True
    assert r["frames"] == 4  # 2 pushes x data=2 frames per dispatch


def test_local_bounds_cover_sharding(weights):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from srcnn_cpp_tpu.parallel.distributed import _local_bounds, frame_mesh

    mesh = frame_mesh(data=2)
    spec = NamedSharding(mesh, P("data", None, "row", None))
    b = _local_bounds(spec, (4, 3, 32, 16), dims=(0, 2))
    assert b[0] == (0, 4)       # single process: owns everything
    assert b[2] == (0, 32)


def test_single_process_stream_fused_variant(weights):
    """x1.5 through the stream: the GSPMD-sharded resize at a non-integer
    scale (parity phase plans) plus the row-tiled conv; output matches the
    monolithic pipeline bit for bit."""
    from srcnn_cpp_tpu.parallel.distributed import frame_mesh, run_synthetic

    mesh = frame_mesh(data=2)
    r = run_synthetic(2, (48, 64), 1.5, mesh, weights=weights, depth=1,
                      check=True, kernel="xla")
    assert r["frames"] == 4
    assert r["bitexact"] is True and r["max_abs_diff"] == 0, r


def test_two_process_stream_fused_variant():
    """2 OS processes, x1.5 with rows spanning both: the GSPMD resize's
    boundary comms and the conv halos cross the process boundary; each
    process checks its block against the monolithic pipeline."""
    rows = _run_all(2, ["--frames=2", "--size=64x48", "--scale=1.5",
                        "--kernel=xla", "--check"])
    for r in rows:
        assert r["processes"] == 2
        assert r["bitexact"] is True and r["max_abs_diff"] == 0, r
