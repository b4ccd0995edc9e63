"""CLI surface tests: flags, default output naming, exit codes, narration.

Mirrors the reference arg parser semantics (reference src/srcnn.cpp:331-425)
without spawning a subprocess per case (parse_args is pure); one subprocess
test covers the full binary-equivalent invocation.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from srcnn_cpp_tpu.cli import parse_args


def test_defaults():
    opts = parse_args(["photo.png"])
    assert opts["scale"] == 2.0
    assert opts["verbose"] is True
    assert opts["src"] == "photo.png"
    assert opts["dst"] == "photo_resized.png"


def test_scale_parsing():
    assert parse_args(["--scale=1.5", "a.jpg"])["scale"] == 1.5
    # non-positive or malformed scales fall back to the default (ref :359-370)
    assert parse_args(["--scale=-3", "a.jpg"])["scale"] == 2.0
    assert parse_args(["--scale=abc", "a.jpg"])["scale"] == 2.0


def test_noverbose_and_dst():
    opts = parse_args(["--noverbose", "in.png", "out.png"])
    assert opts["verbose"] is False
    assert opts["dst"] == "out.png"


def test_help_returns_none():
    assert parse_args(["--help"]) is None


def test_missing_src_exits_zero():
    # the reference prints title+help and returns 0 when parseArgs fails
    # (srcnn.cpp:709-715) — bare/`--noverbose`-only invocations match that
    from srcnn_cpp_tpu.cli import main

    assert main(["--noverbose"]) == 0


def test_unknown_flag_rejected(capsys):
    from srcnn_cpp_tpu.cli import UsageError, main

    with pytest.raises(UsageError):
        parse_args(["--bogus", "a.png"])
    assert main(["--bogus", "a.png"]) == 1
    assert "unknown option" in capsys.readouterr().err


def test_malformed_extension_flag_values(capsys):
    from srcnn_cpp_tpu.cli import UsageError, main

    for argv in (["--repeat=abc", "a.png"],
                 ["--kernel=cuda", "a.png"],
                 ["--resize=nearest", "a.png"]):
        with pytest.raises(UsageError):
            parse_args(argv)
        assert main(argv) == 1
    assert parse_args(["--repeat=3", "a.png"])["repeat"] == 3
    assert parse_args(["--repeat=0", "a.png"])["repeat"] == 1


def test_cli_downscale_end_to_end(monkeypatch, tmp_path):
    # --scale=0.5 runs the full pipeline at scale < 1 (the reference
    # accepts any positive scale, srcnn.cpp:359-370) and writes the
    # oracle-exact shrunken image
    import srcnn_cpp_tpu.cli as cli
    from srcnn_cpp_tpu.oracle import pipeline_ref

    img = np.random.default_rng(5).integers(0, 256, (32, 44, 3),
                                            dtype=np.uint8)
    written = {}
    monkeypatch.setattr(cli, "imread_bgr", lambda p: img)
    monkeypatch.setattr(cli, "imwrite_bgr",
                        lambda p, o: written.update({p: np.asarray(o)}) or True)
    opts = parse_args(["--noverbose", "--scale=0.5",
                       str(tmp_path / "in.png")])
    assert cli.run(opts) == 0
    (out,) = written.values()
    assert out.shape == (16, 22, 3)
    assert np.abs(out.astype(int)
                  - pipeline_ref(img, 0.5).astype(int)).max() <= 1


def test_exit_code_colorspace(monkeypatch, capsys):
    # a decoded image that is not 3-channel maps to the reference's
    # cvtColor failure code (-2 -> 2, srcnn.cpp:509-526)
    import srcnn_cpp_tpu.cli as cli

    monkeypatch.setattr(cli, "imread_bgr",
                        lambda p: np.zeros((8, 8), np.uint8))
    opts = parse_args(["--noverbose", "gray.png"])
    assert cli.run(opts) == 2


def test_exit_code_split(monkeypatch):
    # wrong output plane count maps to the split/merge failure (-3 -> 3)
    import srcnn_cpp_tpu.cli as cli

    monkeypatch.setattr(cli, "imread_bgr",
                        lambda p: np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setattr(cli, "upscale_bgr",
                        lambda *a, **k: np.zeros((16, 16, 2), np.uint8))
    monkeypatch.setattr(cli, "load_weights", lambda: None)
    opts = parse_args(["--noverbose", "in.png"])
    assert cli.run(opts) == 3


def test_exit_code_load_failure(monkeypatch):
    import srcnn_cpp_tpu.cli as cli

    monkeypatch.setattr(cli, "imread_bgr", lambda p: None)
    opts = parse_args(["--noverbose", "missing.png"])
    assert cli.run(opts) == 1


@pytest.mark.slow
def test_end_to_end_subprocess(tmp_path):
    import cv2

    src = tmp_path / "in.png"
    img = np.random.default_rng(0).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    cv2.imwrite(str(src), img)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run(
        [sys.executable, "-m", "srcnn_cpp_tpu", "--scale=1.5", str(src)],
        capture_output=True, text=True, env=env, timeout=600, cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr
    out_path = tmp_path / "in_resized.png"
    assert out_path.exists()
    out = cv2.imread(str(out_path))
    assert out.shape == (48, 72, 3)
    assert "Performance" in proc.stdout


def test_resize_auto_default_and_resolution():
    """--resize defaults to auto; auto resolves to the exact engine."""
    from srcnn_cpp_tpu.cli import UsageError, parse_args
    from srcnn_cpp_tpu.runtime import resolve_resize

    assert parse_args(["a.png"])["resize"] == "auto"
    assert parse_args(["--resize=fast", "a.png"])["resize"] == "fast"
    with pytest.raises(UsageError):       # the Pallas pre-pass is gone
        parse_args(["--resize=fused", "a.png"])
    assert resolve_resize("auto") == "exact"
    for mode in ("exact", "fast"):  # concrete modes pass through
        assert resolve_resize(mode) == mode
    with pytest.raises(ValueError):
        resolve_resize("fused")
