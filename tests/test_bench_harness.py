"""CPU tests of the harness around the device path: the backend resolver,
the compile-cache location, the standard-library PNG codec, and the
refusal of chip_smoke.py and bench.py to report anything without a GPU."""

import importlib.util
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backend,want", [
    ("gpu", "pallas"), ("cpu", "xla"), ("metal", "xla")])
def test_resolve_kernel_auto_per_backend(backend, want):
    from srcnn_cpp_tpu.runtime import resolve_kernel

    assert resolve_kernel("auto", backend) == want


def test_resolve_kernel_concrete_and_errors():
    from srcnn_cpp_tpu.runtime import resolve_kernel

    assert resolve_kernel("xla", "cpu") == resolve_kernel("xla", "gpu") == "xla"
    with pytest.raises(ValueError, match="unknown kernel"):
        resolve_kernel("xla_split", "gpu")          # removed: slower than xla
    assert resolve_kernel("pallas", "gpu") == "pallas"
    with pytest.raises(ValueError, match="Triton kernel for CUDA GPUs"):
        resolve_kernel("pallas", "cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        resolve_kernel("mosaic", "gpu")
    # the hermetic suite runs on the CPU backend
    assert resolve_kernel() == "xla"


def test_pipeline_and_cli_refuse_pallas_on_cpu(capsys):
    from srcnn_cpp_tpu import cli
    from srcnn_cpp_tpu.pipeline import upscale_bgr

    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="cannot compile"):
        upscale_bgr(img, 2.0, kernel="pallas")
    src = ROOT / "tests" / "data" / "eval" / "teapot.png"
    assert cli.main(["--kernel=pallas", "--noverbose", str(src),
                     os.devnull]) == 1
    assert "cannot compile" in capsys.readouterr().err


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    from srcnn_cpp_tpu import runtime

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert runtime.cache_dir() == tmp_path / "c"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert runtime.cache_dir() == ROOT / ".jax_cache"
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_enable_compilation_cache_sets_jax_config(monkeypatch, tmp_path):
    import jax

    from srcnn_cpp_tpu.runtime import enable_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    try:
        assert enable_compilation_cache() == tmp_path / "jc"
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jc")
        assert (tmp_path / "jc").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """Encode ``img [H, W, C]`` applying PNG filter ``filters[y]`` per row."""
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int64)
    rows = []
    for y in range(h):
        cur = raw[y]
        prev = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            pa = np.abs(prev - upleft)
            pb = np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8)
                    .tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_png_decode_every_filter(ch):
    from srcnn_cpp_tpu.imageio import png_decode

    img = np.random.default_rng(ch).integers(0, 256, (10, 7, ch), np.uint8)
    got = png_decode(_png_with_filters(img, [0, 1, 2, 3, 4]))
    assert np.array_equal(got, img)


def test_png_roundtrip_and_cv2_agreement():
    from srcnn_cpp_tpu.imageio import png_decode, png_encode

    rng = np.random.default_rng(0)
    for shape in [(5, 9), (6, 4, 3), (3, 8, 4)]:
        img = rng.integers(0, 256, shape, np.uint8)
        back = png_decode(png_encode(img))
        assert np.array_equal(back.reshape(img.shape), img), shape
    cv2 = pytest.importorskip("cv2")
    rgb = rng.integers(0, 256, (12, 17, 3), np.uint8)
    dec = cv2.imdecode(np.frombuffer(png_encode(rgb), np.uint8),
                       cv2.IMREAD_COLOR)
    assert np.array_equal(dec, rgb[..., ::-1])


def test_imageio_falls_back_to_png_codec(monkeypatch, tmp_path):
    from srcnn_cpp_tpu import imageio

    golden = ROOT / "tests" / "golden" / "butterfly_x0.75_ref.png"
    want = imageio.imread_bgr(golden)
    monkeypatch.setattr(imageio, "_HAVE_CV2", False)
    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL -> error
    got = imageio.imread_bgr(golden)
    assert np.array_equal(got, want)
    dst = tmp_path / "out.png"
    assert imageio.imwrite_bgr(dst, got)
    assert np.array_equal(imageio.imread_bgr(dst), want)
    assert not imageio.imwrite_bgr(tmp_path / "out.jpg", got)
    assert imageio.imread_bgr(tmp_path / "missing.png") is None
    assert imageio.decode_provenance()["decoder"] == "png-zlib"


def test_chip_smoke_refuses_cpu(capsys):
    smoke = _load("chip_smoke")
    assert smoke.main([]) != 0
    assert smoke.main(["--four-cards"]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_chip_smoke_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repository
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_audit_precision_flags_unstated_f32():
    import jax
    import jax.numpy as jnp
    from jax import lax

    smoke = _load("chip_smoke")
    a = jnp.ones((8, 16), jnp.float32)
    txt = jax.jit(lambda a: jnp.dot(a, a.T)).lower(a).as_text()
    with pytest.raises(AssertionError, match="without HIGHEST"):
        smoke.audit_precision("dot", txt)
    txt = jax.jit(lambda a: jnp.dot(a, a.T, precision=lax.Precision.HIGHEST)
                  ).lower(a).as_text()
    smoke.audit_precision("dot", txt)
    b = a.astype(jnp.bfloat16)
    smoke.audit_precision("bf16", jax.jit(lambda b: jnp.dot(
        b, b.T, preferred_element_type=jnp.float32)).lower(b).as_text())


def test_bench_refuses_cpu(capsys):
    bench = _load("bench")
    assert bench.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err
    assert bench.BATCH <= 16      # fits one 80 GB card on every conv path
