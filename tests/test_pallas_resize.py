"""Colour + bicubic pre-pass: the XLA engines against the NumPy oracle.

The pre-pass runs as XLA ops on every backend (the GPU fuses its
elementwise and strided-slice chains).  Its numerics contract is
OpenCV 4.6's: ``oracle.bgr2ycrcb_u8_ref`` followed by the per-channel
``resize_bicubic_u8_np`` with separate mul and add roundings.  XLA may
contract the vertical pass's mul+add into an FMA, so a handful of
exact-.5-boundary pixels (~1e-5) may flip by 1 LSB; the gate allows <=1
LSB on a tiny fraction.  The geometries are those of every resize plan
family (strict phase plans, S=2 and S=4 parity plans, the generalized
x3 plan, and the gather fallback).
"""

import numpy as np
import pytest


def _engine(bgr_p, out_hw):
    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar
    from srcnn_cpp_tpu.ops.resize import resize_bicubic_u8

    return np.asarray(resize_bicubic_u8(bgr2ycrcb_u8_planar(bgr_p), out_hw))


def _ref(bgr_p, out_hw):
    """NumPy oracle on planar BGR ``[..., 3, H, W]``."""
    from srcnn_cpp_tpu.oracle import bgr2ycrcb_u8_ref
    from srcnn_cpp_tpu.ops.resize_tables import resize_bicubic_u8_np

    x = np.asarray(bgr_p)
    lead = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:])
    out = []
    for frame in x:
        ycc = bgr2ycrcb_u8_ref(np.moveaxis(frame, 0, -1))
        out.append(np.stack([resize_bicubic_u8_np(ycc[..., c], out_hw)
                             for c in range(3)]))
    return np.stack(out).reshape(lead + (3,) + tuple(out_hw))


def _assert_parity(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-4, (d > 0).mean()   # boundary flips only


@pytest.mark.parametrize("ih,iw,s", [
    (64, 96, 2), (32, 160, 2), (40, 128, 3), (24, 96, 4),
    (64, 96, 1.5), (54, 172, 1.5), (92, 250, 1.5),   # S=2 parity planes
    (64, 256, 0.5), (126, 300, 0.5),                 # 2:1 downscale (S=2)
    (64, 128, 1.25), (48, 160, 1.75), (40, 128, 2.5),   # S=4 / S=2
    (64, 192, 0.75), (63, 384, 1 / 3), (48, 512, 0.25),  # S=4/3/4 down
])
def test_fused_pre_parity_integer_scales(ih, iw, s):
    from srcnn_cpp_tpu.ops.resize import scaled_size

    rng = np.random.default_rng(int(ih + iw + s))
    x = rng.integers(0, 256, (2, 3, ih, iw), dtype=np.uint8)
    ow, oh = scaled_size(iw, ih, s)
    out_hw = (oh, ow)
    _assert_parity(_engine(x, out_hw), _ref(x, out_hw))


def test_fused_pre_bench_geometry():
    # the production x2 shape family (scaled down in H for test speed):
    # full-width 1080p columns exercise the dense band matmul at width
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (1, 3, 48, 1920), dtype=np.uint8)
    _assert_parity(_engine(x, (96, 3840)), _ref(x, (96, 3840)))


def test_fused_pre_single_frame_squeeze():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (3, 40, 144), dtype=np.uint8)
    got = _engine(x, (80, 288))
    assert got.shape == (3, 80, 288)
    _assert_parity(got, _ref(x[None], (80, 288))[0])


def test_fused_pre_declines_nonphase_geometries():
    # geometries without a bitwise phase plan take the gather fallback:
    # x1.2 (source step 5), a non-periodic ratio (50/64) and tiny planes
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (1, 3, 64, 128), dtype=np.uint8)
    for out_hw in [(76, 153), (50, 256)]:
        _assert_parity(_engine(x, out_hw), _ref(x, out_hw))
    tiny = rng.integers(0, 256, (1, 3, 2, 16), dtype=np.uint8)
    _assert_parity(_engine(tiny, (4, 32)), _ref(tiny, (4, 32)))


def test_pipeline_resize_fused_matches_exact(weights):
    # the whole pipeline against the NumPy oracle of the reference binary:
    # pre-pass boundary flips propagate through the conv and the inverse
    # colour transform, hence <=2 LSB on a tiny fraction
    from srcnn_cpp_tpu.oracle import pipeline_ref
    from srcnn_cpp_tpu.pipeline import _upscale_planar_jit

    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (2, 3, 32, 144), dtype=np.uint8)
    for scale, out_hw in [(2.0, (64, 288)), (1.5, (48, 216))]:
        a = np.asarray(_upscale_planar_jit(x, weights, out_hw, "xla",
                                           "exact"))
        for i in range(2):
            b = pipeline_ref(np.moveaxis(x[i], 0, -1), scale, weights)
            d = np.abs(np.moveaxis(a[i], 0, -1).astype(int) - b.astype(int))
            assert d.max() <= 2 and (d > 0).mean() < 1e-3, (
                scale, d.max(), (d > 0).mean())


@pytest.mark.parametrize("oh,ih,ow,iw,which", [
    (1620, 540, 288, 96, "v"),    # x3 rows cross the f32 boundary at 1536
    (192, 64, 1620, 540, "h"),    # x3 cols cross it
])
def test_fused_pre_generalized_plan(oh, ih, ow, iw, which):
    # Non-power-of-2 integer upscales past output 1536: OpenCV's float32
    # fractional offsets stop repeating bitwise, so the strict phase plan
    # declines on that axis and the engine takes its gather form there
    from srcnn_cpp_tpu.ops.resize import _hphase_plan, _vphase_plan

    if which == "v":
        assert _vphase_plan(oh, ih) is None
    else:
        assert _hphase_plan(ow, iw) is None
    rng = np.random.default_rng(oh + ow)
    x = rng.integers(0, 256, (1, 3, ih, iw), dtype=np.uint8)
    _assert_parity(_engine(x, (oh, ow)), _ref(x, (oh, ow)))


def test_fused_pre_fuzz_random_geometries():
    # randomized geometries across ALL plan families — integer upscales
    # (strict), x1.5/x0.5 (S=2 parity planes), x1.25/x0.75 (S=4): odd
    # widths/heights exercise ragged tile overshoot, phase interleaves
    # and the padding arithmetic
    from srcnn_cpp_tpu.ops.resize import scaled_size

    rng = np.random.default_rng(42)
    tried = 0
    scales = [2, 3, 4, 1.5, 0.5, 1.25, 0.75]
    for i in range(21):
        s = scales[i % len(scales)]
        mult = {0.5: 2, 1.25: 4, 0.75: 4}.get(s, 1)
        ih = int(rng.integers(9, 70)) * mult
        iw = int(rng.integers(33, 400)) * (2 if s == 0.5 else mult)
        ow, oh = scaled_size(iw, ih, s)
        if oh < 8 or ow < 128:
            continue
        x = rng.integers(0, 256, (1, 3, ih, iw), dtype=np.uint8)
        tried += 1
        _assert_parity(_engine(x, (oh, ow)), _ref(x, (oh, ow)))
    assert tried >= 12, f"fuzz covered only {tried} geometries"
