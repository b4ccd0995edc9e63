"""End-to-end pipeline against the reference binary's own outputs.

``tests/golden/butterfly_x{0.75,1.25,1.5,2,3}_ref.png`` are the literal
outputs of the reference binary (built from its sources with OpenCV 4.6)
on butterfly.png (the 0.75/1.25 pair covers the S=4 phase-plan scales).  The accuracy gate from BASELINE.md is PSNR within 0.05 dB of
the reference at x1.5/x2/x3; the pipeline here lands around 60+ dB *against
the reference output itself*, i.e. the two are visually and metrically
indistinguishable (residual: fp32 reassociation inside the conv stack vs the
-ffast-math binary).
"""

import numpy as np
import pytest

from srcnn_cpp_tpu.utils.metrics import psnr
from tests.conftest import golden_ref


@pytest.mark.parametrize(
    "scale,tag",
    [(1.5, "1.5"),
     pytest.param(2.0, "2", marks=pytest.mark.slow),
     pytest.param(3.0, "3", marks=pytest.mark.slow),
     # the S=4 phase-plan scales: goldens minted from the same binary
     # build
     (1.25, "1.25"), (0.75, "0.75")],
)
def test_golden_butterfly(butterfly_bgr, scale, tag):
    from srcnn_cpp_tpu.pipeline import upscale_bgr

    ref = golden_ref(tag)
    out = np.asarray(upscale_bgr(butterfly_bgr, scale))
    assert out.shape == ref.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    # fp32 reassociation can push a Y value across its quantization
    # boundary; the YCrCb->BGR conversion then amplifies 1 Y LSB to 2 BGR
    # LSB on isolated pixels.  Gate: <=2 LSB, vanishing count, high PSNR.
    assert diff.max() <= 2, f"max LSB diff {diff.max()}"
    assert (diff > 1).mean() < 1e-5
    p = psnr(out, ref)
    assert p > 55.0, f"PSNR vs reference output {p:.2f} dB"


def test_oracle_pipeline_bit_faithful(butterfly_bgr):
    # The NumPy oracle is the strictest parity artifact: <= 1 LSB on a
    # handful of pixels per megapixel vs the actual binary.
    from srcnn_cpp_tpu.oracle import pipeline_ref

    ref = golden_ref("1.5")
    out = pipeline_ref(butterfly_bgr, 1.5)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-4


def test_output_size_matches_reference_rule():
    from srcnn_cpp_tpu.pipeline import upscale_bgr

    img = np.random.default_rng(0).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    out = np.asarray(upscale_bgr(img, 1.5))
    assert out.shape == (55, 79, 3)  # floor(37*1.5), floor(53*1.5)


def test_process_srcnn_buffer_api():
    from srcnn_cpp_tpu.pipeline import process_srcnn

    rng = np.random.default_rng(1)
    h, w, d = 24, 16, 3
    buf = rng.integers(0, 256, h * w * d, dtype=np.uint8)
    out, n = process_srcnn(buf, w, h, d, 2.0)
    assert n == (2 * w) * (2 * h) * d  # contract from reference test.cpp:357-361
    assert out.dtype == np.uint8 and out.size == n

    buf1 = rng.integers(0, 256, h * w, dtype=np.uint8)
    out1, n1 = process_srcnn(buf1, w, h, 1, 1.5)
    assert n1 == int(w * 1.5) * int(h * 1.5)


def test_matches_oracle_on_arbitrary_size():
    # Cross-validates the full jitted pipeline against the pure-NumPy oracle
    # (which uses plain-bicubic Cr/Cb by construction, srcnn.cpp:609,627,638)
    # on a non-square, non-multiple-of-anything image.
    from srcnn_cpp_tpu.oracle import pipeline_ref
    from srcnn_cpp_tpu.pipeline import upscale_bgr

    img = np.random.default_rng(9).integers(0, 256, (41, 67, 3), dtype=np.uint8)
    out = np.asarray(upscale_bgr(img, 2.0))
    ref = pipeline_ref(img, 2.0)
    assert out.shape == ref.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("scale", [0.5, 0.75])
def test_matches_oracle_downscale(scale):
    # The reference accepts ANY scale > 0 (srcnn.cpp:359-370): scale < 1
    # shrinks with the same INTER_CUBIC pre-pass (no anti-aliasing — OpenCV
    # INTER_CUBIC semantics) and still runs the conv stack on the small Y.
    # e2e parity vs the NumPy oracle, both through the pipeline and the CLI
    # scale plumbing (upscale_bgr is exactly what cli.run calls).
    from srcnn_cpp_tpu.oracle import pipeline_ref, scaled_size
    from srcnn_cpp_tpu.pipeline import upscale_bgr

    img = np.random.default_rng(13).integers(0, 256, (48, 70, 3),
                                             dtype=np.uint8)
    out = np.asarray(upscale_bgr(img, scale))
    ref = pipeline_ref(img, scale)
    ow, oh = scaled_size(70, 48, scale)
    assert out.shape == (oh, ow, 3) == ref.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_conv_image_normalization_matches_reference():
    """conv_image mirrors the reference harness's convImage cases
    (reference src/test.cpp:34-134)."""
    from srcnn_cpp_tpu.imageio import conv_image

    rng = np.random.default_rng(3)
    h, w = 5, 7
    # d=1 gray -> R=G=B (test.cpp:47-60)
    gray = rng.integers(0, 256, h * w, dtype=np.uint8)
    rgb = conv_image(gray, w, h, 1)
    assert rgb.shape == (h, w, 3)
    assert all(np.array_equal(rgb[..., c], gray.reshape(h, w)) for c in range(3))

    # d=2 RGB565 -> raw field extraction, NO 8-bit expansion (test.cpp:71-83)
    px = rng.integers(0, 1 << 16, h * w, dtype=np.uint16)
    rgb = conv_image(px.view(np.uint8), w, h, 2)
    v = px.reshape(h, w)
    assert np.array_equal(rgb[..., 0], (v & 0xF800) >> 11)
    assert np.array_equal(rgb[..., 1], (v & 0x07E0) >> 5)
    assert np.array_equal(rgb[..., 2], v & 0x001F)
    assert rgb[..., 0].max() <= 31 and rgb[..., 1].max() <= 63

    # d=3 -> copy (test.cpp:121-128)
    tri = rng.integers(0, 256, h * w * 3, dtype=np.uint8)
    assert np.array_equal(conv_image(tri, w, h, 3).reshape(-1), tri)

    # d=4 RGBA -> alpha-premultiplied, truncating float->u8 (test.cpp:95-108)
    quad = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgb = conv_image(quad.reshape(-1), w, h, 4)
    alp = quad[..., 3:4].astype(np.float32) / 255.0
    want = (quad[..., :3].astype(np.float32) * alp).astype(np.uint8)
    assert np.array_equal(rgb, want)

    with pytest.raises(ValueError):
        conv_image(tri, w, h, 5)


def test_process_srcnn_rgb565():
    # the reference harness feeds ProcessSRCNN through convImage; depth-2
    # buffers are accepted directly and come back 3-channel
    from srcnn_cpp_tpu.imageio import conv_image
    from srcnn_cpp_tpu.pipeline import process_srcnn

    rng = np.random.default_rng(4)
    h, w = 12, 10
    px = rng.integers(0, 1 << 16, h * w, dtype=np.uint16)
    out, n = process_srcnn(px.view(np.uint8), w, h, 2, 2.0)
    assert n == (2 * w) * (2 * h) * 3
    ref, m = process_srcnn(conv_image(px.view(np.uint8), w, h, 2).reshape(-1),
                           w, h, 3, 2.0)
    assert m == n and np.array_equal(out, ref)


def test_process_srcnn_rgba():
    from srcnn_cpp_tpu.pipeline import process_srcnn

    rng = np.random.default_rng(2)
    h, w = 16, 20
    buf = rng.integers(0, 256, h * w * 4, dtype=np.uint8)
    out, n = process_srcnn(buf, w, h, 4, 2.0)
    assert n == (2 * w) * (2 * h) * 4
    rgba = out.reshape(2 * h, 2 * w, 4)
    # alpha is plain bicubic of the alpha plane
    from srcnn_cpp_tpu.ops.resize_tables import resize_bicubic_u8_np

    a_ref = resize_bicubic_u8_np(
        buf.reshape(h, w, 4)[..., 3], (2 * h, 2 * w))
    assert np.array_equal(rgba[..., 3], a_ref)


def test_tiny_image_shapes(weights):
    # degenerate geometries exercise every border fallback: w<=8 strip
    # fallback, h<8 corner fallback, single-pixel planes
    import numpy as np
    from srcnn_cpp_tpu.pipeline import upscale_bgr
    from srcnn_cpp_tpu.ops.resize import scaled_size

    rng = np.random.default_rng(0)
    for (h, w) in [(7, 5), (8, 9), (5, 40), (40, 5), (1, 1)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out = np.asarray(upscale_bgr(img, 2.0, weights))
        ow, oh = scaled_size(w, h, 2.0)
        assert out.shape == (oh, ow, 3), (h, w, out.shape)
