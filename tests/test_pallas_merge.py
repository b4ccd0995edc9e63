"""Merge + YCrCb->BGR post-pass: the XLA path against the NumPy oracle.

The inverse colour transform is integer-exact in f32 on every backend —
no FMA-contraction rounding hazard — so these tests assert bit equality
with ``oracle.ycrcb2bgr_u8_ref`` (OpenCV's fixed-point cvtColor).
"""

import numpy as np
import pytest


def _post(y_sr, up):
    """The pipeline's post-pass on planar ``y_sr [B,H,W]``, ``up [B,3,H,W]``."""
    import jax.numpy as jnp

    from srcnn_cpp_tpu.ops.color import ycrcb2bgr_u8_planar

    merged = jnp.stack([jnp.asarray(y_sr), jnp.asarray(up[:, 1]),
                        jnp.asarray(up[:, 2])], axis=-3)
    return np.asarray(ycrcb2bgr_u8_planar(merged))


def _ref(y_sr, up):
    from srcnn_cpp_tpu.oracle import ycrcb2bgr_u8_ref

    merged = np.stack([np.asarray(y_sr), np.asarray(up)[:, 1],
                       np.asarray(up)[:, 2]], axis=-1)      # [B, H, W, 3]
    return np.moveaxis(ycrcb2bgr_u8_ref(merged), -1, 1)


@pytest.mark.parametrize("b,oh,ow", [
    (2, 64, 128), (1, 40, 256), (3, 136, 1920),
])
def test_merge_fused_bit_equal(b, oh, ow):
    rng = np.random.default_rng(oh + ow)
    y_sr = rng.integers(0, 256, (b, oh, ow), dtype=np.uint8)
    up = rng.integers(0, 256, (b, 3, oh, ow), dtype=np.uint8)
    assert np.array_equal(_post(y_sr, up), _ref(y_sr, up))


def test_merge_fused_full_u8_range_rows():
    # exercise every (y, cr) and (y, cb) pair on clip boundaries: extreme
    # chroma drives b/g/r far outside [0, 255]
    y = np.tile(np.arange(256, dtype=np.uint8), (1, 8, 1))
    for cr, cb in [(0, 0), (255, 255), (0, 255), (255, 0), (128, 128)]:
        up = np.empty((1, 3, 8, 256), dtype=np.uint8)
        up[:, 1] = cr
        up[:, 2] = cb
        assert np.array_equal(_post(y, up), _ref(y, up)), (cr, cb)


@pytest.mark.parametrize("b,oh,ow", [
    (1, 64, 576),    # butterfly x1.5 width
    (1, 12, 128),
    (2, 537, 1111),  # odd sizes
])
def test_merge_fused_ragged_geometry_bit_equal(b, oh, ow):
    rng = np.random.default_rng(3 * oh + ow)
    y_sr = rng.integers(0, 256, (b, oh, ow), dtype=np.uint8)
    up = rng.integers(0, 256, (b, 3, oh, ow), dtype=np.uint8)
    assert np.array_equal(_post(y_sr, up), _ref(y_sr, up))


def test_merge_fused_declines_tiny_planes():
    # tiny planes take the same path and stay exact
    rng = np.random.default_rng(5)
    for shape in [(1, 64, 96), (1, 4, 128), (1, 1, 1)]:
        y = rng.integers(0, 256, shape, dtype=np.uint8)
        up = rng.integers(0, 256, (shape[0], 3) + shape[1:], dtype=np.uint8)
        assert np.array_equal(_post(y, up), _ref(y, up)), shape


@pytest.mark.parametrize("b,h,w", [(2, 48, 200), (1, 64, 96), (3, 41, 130)])
def test_srcnn_merge_fused_bit_equal(weights, b, h, w):
    # conv + quantize + merge + inverse colour as the pipeline composes
    # them: the merge of the conv output equals the oracle's merge of the
    # same planes, and the conv stays within its 1-LSB budget of the
    # NumPy oracle
    from srcnn_cpp_tpu.oracle import srcnn_y_ref
    from srcnn_cpp_tpu.pipeline import _srcnn

    rng = np.random.default_rng(b + h + w)
    up = rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)
    y_sr = np.asarray(_srcnn(up[:, 0], weights, "xla"))
    np.testing.assert_array_equal(_post(y_sr, up), _ref(y_sr, up))
    want = np.stack([srcnn_y_ref(f, weights) for f in up[:, 0]])
    assert np.abs(y_sr.astype(int) - want.astype(int)).max() <= 1


def test_pipeline_fused_post_pass_engages(weights):
    # the post-pass inside the jitted pipeline equals the oracle's merge of
    # the pipeline's own Y and chroma planes
    import jax
    import jax.numpy as jnp

    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar
    from srcnn_cpp_tpu.ops.resize import resize_bicubic_u8
    from srcnn_cpp_tpu.pipeline import _srcnn, _upscale_planar_jit

    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (1, 3, 32, 128), dtype=np.uint8)
    out = np.asarray(_upscale_planar_jit(x, weights, (64, 256), "xla",
                                         "exact"))
    up = np.asarray(jax.jit(lambda x: resize_bicubic_u8(
        bgr2ycrcb_u8_planar(x), (64, 256)))(jnp.asarray(x)))
    y_sr = np.asarray(_srcnn(up[:, 0], weights, "xla"))
    assert np.array_equal(out, _ref(y_sr, up))
