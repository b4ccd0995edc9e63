"""Fused SRCNN kernel (Pallas, Triton route) in interpret mode on the CPU.

Gate: <=1 quantization LSB anywhere against the fp32 XLA path (the bf16
hi/lo products carry ~2^-16 relative error).  The same comparison at
1920x1080 runs on the card in chip_smoke.py (tests/test_gpu.py).
"""

import numpy as np
import pytest


def _fused(y, weights):
    from srcnn_cpp_tpu.ops.pallas_srcnn import srcnn_y_fused

    return np.asarray(srcnn_y_fused(y, weights, interpret=True))


def _cmp(shape, seed, weights):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    y = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(srcnn_y(y, weights))
    d = np.abs(ref.astype(int) - _fused(y, weights).astype(int))
    return d.max(), (d > 0).mean()


@pytest.mark.parametrize("shape,seed", [
    ((40, 520), 0),    # several pixel blocks, ragged last block
    ((64, 128), 1),    # exactly one block
    ((100, 700), 2),   # ragged both
    ((17, 130), 3),    # tiny, a 2-pixel last block
])
def test_fused_matches_xla(shape, seed, weights):
    mx, frac = _cmp(shape, seed, weights)
    assert mx <= 1, f"max LSB {mx}"
    assert frac < 5e-3, f"diff fraction {frac}"


def test_fused_batch_vmap(weights):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    y = np.random.default_rng(9).integers(0, 256, (3, 32, 256), dtype=np.uint8)
    ref = np.asarray(srcnn_y(y, weights))
    out = _fused(y, weights)
    assert out.shape == ref.shape
    assert np.abs(ref.astype(int) - out.astype(int)).max() <= 1


def test_split_hi_lo_reconstructs(weights):
    from srcnn_cpp_tpu.ops.quantize import split_hi_lo

    x = np.random.default_rng(0).normal(scale=100, size=(64, 96)).astype(np.float32)
    hi, lo = split_hi_lo(x)
    rec = np.asarray(hi, np.float32) + np.asarray(lo, np.float32)
    rel = np.abs(rec - x) / np.maximum(np.abs(x), 1e-6)
    assert rel.max() < 2 ** -15


def test_fused_constant_plane(weights):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    y = np.full((24, 256), 100, dtype=np.uint8)
    out = _fused(y, weights)
    ref = np.asarray(srcnn_y(y, weights))
    assert (out == out[12, 128]).all()
    assert abs(int(out[12, 128]) - int(ref[12, 128])) <= 1


@pytest.mark.parametrize("h,w", [(1, 1), (9, 127), (12, 129), (5, 300)])
def test_conv12_q_shapes_and_padding(weights, h, w):
    """The wrapper pads W to whole pixel blocks and crops back: the per-tap
    partials come out ``[B, 25, H, W]`` and match conv2's features times
    conv3's filter, pixel blocks and ragged tails alike."""
    import jax.numpy as jnp

    from srcnn_cpp_tpu.ops.pallas_srcnn import conv12_q
    from srcnn_cpp_tpu.ops.srcnn import conv12_f32

    y = np.random.default_rng(h * w).integers(0, 256, (2, h, w), np.uint8)
    xp = jnp.pad(jnp.asarray(y), ((0, 0), (4, 4), (4, 4)), mode="edge")
    q = np.asarray(conv12_q(xp, weights, interpret=True))
    assert q.shape == (2, 25, h, w) and q.dtype == np.float32
    f2 = np.asarray(conv12_f32(jnp.asarray(y)[..., None], weights))
    w3 = np.asarray(weights.conv3_w).reshape(32, 25)
    want = np.einsum("bhwc,ct->bthw", f2.astype(np.float64), w3)
    np.testing.assert_allclose(q, want, rtol=1e-4, atol=2e-3)


def test_conv3_from_q_feature_clamp(weights):
    """The epilogue's edge pad of the per-tap partials reproduces conv3's
    feature-level clamp (srcnn.cpp:200-210) exactly as the XLA conv3."""
    import jax.numpy as jnp

    from srcnn_cpp_tpu.ops.pallas_srcnn import conv3_from_q
    from srcnn_cpp_tpu.ops.srcnn import conv12_f32, conv3_f32

    y = np.random.default_rng(5).integers(0, 256, (1, 11, 14), np.uint8)
    f2 = conv12_f32(jnp.asarray(y)[..., None], weights)
    w3 = jnp.asarray(weights.conv3_w).reshape(32, 25)
    q = jnp.einsum("bhwc,ct->bthw", f2, w3,
                   precision="highest")
    got = np.asarray(conv3_from_q(q, weights.conv3_b))
    want = np.asarray(conv3_f32(f2, weights))[..., 0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # VALID rows: two rows lost per side, columns still clamped
    valid = np.asarray(conv3_from_q(q, weights.conv3_b, pad_h=False))
    assert valid.shape == (1, 7, 14)
    np.testing.assert_allclose(
        valid, np.asarray(conv3_f32(f2, weights, pad_h=False))[..., 0],
        rtol=1e-5, atol=1e-3)


def test_fused_edge_and_corner_semantics(weights):
    # Adversarial border content: saturated frame, gradients, and a batch
    # whose frames differ near the borders — locks the feature-column and
    # feature-row clamp of the epilogue against the XLA reference path.
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    h, w = 48, 200
    g = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = ((g[0] * 37 + g[1] * 11) % 256).astype(np.uint8)
    img[:3, :] = 255
    img[:, :3] = 0
    img[-3:, :] = 255
    img[:, -3:] = 0
    batch = np.stack([img, 255 - img, np.roll(img, 7, axis=1)])
    ref = np.asarray(srcnn_y(batch, weights)).astype(int)
    out = _fused(batch, weights).astype(int)
    d = np.abs(ref - out)
    assert d.max() <= 1, d.max()
    border = np.ones_like(d, bool)
    border[:, 3:-3, 3:-3] = False
    assert d[border].max() <= 1


def test_fused_batch_equals_per_frame(weights):
    # every program reads one row segment of one frame, so a batched call
    # is bitwise the stack of per-frame calls
    y = np.random.default_rng(11).integers(0, 256, (2, 24, 150),
                                           dtype=np.uint8)
    a = _fused(y, weights)
    b = np.stack([_fused(f, weights) for f in y])
    assert np.array_equal(a, b)


def test_conv12_q_rows_independent(weights):
    # each program reads its own row of the padded plane, so the partials
    # of a row band equal that band of the full plane's partials (the
    # tiled multi-card paths run the kernel on halo-extended row blocks)
    import jax.numpy as jnp

    from srcnn_cpp_tpu.ops.pallas_srcnn import conv12_q

    y = np.random.default_rng(12).integers(0, 256, (1, 20, 150), np.uint8)
    xp = jnp.pad(jnp.asarray(y), ((0, 0), (4, 4), (4, 4)), mode="edge")
    full = np.asarray(conv12_q(xp, weights, interpret=True))
    band = np.asarray(conv12_q(xp[:, 5:19], weights, interpret=True))
    assert np.array_equal(band, full[:, :, 5:11])
