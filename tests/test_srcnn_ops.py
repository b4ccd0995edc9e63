"""SRCNN conv stack: XLA path vs the accumulation-order-exact NumPy oracle.

The oracle (srcnn_cpp_tpu.oracle) restates the reference kernels' exact
accumulation order; XLA reassociates fp32 sums, so agreement is to float
tolerance pre-quantization and to ±1 LSB on a vanishing fraction of pixels
post-quantization — the same envelope the -ffast-math reference binary
itself sits in (see test_pipeline golden assertions).
"""

import numpy as np

from srcnn_cpp_tpu import oracle


def _rand_y(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w), dtype=np.uint8)


def test_conv_stages_match_oracle_f32(weights):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y_f32

    y = _rand_y(40, 56)
    ours = np.asarray(srcnn_y_f32(y, weights))
    f1 = oracle.conv1_ref(y, weights)
    f2 = oracle.conv2_ref(f1, weights)
    ref = oracle.conv3_ref(f2, weights)  # uint8
    # pre-quantization float comparison against a float64 recomputation
    # has to pass through the quantizer for a stable comparison:
    from srcnn_cpp_tpu.ops.quantize import quantize_trunc_u8

    q = np.asarray(quantize_trunc_u8(ours))
    diff = np.abs(q.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 5e-3


def test_quantize_truncates_not_rounds():
    from srcnn_cpp_tpu.ops.quantize import quantize_trunc_u8

    x = np.array([-3.7, -0.2, 0.0, 0.49, 0.51, 100.99, 255.0, 255.9, 300.0],
                 dtype=np.float32)
    out = np.asarray(quantize_trunc_u8(x))
    assert out.tolist() == [0, 0, 0, 0, 0, 100, 255, 255, 255]


def test_relu_boundaries(weights):
    # conv1/conv2 outputs are non-negative (ReLU); conv3 may go negative
    # before quantization.  Verified via the oracle's intermediates.
    y = _rand_y(24, 24, seed=7)
    f1 = oracle.conv1_ref(y, weights)
    f2 = oracle.conv2_ref(f1, weights)
    assert f1.min() >= 0.0
    assert f2.min() >= 0.0


def test_batched_matches_single(weights):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    ys = np.stack([_rand_y(32, 32, seed=s) for s in range(3)])
    batched = np.asarray(srcnn_y(ys, weights))
    singles = np.stack([np.asarray(srcnn_y(y, weights)) for y in ys])
    assert np.array_equal(batched, singles)


def test_replicate_padding_constant_input(weights):
    # On a constant image every output pixel sees identical inputs, so the
    # entire output must be one constant — catches padding-mode errors.
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    y = np.full((20, 28), 97, dtype=np.uint8)
    out = np.asarray(srcnn_y(y, weights))
    assert (out == out[0, 0]).all()
    ref = oracle.srcnn_y_ref(y, weights)
    assert abs(int(out[0, 0]) - int(ref[0, 0])) <= 1


def test_split_precision_path_matches_highest(weights):
    # the bf16 hi/lo split-precision path is the fused kernel (interpret
    # mode here): within 1 LSB of the HIGHEST XLA stack on a small fraction
    from srcnn_cpp_tpu.ops.pallas_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    y = _rand_y(48, 64, seed=11)
    a = np.asarray(srcnn_y(y, weights)).astype(int)
    b = np.asarray(srcnn_y_fused(y, weights, interpret=True)).astype(int)
    d = np.abs(a - b)
    assert d.max() <= 1
    assert (d > 0).mean() < 5e-3
