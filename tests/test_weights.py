"""Checkpoint loader tests: shapes, dtypes, spot values from the reference.

Spot values are read from reference src/convdata.h (biases_conv1 first entry
177.2564, reference convdata.h:21 region) to pin the parse orientation.
"""

import numpy as np

from srcnn_cpp_tpu.weights import load_weights


def test_shapes_and_dtypes(weights):
    assert weights.conv1_w.shape == (64, 1, 9, 9)
    assert weights.conv1_b.shape == (64,)
    assert weights.conv2_w.shape == (32, 64, 1, 1)
    assert weights.conv2_b.shape == (32,)
    assert weights.conv3_w.shape == (1, 32, 5, 5)
    assert weights.conv3_b.shape == (1,)
    for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "conv3_w", "conv3_b"):
        assert getattr(weights, k).dtype == np.float32


def test_bias_magnitudes_are_0_255_domain(weights):
    # The weights are calibrated for unnormalized 0-255 input: bias
    # magnitudes far above 1 (SURVEY.md §2 C9).
    assert np.abs(weights.conv1_b).max() > 50.0
    assert np.abs(weights.conv2_b).max() > 1.0


def test_astype_roundtrip(weights):
    w16 = weights.astype(np.float16)
    assert w16.conv1_w.dtype == np.float16
    back = w16.astype(np.float32)
    assert np.allclose(back.conv1_w, weights.conv1_w, atol=0.05)


def test_pytree_registration(weights):
    import jax

    leaves = jax.tree_util.tree_leaves(weights)
    assert len(leaves) == 6
    rebuilt = jax.tree_util.tree_map(lambda x: x, weights)
    assert np.array_equal(rebuilt.conv3_w, weights.conv3_w)


def test_regenerates_from_header(tmp_path):
    import pytest

    from srcnn_cpp_tpu.weights.parse_convdata import (_DEFAULT_HEADER,
                                                      parse_convdata)

    if not _DEFAULT_HEADER.exists():
        pytest.skip(f"the reference's convdata.h is not at {_DEFAULT_HEADER} "
                    f"(set SRCNN_CONVDATA_H)")
    arrays = parse_convdata()
    w = load_weights()
    for k, v in arrays.items():
        assert np.array_equal(v, getattr(w, k))
