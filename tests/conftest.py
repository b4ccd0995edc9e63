"""Test configuration: hermetic CPU execution with a virtual 8-device mesh.

Multi-chip sharding logic is validated on one host by forcing the CPU
platform with 8 virtual XLA devices (SURVEY.md §4d) — these env vars must be
set before the first ``import jax`` anywhere in the test process.  A run
that sets ``JAX_PLATFORMS`` itself (e.g. ``cuda`` for the ``gpu``-marked
tests, see README.md) keeps its choice.
"""

import os

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_num_cpu_devices", 8)

from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).parent / "golden"
EVAL_IMAGES = Path(__file__).parent / "data" / "eval"


@pytest.fixture(scope="session")
def weights():
    from srcnn_cpp_tpu.weights import load_weights

    return load_weights()


@pytest.fixture(scope="session")
def butterfly_bgr():
    """The reference demo image as BGR uint8 (384x384)."""
    from srcnn_cpp_tpu.imageio import imread_bgr

    img = imread_bgr(EVAL_IMAGES / "butterfly.png")
    assert img is not None and img.shape == (384, 384, 3)
    return img


@pytest.fixture(scope="session")
def butterfly_y():
    return np.load(GOLDEN / "butterfly_y384.npy")


@pytest.fixture(scope="session")
def butterfly_yup():
    return np.load(GOLDEN / "butterfly_yup576.npy")


def golden_ref(scale: str) -> np.ndarray:
    """Reference binary output for butterfly at the given scale tag."""
    from srcnn_cpp_tpu.imageio import imread_bgr

    img = imread_bgr(GOLDEN / f"butterfly_x{scale}_ref.png")
    assert img is not None
    return img


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX found {dev.platform!r}); run with "
                    f"JAX_PLATFORMS=cuda on a GPU host")
    return dev
