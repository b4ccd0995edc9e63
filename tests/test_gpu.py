"""On-card gates: the phases of chip_smoke.py as tests.

They need a CUDA GPU; the ``gpu`` fixture skips them elsewhere.  Run them
on a GPU host, in one process (a JAX process reserves most of the card):

    JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0 tests/test_gpu.py

``python3 chip_smoke.py`` runs the same phases without pytest.
"""

import importlib.util
from pathlib import Path

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_matches_reference_binary(gpu, smoke):
    smoke.phase_cli()


def test_pipeline_matches_reference_binary(gpu, smoke):
    smoke.phase_goldens()


def test_conv_paths_match_highest_and_oracle(gpu, smoke):
    smoke.phase_conv()


def test_steady_state_configs(gpu, smoke):
    smoke.phase_steady()


def test_train_steps_finite(gpu, smoke):
    smoke.phase_train()
