"""Checkpoint loading for the SRCNN 9-5-5 model.

The only "checkpoint" capability the reference has is its compiled-in weight
header (reference src/convdata.h, included at srcnn.cpp:31); here that becomes
a real loader with dtype control so the device compute path can run the matmul
weights in bfloat16 while keeping fp32 masters.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np

WEIGHTS_NPZ = Path(__file__).with_name("srcnn955.npz")

_KEYS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "conv3_w", "conv3_b")


@dataclasses.dataclass(frozen=True)
class SRCNNWeights:
    """SRCNN 9-5-5 parameters in NCHW filter layout ``[out_c, in_c, kh, kw]``."""

    conv1_w: Any  # (64, 1, 9, 9)
    conv1_b: Any  # (64,)
    conv2_w: Any  # (32, 64, 1, 1)
    conv2_b: Any  # (32,)
    conv3_w: Any  # (1, 32, 5, 5)
    conv3_b: Any  # (1,)

    def astype(self, dtype) -> "SRCNNWeights":
        return SRCNNWeights(**{k: getattr(self, k).astype(dtype) for k in _KEYS})

    def as_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in _KEYS}

    def tree_flatten(self):
        return tuple(getattr(self, k) for k in _KEYS), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        return cls(*children)


def _register_pytree() -> None:
    try:
        import jax

        jax.tree_util.register_pytree_node(
            SRCNNWeights, SRCNNWeights.tree_flatten,
            SRCNNWeights.tree_unflatten,
        )
    except Exception:  # jax absent or already registered
        pass


_register_pytree()


def load_weights(path: Path | str | None = None, dtype=np.float32) -> SRCNNWeights:
    """Load the pretrained SRCNN 9-5-5 checkpoint.

    If the ``.npz`` artifact is missing but the reference header is available,
    regenerate it on the fly (keeps fresh clones usable without a build step).
    """
    path = Path(path) if path is not None else WEIGHTS_NPZ
    if not path.exists() and path == WEIGHTS_NPZ:
        from .parse_convdata import _DEFAULT_HEADER, parse_convdata

        if _DEFAULT_HEADER.exists():
            arrays = parse_convdata(_DEFAULT_HEADER)
            np.savez_compressed(path, **arrays)
    with np.load(path) as z:
        return SRCNNWeights(**{k: z[k].astype(dtype) for k in _KEYS})
