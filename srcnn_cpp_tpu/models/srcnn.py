"""The SRCNN 9-5-5 model family (Dong et al. 2014) as a model object.

The reference hard-codes one architecture (64/32 filters, 9-5-5, reference
src/convdata.h:4-16 CONV1_FILTERS/CONV2_FILTERS and kernel dims); this class
generalizes it to the paper's whole family (9-1-5, 9-3-5, 9-5-5, any filter
counts) while loading the reference checkpoint for the canonical config.

Functional-core design: the model object holds hyperparameters; parameters
travel explicitly (SRCNNWeights pytree) through pure apply functions, so the
same object serves inference (jit), training (grad), and sharding (pjit /
shard_map) without framework machinery.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..weights import SRCNNWeights, load_weights


@dataclasses.dataclass(frozen=True)
class SRCNN:
    """SRCNN f1-f2-f3 with n1/n2 feature maps (default: the 9-5-5 64/32)."""

    n1: int = 64
    n2: int = 32
    f1: int = 9
    f2: int = 1
    f3: int = 5

    @property
    def pad(self) -> tuple[int, int]:
        """(conv1, conv3) 'same' padding radii."""
        return (self.f1 // 2, self.f3 // 2)

    def init(self, key, dtype=jnp.float32) -> SRCNNWeights:
        """Random init per the SRCNN paper: N(0, 1e-3) weights, zero biases.

        Note: trains in the 0-255 pixel domain like the reference weights.
        """
        k1, k2, k3 = jax.random.split(key, 3)
        return SRCNNWeights(
            conv1_w=jax.random.normal(k1, (self.n1, 1, self.f1, self.f1),
                                      dtype) * 1e-3,
            conv1_b=jnp.zeros((self.n1,), dtype),
            conv2_w=jax.random.normal(k2, (self.n2, self.n1, self.f2, self.f2),
                                      dtype) * 1e-3,
            conv2_b=jnp.zeros((self.n2,), dtype),
            conv3_w=jax.random.normal(k3, (1, self.n2, self.f3, self.f3),
                                      dtype) * 1e-3,
            conv3_b=jnp.zeros((1,), dtype),
        )

    def pretrained(self) -> SRCNNWeights:
        """The reference checkpoint (only valid for the default config)."""
        if (self.n1, self.n2, self.f1, self.f2, self.f3) != (64, 32, 9, 1, 5):
            raise ValueError("pretrained weights exist only for 9-5-5 64/32")
        return load_weights()

    def apply(self, weights: SRCNNWeights, y, precision=None):
        """Forward on pre-upscaled Y planes (0-255 domain) -> float32.

        Shapes per :func:`srcnn_cpp_tpu.ops.srcnn.srcnn_y_f32`.  The
        generic path runs lax convs with the same replicate/feature-clamp
        semantics.  Every conv states its precision (HIGHEST unless the
        caller passes one), so no backend rounds it to TF32.
        """
        from ..ops.srcnn import srcnn_y_f32
        from jax import lax

        if (self.f1, self.f2, self.f3) == (9, 1, 5):
            kwargs = {} if precision is None else {"precision": precision}
            return srcnn_y_f32(y, weights, **kwargs)
        return self._apply_generic(weights, y,
                                   precision or lax.Precision.HIGHEST)

    def _apply_generic(self, weights, y, precision):
        from jax import lax

        squeeze = []
        if y.ndim == 2:
            y = y[None]
            squeeze.append(0)
        if y.ndim == 3:
            y = y[..., None]
        x = y.astype(jnp.float32)
        p1, p3 = self.pad

        def conv(x, w):
            return lax.conv_general_dilated(
                x, jnp.transpose(w.astype(jnp.float32), (2, 3, 1, 0)),
                (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                precision=precision, preferred_element_type=jnp.float32)

        def pad_hw(x, p):
            return jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="edge")

        x = jax.nn.relu(conv(pad_hw(x, p1), weights.conv1_w)
                        + weights.conv1_b.astype(jnp.float32))
        p2 = self.f2 // 2
        x = jax.nn.relu(conv(pad_hw(x, p2) if p2 else x, weights.conv2_w)
                        + weights.conv2_b.astype(jnp.float32))
        x = conv(pad_hw(x, p3), weights.conv3_w) \
            + weights.conv3_b.astype(jnp.float32)
        x = x[..., 0]
        for ax in squeeze:
            x = jnp.squeeze(x, ax)
        return x

    def infer_u8(self, weights: SRCNNWeights, y_u8):
        """uint8 -> uint8 with the reference's truncating quantization."""
        from ..ops.quantize import quantize_trunc_u8

        return quantize_trunc_u8(self.apply(weights, y_u8))

    def num_params(self) -> int:
        return (self.n1 * self.f1 ** 2 + self.n1
                + self.n2 * self.n1 * self.f2 ** 2 + self.n2
                + self.n2 * self.f3 ** 2 + 1)
