"""The SRCNN 9-5-5 conv stack as XLA convolutions (the baseline compute path).

Reproduces the numerics of the reference's hand-written kernels —
``Convolution99x11`` (reference src/srcnn.cpp:254-325) and ``Convolution55``
(:189-243) — as three ``lax.conv_general_dilated`` calls:

* unnormalized uint8 0-255 input to conv1 (srcnn.cpp:297);
* replicate (clamp-to-edge) "same" padding, realized as an explicit edge pad
  followed by VALID convolution (srcnn.cpp:269-280 index LUTs);
* ReLU after conv1 and conv2, none after conv3 (srcnn.cpp:304,319);
* float32 products and accumulation (precision=HIGHEST, so no backend
  rounds the operands to bf16 or TF32; the reference accumulates
  fp32/fp64 — srcnn.cpp:291-316,222-232);
* truncating uint8 quantization (srcnn.cpp:238-240) via
  :func:`..ops.quantize.quantize_trunc_u8`.

The fused GPU kernel lives in :mod:`.pallas_srcnn`; this module is the
always-available reference path it is verified against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .quantize import quantize_trunc_u8

def _conv(x, w, precision):
    return lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def _edge_pad_hw(x, pad: int, pad_h: bool = True, pad_w: bool = True):
    """Replicate-pad the H/W dims of an NHWC tensor (each optional)."""
    hp = (pad, pad) if pad_h else (0, 0)
    wp = (pad, pad) if pad_w else (0, 0)
    return jnp.pad(x, ((0, 0), hp, wp, (0, 0)), mode="edge")


def _to_nhwc(y):
    squeeze = []
    if y.ndim == 2:
        y = y[None]
        squeeze.append(0)
    if y.ndim == 3:
        y = y[..., None]
    return y, squeeze


def conv12_f32(y_nhwc, weights, precision=lax.Precision.HIGHEST,
               pad_h: bool = True, pad_w: bool = True):
    """conv1 (9x9, 1->64, ReLU) + conv2 (1x1, 64->32, ReLU) on NHWC input.

    With ``pad_h=False`` (resp. ``pad_w=False``) the 9x9 runs VALID in that
    dim: the output loses 4 rows/cols per side relative to the input (used
    by the tiled paths, which feed halo-extended tiles).
    """
    x = y_nhwc.astype(jnp.float32)
    w1 = jnp.transpose(weights.conv1_w.astype(jnp.float32), (2, 3, 1, 0))
    w2 = jnp.transpose(weights.conv2_w.astype(jnp.float32), (2, 3, 1, 0))
    x = _conv(_edge_pad_hw(x, 4, pad_h, pad_w), w1, precision) \
        + weights.conv1_b.astype(jnp.float32)
    x = jax.nn.relu(x)
    x = _conv(x, w2, precision) + weights.conv2_b.astype(jnp.float32)
    return jax.nn.relu(x)


def conv3_f32(f2_nhwc, weights, precision=lax.Precision.HIGHEST,
              pad_h: bool = True, pad_w: bool = True):
    """conv3 (5x5, 32->1, no ReLU) on NHWC features -> NHWC [..., 1].

    The reference replicate-pads conv3 *at the feature level* — the pad rows
    are clamped copies of f2's edge rows (srcnn.cpp:200-210), not values
    computed from virtually-extended input.  ``pad_h=True`` reproduces that;
    ``pad_h=False`` expects the caller to supply the 2 extra feature rows
    (likewise for ``pad_w``).
    """
    w3 = jnp.transpose(weights.conv3_w.astype(jnp.float32), (2, 3, 1, 0))
    x = _conv(_edge_pad_hw(f2_nhwc, 2, pad_h, pad_w), w3, precision)
    return x + weights.conv3_b.astype(jnp.float32)


def srcnn_y_f32(y, weights, precision=lax.Precision.HIGHEST):
    """3-layer SRCNN on float32 Y planes; returns pre-quantization float32.

    ``y``: ``[H, W]``, ``[B, H, W]`` or NHWC ``[B, H, W, 1]`` in the 0-255
    domain.  ``weights``: an ``SRCNNWeights`` (OIHW filter layout).
    """
    y, squeeze = _to_nhwc(y)
    x = conv3_f32(conv12_f32(y, weights, precision), weights, precision)
    x = x[..., 0]
    for ax in squeeze:
        x = jnp.squeeze(x, ax)
    return x


def srcnn_y(y_u8, weights, precision=lax.Precision.HIGHEST):
    """uint8 Y plane(s) -> uint8 super-resolved Y plane(s)."""
    return quantize_trunc_u8(srcnn_y_f32(y_u8, weights, precision))
