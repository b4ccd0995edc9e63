"""Fused SRCNN conv stack for NVIDIA GPUs (Pallas, Triton route).

The XLA path (:mod:`.srcnn`) writes conv1's 64-channel and conv2's
32-channel float32 feature planes to device memory and reads them back.
This kernel keeps both in registers.  One program takes ``BLOCK_PIXELS``
consecutive pixels of one row and computes:

* conv1 (9x9, 1->64) as one tensor-core product of the ``[128, 128]``
  im2col patch (81 shifted loads of the edge-padded input, zero-padded to
  128 taps) with the ``[128, 64]`` filter.  The uint8 input is exact in
  bf16, so two bf16 products (``x @ w_hi + x @ w_lo``) carry the filter
  to ~2^-16 relative error;
* conv2 (1x1, 64->32) as three bf16 products of the hi/lo split of both
  operands (``xh@wh + xh@wl + xl@wh``);
* conv3's channel reduction, also split three ways: the per-tap partials
  ``q[t] = sum_c w3[t, c] * f2[c]`` for the 25 taps of the 5x5 filter
  (padded to 32), written as planar ``[B, 32, H, W]`` float32.

The 5x5 shifted sum over ``q`` runs in jnp (:func:`conv3_from_q`), where
XLA fuses it with the bias and quantization.  It edge-pads ``q`` before
summing, which is exactly the reference's feature-level clamp for conv3
(srcnn.cpp:200-210), so image edges need no special case.

All products accumulate in float32; every bf16 operand is an explicit
hi/lo pair, never an implicit TF32 rounding.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .quantize import quantize_trunc_u8, split_hi_lo

#: conv1 taps (81) padded to the next power of two (Triton block shapes)
_KTAPS = 128
#: conv3 taps (25) padded likewise
_QTAPS = 32
#: pixels per program (one row segment) and warps per program: the best of
#: 64/128/256 pixels x 4/8 warps at the bench geometry on an H100
BLOCK_PIXELS = 128
_NUM_WARPS = 4


def _pack_weights(weights):
    """SRCNNWeights -> the kernel's bf16 hi/lo operands and f32 biases."""
    w1 = weights.conv1_w.astype(jnp.float32).reshape(64, 81).T   # [81, 64]
    w1 = jnp.pad(w1, ((0, _KTAPS - 81), (0, 0)))
    w2 = weights.conv2_w.astype(jnp.float32).reshape(32, 64).T   # [64, 32]
    w3 = weights.conv3_w.astype(jnp.float32).reshape(32, 25).T   # [25, 32]
    w3 = jnp.pad(w3, ((0, _QTAPS - 25), (0, 0)))                 # [tap, c]
    w1h, w1l = split_hi_lo(w1)
    w2h, w2l = split_hi_lo(w2)
    w3h, w3l = split_hi_lo(w3)
    return (w1h, w1l, weights.conv1_b.astype(jnp.float32),
            w2h, w2l, weights.conv2_b.astype(jnp.float32), w3h, w3l)


def _kernel(x_ref, tap_ref, w1h_ref, w1l_ref, b1_ref, w2h_ref, w2l_ref,
            b2_ref, w3h_ref, w3l_ref, q_ref, *, row_stride: int, bp: int):
    c0 = pl.program_id(0) * bp
    r = pl.program_id(1)
    b = pl.program_id(2)
    # im2col gather: pixel p, tap k -> flat offset of (r + dy, c0 + p + dx)
    base = r * row_stride + c0
    pix = jnp.arange(bp, dtype=jnp.int32)
    idx = base + pix[:, None] + tap_ref[...][None, :]
    patch = x_ref[b, idx]                                   # [bp, 128] bf16

    def dot(a, w):
        return pl.dot(a, w, precision=jax.lax.Precision.DEFAULT)

    f1 = dot(patch, w1h_ref[...]) + dot(patch, w1l_ref[...])
    f1 = jnp.maximum(f1 + b1_ref[...][None, :], 0.0)        # [bp, 64] f32
    f1h, f1l = split_hi_lo(f1)
    w2h, w2l = w2h_ref[...], w2l_ref[...]
    f2 = dot(f1h, w2h) + dot(f1h, w2l) + dot(f1l, w2h)
    f2 = jnp.maximum(f2 + b2_ref[...][None, :], 0.0)        # [bp, 32] f32
    f2h, f2l = split_hi_lo(f2)
    w3h, w3l = w3h_ref[...], w3l_ref[...]

    def dot_t(w, a):   # [tap, c] x [bp, c]^T -> [tap, bp]
        return pl.dot(w, a, trans_b=True, precision=jax.lax.Precision.DEFAULT)

    q = dot_t(w3h, f2h) + dot_t(w3l, f2h) + dot_t(w3h, f2l)
    q_ref[b, :, r, pl.ds(c0, bp)] = q


@partial(jax.jit, static_argnames=("interpret",))
def conv12_q(xp, weights, interpret: bool = False):
    """conv1+conv2 and conv3's channel sum on a pre-padded plane.

    ``xp``: ``[B, H + 8, W + 8]`` values in the 0-255 domain (uint8 or any
    float type that holds them exactly), already padded by 4 on each side
    the way the caller wants conv1's border handled.  Returns the per-tap
    conv3 partials ``[B, 25, H, W]`` float32 (VALID conv1, no conv3 yet).
    """
    bp = BLOCK_PIXELS
    b, hp, wpad = xp.shape
    h, w = hp - 8, wpad - 8
    wq = -(-w // bp) * bp
    # bf16 holds 0-255 exactly; pad the right edge to whole pixel blocks
    x = jnp.pad(xp.astype(jnp.bfloat16), ((0, 0), (0, 0), (0, wq - w)),
                mode="edge")
    row_stride = wq + 8
    x = x.reshape(b, hp * row_stride)
    k = jnp.arange(_KTAPS, dtype=jnp.int32)
    taps = jnp.where(k < 81, (k // 9) * row_stride + k % 9, 0)
    kernel = partial(_kernel, row_stride=row_stride, bp=bp)
    q = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b, _QTAPS, h, wq), jnp.float32),
        grid=(wq // bp, h, b),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="srcnn_conv12_q",
    )(x, taps, *_pack_weights(weights))
    return q[:, :25, :, :w]


def conv3_from_q(q, bias, pad_h: bool = True, pad_w: bool = True):
    """5x5 shifted sum of per-tap partials ``[B, 25, H, W]`` + bias.

    With ``pad_h``/``pad_w`` the partials are edge-padded by 2 first, which
    is the reference's feature-level clamp (srcnn.cpp:200-210) and keeps
    the output at ``[B, H, W]``.  Without, that dim is VALID and loses 2
    rows/cols per side (the tiled paths supply real neighbour rows).
    """
    qp = jnp.pad(q, ((0, 0), (0, 0), (2, 2) if pad_h else (0, 0),
                     (2, 2) if pad_w else (0, 0)), mode="edge")
    ho, wo = qp.shape[2] - 4, qp.shape[3] - 4
    out = bias.astype(jnp.float32).reshape(())
    for t in range(25):
        dy, dx = divmod(t, 5)
        out = out + qp[:, t, dy:dy + ho, dx:dx + wo]
    return out


def srcnn_y_fused(y_u8, weights, interpret: bool = False):
    """uint8 Y plane(s) ``[H, W]`` or ``[B, H, W]`` -> uint8 super-resolved
    Y plane(s)."""
    y = jnp.asarray(y_u8)
    squeeze = y.ndim == 2
    y = y[None] if squeeze else y
    xp = jnp.pad(y, ((0, 0), (4, 4), (4, 4)), mode="edge")
    out = quantize_trunc_u8(conv3_from_q(
        conv12_q(xp, weights, interpret=interpret), weights.conv3_b))
    return out[0] if squeeze else out
