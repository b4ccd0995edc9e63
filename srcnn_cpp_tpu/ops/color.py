"""BGR <-> YCrCb colorspace conversion, bit-exact with OpenCV's uint8 path.

The reference delegates colorspace conversion to OpenCV
(reference src/srcnn.cpp:509 ``cvtColor(BGR2YCrCb)`` and :657 the inverse).
OpenCV's uint8 conversion is *fixed-point*: 14-bit scaled integer coefficients
with round-half-up descaling.  This module restates that arithmetic in pure
``jnp`` integer ops (VPU-friendly, no lookup tables), verified bit-exact
against OpenCV 4.6 (the version the reference binary links) over the full
uint8 cube in ``tests/test_color.py``.

Constants (OpenCV modules/imgproc color conventions, ITU-R BT.601):

* forward:  Y = 0.299 R + 0.587 G + 0.114 B;  Cr = (R-Y)*0.713 + 128;
  Cb = (B-Y)*0.564 + 128 — scaled by 2**14 and rounded.
* inverse:  R = Y + 1.403 (Cr-128);  G = Y - 0.714 (Cr-128) - 0.344 (Cb-128);
  B = Y + 1.773 (Cb-128).
"""

from __future__ import annotations

import jax.numpy as jnp

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
# forward coefficients, round(c * 2**14)
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_R2CR, _B2CB = 11682, 9241
_DELTA = 128 << _SHIFT
# inverse coefficients
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049


def _descale(x, n: int = _SHIFT):
    """OpenCV CV_DESCALE: add half, arithmetic shift right."""
    return (x + _HALF) >> n


def bgr2ycrcb_u8(bgr):
    """uint8 BGR [..., 3] -> uint8 YCrCb [..., 3], OpenCV-bit-exact.

    The jitted pipeline uses the planar variants below.
    """
    x = bgr.astype(jnp.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = _descale(b * _B2Y + g * _G2Y + r * _R2Y)
    cr = _descale((r - y) * _R2CR + _DELTA)
    cb = _descale((b - y) * _B2CB + _DELTA)
    out = jnp.stack([y, cr, cb], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def ycrcb2bgr_u8(ycrcb):
    """uint8 YCrCb [..., 3] -> uint8 BGR [..., 3], OpenCV-bit-exact."""
    x = ycrcb.astype(jnp.int32)
    y, cr, cb = x[..., 0], x[..., 1], x[..., 2]
    b = y + _descale((cb - 128) * _CB2B)
    g = y + _descale((cb - 128) * _CB2G + (cr - 128) * _CR2G)
    r = y + _descale((cr - 128) * _CR2R)
    out = jnp.stack([b, g, r], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def _descale_f32(x):
    """CV_DESCALE in float32: floor((x + half) * 2^-14).

    Exact: every intermediate is an integer of magnitude < 2^23 (the
    largest fixed-point sum is 255*2^14 + delta + half < 2^23), so the f32
    products/sums are exact, the power-of-two scaling is an exponent
    shift, and floor of a negative value matches the arithmetic right
    shift.  Verified exhaustively over the full 2^24 input cube against
    the integer form.
    """
    return jnp.floor((x + jnp.float32(_HALF)) * jnp.float32(2.0 ** -_SHIFT))


def bgr2ycrcb_u8_planar(bgr_p):
    """uint8 planar BGR [..., 3, H, W] -> planar YCrCb, OpenCV-bit-exact.

    Planar layout keeps W on the lane axis (dense tiles); the channel dim is
    a cheap leading dim.  Same 14-bit fixed-point arithmetic as above, run
    in exact f32 (see :func:`_descale_f32`).
    """
    x = bgr_p.astype(jnp.float32)
    b, g, r = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    y = _descale_f32(b * _B2Y + g * _G2Y + r * _R2Y)
    cr = _descale_f32((r - y) * _R2CR + _DELTA)
    cb = _descale_f32((b - y) * _B2CB + _DELTA)
    out = jnp.stack([y, cr, cb], axis=-3)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def ycrcb2bgr_u8_planar(ycrcb_p):
    """uint8 planar YCrCb [..., 3, H, W] -> planar BGR, OpenCV-bit-exact."""
    x = ycrcb_p.astype(jnp.float32)
    y, cr, cb = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    b = y + _descale_f32((cb - 128) * _CB2B)
    g = y + _descale_f32((cb - 128) * _CB2G + (cr - 128) * _CR2G)
    r = y + _descale_f32((cr - 128) * _CR2R)
    out = jnp.stack([b, g, r], axis=-3)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)
