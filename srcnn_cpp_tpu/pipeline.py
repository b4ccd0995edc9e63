"""End-to-end super-resolution pipeline (the reference's ``pthreadcall``).

One jitted function runs the reference's full 9-step pipeline
(reference src/srcnn.cpp:449-698) on device:

    BGR u8 -> YCrCb (fixed-point, bit-exact) -> per-channel bicubic x scale
    (OpenCV-4.6-bit-exact) -> SRCNN on Y -> merge(Y', Cr, Cb) -> BGR u8

Everything between decode and encode happens in a single XLA program with
static shapes; image decode/encode stay host-side (as in the reference,
srcnn.cpp:462,670 via OpenCV imread/imwrite).

Device arrays are PLANAR ``[..., 3, H, W]``; host wrappers transpose
HWC<->planar (a memcpy-speed numpy op) around the jit boundary.

``kernel`` and ``resize`` name the conv path and the pre-upscale engine;
``"auto"`` resolves per backend in :mod:`.runtime`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ops.color import bgr2ycrcb_u8_planar, ycrcb2bgr_u8_planar
from .ops.resize import resize_bicubic_u8, resize_bicubic_u8_fast, scaled_size
from .ops.srcnn import srcnn_y
from .runtime import resolve_kernel, resolve_resize
from .weights import SRCNNWeights, load_weights


def _srcnn(y_u8, weights, kernel: str):
    """The conv stack on uint8 Y planes by a concrete kernel name."""
    if kernel == "pallas":
        from .ops.pallas_srcnn import srcnn_y_fused

        return srcnn_y_fused(y_u8, weights)
    return srcnn_y(y_u8, weights)


@partial(jax.jit, static_argnames=("out_hw", "backend_kernel", "resize_mode"))
def _upscale_planar_jit(bgr_p, weights: SRCNNWeights, out_hw: tuple[int, int],
                        backend_kernel: str, resize_mode: str = "exact"):
    """Planar BGR u8 ``[B, 3, H, W]`` -> planar BGR u8 ``[B, 3, oh, ow]``.

    ``backend_kernel`` and ``resize_mode`` are concrete names (see
    :func:`.runtime.resolve_kernel`).
    """
    ycc = bgr2ycrcb_u8_planar(bgr_p)
    rs = resize_bicubic_u8_fast if resize_mode == "fast" else resize_bicubic_u8
    up = rs(ycc, out_hw)                                  # [B, 3, oh, ow]
    y_sr = _srcnn(up[:, 0], weights, backend_kernel)      # [B, oh, ow]
    merged = jnp.stack([y_sr, up[:, 1], up[:, 2]], axis=-3)
    return ycrcb2bgr_u8_planar(merged)


def upscale_bgr_batch(bgr_u8, scale: float, weights: SRCNNWeights | None = None,
                      kernel: str = "auto", resize: str = "auto"):
    """Super-resolve a batch ``[B, H, W, 3]`` of BGR uint8 frames.

    The batch dimension amortizes dispatch overhead and shards over the
    ``data`` mesh axis under pjit.
    """
    weights = weights if weights is not None else load_weights()
    h, w = bgr_u8.shape[1:3]
    ow, oh = scaled_size(w, h, scale)
    if isinstance(bgr_u8, jax.Array):
        planar = jnp.moveaxis(bgr_u8, -1, 1)  # device-side relayout
    else:  # host transpose is memcpy-speed; avoids the padded HWC layout
        planar = jnp.asarray(
            np.ascontiguousarray(np.moveaxis(np.asarray(bgr_u8), -1, 1)))
    out = _upscale_planar_jit(planar, weights, (oh, ow),
                              resolve_kernel(kernel), resolve_resize(resize))
    return jnp.moveaxis(out, 1, -1)


def upscale_bgr(bgr_u8, scale: float, weights: SRCNNWeights | None = None,
                kernel: str = "auto", resize: str = "auto"):
    """Super-resolve one BGR uint8 image ``[H, W, 3]`` by ``scale``.

    Output dims are ``floor(float32(dim) * float32(scale))``, matching the
    reference (srcnn.cpp:573-575).
    """
    out = upscale_bgr_batch(np.asarray(bgr_u8)[None], scale, weights,
                            kernel=kernel, resize=resize)
    return out[0]


@partial(jax.jit, static_argnames=("out_hw", "backend_kernel"))
def _upscale_plane_jit(y_u8, weights: SRCNNWeights, out_hw: tuple[int, int],
                       backend_kernel: str):
    return _srcnn(resize_bicubic_u8(y_u8, out_hw), weights, backend_kernel)


def process_srcnn(buf, w: int, h: int, d: int, scale: float,
                  weights: SRCNNWeights | None = None, kernel: str = "auto"):
    """Raw-buffer library API (the libsrcnn ``ProcessSRCNN`` shape).

    Mirrors the call contract documented by the reference's sibling test
    harness (reference src/test.cpp:345-361): interleaved uint8 pixels in,
    ``(out_buffer, out_size)`` out, with ``out_size == floor(w*scale) *
    floor(h*scale) * d``.  ``d`` may be 1 (single plane, super-resolved
    directly), 2 (RGB565: normalized to RGB via the convImage front-end,
    imageio.conv_image, and returned as 3-channel — matching the reference
    harness, which converts before calling ProcessSRCNN, test.cpp:328),
    3 (RGB, converted through YCrCb like the main binary) or 4 (RGBA:
    color super-resolved, alpha bicubic — test.cpp's convImage normalizes
    RGBA to RGB before calling; here alpha is carried through).
    """
    weights = weights if weights is not None else load_weights()
    if d == 2:
        from .imageio import conv_image

        img = conv_image(buf, w, h, 2)
        d = 3
    else:
        img = np.asarray(buf, dtype=np.uint8).reshape(h, w, d) if d > 1 else \
            np.asarray(buf, dtype=np.uint8).reshape(h, w)
    ow, oh = scaled_size(w, h, scale)
    if d == 1:
        out = np.asarray(_upscale_plane_jit(jnp.asarray(img), weights,
                                            (oh, ow), resolve_kernel(kernel)))
    elif d in (3, 4):
        bgr = img[..., 2::-1]
        sr = np.asarray(upscale_bgr(bgr, scale, weights, kernel))[..., ::-1]
        if d == 4:
            alpha = np.asarray(resize_bicubic_u8(img[..., 3], (oh, ow)))
            out = np.concatenate([sr, alpha[..., None]], axis=-1)
        else:
            out = sr
    else:
        raise ValueError(f"unsupported depth {d}; expected 1, 2, 3 or 4")
    flat = np.ascontiguousarray(out).reshape(-1)
    return flat, flat.size
