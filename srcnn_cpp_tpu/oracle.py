"""Bit-faithful NumPy emulation of the reference SRCNN binary.

This module is the **test oracle**: a slow, simple, host-side re-statement of
every numerical behavior of the reference pipeline (reference src/srcnn.cpp),
used to validate the device compute path.  It reproduces, per SURVEY.md §2:

* Y-only inference on OpenCV YCrCb (srcnn.cpp:509,540,609).
* Unnormalized uint8 0-255 conv1 input (srcnn.cpp:297).
* Replicate (clamp-to-edge) padding via index clamping (srcnn.cpp:269-280).
* ReLU after conv1/conv2, none after conv3 (srcnn.cpp:304,319,238).
* float32 accumulation for conv1/conv2 **in reference tap order**
  (srcnn.cpp:291-316), float64 per-map accumulation for conv3 summed into a
  float32 accumulator (srcnn.cpp:218-232).
* Final quantization by float->int truncation then clamp to [0,255]
  (srcnn.cpp:238-240, IntTrim at srcnn.cpp:77-81).
* Output dims floor(w*scale), floor(h*scale) with float32 multiply
  (srcnn.cpp:573-575, cv::Size int truncation).

Colorspace conversion and the bicubic pre-upscale use our own pure-NumPy
restatements of OpenCV 4.6's fixed-point arithmetic (the version the
reference binary links).  Note cv2's Python binding on this machine is OpenCV
5.0, whose INTER_CUBIC differs from 4.6 by ±1 LSB on fractional scales — so
the oracle deliberately does NOT delegate to cv2; bit-exactness against the
4.6 C++ library is pinned by the golden fixtures in ``tests/golden/``.
"""

from __future__ import annotations

import numpy as np

from .ops.resize_tables import resize_bicubic_u8_np
from .weights import SRCNNWeights, load_weights


# ---------------------------------------------------------------------------
# Padding / geometry helpers
# ---------------------------------------------------------------------------

def clamp_index_lut(n: int, pad: int) -> np.ndarray:
    """Replicate-pad index LUT: reference IntTrim LUT (srcnn.cpp:269-280)."""
    return np.clip(np.arange(n + 2 * pad) - pad, 0, n - 1)


def scaled_size(w: int, h: int, scale: float) -> tuple[int, int]:
    """Output (w, h): float32 multiply then int truncation (srcnn.cpp:573-575)."""
    return (
        int(np.float32(w) * np.float32(scale)),
        int(np.float32(h) * np.float32(scale)),
    )


def replicate_pad(img: np.ndarray, pad: int) -> np.ndarray:
    """Clamp-to-edge padding of a 2-D plane, identical to the index LUTs."""
    r = clamp_index_lut(img.shape[0], pad)
    c = clamp_index_lut(img.shape[1], pad)
    return img[np.ix_(r, c)]


# ---------------------------------------------------------------------------
# Convolution stages (exact accumulation-order emulation)
# ---------------------------------------------------------------------------

def conv1_ref(y_u8: np.ndarray, w: SRCNNWeights) -> np.ndarray:
    """Layer 1: 1->64, 9x9, replicate pad, ReLU.  Returns float32 [64, H, W].

    Accumulates in float32 in the reference's row-major tap order
    (srcnn.cpp:293-299) so per-pixel float rounding matches bit-for-bit.
    """
    h, wdt = y_u8.shape
    src = replicate_pad(y_u8, 4).astype(np.float32)
    out = np.zeros((64, h, wdt), dtype=np.float32)
    k = w.conv1_w.reshape(64, 9, 9).astype(np.float32)
    for i in range(9):
        for j in range(9):
            out += k[:, i, j][:, None, None] * src[None, i : i + h, j : j + wdt]
    out += w.conv1_b.astype(np.float32)[:, None, None]
    np.maximum(out, 0.0, out=out)
    return out


def conv2_ref(f1: np.ndarray, w: SRCNNWeights) -> np.ndarray:
    """Layer 2: 64->32, 1x1, ReLU.  float32 accumulation in channel order
    (srcnn.cpp:310-316).  Returns float32 [32, H, W]."""
    k = w.conv2_w.reshape(32, 64).astype(np.float32)
    out = np.zeros((32,) + f1.shape[1:], dtype=np.float32)
    for i in range(64):
        out += k[:, i][:, None, None] * f1[i][None]
    out += w.conv2_b.astype(np.float32)[:, None, None]
    np.maximum(out, 0.0, out=out)
    return out


def conv3_ref(f2: np.ndarray, w: SRCNNWeights) -> np.ndarray:
    """Layer 3: 32->1, 5x5, replicate pad, no ReLU, truncating uint8 quantize.

    Per reference srcnn.cpp:215-240: each map's 5x5 window accumulates in
    float64; each map's total is then added into a float32 accumulator; the
    bias is added in float32; the result is truncated toward zero and clamped
    to [0,255].
    """
    _, h, wdt = f2.shape
    k = w.conv3_w.reshape(32, 5, 5).astype(np.float64)
    acc = np.zeros((h, wdt), dtype=np.float32)
    for ch in range(32):
        src = replicate_pad(f2[ch], 2).astype(np.float64)
        m = np.zeros((h, wdt), dtype=np.float64)
        for i in range(5):
            for j in range(5):
                m += k[ch, i, j] * src[i : i + h, j : j + wdt]
        acc = (acc.astype(np.float64) + m).astype(np.float32)
    acc += np.float32(w.conv3_b[0])
    return quantize_trunc_u8(acc)


def quantize_trunc_u8(x: np.ndarray) -> np.ndarray:
    """float -> uint8 via C truncation-toward-zero then [0,255] clamp
    (srcnn.cpp:238-240)."""
    return np.clip(np.trunc(x), 0, 255).astype(np.uint8)


def srcnn_y_ref(y_up_u8: np.ndarray, w: SRCNNWeights | None = None) -> np.ndarray:
    """Full 3-layer SRCNN on an already-upscaled uint8 Y plane -> uint8."""
    w = w if w is not None else load_weights()
    return conv3_ref(conv2_ref(conv1_ref(y_up_u8, w), w), w)


# ---------------------------------------------------------------------------
# Colorspace (OpenCV uint8 fixed-point arithmetic, pure NumPy)
# ---------------------------------------------------------------------------

def _descale(x: np.ndarray) -> np.ndarray:
    return (x + (1 << 13)) >> 14


def bgr2ycrcb_u8_ref(bgr: np.ndarray) -> np.ndarray:
    """OpenCV-bit-exact uint8 BGR -> YCrCb (cvtColor at srcnn.cpp:509)."""
    x = bgr.astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = _descale(b * 1868 + g * 9617 + r * 4899)
    cr = _descale((r - y) * 11682 + (128 << 14))
    cb = _descale((b - y) * 9241 + (128 << 14))
    return np.clip(np.stack([y, cr, cb], axis=-1), 0, 255).astype(np.uint8)


def ycrcb2bgr_u8_ref(ycrcb: np.ndarray) -> np.ndarray:
    """OpenCV-bit-exact uint8 YCrCb -> BGR (cvtColor at srcnn.cpp:657)."""
    x = ycrcb.astype(np.int32)
    y, cr, cb = x[..., 0], x[..., 1], x[..., 2]
    b = y + _descale((cb - 128) * 29049)
    g = y + _descale((cb - 128) * -5636 + (cr - 128) * -11698)
    r = y + _descale((cr - 128) * 22987)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Full-image pipeline (pure NumPy, OpenCV-4.6-bit-exact pre/post stages)
# ---------------------------------------------------------------------------

def pipeline_ref(bgr_u8: np.ndarray, scale: float,
                 w: SRCNNWeights | None = None) -> np.ndarray:
    """Emulates one full run of the reference binary on a BGR uint8 image.

    decode -> YCrCb -> split -> bicubic x scale (all 3 channels) ->
    SRCNN on Y -> merge(Y', Cr, Cb) -> BGR  (srcnn.cpp:449-698).
    """
    w = w if w is not None else load_weights()
    ycrcb = bgr2ycrcb_u8_ref(bgr_u8)
    h, wdt = bgr_u8.shape[:2]
    ow, oh = scaled_size(wdt, h, scale)
    chans = [resize_bicubic_u8_np(ycrcb[:, :, i], (oh, ow)) for i in range(3)]
    y_sr = srcnn_y_ref(chans[0], w)
    merged = np.stack([y_sr, chans[1], chans[2]], axis=-1)
    return ycrcb2bgr_u8_ref(merged)
