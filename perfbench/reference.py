"""The plain reference of the super-resolution pipeline.

It restates, from the published method and OpenCV's documented uint8
arithmetic, what one request computes, and imports nothing of the program:

* BGR -> YCrCb and back in OpenCV's 14-bit fixed point, with round-half-up
  descaling (NumPy integers);
* OpenCV 4.6 ``INTER_CUBIC`` on uint8 planes: Catmull-Rom taps (a = -0.75)
  in float32, quantized to 11-bit integers, an integer horizontal pass and
  a float32 vertical pass with a rounding after every product and every sum
  (NumPy, so that no fused multiply-add changes a rounding);
* SRCNN 9-1-5 (Dong et al., arXiv:1501.00092) with 64 and 32 filters on the
  0-255 Y plane: clamp-to-edge padding of the input for the 9x9 layer and
  of the second layer's features for the 5x5 layer, ReLU after the first
  two layers, and truncation toward zero then a clamp to 0-255 at the end
  (``jax.numpy`` convolutions on the device, float32 at ``HIGHEST``).

``conv_dtype="bfloat16"`` gives the control: the same computation with
every convolution operand rounded to bfloat16, the precision below the
float32 the configuration states.  The weights are the benchmark's own copy
of the pretrained checkpoint (``weights/srcnn955.npz``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

WEIGHTS = Path(__file__).resolve().parent / "weights" / "srcnn955.npz"
KEYS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "conv3_w", "conv3_b")


def load_weights(path: Path = WEIGHTS) -> dict[str, np.ndarray]:
    """The checkpoint as float32 arrays, filters ``[out, in, kh, kw]``."""
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in KEYS}


def scaled_size(w: int, h: int, scale: float) -> tuple[int, int]:
    """Output ``(w, h)``: float32 products truncated toward zero."""
    return (int(np.float32(w) * np.float32(scale)),
            int(np.float32(h) * np.float32(scale)))


# --- colour: OpenCV's uint8 fixed point (BT.601) ---------------------------

def _descale(x):
    return (x + (1 << 13)) >> 14


def bgr2ycrcb(bgr: np.ndarray) -> np.ndarray:
    x = bgr.astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = _descale(b * 1868 + g * 9617 + r * 4899)
    cr = _descale((r - y) * 11682 + (128 << 14))
    cb = _descale((b - y) * 9241 + (128 << 14))
    return np.clip(np.stack([y, cr, cb], axis=-1), 0, 255).astype(np.uint8)


def ycrcb2bgr(ycc: np.ndarray) -> np.ndarray:
    x = ycc.astype(np.int32)
    y, cr, cb = x[..., 0], x[..., 1], x[..., 2]
    b = y + _descale((cb - 128) * 29049)
    g = y + _descale((cb - 128) * -5636 + (cr - 128) * -11698)
    r = y + _descale((cr - 128) * 22987)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


# --- OpenCV 4.6 INTER_CUBIC on uint8 ---------------------------------------

def cubic_tables(dst: int, src: int):
    """Clamped tap indices ``[dst, 4]``, 11-bit integer coefficients and
    the float32 vertical coefficients ``int * 2**-22``."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    fx = (f - s).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1)
    c0 = ((a * (fx + one) - np.float32(5) * a) * (fx + one)
          + np.float32(8) * a) * (fx + one) - np.float32(4) * a
    c1 = ((a + 2) * fx - (a + 3)) * fx * fx + one
    c2 = ((a + 2) * (one - fx) - (a + 3)) * (one - fx) * (one - fx) + one
    c3 = one - c0 - c1 - c2
    coef = np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)
    icoef = np.rint((coef * np.float32(2048)).astype(np.float32)).astype(
        np.int32)
    fcoef = (icoef.astype(np.float32)
             * np.float32(1.0 / (2048 * 2048))).astype(np.float32)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, icoef, fcoef


def resize_cubic(plane: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 ``[h, w]`` -> uint8 ``[oh, ow]``."""
    oh, ow = out_hw
    ih, iw = plane.shape
    xi, xic, _ = cubic_tables(ow, iw)
    yi, _, yfc = cubic_tables(oh, ih)
    s = plane.astype(np.int32)
    rows = s[:, xi[:, 0]] * xic[:, 0]
    for j in (1, 2, 3):
        rows += s[:, xi[:, j]] * xic[:, j]
    rows = rows.astype(np.float32)
    r = rows[yi[:, 3]] * yfc[:, 3][:, None]
    for k in (2, 1, 0):
        r = rows[yi[:, k]] * yfc[:, k][:, None] + r
    return np.clip(np.rint(r), 0, 255).astype(np.uint8)


# --- SRCNN 9-1-5 on the Y plane --------------------------------------------

@partial(jax.jit, static_argnames=("dtype",))
def _conv_stack(y, w, dtype: str):
    low = dtype == "bfloat16"
    prec = lax.Precision.DEFAULT if low else lax.Precision.HIGHEST

    def conv(x, k):   # x [1, H, W, C], k [out, in, kh, kw]
        k = jnp.transpose(k, (2, 3, 1, 0))
        if low:
            x, k = x.astype(jnp.bfloat16), k.astype(jnp.bfloat16)
        return lax.conv_general_dilated(
            x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=prec, preferred_element_type=jnp.float32)

    def edge(x, p):
        return jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="edge")

    x = y.astype(jnp.float32)[None, :, :, None]
    f1 = jax.nn.relu(conv(edge(x, 4), w["conv1_w"]) + w["conv1_b"])
    f2 = jax.nn.relu(conv(f1, w["conv2_w"]) + w["conv2_b"])
    out = conv(edge(f2, 2), w["conv3_w"]) + w["conv3_b"]
    return jnp.clip(jnp.trunc(out[0, :, :, 0]), 0, 255).astype(jnp.uint8)


def srcnn_y(y_up: np.ndarray, w: dict, dtype: str = "float32") -> np.ndarray:
    """uint8 upscaled Y ``[H, W]`` -> uint8 super-resolved Y, on the
    default device."""
    with jax.default_matmul_precision("highest"):
        return np.asarray(_conv_stack(y_up, w, dtype=dtype))


def upscale(bgr: np.ndarray, scale: float, w: dict,
            conv_dtype: str = "float32") -> np.ndarray:
    """BGR uint8 ``[h, w, 3]`` -> BGR uint8 ``[oh, ow, 3]``."""
    h, wd = bgr.shape[:2]
    ow, oh = scaled_size(wd, h, scale)
    ycc = bgr2ycrcb(bgr)
    with ThreadPoolExecutor(3) as pool:
        up = list(pool.map(partial(resize_cubic, out_hw=(oh, ow)),
                           [ycc[..., c] for c in range(3)]))
    y_sr = srcnn_y(up[0], w, conv_dtype)
    return ycrcb2bgr(np.stack([y_sr, up[1], up[2]], axis=-1))
