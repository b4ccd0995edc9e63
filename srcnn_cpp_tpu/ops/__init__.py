"""Image ops: colorspace, resize, SRCNN conv stack, quantization.

Each op re-implements (as JAX code, not a translation) a behavior of the
reference binary (reference src/srcnn.cpp) and is validated bit-for-bit or to
PSNR tolerance against it.  See individual modules for file:line citations.
"""

from .color import (bgr2ycrcb_u8, bgr2ycrcb_u8_planar, ycrcb2bgr_u8,
                    ycrcb2bgr_u8_planar)
from .resize import (FILTERS, resize_bicubic_u8, resize_bicubic_u8_fast,
                     resize_separable)
from .quantize import quantize_trunc_u8
from .srcnn import srcnn_y, srcnn_y_f32

__all__ = [
    "bgr2ycrcb_u8",
    "bgr2ycrcb_u8_planar",
    "ycrcb2bgr_u8",
    "ycrcb2bgr_u8_planar",
    "resize_bicubic_u8",
    "resize_bicubic_u8_fast",
    "resize_separable",
    "FILTERS",
    "quantize_trunc_u8",
    "srcnn_y",
    "srcnn_y_f32",
]
