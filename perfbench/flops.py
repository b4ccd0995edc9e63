"""Operations and bytes of the SRCNN conv stack, from the model's shapes.

The work is what the model needs, counted the same whatever implements it:
a multiply-add is 2 operations, and a layer of ``k x k`` filters from
``c_in`` to ``c_out`` channels costs ``k * k * c_in * c_out`` multiply-adds
per output pixel.  The 9-1-5 model with 64 and 32 filters on one channel
needs 9*9*64 + 64*32 + 5*5*32 = 8,032 multiply-adds, 16,064 operations, per
output pixel.  Padding of taps, split-precision products and recomputed
halos are the implementation's and are not counted.

The bytes are the least the conv stack must move: one uint8 Y value read
and one written per output pixel per channel.  At 16,064 operations over
2 bytes the stack is bound by compute on any GPU, and the roofline says so.
"""

from __future__ import annotations


def conv_macs_per_px(cfg: dict) -> int:
    c, n1, n2 = cfg["channels"], cfg["n1"], cfg["n2"]
    return (cfg["f1"] ** 2 * c * n1 + cfg["f2"] ** 2 * n1 * n2
            + cfg["f3"] ** 2 * n2 * c)


def conv_flop_per_px(cfg: dict) -> int:
    return 2 * conv_macs_per_px(cfg)


def conv_bytes_per_px(cfg: dict) -> int:
    return 2 * cfg["channels"]


def out_pixels(cfg: dict) -> int:
    """Output pixels of one frame."""
    oh, ow = cfg["out_hw"]
    return oh * ow


def least_time_s(flop: float, nbytes: float, peak: dict) -> tuple[float, str]:
    """The least time the chip could take, and which roof bounds it."""
    t_flop = flop / peak["bf16_dense_flop_per_s"]
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    return (t_flop, "compute") if t_flop >= t_bytes else (t_bytes, "memory")
