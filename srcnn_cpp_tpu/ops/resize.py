"""Separable image resampling on device.

Two engines, mirroring the two resize paths of the reference:

1. :func:`resize_bicubic_u8` — bit-exact emulation of OpenCV 4.6's
   ``cv::resize(..., INTER_CUBIC)`` on uint8, the resize of record of the
   reference binary (reference src/srcnn.cpp:577-582).  OpenCV's uint8 path is
   fixed-point: per-axis coefficient tables (Catmull-Rom a=-0.75, float32
   math, quantized to int16 by scaling with 2**11 and rounding), an integer
   horizontal pass, and a float32 vertical pass that multiplies by
   ``int16_coef * (1/2048**2)`` accumulating right-to-left with separate
   mul/add roundings.  All of that restates exactly here as XLA ops:
   the horizontal pass as an exact banded bf16 matmul (with
   bit-identical block-banded and lane-phase forms, auto-selected for
   giant geometries where the dense constants would not even compile) and
   the vertical pass as phase-decomposed strided-slice streams with
   gather fallback — every variant produces the reference's integer sums
   and per-product float32 roundings bit-for-bit.

2. :func:`resize_separable` — a general float weights-table resampler, the
   counterpart of the reference's standalone FreeImage-derived
   engine (reference src/frawscale.cpp:8-151 weight tables,
   :157-385 two-pass filtering).  Same algorithm family — per-output-pixel
   contribution windows, weight normalization to sum 1, clamp-to-edge
   boundary, anti-aliased (filter-width-scaled) downscale — but re-derived
   from the resampling math, not translated: windows become static gather
   index tables and the two 1-D passes become tap-loops of fused
   gather-multiply-adds under jit.

Both engines are shape-static: tables are computed host-side in NumPy at
trace time and embedded as constants, so everything under ``jit`` stays
statically shaped for XLA.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .resize_tables import cv_cubic_tables, cv_cubic_taps_unclamped

__all__ = ["resize_bicubic_u8", "resize_separable", "FILTERS", "scaled_size"]


def scaled_size(w: int, h: int, scale: float) -> tuple[int, int]:
    """Output (w, h) = floor(float32(dim) * float32(scale)).

    Matches the reference's cv::Size arithmetic (srcnn.cpp:573-575): the
    product is computed in float32 and truncated toward zero.
    """
    return (
        int(np.float32(w) * np.float32(scale)),
        int(np.float32(h) * np.float32(scale)),
    )


# ---------------------------------------------------------------------------
# Engine 1: OpenCV-4.6-bit-exact uint8 bicubic
# ---------------------------------------------------------------------------

def _hband_split(ow: int, iw: int):
    """Horizontal banded matrix [iw, ow] as an exact bf16 hi/lo pair.

    Clamped border taps collapse onto the same source column, so their
    integer coefficients sum into one entry — identical to the gather-sum.
    Exactness: any |int| <= 2^12 coefficient is the sum of its two bf16
    split halves exactly; u8 pixels are exact in bf16; every product is
    <= 2^19 and the 8-term dot <= 2^22, exact in an f32 accumulator.
    """
    xi, xic, _ = cv_cubic_tables(ow, iw)
    mx = np.zeros((iw, ow), np.float32)
    np.add.at(mx, (xi, np.broadcast_to(np.arange(ow)[:, None], xi.shape)),
              xic.astype(np.float32))
    return _np_split_bf16(mx)


def _hband_blocks(ow: int, iw: int):
    """Block-banded form of the horizontal matrix: per-128-lane group.

    The dense ``[iw, ow]`` band matrix has only 4 non-zeros per column, so
    the matmul multiplies ~iw/(128*scale) zeros per useful product.  A group
    of 128 consecutive output columns only reads a ``~128*scale+4``-wide
    input window; this returns ``(bases, K, Mh, Ml)`` with ``M[g]`` of
    shape ``(K, 128)`` such that ``out[:, 128g:128g+128] =
    x[:, bases[g]:bases[g]+K] @ M[g]``.  Exactness: identical integer
    coefficient entries as the dense band (zeros elsewhere add exactly 0
    in the f32 accumulator), so the sums are bit-identical.
    """
    xi, xic, _ = cv_cubic_tables(ow, iw)
    ng = -(-ow // 128)
    bases, spans = [], []
    for g in range(ng):
        j0, j1 = g * 128, min(ow, (g + 1) * 128)
        bases.append(int(xi[j0:j1].min()))
        spans.append(int(xi[j0:j1].max()) - bases[-1] + 1)
    k = -(-max(spans) // 16) * 16
    mx = np.zeros((ng, k, 128), np.float32)
    for j in range(ow):
        g, c = divmod(j, 128)
        for t in range(4):
            mx[g, xi[j, t] - bases[g], c] += float(xic[j, t])
    mh, ml = _np_split_bf16(mx)
    return bases, k, mh, ml


def _vphase_plan(oh: int, ih: int):
    """Phase decomposition of the vertical pass, when bitwise-valid.

    OpenCV's per-output-row tap indices/coefficients usually repeat with a
    small period ``P`` (advancing ``S`` source rows per period): exact for
    x2/x3 (P=2/3, S=1) and in practice for x1.5 (P=3, S=2).  When a period
    exists BITWISE (indices shift by exactly S, float32 coefficients
    identical), each phase's gather collapses to 4 strided slices with
    scalar coefficients — XLA fuses those into sequential streams, where
    the gather form materializes four full-size planes.  Returns
    ``(P, S, top, bot, bases, coefs)`` or ``None`` (fallback to gathers).
    """
    yi_un, _ = cv_cubic_taps_unclamped(oh, ih)   # shared mapping
    _, _, yfc = cv_cubic_tables(oh, ih)
    for P in range(1, 9):
        if oh <= P:
            return None
        S = int(yi_un[P, 0] - yi_un[0, 0])
        if (yi_un[P:] == yi_un[:-P] + S).all() \
                and (yfc[P:].view(np.uint32) == yfc[:-P].view(np.uint32)).all():
            top = max(0, -int(yi_un.min()))
            bot = max(0, int(yi_un.max()) - (ih - 1))
            return (P, S, top, bot,
                    [[int(v) + top for v in yi_un[p]] for p in range(P)],
                    [[np.float32(v) for v in yfc[p]] for p in range(P)])
    return None


def _hphase_plan(ow: int, iw: int):
    """Lane-phase decomposition of the horizontal pass (S == 1 only).

    Mirror of :func:`_vphase_plan` for the column axis, restricted to
    plans whose source step per period is exactly 1 (true for any integer
    upscale: x2 -> P=2, x3 -> P=3, ...): each phase's taps are then
    CONTIGUOUS lane slices ``x[:, b : b+n]``, which XLA streams, instead
    of a dense band matmul that multiplies ~iw/4 zeros per output.  The
    integer coefficients must repeat bitwise.  Returns ``(P, left, right,
    bases, coefs)`` or ``None`` (fallback to the dense matmul).
    """
    xi_un, _ = cv_cubic_taps_unclamped(ow, iw)   # shared mapping
    _, xic, _ = cv_cubic_tables(ow, iw)
    for P in range(1, 9):
        if ow <= P:
            return None
        if int(xi_un[P, 0] - xi_un[0, 0]) != 1:
            continue
        if (xi_un[P:] == xi_un[:-P] + 1).all() and (xic[P:] == xic[:-P]).all():
            left = max(0, -int(xi_un.min()))
            right = max(0, int(xi_un.max()) - (iw - 1))
            return (P, left, right,
                    [[int(v) + left for v in xi_un[p]] for p in range(P)],
                    [[np.float32(v) for v in xic[p]] for p in range(P)])
    return None


#: beyond this many (iw * ow) band-matrix entries the dense horizontal
#: pass is not viable: the traced program embeds the (iw, ow) bf16 pair as
#: constants, and at 8K->16K (118M entries, ~470 MB) the program is too
#: large to compile comfortably.  The auto policy
#: switches to the phase form (tiny per-phase scalars) when bitwise-valid,
#: else the block-banded form (~(ow/128, K, 128) constants).
_DENSE_HBAND_LIMIT = 1 << 25


@partial(jnp.vectorize, excluded=(1, 2, 3), signature="(h,w)->(p,q)")
def _resize_bicubic_u8_2d(img, oh: int, ow: int, hmode: str = "dense"):
    ih, iw = img.shape
    yi, _, yfc = cv_cubic_tables(oh, ih)
    vplan = _vphase_plan(oh, ih)   # computed once, shared by every phase
    # horizontal pass: OpenCV accumulates int32 row sums (HResizeNoVec);
    # the same integer values are produced here by an exact banded matmul
    auto = hmode == "dense" and iw * ow > _DENSE_HBAND_LIMIT
    hplan = _hphase_plan(ow, iw) if (auto or hmode == "phase") else None
    if auto:
        hmode = "phase" if hplan is not None else "block"
    if hplan is not None:
        # lane-phase form (integer upscales): each phase's taps are
        # contiguous lane slices x scalar int coefficients — the identical
        # integer sums (every product/sum < 2^22, exact in f32), with the
        # vertical pass applied per phase and the u8 phases lane-interleaved
        # at the end (1 byte/px instead of a 4-byte f32 relayout)
        P, left, right, pbases, pcoefs = hplan
        xp = jnp.concatenate(
            ([jnp.repeat(img[:, :1], left, axis=1)] if left else [])
            + [img]
            + ([jnp.repeat(img[:, -1:], right, axis=1)] if right else []),
            axis=1).astype(jnp.float32)
        nmax = -(-ow // P)
        cols = []
        for p in range(P):
            n = len(range(p, ow, P))
            r = xp[:, pbases[p][3]: pbases[p][3] + n] * pcoefs[p][3]
            for k in (2, 1, 0):
                r = xp[:, pbases[p][k]: pbases[p][k] + n] * pcoefs[p][k] + r
            u = _vpass(r, oh, yi, yfc, vplan)     # (oh, n) u8
            if n < nmax:
                u = jnp.pad(u, ((0, 0), (0, nmax - n)))
            cols.append(u)
        out = jnp.stack(cols, axis=2).reshape(oh, nmax * P)
        return out[:, :ow]
    # the dense band matmul multiplies mostly zeros; hmode="block" keeps
    # the block-banded form (fewer FLOPs, more relayouts) for A/Bs
    blocks = _hband_blocks(ow, iw) if ow > 128 and hmode == "block" else None
    if blocks is not None and iw >= 2 * blocks[1]:
        # block-banded: ~iw/K fewer (all-zero) FLOPs, bit-identical sums
        bases, k, bh, bl = blocks
        iw_pad = max(b + k for b in bases)
        xp = img.astype(jnp.bfloat16)
        if iw_pad > iw:
            xp = jnp.pad(xp, ((0, 0), (0, iw_pad - iw)))
        xg = jnp.stack([xp[:, b:b + k] for b in bases])    # (G, ih, K)

        def dg(a, b):
            return jax.lax.dot_general(
                a, b, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)

        res = dg(xg, jnp.asarray(bh)) + dg(xg, jnp.asarray(bl))
        rows = jnp.transpose(res, (1, 0, 2)).reshape(
            ih, len(bases) * 128)[:, :ow]
    elif hmode == "gather" or (auto and hmode == "block"):
        # constant-light fallback: the auto policy switched away from the
        # dense band (constants too large to compile), but the block form
        # was rejected too (ow <= 128, or a heavy downscale where the
        # per-group window K ~ iw).  Falling back to dense would re-embed
        # the giant constants the limit exists to avoid, so use 4 clamped
        # column gathers instead — the identical integer sums (u8 x 12-bit
        # int coefficients, every product < 2^19 and 4-term sum < 2^22,
        # exact in f32), with only (ow, 4) tables embedded.
        xi, xic, _ = cv_cubic_tables(ow, iw)
        xf = img.astype(jnp.float32)
        rows = xf[:, xi[:, 3]] * jnp.asarray(xic[:, 3], jnp.float32)
        for t in (2, 1, 0):
            rows = xf[:, xi[:, t]] * jnp.asarray(xic[:, t], jnp.float32) + rows
    else:
        mxh, mxl = _hband_split(ow, iw)
        x = img.astype(jnp.bfloat16)
        dot = partial(jnp.dot, preferred_element_type=jnp.float32)
        rows = dot(x, jnp.asarray(mxh)) + dot(x, jnp.asarray(mxl))
    return _vpass(rows, oh, yi, yfc, vplan)


def _vpass(rows, oh: int, yi, yfc, plan):
    """Vertical pass on int-valued f32 ``rows`` of any column count.

    float32, right-to-left separate mul/add with OpenCV's per-product
    roundings (SIMD VResizeCubic); ``plan`` (a ``_vphase_plan`` result,
    computed once by the caller) selects the phased strided-slice form;
    ``None`` falls back to per-row gathers.
    """
    ncols = rows.shape[1]
    if plan is not None:
        # phased form: replicate row padding realizes the index clamp, each
        # phase is 4 shifted (stride-S) slices x scalar coefficients — the
        # identical mul/add chain per element, so bit-identical output
        P, S, top, bot, bases, coefs = plan
        rp = jnp.concatenate(
            ([jnp.repeat(rows[:1, :], top, axis=0)] if top else [])
            + [rows]
            + ([jnp.repeat(rows[-1:, :], bot, axis=0)] if bot else []),
            axis=0)
        nmax = -(-oh // P)
        phases = []
        for p in range(P):
            n = len(range(p, oh, P))
            r = rp[bases[p][3]: bases[p][3] + S * n: S, :] * coefs[p][3]
            for k in (2, 1, 0):
                r = rp[bases[p][k]: bases[p][k] + S * n: S, :] * coefs[p][k] + r
            u = jnp.clip(jnp.round(r), 0, 255).astype(jnp.uint8)
            if n < nmax:
                u = jnp.pad(u, ((0, nmax - n), (0, 0)))
            phases.append(u)
        out = jnp.stack(phases, axis=1).reshape(nmax * P, ncols)
        return out[:oh]
    r = rows[yi[:, 3], :] * yfc[:, 3][:, None]
    for k in (2, 1, 0):
        r = rows[yi[:, k], :] * yfc[:, k][:, None] + r
    return jnp.clip(jnp.round(r), 0, 255).astype(jnp.uint8)


def resize_bicubic_u8(img, out_hw: tuple[int, int], hmode: str = "dense"):
    """OpenCV-4.6-bit-exact INTER_CUBIC resize of uint8 planes.

    ``img``: uint8 ``[..., H, W]`` (leading dims vectorized). ``out_hw``:
    static ``(out_h, out_w)``.  Returns uint8 ``[..., out_h, out_w]``.

    ``hmode`` selects the horizontal-pass implementation — all are
    bit-identical; "dense" is the default:

    * ``"dense"`` — dense banded matmul (mostly zero FLOPs, but zero
      relayouts);
    * ``"block"`` — block-banded matmul (~iw/K fewer FLOPs, per-group
      stack/transpose relayouts);
    * ``"phase"`` — lane-phase strided-slice form for integer upscales
      (minimal FLOPs, a final u8 lane interleave);
    * ``"gather"`` — 4 clamped column gathers, no embedded matrices at all
      (the auto fallback for giant geometries the block form rejects).

    Past ``_DENSE_HBAND_LIMIT`` band entries the auto policy leaves "dense"
    for phase/block/gather so giant constant matrices are never embedded.
    """
    oh, ow = int(out_hw[0]), int(out_hw[1])
    return _resize_bicubic_u8_2d(img, oh, ow, hmode)


def _np_split_bf16(m: np.ndarray):
    """Exact numpy hi/lo bf16 split (hi = top-16-bit truncation)."""
    bits = m.astype(np.float32).view(np.uint32)
    hi = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    lo = m.astype(np.float32) - hi
    import ml_dtypes

    return hi.astype(ml_dtypes.bfloat16), lo.astype(ml_dtypes.bfloat16)


def resize_bicubic_u8_fast(img, out_hw: tuple[int, int]):
    """Matmul INTER_CUBIC resize: same tables, banded-matrix form.

    This variant expresses both 1-D passes as dense banded matmuls
    (clamped border taps collapse onto the same source
    row, so their coefficients are summed into one matrix entry — identical
    to the gather-sum semantics).

    Numerics: the horizontal (integer) pass is EXACT — uint8 values and the
    split 12-bit coefficients are exact in bf16 and the <=2^22 sums are
    exact in fp32.  The vertical pass uses split-precision (~2^-16 relative)
    instead of the reference's per-product fp32 roundings, so isolated
    pixels whose exact value sits within ~0.005 of a rounding boundary can
    land 1 LSB away from the exact engine (~70 dB agreement).  Use for
    throughput paths; the default engine remains bit-exact.
    """
    from .quantize import split_hi_lo as _split_hi_lo

    oh, ow = int(out_hw[0]), int(out_hw[1])
    ih, iw = img.shape[-2:]
    if iw * ow > _DENSE_HBAND_LIMIT or ih * oh > _DENSE_HBAND_LIMIT:
        # the dense (iw, ow) + (oh, ih) constants would hit the same
        # compile-size cliff the exact engine guards against
        # (_DENSE_HBAND_LIMIT); delegate to the exact engine's auto policy,
        # which picks a constant-light form for such geometries.
        return resize_bicubic_u8(img, out_hw)
    yi, _, yfc = cv_cubic_tables(oh, ih)
    mxh, mxl = _hband_split(ow, iw)    # shared with the exact engine
    my = np.zeros((oh, ih), np.float32)
    np.add.at(my, (np.broadcast_to(np.arange(oh)[:, None], yi.shape), yi),
              yfc)
    myh, myl = _np_split_bf16(my)

    x = img.astype(jnp.bfloat16)  # u8 exact in bf16
    dot = partial(jnp.einsum, precision=None,
                  preferred_element_type=jnp.float32)
    rows = dot("...hw,wo->...ho", x, jnp.asarray(mxh)) \
        + dot("...hw,wo->...ho", x, jnp.asarray(mxl))   # exact int32-valued
    rh, rl = _split_hi_lo(rows)
    out = dot("oh,...hw->...ow", jnp.asarray(myh), rh) \
        + dot("oh,...hw->...ow", jnp.asarray(myh), rl) \
        + dot("oh,...hw->...ow", jnp.asarray(myl), rh)
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Engine 2: generic float weights-table resampler
# ---------------------------------------------------------------------------

def _box(x):
    return (np.abs(x) <= 0.5).astype(np.float64)


def _bilinear(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _mitchell(x, b=1.0 / 3.0, c=1.0 / 3.0):
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    y = np.where(
        x < 1.0,
        ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)) / 6.0,
        np.where(
            x < 2.0,
            ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
             + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0,
            0.0,
        ),
    )
    return y


def _catmull_rom(x, a=-0.75):
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2) * x - (a + 3)) * x * x + 1,
        np.where(x < 2.0, ((a * x - 5 * a) * x + 8 * a) * x - 4 * a, 0.0),
    )


def _keys_cubic(x):
    # a = -0.5: the Keys kernel MATLAB's imresize 'bicubic' uses — the
    # degradation of record for the SRCNN evaluation protocol
    # (reference Pictures/Resize.m).
    return _catmull_rom(x, a=-0.5)


def _lanczos(x, a=3):
    x = np.asarray(x, dtype=np.float64)
    y = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, y, 0.0)


#: filter name -> (kernel function, support radius)
FILTERS: dict[str, tuple] = {
    "box": (_box, 0.5),
    "bilinear": (_bilinear, 1.0),
    "mitchell": (_mitchell, 2.0),      # frawscale's "bicubic" (frawscale.h:92)
    "catmull_rom": (_catmull_rom, 2.0),  # OpenCV INTER_CUBIC's kernel, float
    "cubic_matlab": (_keys_cubic, 2.0),  # MATLAB imresize kernel (a=-0.5)
    "lanczos3": (_lanczos, 3.0),
}


def _weights_table(dst: int, src: int, filter_name: str) -> tuple[np.ndarray, np.ndarray]:
    """Static gather-index and weight tables for one axis.

    Same contract as the reference's weight-table builder
    (frawscale.cpp:8-112): coordinate mapping ``(i+0.5)/scale - 0.5``,
    window ``2*ceil(fwidth)+1``, anti-aliased downscale (kernel stretched by
    the scale factor), weights normalized to sum 1, indices clamped to the
    image (replicate border).
    """
    fn, support = FILTERS[filter_name]
    scale = dst / src
    if scale < 1.0:
        fwidth, fscale = support / scale, scale
    else:
        fwidth, fscale = support, 1.0
    ntaps = 2 * math.ceil(fwidth) + 1
    centers = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    left = np.ceil(centers - fwidth).astype(np.int64)
    taps = left[:, None] + np.arange(ntaps)[None, :]
    w = fn((centers[:, None] - taps) * fscale)
    norm = w.sum(axis=1, keepdims=True)
    norm = np.where(norm == 0.0, 1.0, norm)
    w = (w / norm).astype(np.float32)
    idx = np.clip(taps, 0, src - 1).astype(np.int32)
    return idx, w


def _apply_axis(x, idx: np.ndarray, w: np.ndarray, axis: int):
    """One 1-D filtering pass along ``axis`` as a tap-loop of gathers."""
    wshape = [1] * x.ndim
    wshape[axis] = w.shape[0]
    acc = None
    for t in range(idx.shape[1]):
        g = jnp.take(x, jnp.asarray(idx[:, t]), axis=axis)
        term = g * jnp.asarray(w[:, t]).reshape(wshape)
        acc = term if acc is None else acc + term
    return acc


def resize_separable(x, out_hw: tuple[int, int], method: str = "mitchell"):
    """General separable resize of float planes ``[..., H, W]``.

    Pass order follows the reference engine (frawscale.cpp:195-278):
    horizontal first when downscaling, vertical first when upscaling, which
    minimizes the intermediate buffer.
    """
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ih, iw = x.shape[-2:]
    x = x.astype(jnp.float32)
    yi, yw = _weights_table(oh, ih, method)
    xi, xw = _weights_table(ow, iw, method)
    if ow <= iw:  # downscale: shrink width first
        x = _apply_axis(x, xi, xw, x.ndim - 1)
        x = _apply_axis(x, yi, yw, x.ndim - 2)
    else:  # upscale: filter the small-width intermediate first (vertical pass)
        x = _apply_axis(x, yi, yw, x.ndim - 2)
        x = _apply_axis(x, xi, xw, x.ndim - 1)
    return x
