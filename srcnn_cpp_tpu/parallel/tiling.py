"""Spatial row-tile sharding with bit-exact halo exchange.

The reference handles large images only by single-node O(W*H) memory
(SURVEY.md §5.7); here one image's rows are sharded across devices and the
conv stack's receptive field is stitched with explicit halo exchange:

* total halo = 6 rows per side — 4 for the 9x9 conv1 "same" padding + 2 for
  the 5x5 conv3 (reference pad geometry, src/srcnn.cpp:271-280, 200-210);
* interior tile edges receive real neighbor rows via ``lax.ppermute`` over
  the ``row`` mesh axis (neighbor exchange, non-periodic);
* true image edges receive replicate (clamp-to-edge) rows, identical to the
  reference's index-clamp LUTs;
* each device then runs the convs VALID in H over its extended tile, so the
  stitched result is bit-identical to the monolithic conv (gate:
  tests/test_tiling.py).

Differentiable end-to-end (ppermute transposes to the reverse permutation),
so the same forward serves sharded training (:mod:`..train`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.color import bgr2ycrcb_u8_planar, ycrcb2bgr_u8_planar
from ..ops.quantize import quantize_trunc_u8
from ..ops.resize import resize_bicubic_u8, resize_bicubic_u8_fast
from ..ops.srcnn import conv12_f32, conv3_f32

#: receptive-field radius of the 9-5-5 stack (4 + 0 + 2)
HALO = 6


def _halo_exchange(y, halo: int, axis_name: str, axis: int):
    """Extend a block by ``halo`` rows (``axis=-2``) or cols (``-1``).

    Interior seams get neighbor rows/cols (ppermute); the global edges get
    replicate copies, matching clamp-to-edge padding.
    """
    def take(start, stop):
        sl = [slice(None)] * y.ndim
        sl[axis] = slice(start, stop)
        return y[tuple(sl)]

    edge_lo = jnp.repeat(take(0, 1), halo, axis=axis)
    edge_hi = jnp.repeat(take(-1, None), halo, axis=axis)
    n = lax.axis_size(axis_name)
    if n == 1:
        return jnp.concatenate([edge_lo, y, edge_hi], axis=axis)
    idx = lax.axis_index(axis_name)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    recv_lo = lax.ppermute(take(-halo, None), axis_name, fwd)
    recv_hi = lax.ppermute(take(0, halo), axis_name, bwd)
    lead = jnp.where(idx == 0, edge_lo, recv_lo)
    tail = jnp.where(idx == n - 1, edge_hi, recv_hi)
    return jnp.concatenate([lead, y, tail], axis=axis)


def _halo_exchange_rows(y, halo: int, axis_name: str = "row"):
    """Row halo of a block ``[..., Ht, W]`` (see :func:`_halo_exchange`)."""
    return _halo_exchange(y, halo, axis_name, -2)


def _halo_exchange_cols(y, halo: int, axis_name: str = "col"):
    """Column halo of a block ``[..., H, Wt]`` (see :func:`_halo_exchange`)."""
    return _halo_exchange(y, halo, axis_name, -1)


def _clamp_feature_edges(f2, axis: int, axis_name: str):
    """Replace the 2 outermost feature rows/cols with clamped copies at the
    true image edges (reference conv3 padding semantics), pass through
    neighbor-derived values elsewhere.  ``axis`` is the spatial dim of the
    feature tensor."""
    n = lax.axis_size(axis_name)

    def take(i, k=1):
        sl = [slice(None)] * f2.ndim
        sl[axis] = slice(i, i + k) if i >= 0 else slice(i, (i + k) or None)
        return f2[tuple(sl)]

    lead_clamped = jnp.repeat(take(2), 2, axis=axis)
    tail_clamped = jnp.repeat(take(-3), 2, axis=axis)
    if n == 1:
        lead, tail = lead_clamped, tail_clamped
    else:
        idx = lax.axis_index(axis_name)
        lead = jnp.where(idx == 0, lead_clamped, take(0, 2))
        tail = jnp.where(idx == n - 1, tail_clamped, take(-2, 2))
    mid_sl = [slice(None)] * f2.ndim
    mid_sl[axis] = slice(2, -2)
    return jnp.concatenate([lead, f2[tuple(mid_sl)], tail], axis=axis)


def _features(ext, weights, kernel: str, pad_w: bool):
    """conv1+conv2 (and, for the kernel, conv3's channel sum) on a
    halo-extended block ``[B, Hx, Wx]``, VALID in rows (and in cols unless
    ``pad_w``).  Returns ``(features, row_axis, col_axis)``: NHWC f2 for
    the XLA stack, the per-tap partials ``[B, 25, h, w]`` for the kernel.
    """
    if kernel == "pallas":
        from ..ops.pallas_srcnn import conv12_q

        xp = jnp.pad(ext, ((0, 0), (0, 0), (4, 4) if pad_w else (0, 0)),
                     mode="edge")
        return conv12_q(xp, weights), -2, -1
    f2 = conv12_f32(ext[..., None], weights, pad_h=False, pad_w=pad_w)
    return f2, -3, -2


def _conv3(f, weights, kernel: str, pad_w: bool):
    """conv3 on :func:`_features` output, VALID in rows -> f32 [B, h, w]."""
    if kernel == "pallas":
        from ..ops.pallas_srcnn import conv3_from_q

        return conv3_from_q(f, weights.conv3_b, pad_h=False, pad_w=pad_w)
    return conv3_f32(f, weights, pad_h=False, pad_w=pad_w)[..., 0]


def _srcnn_rows_f32(y_block, weights, axis_name: str = "row",
                    kernel: str = "xla"):
    """Per-device forward on a row block ``[B, Ht, W]`` -> f32 ``[B, Ht, W]``.

    One 6-row input halo exchange covers conv1's 4 and conv3's 2 — but at
    the *true* image edges conv3's padding must be clamped copies of f2's
    edge rows (feature-level replication, srcnn.cpp:200-210), not features
    computed from virtually-extended input; those two rows are overwritten
    accordingly on the first/last device.  ``kernel="pallas"`` runs the
    fused kernel of :mod:`..ops.pallas_srcnn` (inference only); any other
    value the differentiable XLA stack.
    """
    ext = _halo_exchange_rows(y_block, HALO, axis_name)        # [B, Ht+12, W]
    f, row_ax, _ = _features(ext, weights, kernel, pad_w=True)
    f = _clamp_feature_edges(f, row_ax, axis_name)
    return _conv3(f, weights, kernel, pad_w=True)


def _srcnn_tile2d_f32(y_block, weights, row_axis: str = "row",
                      col_axis: str = "col", kernel: str = "xla"):
    """Per-device forward on a 2-D tile ``[B, Ht, Wt]`` (row x col mesh).

    Halo exchange on both spatial axes; conv runs VALID in both; conv3's
    feature-level clamp applied at true image edges on both axes.
    """
    ext = _halo_exchange_rows(y_block, HALO, row_axis)
    ext = _halo_exchange_cols(ext, HALO, col_axis)     # [B, Ht+12, Wt+12]
    f, row_ax, col_ax = _features(ext, weights, kernel, pad_w=False)
    f = _clamp_feature_edges(f, row_ax, row_axis)
    f = _clamp_feature_edges(f, col_ax, col_axis)
    return _conv3(f, weights, kernel, pad_w=False)


@partial(jax.jit, static_argnames=("mesh", "kernel"))
def _tiled_call(y, weights, mesh: Mesh, kernel: str = "xla"):
    if mesh.shape.get("col", 1) > 1:
        spec = P("data", "row", "col")
        body = lambda w, x: quantize_trunc_u8(
            _srcnn_tile2d_f32(x, w, kernel=kernel))
    else:
        spec = P("data", "row", None)
        body = lambda w, x: quantize_trunc_u8(
            _srcnn_rows_f32(x, w, kernel=kernel))
    return shard_map(
        body, mesh=mesh, in_specs=(P(), spec), out_specs=spec,
        # pallas_call's out_shape carries no varying-mesh-axes info, so
        # the vma checker cannot see through the kernel
        check_vma=kernel != "pallas",
    )(weights, y)


def srcnn_y_tiled(y_u8, weights, mesh: Mesh, kernel: str = "xla"):
    """SRCNN an upscaled Y batch ``[B, H, W]`` sharded over a device mesh.

    ``B`` shards over the ``data`` axis, rows over ``row`` and (when the
    mesh has one) columns over ``col`` — 2-D spatial tiling with halo
    exchange on both axes.  Dims must divide by the mesh axis sizes (use
    :func:`upscale_y_tiled` for arbitrary ``H``).  ``kernel`` is a
    concrete conv path (``runtime.resolve_kernel``): ``"pallas"`` runs the
    fused kernel on each device's halo-extended tile, anything else the
    XLA stack at ``Precision.HIGHEST``.
    """
    ndata, nrow = mesh.shape["data"], mesh.shape["row"]
    ncol = mesh.shape.get("col", 1)
    b, h, w = y_u8.shape
    if b % ndata or h % nrow or w % ncol:
        raise ValueError(f"batch {b} / height {h} / width {w} not divisible "
                         f"by mesh {ndata}x{nrow}x{ncol}")
    spec = P("data", "row", "col" if ncol > 1 else None)
    y = jax.device_put(y_u8, NamedSharding(mesh, spec))
    return _tiled_call(y, weights, mesh, kernel)


def upscale_y_tiled(y_u8, weights, mesh: Mesh, kernel: str = "xla"):
    """Like :func:`srcnn_y_tiled` but pads H to a tile multiple and crops.

    Bottom padding uses replicate rows, which are *identical* to conv1's
    input-level clamp, so every f2 feature row up to the real edge is exact.
    Only conv3's feature-level clamp differs: the last 2 real output rows
    see computed (not clamped) f2 pad rows.  Those 2 rows are recomputed
    monolithically from a 16-row bottom strip and patched in, keeping the
    whole result bit-exact.

    All padding/cropping/patching is device-side jnp (no host round-trip):
    a jax.Array input stays on device end to end.  Returns a jax.Array.
    """
    from ..pipeline import _srcnn

    nrow = mesh.shape["row"]
    y = jnp.asarray(y_u8)
    squeeze = y.ndim == 2
    if squeeze:
        y = y[None]
    b, h, w = y.shape
    hpad = (-h) % nrow
    yp = y
    if hpad:
        yp = jnp.concatenate(
            [y, jnp.repeat(y[:, -1:, :], hpad, axis=1)], axis=1)
    ndata = mesh.shape["data"]
    bpad = (-b) % ndata
    if bpad:
        yp = jnp.concatenate([yp, yp[:bpad]], axis=0)
    out = srcnn_y_tiled(yp, weights, mesh, kernel)[:b, :h, :]
    if hpad:
        strip = min(h, 16)
        fix = _srcnn(y[:, h - strip:, :], weights, kernel)
        n_bad = min(2, h)
        out = out.at[:, h - n_bad:, :].set(fix[:, strip - n_bad:, :])
    return out[0] if squeeze else out


def pre_upscale_sharded(bgr_p, out_hw: tuple[int, int], sharding,
                        resize: str = "exact"):
    """Colour + bicubic pre-pass of planar BGR ``[..., 3, H, W]`` under a
    row (and column) ``sharding``, inside a jit.  XLA's SPMD partitioner
    inserts the resize's boundary communication.  ``resize`` is a
    concrete engine name (``runtime.resolve_resize``)."""
    rs = resize_bicubic_u8_fast if resize == "fast" else resize_bicubic_u8
    x = lax.with_sharding_constraint(bgr_p, sharding)
    return lax.with_sharding_constraint(
        rs(bgr2ycrcb_u8_planar(x), out_hw), sharding)


def merge_sharded(y_sr, up, sharding):
    """Merge ``y_sr [..., H, W]`` with the chroma of ``up [..., 3, H, W]``
    and convert to planar BGR under ``sharding`` (pointwise: no comms)."""
    merged = jnp.stack([y_sr, up[..., 1, :, :], up[..., 2, :, :]], axis=-3)
    return lax.with_sharding_constraint(ycrcb2bgr_u8_planar(merged), sharding)
