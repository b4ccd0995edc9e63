"""Spatial tiling gate: tiled-with-halo-exchange == monolithic, bit-exact.

Runs on the 8-virtual-CPU-device mesh (conftest).  This is the pure-logic
multi-chip test SURVEY.md §4d calls for: seam correctness needs no real
cluster, only correct halo plumbing.
"""

import numpy as np
import pytest


def _rand_y(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def mesh24():
    from srcnn_cpp_tpu.parallel import make_mesh

    return make_mesh(data=2, row=4)


@pytest.fixture(scope="module")
def mesh18():
    from srcnn_cpp_tpu.parallel import make_mesh

    return make_mesh(data=1, row=8)


def test_tiled_bit_exact_vs_monolithic(weights, mesh24):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.parallel import srcnn_y_tiled

    y = _rand_y((2, 64, 96))
    mono = np.asarray(srcnn_y(y, weights))
    tiled = np.asarray(srcnn_y_tiled(y, weights, mesh24))
    assert np.array_equal(mono, tiled)


def test_tiled_8way_rows(weights, mesh18):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.parallel import srcnn_y_tiled

    # 8 row-tiles of height 16 — halo (6) is a large fraction of the tile,
    # which stresses the exchange plumbing hardest.
    y = _rand_y((1, 128, 64), seed=3)
    mono = np.asarray(srcnn_y(y, weights))
    tiled = np.asarray(srcnn_y_tiled(y, weights, mesh18))
    assert np.array_equal(mono, tiled)


def test_tiled_rejects_indivisible(weights, mesh24):
    from srcnn_cpp_tpu.parallel import srcnn_y_tiled

    with pytest.raises(ValueError):
        srcnn_y_tiled(_rand_y((2, 65, 64)), weights, mesh24)


def test_upscale_y_tiled_pads_and_crops(weights, mesh24):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.parallel import upscale_y_tiled

    # H=61 not divisible by 4 row-tiles; single plane (2-D input).
    y = _rand_y((61, 40), seed=5)
    mono = np.asarray(srcnn_y(y, weights))
    tiled = upscale_y_tiled(y, weights, mesh24)
    assert tiled.shape == mono.shape
    assert np.array_equal(mono, tiled)


def test_mesh_construction():
    import jax

    from srcnn_cpp_tpu.parallel import make_mesh

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    m = make_mesh()
    assert dict(m.shape) == {"data": 1, "row": 8, "col": 1}
    m2 = make_mesh(data=4)
    assert dict(m2.shape) == {"data": 4, "row": 2, "col": 1}
    m3 = make_mesh(data=1, row=4, col=2)
    assert dict(m3.shape) == {"data": 1, "row": 4, "col": 2}
    with pytest.raises(ValueError):
        make_mesh(data=3, row=3)


def test_tiled_2d_bit_exact_vs_monolithic(weights):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.parallel import make_mesh, srcnn_y_tiled

    # 2-D spatial mesh: rows x cols halo exchange on both axes
    mesh = make_mesh(data=1, row=2, col=4)
    y = _rand_y((1, 64, 96), seed=7)
    mono = np.asarray(srcnn_y(y, weights))
    tiled = np.asarray(srcnn_y_tiled(y, weights, mesh))
    assert np.array_equal(mono, tiled)


def test_tiled_2d_with_data_axis(weights):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.parallel import make_mesh, srcnn_y_tiled

    mesh = make_mesh(data=2, row=2, col=2)
    y = _rand_y((2, 48, 64), seed=8)
    mono = np.asarray(srcnn_y(y, weights))
    tiled = np.asarray(srcnn_y_tiled(y, weights, mesh))
    assert np.array_equal(mono, tiled)


def test_gspmd_matches_monolithic_and_manual(weights, mesh24):
    # two independent partitioners (XLA SPMD vs hand shard_map) vs monolith
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.parallel import srcnn_y_tiled
    from srcnn_cpp_tpu.parallel.gspmd import srcnn_y_gspmd

    y = _rand_y((2, 64, 96), seed=12)
    mono = np.asarray(srcnn_y(y, weights))
    auto = np.asarray(srcnn_y_gspmd(y, weights, mesh24))
    manual = np.asarray(srcnn_y_tiled(y, weights, mesh24))
    assert np.array_equal(mono, auto)
    assert np.array_equal(mono, manual)


def test_gspmd_handles_indivisible_dims(weights, mesh24):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu.parallel.gspmd import srcnn_y_gspmd

    y = _rand_y((2, 61, 53), seed=13)  # nothing divides by the mesh
    mono = np.asarray(srcnn_y(y, weights))
    auto = np.asarray(srcnn_y_gspmd(y, weights, mesh24))
    assert np.array_equal(mono, auto)


@pytest.fixture()
def interpret_kernel(monkeypatch):
    """Run the fused kernel in interpret mode wherever the tiled paths
    call it (the CPU cannot compile its Triton lowering)."""
    from functools import partial

    import srcnn_cpp_tpu.ops.pallas_srcnn as ps

    monkeypatch.setattr(ps, "conv12_q", partial(ps.conv12_q, interpret=True))


def test_pallas_tiled_matches_monolithic(weights, interpret_kernel):
    # the fused-kernel-per-device composition (the GPU's multi-card conv)
    # must agree with the monolithic paths within the usual 1-LSB
    # split-precision budget, including the global top/bottom rows that
    # take the feature-row clamp
    from srcnn_cpp_tpu.parallel import make_mesh
    from srcnn_cpp_tpu.parallel.tiling import srcnn_y_tiled
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    mesh = make_mesh(data=2, row=4)
    y = np.random.default_rng(21).integers(0, 256, (2, 64, 144),
                                           dtype=np.uint8)
    out = np.asarray(srcnn_y_tiled(y, weights, mesh, kernel="pallas"))
    ref = np.asarray(srcnn_y(y, weights))
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1, d.max()


def test_pallas_tiled_2d_matches_monolithic(weights, interpret_kernel):
    # fused kernel on a (row x col) mesh: halos on both axes, the feature
    # clamp at the true image edges on both axes
    from srcnn_cpp_tpu.parallel import make_mesh
    from srcnn_cpp_tpu.parallel.tiling import srcnn_y_tiled
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y

    y = np.random.default_rng(22).integers(0, 256, (2, 48, 160),
                                           dtype=np.uint8)
    ref = np.asarray(srcnn_y(y, weights))
    for shape in [dict(data=2, row=2, col=2), dict(data=1, row=2, col=4)]:
        mesh = make_mesh(**shape)
        out = np.asarray(srcnn_y_tiled(y, weights, mesh, kernel="pallas"))
        d = np.abs(out.astype(int) - ref.astype(int))
        assert d.max() <= 1, (shape, d.max())

    # tiles as small as the halo (6 rows) stitch too
    mesh = make_mesh(data=2, row=2, col=2)
    out = np.asarray(srcnn_y_tiled(y[:, :12, :], weights, mesh,
                                   kernel="pallas"))
    d = np.abs(out.astype(int) - np.asarray(srcnn_y(y[:, :12, :], weights))
               .astype(int))
    assert d.max() <= 1, d.max()


def _engine(x, out_hw):
    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar
    from srcnn_cpp_tpu.ops.resize import resize_bicubic_u8

    return np.asarray(resize_bicubic_u8(bgr2ycrcb_u8_planar(x), out_hw))


def _sharded_pre(x, out_hw, mesh, resize="exact"):
    """parallel.tiling.pre_upscale_sharded under the mesh's row (and col)
    sharding, batch over ``data``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from srcnn_cpp_tpu.parallel.tiling import pre_upscale_sharded

    col = "col" if mesh.shape.get("col", 1) > 1 else None
    spec = NamedSharding(mesh, P("data", None, "row", col))
    fn = jax.jit(lambda v: pre_upscale_sharded(v, out_hw, spec, resize))
    return np.asarray(fn(x))


def _assert_close(got, ref, frac=1e-4):
    # the partitioned program may contract the vertical pass's mul+add
    # differently from the monolithic one: rare 1-LSB boundary flips
    d = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < frac, (d.max(), (d > 0).mean())


def test_pre_upscale_fused_rows_matches_monolith(weights, mesh24):
    # row-sharded (GSPMD) pre-pass: stitched plane vs the monolithic engine
    rng = np.random.default_rng(7)
    for s, b in [(2, 2), (3, 4)]:
        x = rng.integers(0, 256, (b, 3, 64, 160), dtype=np.uint8)
        out_hw = (64 * s, 160 * s)
        _assert_close(_sharded_pre(x, out_hw, mesh24), _engine(x, out_hw))


def test_pre_upscale_fused_rows_declines(weights, mesh24):
    # geometries the old per-device kernel declined all partition: x1.2
    # (no phase plan), rows not divisible by the row axis, column blocks
    # narrower than 128, widths not divisible by the col axis
    from srcnn_cpp_tpu.parallel import make_mesh

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 3, 64, 160), dtype=np.uint8)
    _assert_close(_sharded_pre(x, (76, 192), mesh24), _engine(x, (76, 192)))
    x2 = rng.integers(0, 256, (2, 3, 63, 160), dtype=np.uint8)
    _assert_close(_sharded_pre(x2, (126, 320), mesh24),
                  _engine(x2, (126, 320)))
    mesh2d = make_mesh(data=1, row=2, col=4)
    _assert_close(_sharded_pre(x, (128, 320), mesh2d), _engine(x, (128, 320)))
    x3 = rng.integers(0, 256, (2, 3, 64, 634), dtype=np.uint8)
    _assert_close(_sharded_pre(x3, (128, 1268), mesh2d),
                  _engine(x3, (128, 1268)))


def test_pre_upscale_fused_rows_generalized_plan(weights, mesh24):
    # x3 past OpenCV's f32 coefficient-drift boundary (output rows >=
    # 1536): the vertical pass takes its gather form, sharded over ``row``
    rng = np.random.default_rng(17)
    x = rng.integers(0, 256, (2, 3, 540, 96), dtype=np.uint8)
    _assert_close(_sharded_pre(x, (1620, 288), mesh24),
                  _engine(x, (1620, 288)))


def test_pre_upscale_fused_rows_parity_plans(weights, mesh24):
    # S>=2 parity plans sharded: x1.5 (pv=3, sv=2), x0.75 (pv=3, sv=4),
    # the 2:1 downscale (pv=1, sv=2) and x1.25 (S=4)
    rng = np.random.default_rng(23)
    for scale, ih, iw in [(1.5, 64, 192), (0.75, 96, 256), (0.5, 128, 512),
                          (1.25, 96, 256)]:
        x = rng.integers(0, 256, (2, 3, ih, iw), dtype=np.uint8)
        out_hw = (int(ih * scale), int(iw * scale))
        _assert_close(_sharded_pre(x, out_hw, mesh24), _engine(x, out_hw))


def test_pre_upscale_fused_rows_fuzz(weights, mesh24):
    # randomized RATIONAL-scale geometries, anisotropic (independent p/q
    # per axis), through the sharded path
    import random

    random.seed(77)
    rng = np.random.default_rng(1)
    tried = 0
    for trial in range(24):
        qv, pv = random.randrange(1, 5), random.randrange(1, 13)
        qh, ph = random.randrange(1, 5), random.randrange(1, 13)
        ih = random.randrange(2, 12) * qv * 4
        iw = max(128, random.randrange(32, 80) * qh)
        oh, ow = ih * pv // qv, iw * ph // qh
        if not (32 <= oh <= 600 and oh % 4 == 0 and 128 <= ow <= 900):
            continue
        x = rng.integers(0, 256, (2, 3, ih, iw), dtype=np.uint8)
        tried += 1
        _assert_close(_sharded_pre(x, (oh, ow), mesh24), _engine(x, (oh, ow)),
                      frac=1e-3)
        if tried >= 8:       # bound the suite cost; the generator is the gate
            break
    assert tried >= 6, f"fuzz exercised only {tried} sharded geometries"


def test_pre_upscale_fused_2d_parity_plan(weights):
    # x1.5 on a (row, col) mesh: GSPMD comms on both axes
    from srcnn_cpp_tpu.parallel import make_mesh

    mesh2d = make_mesh(data=1, row=2, col=4)
    rng = np.random.default_rng(29)
    x = rng.integers(0, 256, (2, 3, 64, 1024), dtype=np.uint8)
    _assert_close(_sharded_pre(x, (96, 1536), mesh2d),
                  _engine(x, (96, 1536)))


def test_pre_upscale_fused_2d_matches_monolith(weights):
    # 2-D (row, col) mesh at integer scales, both resize engines
    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar
    from srcnn_cpp_tpu.ops.resize import resize_bicubic_u8_fast
    from srcnn_cpp_tpu.parallel import make_mesh

    mesh2d = make_mesh(data=1, row=2, col=4)
    rng = np.random.default_rng(8)
    for s, iw in [(2, 256), (3, 192)]:
        x = rng.integers(0, 256, (2, 3, 64, iw), dtype=np.uint8)
        out_hw = (64 * s, iw * s)
        _assert_close(_sharded_pre(x, out_hw, mesh2d), _engine(x, out_hw))
        fast = np.asarray(resize_bicubic_u8_fast(bgr2ycrcb_u8_planar(x),
                                                 out_hw))
        _assert_close(_sharded_pre(x, out_hw, mesh2d, "fast"), fast)


def test_merge_fused_rows_bit_equal(weights, mesh24):
    # pointwise post-pass: sharded == monolithic exactly, on row and
    # (row, col) meshes and on rows the mesh does not divide
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from srcnn_cpp_tpu.ops.color import ycrcb2bgr_u8_planar
    from srcnn_cpp_tpu.parallel import make_mesh
    from srcnn_cpp_tpu.parallel.tiling import merge_sharded

    def mono(y, up):
        import jax.numpy as jnp

        return np.asarray(ycrcb2bgr_u8_planar(jnp.stack(
            [jnp.asarray(y), jnp.asarray(up[:, 1]), jnp.asarray(up[:, 2])],
            axis=1)))

    def sharded(y, up, mesh):
        col = "col" if mesh.shape.get("col", 1) > 1 else None
        spec = NamedSharding(mesh, P("data", None, "row", col))
        return np.asarray(jax.jit(lambda a, b: merge_sharded(a, b, spec))(
            y, up))

    rng = np.random.default_rng(11)
    y_sr = rng.integers(0, 256, (2, 64, 192), dtype=np.uint8)
    up = rng.integers(0, 256, (2, 3, 64, 192), dtype=np.uint8)
    assert np.array_equal(sharded(y_sr, up, mesh24), mono(y_sr, up))
    mesh2d = make_mesh(data=2, row=2, col=2)
    y2 = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    up2 = rng.integers(0, 256, (2, 3, 64, 256), dtype=np.uint8)
    assert np.array_equal(sharded(y2, up2, mesh2d), mono(y2, up2))
    for rows in (60, 62, 16):
        assert np.array_equal(sharded(y_sr[:, :rows], up[:, :, :rows], mesh24),
                              mono(y_sr[:, :rows], up[:, :, :rows])), rows
