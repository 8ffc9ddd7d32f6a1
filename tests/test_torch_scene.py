"""Port's mosaic build vs the JAX device build, table by table.

A 2x2 block of 65^2 tiles with shared seams goes through the JAX package's
`build_mosaic(..., on_device=True)` and the port's `build_mosaic` on the
CPU. Heights, every mip level, the dilated max pyramid and the height plane
of every window table must be equal. Packed normals may differ by one code
per 10-bit channel: the normals pass through cos() of each row's latitude
and a tile rotation, whose last bits differ between XLA and PyTorch, before
rounding to 1023 levels.

The mosaic's accessors (`normals_packed`, `normals`, `valid`, `cell_tile`,
`tile_rot`) read as JAX's do: the packed words and their decode bit for
bit on the JAX build carried across (`jax_mosaic_to_port`), the host
bookkeeping equal between the two builds.
"""

import numpy as np
import pytest
import torch

from tests.helpers import synthetic_heights
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.data.coordinate_transform import CoordinateTransform as JaxTransform
from topo_renderer_tpu.geo import GeoLocation as JaxLocation
from topo_renderer_tpu.models.scene import TerrainTile as JaxTile, build_mosaic as jax_build_mosaic
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models.scene import TerrainTile, build_mosaic, unpack_normals

N, SPAN = 65, 0.05


def _tiles():
    """2x2 tiles sharing their seam rows/columns; per-tile heights from a
    seed, so seam texels come from whichever tile is written last."""
    out = []
    ps = SPAN / (N - 1)
    for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        lat_top, lon0 = 49.1 - dy * SPAN, 20.0 + dx * SPAN
        out.append((49 - dy, 20 + dx, synthetic_heights(N, seed=i), (lon0, lat_top), ps))
    return out


@pytest.fixture(scope="module")
def mosaics():
    tiles = _tiles()
    jm = jax_build_mosaic(
        [JaxTile(JaxLocation.from_coord(la, lo), h, JaxTransform((0.0, 0.0), mp, (ps, ps)))
         for la, lo, h, mp, ps in tiles],
        window_table_min=0, on_device=True,
    )
    pm = build_mosaic(
        [TerrainTile(GeoLocation.from_coord(la, lo), h, CoordinateTransform((0.0, 0.0), mp, (ps, ps)))
         for la, lo, h, mp, ps in tiles],
        window_table_min=0, device="cpu",
    )
    return jm, pm


def test_static_fields_equal(mosaics):
    jm, pm = mosaics
    assert pm.shape == jm.shape == (2 * N - 1, 2 * N - 1)
    assert pm.mip_shapes == tuple(jm.mip_shapes)
    assert pm.texel_m == jm.texel_m
    assert pm.has_cell_table == jm.has_cell_table
    for name in ("model_point", "pixel_scale", "hmax", "bound_center", "bound_radius"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)), err_msg=name)


def test_heights_and_pyramids_exact(mosaics):
    jm, pm = mosaics
    np.testing.assert_array_equal(pm.heights_flat.numpy(), np.asarray(jm.heights_flat))
    np.testing.assert_array_equal(pm.attr_packed_flat[:, 0].numpy(), np.asarray(jm.attr_packed_flat[:, 0]))
    assert len(pm.mip_heights_flat) == len(jm.mip_heights_flat) > 0
    for level, (p, j) in enumerate(zip(pm.mip_heights_flat, jm.mip_heights_flat), start=1):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=f"mip {level}")
    for level, (p, j) in enumerate(zip(pm.mip_hmax_flat, jm.mip_hmax_flat), start=1):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=f"hmax {level}")
    for level, (p, j) in enumerate(zip(pm.mip_attr_flat, jm.mip_attr_flat), start=1):
        np.testing.assert_array_equal(p[:, 0].numpy(), np.asarray(j[:, 0]), err_msg=f"mip attr {level}")
    assert len(pm.win_attr_2d) == len(jm.win_attr_2d)
    for level, (p, j) in enumerate(zip(pm.win_attr_2d, jm.win_attr_2d)):
        assert (p is None) == (j is None), level
        if p is not None:
            np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]), err_msg=f"win {level}")
    np.testing.assert_array_equal(pm.cell_heights_flat[:, :4].numpy(), np.asarray(jm.cell_heights_flat[:, :4]))


def _codes(bits):
    b = np.asarray(bits).view(np.uint32).astype(np.int64)
    return np.stack([(b >> s) & 0x3FF for s in (0, 10, 20)], axis=-1)


def _normal_tables(m, to_np):
    tables = {"level 0": m.attr_packed_flat[:, 1], "cell": m.cell_heights_flat[:, 4:]}
    for level, a in enumerate(m.mip_attr_flat, start=1):
        tables[f"level {level}"] = a[:, 1]
    for level, w in enumerate(m.win_attr_2d):
        if w is not None:
            tables[f"win {level}"] = w[1]
    return {k: to_np(v) for k, v in tables.items()}


def test_packed_normals_within_one_code(mosaics):
    jm, pm = mosaics
    jt = _normal_tables(jm, lambda a: np.asarray(a))
    pt = _normal_tables(pm, lambda a: a.contiguous().numpy())
    report = {}
    for name in jt:
        d = np.abs(_codes(pt[name]) - _codes(jt[name]))
        report[name] = float((d != 0).any(axis=-1).mean())
        assert d.max() <= 1, (name, int(d.max()))
    # The failing fraction per table: texels with some code off by one.
    print("packed normals off by one code:", report)
    assert max(report.values()) < 0.05, report


def test_unpack_normals_reads_the_bits(mosaics):
    _, pm = mosaics
    nx, ny, nz = unpack_normals(pm.attr_packed_flat[:, 1].contiguous())
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz).numpy().reshape(pm.shape)
    # The outer ring keeps the zero-encoded (-1, -1, -1) normal, rotated.
    assert np.all(np.abs(norm[1:-1, 1:-1] - 1.0) < 0.01)


def test_normals_packed_and_decoded_equal_jax(mosaics):
    jm, _ = mosaics
    pm = jax_mosaic_to_port(jm)
    packed, want = pm.normals_packed, np.asarray(jm.normals_packed)
    assert packed.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(packed.numpy(), want)
    normals, want = pm.normals.numpy(), np.asarray(jm.normals)
    assert normals.shape == want.shape == (*jm.shape, 3)
    np.testing.assert_array_equal(normals.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(pm.heights.numpy(), np.asarray(jm.heights))


def test_host_accessors_equal_jax(mosaics):
    jm, pm = mosaics
    for name in ("valid", "cell_tile", "tile_rot"):
        got, want = np.asarray(getattr(pm, name)), np.asarray(getattr(jm, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
