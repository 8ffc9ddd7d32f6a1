"""Streaming slot updates: the port's `models/mosaic_update.py` and
`RenderEngine(streaming=True)` vs the JAX package and vs the port's own
fresh builds.

Tiles are `tests/test_mosaic_update.py`'s (N = 33 texels with shared seams).
Tolerances:

- Canvas sizing and slice geometry: equal to JAX's.
- The port's canvas build and its slot update against JAX's (the update on
  JAX's own pre-update tables, carried across): heights, mips, the dilated
  and raw max pyramids and the cell heights bit-equal; packed normals
  within one code per 10-bit channel, on at most 0.1% of all packed texels
  (the known build difference: the normals pass through cos() of each
  row's latitude and a tile rotation, whose last bits differ between XLA
  and PyTorch).
- The port's streaming engine against its own fresh build of the same
  tiles on the same canvas: every table bit for bit, ``hmax``, the
  bounding sphere, and the host arrays (valid mask, each texel's owning
  tile and its rotation).
- A 96 x 64 exact frame after an update against JAX's streaming engine
  evaluated primitive by primitive (`jax.disable_jit()`), at
  `test_torch_exact_frame.py`'s limits for the guided march: hit masks
  equal on >= 99.9% of pixels; the hit distance's relative difference
  below 1e-6 at p50, 1e-4 at p99 and 5e-2 at max, above 1e-3 on at most
  2%; depth within 5e-3 relative. The hits lie 1-2 km away, where a
  half-metre float32 ulp of an ECEF coordinate is 2-5e-4 of the distance:
  the jitted JAX frame's distances differ from JAX's own eager ones by
  5.1e-4 at p50 here, and depth's ``clip_z / clip_w`` (ECEF products of
  ~6.4e6 m) moves by 2.1e-4 at p50 between the port and eager JAX even
  with JAX's tables carried across, so neither is held tighter.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import topo_renderer_tpu.models.mosaic_update as jmu
from tests import test_mosaic_update as jtests
from tests.test_torch_exact_frame import port_camera
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.models.scene import build_mosaic as jax_build_mosaic
from topo_renderer_tpu.render.engine import RenderEngine as JaxEngine
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models import mosaic_update as pmu
from topo_renderer_tpu_torch.models.scene import TerrainTile, build_mosaic
from topo_renderer_tpu_torch.render.engine import RenderEngine

WIN_MIN = 500  # exercise the 2-D window tables at test scale


def port_tile(row, col):
    """`test_mosaic_update.tile_at` as the port's tile."""
    t = jtests.tile_at(row, col)
    tr = t.transform
    return TerrainTile(GeoLocation.from_coord(49 - row, 20 + col), t.heights,
                       CoordinateTransform(tr.raster_point, tr.model_point, tr.pixel_scale))


def streaming_engine():
    eng = RenderEngine(device="cpu", streaming=True)
    eng._window_table_min = WIN_MIN
    return eng


def add(eng, *tiles):
    for t in tiles:
        eng.add_terrain(t.location, t.heights, t.transform)


def fresh_build(eng, tiles):
    """A fresh build of ``tiles`` on ``eng``'s canvas, listed in the order of
    the engine's slots. The order matters at one kind of texel: a valid
    texel with no owning cell (the tile set's south and east edges) takes
    the rotation of tile index 0 in both packages, the build's first tile
    and the engine's slot 0, and slot 0 need not hold the tile a sorted
    rebuild would put first (ROADMAP.md §3)."""
    lon_nw, lat_nw, h_m, w_m, _, _ = eng._canvas
    return build_mosaic(sorted(tiles, key=lambda t: eng._slots[t.location][0]), canvas=(lon_nw, lat_nw, h_m, w_m), keep_hmax_raw=True,
                        window_table_min=WIN_MIN, device="cpu")


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


def _np(x):
    return x.contiguous().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


HEIGHT_TABLES = ("heights_flat", "mip_heights_flat", "mip_hmax_flat", "mip_hmax_raw_flat")


def _tables(m):
    """name -> numpy array: every table (heights and packed words apart)."""
    out = {}
    for name in HEIGHT_TABLES:
        vals = getattr(m, name)
        for lv, v in enumerate(vals if isinstance(vals, tuple) else (vals,)):
            out[f"{name}[{lv}]"] = _np(v)
    out["cell heights"] = _np(m.cell_heights_flat)[:, :4]
    out["cell normals"] = _np(m.cell_heights_flat)[:, 4:]
    out["attr heights"] = _np(m.attr_packed_flat)[:, 0]
    out["attr normals"] = _np(m.attr_packed_flat)[:, 1]
    for lv, a in enumerate(m.mip_attr_flat, start=1):
        out[f"mip_attr heights[{lv}]"] = _np(a)[:, 0]
        out[f"mip_attr normals[{lv}]"] = _np(a)[:, 1]
    for lv, w in enumerate(m.win_attr_2d):
        if w is not None:
            out[f"win heights[{lv}]"] = _np(w)[0]
            out[f"win normals[{lv}]"] = _np(w)[1]
    return out


def _codes(words):
    b = _bits(words).astype(np.int64)
    return np.stack([(b >> s) & 0x3FF for s in (0, 10, 20)], axis=-1)


def assert_matches_jax(port, jax_m):
    """Heights and pyramids bit-equal, packed normals within one code on at
    most 0.1% of the packed texels."""
    assert port.shape == tuple(jax_m.shape) and port.mip_shapes == tuple(jax_m.mip_shapes)
    pt, jt = _tables(port), _tables(jax_m)
    assert pt.keys() == jt.keys() and len(port.mip_hmax_raw_flat) == len(port.mip_shapes) > 0
    off, total = 0, 0
    for name in pt:
        if "normals" in name:
            d = np.abs(_codes(pt[name]) - _codes(jt[name]))
            assert d.max() <= 1, (name, int(d.max()))
            off += int((d != 0).any(axis=-1).sum())
            total += d.shape[0] * (d.shape[1] if d.ndim == 3 else 1)
        else:
            np.testing.assert_array_equal(_bits(pt[name]), _bits(jt[name]), err_msg=name)
    assert off <= 0.001 * total, (off, total)
    np.testing.assert_array_equal(_np(port.hmax), np.asarray(jax_m.hmax))


def assert_bitwise(eng, m, ref):
    """The streaming engine's mosaic ``m`` equals the fresh build ``ref``:
    every table, hmax, the bounding sphere and the host arrays."""
    assert m.shape == ref.shape and m.mip_shapes == ref.mip_shapes
    mt, rt = _tables(m), _tables(ref)
    assert mt.keys() == rt.keys()
    for name in mt:
        np.testing.assert_array_equal(_bits(mt[name]), _bits(rt[name]), err_msg=name)
    for name in ("hmax", "bound_center", "bound_radius", "model_point", "pixel_scale"):
        np.testing.assert_array_equal(_bits(_np(getattr(m, name))), _bits(_np(getattr(ref, name))), err_msg=name)
    np.testing.assert_array_equal(m.host.valid, ref.host.valid)
    # Owners: the engine's slot ids against the build's tile indices.
    slot_loc = {slot: loc for loc, (slot, *_) in eng._slots.items()}
    build_loc = dict(enumerate(sorted(eng.loaded_locations, key=lambda loc: eng._slots[loc][0])))
    for cells, names in ((m.host.cell_tile, slot_loc), (ref.host.cell_tile, build_loc)):
        assert set(np.unique(cells[cells >= 0])) <= set(names)
    owner = np.vectorize(lambda i: slot_loc.get(i), otypes=[object])(m.host.cell_tile)
    want = np.vectorize(lambda i: build_loc.get(i), otypes=[object])(ref.host.cell_tile)
    assert (owner == want).all()
    for i, loc in build_loc.items():
        np.testing.assert_array_equal(m.host.tile_rot[eng._slots[loc][0]], ref.host.tile_rot[i], err_msg=str(loc))


# ---- (a) geometry ------------------------------------------------------------


def test_streaming_canvas_dim_equals_jax():
    for n in (3, 7, 8, 9, 31, 100, 1200, 1201, 2401, 6001, 12001):
        assert pmu.streaming_canvas_dim(n) == jmu.streaming_canvas_dim(n)
        for mult in (1, 2, 24, 64, 96, 256):
            assert pmu.streaming_canvas_dim(n, mult) == jmu.streaming_canvas_dim(n, mult)
    assert pmu.streaming_canvas_dim(6001) == 6144
    for n, mult in ((1281, 8 * 9 * 4), (100, 11)):
        with pytest.raises(ValueError):
            jmu.streaming_canvas_dim(n, mult)
        with pytest.raises(ValueError, match="odd factor"):
            pmu.streaming_canvas_dim(n, mult)


@pytest.mark.parametrize("canvas", [(112, 160), (6144, 6144), (40, 24)])
def test_slice_geometry_equals_jax(canvas):
    from topo_renderer_tpu_torch.models.scene import _mip_shapes

    mips = _mip_shapes(*canvas)
    for th, tw in ((33, 33), (1201, 1201), (9, 17)):
        if th > canvas[0] or tw > canvas[1]:
            continue
        assert pmu.region_sizes(th, tw, canvas, mips) == jmu.region_sizes(th, tw, canvas, mips)
        for oy, ox in ((0, 0), (32, 64), (canvas[0] - th, canvas[1] - tw), (5, canvas[1] - tw - 3)):
            got = pmu.attr_slice_geometry(oy, ox, th, tw, canvas, mips)
            assert got == jmu.attr_slice_geometry(oy, ox, th, tw, canvas, mips)
    pmu.check_halvable(canvas, mips)
    with pytest.raises(ValueError, match="halves"):
        pmu.check_halvable((113, 160), _mip_shapes(113, 160))


# ---- (b), (c) against the JAX package ------------------------------------------


@pytest.fixture(scope="module")
def jax_updates():
    """JAX's streaming engine through two slot updates (add a tile, then
    unload one), each call recorded: (pre-update tables carried to the port,
    the arguments, JAX's result carried to the port)."""
    calls = []
    orig = jmu.apply_slot_update

    def recording(mosaic, *args, **kw):
        pre = jax_mosaic_to_port(mosaic)  # copies, before JAX donates them
        out = orig(mosaic, *args, **kw)
        calls.append((pre, args, kw, jax_mosaic_to_port(out)))
        return out

    eng = jtests._streaming_engine()
    a, b, c = jtests.tile_at(0, 0), jtests.tile_at(0, 1), jtests.tile_at(1, 1)
    for t in (a, b):
        eng.add_terrain(t.location, t.heights, t.transform)
    eng.mosaic
    jmu.apply_slot_update = recording
    try:
        eng.add_terrain(c.location, c.heights, c.transform)
        eng.mosaic
        eng.unload_terrain(b.location)
        eng.mosaic
    finally:
        jmu.apply_slot_update = orig
    assert len(calls) == 2
    return eng, calls


def test_canvas_build_matches_jax(jax_updates):
    jeng, _ = jax_updates
    lon_nw, lat_nw, h_m, w_m, _, _ = jeng._canvas
    canvas = (lon_nw, lat_nw, h_m, w_m)
    tiles = [(0, 0), (0, 1), (1, 1)]
    jm = jax_build_mosaic([jtests.tile_at(*rc) for rc in tiles], on_device=True, canvas=canvas, keep_hmax_raw=True,
                          window_table_min=WIN_MIN)
    pm = build_mosaic([port_tile(*rc) for rc in tiles], canvas=canvas, keep_hmax_raw=True,
                      window_table_min=WIN_MIN, device="cpu")
    assert pm.shape == (h_m, w_m) != (2 * 33 - 1, 2 * 33 - 1)
    assert_matches_jax(pm, jm)
    for name in ("model_point", "pixel_scale", "bound_center", "bound_radius"):
        np.testing.assert_array_equal(_np(getattr(pm, name)), np.asarray(getattr(jm, name)), err_msg=name)
    np.testing.assert_array_equal(pm.host.valid, jm.host.valid)
    np.testing.assert_array_equal(pm.host.cell_tile, jm.host.cell_tile)
    with pytest.raises(ValueError, match="outside the pinned canvas"):
        build_mosaic([port_tile(0, 7)], canvas=canvas, device="cpu")


@pytest.mark.parametrize("op", [0, 1], ids=["add", "unload"])
def test_slot_update_matches_jax(jax_updates, op):
    _, calls = jax_updates
    pre, (blk, oy, ox, slices, rot_flat, geo), kw, want = calls[op]

    def t(a):
        return torch.from_numpy(np.array(a))

    before = {k: v.copy() for k, v in _tables(pre).items()}
    got = pmu.apply_slot_update(pre, t(blk), int(oy), int(ox), tuple(t(s).long() for s in slices), t(rot_flat),
                                t(geo), **kw)
    assert got.host is pre.host and got.heights_flat is pre.heights_flat  # written in place
    assert_matches_jax(got, want)
    assert any(not np.array_equal(_bits(before[k]), _bits(v)) for k, v in _tables(got).items())


# ---- (d) the streaming engine against its own fresh builds ---------------------


def test_incremental_add_matches_fresh_build():
    eng = streaming_engine()
    a, b, c = port_tile(0, 0), port_tile(0, 1), port_tile(1, 1)
    add(eng, a, b)
    m0 = eng.mosaic
    assert eng._canvas is not None and not eng._pending and m0.mip_hmax_raw_flat
    add(eng, c)
    assert eng._pending, "an add inside the canvas queues a slot update"
    assert_bitwise(eng, eng.mosaic, fresh_build(eng, [a, b, c]))


def test_incremental_unload_matches_fresh_build():
    eng = streaming_engine()
    a, b, c = port_tile(0, 0), port_tile(0, 1), port_tile(1, 0)
    add(eng, a, b, c)
    eng.mosaic
    eng.unload_terrain(b.location)
    assert eng._pending and eng.loaded_locations == {a.location, c.location}
    assert_bitwise(eng, eng.mosaic, fresh_build(eng, [a, c]))


def test_incremental_add_then_unload_round_trip():
    eng = streaming_engine()
    a, b, c = port_tile(0, 0), port_tile(0, 1), port_tile(1, 0)
    add(eng, a, b)
    eng.mosaic
    add(eng, c)
    eng.mosaic
    eng.unload_terrain(c.location)
    assert_bitwise(eng, eng.mosaic, fresh_build(eng, [a, b]))


def test_out_of_canvas_tile_rebuilds():
    eng = streaming_engine()
    a, far = port_tile(0, 0), port_tile(0, 7)  # beyond the one-tile margin
    add(eng, a)
    eng.mosaic
    canvas = eng._canvas
    add(eng, far)
    assert eng._dirty and not eng._pending
    m = eng.mosaic
    assert eng._canvas != canvas and m.shape == eng._canvas[2:4]
    assert_bitwise(eng, m, fresh_build(eng, [a, far]))


def test_add_then_unload_before_render():
    eng = streaming_engine()
    a, b, c = port_tile(0, 0), port_tile(0, 1), port_tile(1, 0)
    add(eng, a, b)
    eng.mosaic
    add(eng, c)
    eng.unload_terrain(c.location)  # before any render
    assert [op for op, *_ in eng._pending] == ["add", "remove"]
    assert_bitwise(eng, eng.mosaic, fresh_build(eng, [a, b]))


def test_two_engines_do_not_share_host_state():
    eng1, eng2 = streaming_engine(), streaming_engine()
    a, b = port_tile(0, 0), port_tile(0, 1)
    for eng, c in ((eng1, port_tile(1, 1)), (eng2, port_tile(1, 0))):
        add(eng, a, b)
        eng.mosaic
        add(eng, c)
        eng.mosaic
    eng1.unload_terrain(b.location)
    eng2.unload_terrain(port_tile(1, 0).location)
    m1, m2 = eng1.mosaic, eng2.mosaic
    assert m1.host is not m2.host and m1.host.valid is not m2.host.valid
    assert_bitwise(eng1, m1, fresh_build(eng1, [a, port_tile(1, 1)]))
    assert_bitwise(eng2, m2, fresh_build(eng2, [a, b]))


# ---- (e), (f) frames and capacity --------------------------------------------


def test_exact_frame_after_update_matches_jax():
    from topo_renderer_tpu.models.camera import Camera as JaxCamera
    from topo_renderer_tpu.ops.geometry import R0

    jeng, peng = jtests._streaming_engine(), streaming_engine()
    a, b, c = (0, 0), (0, 1), (1, 0)
    for eng, tile in ((jeng, jtests.tile_at), (peng, port_tile)):
        for rc in (a, b):
            t = tile(*rc)
            eng.add_terrain(t.location, t.heights, t.transform)
        eng.mosaic
        t = tile(*c)
        eng.add_terrain(t.location, t.heights, t.transform)
    assert jeng._pending and peng._pending

    lat, lon = 48.985, 20.03
    lam, phi = np.radians(lon), np.radians(lat)
    r = R0 + 2400.0
    eye = jnp.asarray([r * np.cos(phi) * np.cos(lam), r * np.cos(phi) * np.sin(lam), r * np.sin(phi)], jnp.float32)
    jcam = JaxCamera(eye=eye, pitch=0.6, yaw=0.6)  # a downward view onto the new tile
    kw = dict(n_steps=256, n_refine=8, with_labels=False)
    jeng.mosaic  # the update itself runs jitted
    with jax.disable_jit():
        want = jeng.render(jcam, 96, 64, **kw)
    got = peng.render(port_camera(jcam), 96, 64, **kw)
    assert not peng._pending
    hit, jhit = got.hit, np.asarray(want.hit)
    assert (hit == jhit).mean() >= 0.999 and hit.mean() > 0.1
    both = hit & jhit
    rel = np.abs(got.distance - np.asarray(want.distance))[both] / np.asarray(want.distance)[both]
    assert np.median(rel) < 1e-6 and rel.max() < 5e-2 and (rel > 1e-3).mean() < 0.02
    assert np.quantile(rel, 0.99) < 1e-4
    rel_depth = np.abs(got.depth - np.asarray(want.depth))[both] / np.asarray(want.depth)[both]
    assert rel_depth.max() <= 5e-3
    assert np.isfinite(got.color_linear).all()


def test_more_tiles_than_slots_raises():
    """65 tiles: JAX's streaming rebuild fails on its 64-slot rotation table
    (an IndexError); the port refuses before building, naming the limit."""
    n, ps = 5, 0.001

    def tiles(loc_cls, transform_cls):
        for k in range(65):
            yield (loc_cls.from_coord(0, k), np.full((n, n), 100.0 + k, np.float32),
                   transform_cls((0.0, 0.0), (10.0 + k * (n - 1) * ps, 45.0), (ps, ps)))

    from topo_renderer_tpu.data.coordinate_transform import CoordinateTransform as JaxTransform
    from topo_renderer_tpu.geo import GeoLocation as JaxLocation

    jeng, peng = JaxEngine(streaming=True), RenderEngine(device="cpu", streaming=True)
    for eng, args in ((jeng, tiles(JaxLocation, JaxTransform)), (peng, tiles(GeoLocation, CoordinateTransform))):
        for tile in args:
            eng.add_terrain(*tile)
    with pytest.raises(IndexError):
        jeng.mosaic
    with pytest.raises(ValueError, match="at most 64 tile slots"):
        peng.mosaic
    peng.unload_terrain(GeoLocation.from_coord(0, 64))
    assert peng.mosaic.shape[1] == pmu.streaming_canvas_dim(64 * (n - 1) + 1 + 2 * (n - 1))


def test_geo_mesh_still_raises():
    """A geo mesh that is not a ("geo",) `parallel.mesh.Mesh` is refused
    (a real one streams: `tests/test_torch_parallel.py`)."""
    with pytest.raises(TypeError, match="'geo' axis"):
        RenderEngine(device="cpu", streaming=True, geo_mesh=object())
    eng = streaming_engine()
    assert eng.loaded_locations == set()
    with pytest.raises(RuntimeError, match="no terrain"):
        eng.mosaic
    t = port_tile(0, 0)
    add(eng, t)
    eng.unload_terrain(t.location)
    eng.unload_terrain(t.location)  # unknown location: nothing to do
    assert eng.loaded_locations == set() and eng._dirty
