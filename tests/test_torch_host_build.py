"""The port's host mosaic build (`build_mosaic(on_device=False)`,
`build_height_mips`, `build_max_mips`, `compute_normals`) and the engine's
``device_mosaic_build`` switch, against the JAX package's host build and
against the port's own device build, on the CPU.

Tolerances:
- `build_height_mips` and `build_max_mips` are numpy copies: bit for bit
  with JAX's, poisoned texels and odd shapes included.
- The host build against JAX's host build: heights, height mips, the
  dilated and raw max pyramids, the cell table, the host arrays and the
  scalars bit for bit; packed normals within one 10-bit code on under 2%
  of texels (the contract `tests/test_mixed_bands.py` holds JAX's device
  build to against its host build).
- The host build against the port's device build: every table but the
  packed normals bit for bit, the normals to the same contract.
- The goldens' scene from the port's own host build, rendered by the port,
  against JAX's frame evaluated primitive by primitive at the golden
  tolerance (<= 2/255 on >= 99% of pixels), and against the golden no
  worse than that evaluation + 1%.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import test_mosaic_update as jtests
from tests.helpers import east_at, small_scene, yaw_towards
from tests.test_mixed_bands import make_band_tiles
from tests.test_torch_exact_frame import port_camera
from tests.test_torch_panorama import frac_bad
from tests.test_torch_streaming import WIN_MIN, _bits, _codes, _np, _tables, port_tile
from topo_renderer_tpu.models import scene as jscene
from topo_renderer_tpu.ops.normals import compute_normals as jax_compute_normals
from topo_renderer_tpu.ops.raycast import render_perspective as jax_render_perspective
from topo_renderer_tpu.ops.shading import to_srgb8_image as jax_srgb8
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.models import scene
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.scene import TerrainTile, build_mosaic
from topo_renderer_tpu_torch.ops import crossing, window_slice
from topo_renderer_tpu_torch.ops.normals import compute_normals
from topo_renderer_tpu_torch.ops.raycast import render_perspective
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.render.engine import RenderEngine

COUNTERS = (crossing.crossing_search, window_slice.window_slice_multi,
            window_slice.window_slice_multi_batched, window_slice.window_slice)


def _port_tile(tile):
    t = tile.transform
    return TerrainTile(tile.location, tile.heights, CoordinateTransform(t.raster_point, t.model_point, t.pixel_scale))


def assert_tables(port, ref, normals_exact=False, host_arrays=("valid", "cell_tile", "tile_rot")):
    """Every table of ``port`` against ``ref``: bit for bit, but packed
    normals within one code per channel on under 2% of texels (or exact);
    then the scalars and the named host arrays."""
    assert port.shape == tuple(ref.shape) and port.mip_shapes == tuple(ref.mip_shapes)
    assert port.has_cell_table == ref.has_cell_table and port.texel_m == ref.texel_m
    pt, rt = _tables(port), _tables(ref)
    assert pt.keys() == rt.keys()
    assert len(port.mip_hmax_raw_flat) == len(ref.mip_hmax_raw_flat)
    for lv, (a, b) in enumerate(zip(port.mip_hmax_raw_flat, ref.mip_hmax_raw_flat)):
        np.testing.assert_array_equal(_bits(_np(a)), _bits(_np(b)), err_msg=f"hmax raw {lv}")
    for name in pt:
        if "normals" in name and not normals_exact:
            d = np.abs(_codes(pt[name]) - _codes(rt[name]))
            assert d.max() <= 1, (name, int(d.max()))
            assert (d != 0).any(axis=-1).mean() < 0.02, name
        else:
            np.testing.assert_array_equal(_bits(pt[name]), _bits(rt[name]), err_msg=name)
    for name in ("hmax", "bound_center", "bound_radius", "model_point", "pixel_scale"):
        np.testing.assert_array_equal(_np(getattr(port, name)), np.asarray(getattr(ref, name)), err_msg=name)
    for name in host_arrays:
        np.testing.assert_array_equal(getattr(port.host, name), getattr(ref.host, name), err_msg=name)


# ---- the pyramids and the normals ----------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (9, 17), (130, 8), (45, 12)])
def test_mips_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    h = rng.normal(1500.0, 300.0, shape).astype(np.float32)
    h[rng.random(shape) < 0.08] = scene.POISON_HEIGHT
    h[: shape[0] // 3, : shape[1] // 4] = scene.POISON_HEIGHT
    mips, shapes = scene.build_height_mips(h)
    jmips, jshapes = jscene.build_height_mips(h)
    assert shapes == jshapes and len(mips) == len(jmips)
    for a, b in zip(mips, jmips):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for n_levels in (0, 1):
        assert scene.build_height_mips(h, n_levels)[1] == jscene.build_height_mips(h, n_levels)[1]
    (dil, raw), (jdil, jraw) = scene.build_max_mips(h, shapes, return_raw=True), jscene.build_max_mips(
        h, jshapes, return_raw=True)
    for a, b in zip(dil + raw, jdil + jraw):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    odd = [(s[0] - 1, s[1] - 1) for s in shapes if min(s) > 1]  # remainder rows and columns fold in
    for a, b in zip(scene.build_max_mips(h, odd), jscene.build_max_mips(h, odd)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("quantize,correct_axes", [(True, False), (False, False), (True, True)])
def test_compute_normals_equals_jax(quantize, correct_axes):
    rng = np.random.default_rng(4)
    h = rng.normal(1200.0, 90.0, (40, 50)).astype(np.float32)
    valid = rng.random((40, 50)) > 0.05
    kw = dict(quantize=quantize, correct_axes=correct_axes)
    ps, mp = (0.0008333, 0.0008333), (20.0, 50.0)
    got = compute_normals(torch.from_numpy(h), ps, (0.0, 0.0), mp, valid=torch.from_numpy(valid), **kw)
    want = np.asarray(jax_compute_normals(h, ps, (0.0, 0.0), mp, valid=valid, **kw))
    assert tuple(got.shape) == (40, 50, 3)
    # Unquantized: a few float32 ulps (cos of each row's latitude, XLA's and
    # torch's); the u8 round trip absorbs them on this field.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0 if quantize else 1e-6)


# ---- build_mosaic(on_device=False) ------------------------------------------------

@pytest.fixture(scope="module")
def band_builds():
    south, north, _ = make_band_tiles()
    tiles = [south, north]
    jm = jscene.build_mosaic(tiles, window_table_min=0)  # JAX's host build
    ptiles = [_port_tile(t) for t in tiles]
    host = build_mosaic(ptiles, window_table_min=0, on_device=False, device="cpu")
    dev = build_mosaic(ptiles, window_table_min=0, device="cpu")
    return jm, host, dev


def test_host_build_equals_jax_host_build(band_builds):
    jm, host, _ = band_builds
    assert any(w is not None for w in host.win_attr_2d)
    assert_tables(host, jm)
    np.testing.assert_array_equal(_bits(_np(host.cell_heights_flat)), _bits(np.asarray(jm.cell_heights_flat)))


def test_host_build_against_device_build(band_builds):
    _, host, dev = band_builds
    assert_tables(host, dev)
    assert host.attr_packed_flat.dtype == torch.float32 and host.device.type == "cpu"


@pytest.fixture(scope="module")
def streaming_host_engine():
    """A streaming engine whose full builds are host builds, on three of
    `tests/test_mosaic_update.py`'s tiles."""
    eng = RenderEngine(device="cpu", streaming=True, device_mosaic_build=False)
    eng._window_table_min = WIN_MIN
    rcs = [(0, 0), (0, 1), (1, 1)]
    for rc in rcs:
        t = port_tile(*rc)
        eng.add_terrain(t.location, t.heights, t.transform)
    first = eng.mosaic
    return eng, first, rcs


def test_streaming_canvas_host_build_equals_jax(streaming_host_engine):
    """The engine's first build (a host build on its pinned canvas, with the
    raw max pyramid) against JAX's host build of the same tiles in the same
    order on the same canvas."""
    eng, first, rcs = streaming_host_engine
    order = sorted(rcs, key=lambda rc: port_tile(*rc).location)
    jm = jscene.build_mosaic([jtests.tile_at(*rc) for rc in order], canvas=eng._canvas[:4], keep_hmax_raw=True,
                             window_table_min=WIN_MIN)
    assert first.shape == tuple(jm.shape) != (65, 65) and len(first.mip_hmax_raw_flat) == len(first.mip_shapes) > 0
    assert_tables(first, jm)


def test_streaming_host_engine_slot_update_and_frames(streaming_host_engine):
    """A slot update on a host-built canvas runs on the engine's device
    and matches a fresh host build in slot order; the frames after it
    launch no kernel on the CPU."""
    eng, _, _ = streaming_host_engine
    t = port_tile(1, 0)
    eng.add_terrain(t.location, t.heights, t.transform)
    assert eng._pending and not eng._dirty
    m = eng.mosaic
    order = sorted(eng._slots, key=lambda loc: eng._slots[loc][0])
    fresh = build_mosaic([eng._tiles[loc] for loc in order], canvas=eng._canvas[:4], keep_hmax_raw=True,
                         window_table_min=WIN_MIN, device="cpu", on_device=False)
    # The engine's host arrays hold slot ids and all 64 slots' rotations
    # (`tests/test_torch_streaming.py::assert_bitwise` maps them).
    assert_tables(m, fresh, host_arrays=("valid",))
    for f in COUNTERS:
        f.launches = 0
    cam = Camera().reset(jtests_view(), 2300.0)
    for kw in (dict(fast=True, n_steps=128), dict(n_steps=256, n_refine=8)):
        res = eng.render(cam, 48, 32, host_copy=False, **kw)
        assert res.hit.any() and res.color.shape == (32, 48, 3)
    assert [f.launches for f in COUNTERS] == [0, 0, 0, 0]


def jtests_view():
    from topo_renderer_tpu_torch.geo import GeoCoord

    return GeoCoord(49.0 - jtests.SPAN * 0.8, 20.0 + jtests.SPAN * 0.3)


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("device_mosaic_build", [False, True])
def test_engine_switch_selects_the_build(monkeypatch, streaming, device_mosaic_build):
    """Full builds take the host tables exactly when ``device_mosaic_build``
    is False, in the plain and the streaming rebuild."""
    calls = []
    for name in ("_host_mosaic_tables", "_device_mosaic_tables"):
        fn = getattr(scene, name)
        monkeypatch.setattr(scene, name, lambda *a, _fn=fn, _name=name, **kw: (calls.append(_name), _fn(*a, **kw))[1])
    eng = RenderEngine(device="cpu", streaming=streaming, device_mosaic_build=device_mosaic_build)
    south, north, _ = make_band_tiles()
    tiles = [_port_tile(south)] if streaming else [_port_tile(south), _port_tile(north)]
    for t in tiles:
        eng.add_terrain(t.location, t.heights, t.transform)
    m = eng.mosaic
    assert calls == ["_device_mosaic_tables" if device_mosaic_build else "_host_mosaic_tables"]
    assert (eng._canvas is not None) == streaming and m.device.type == "cpu"
    ref = build_mosaic(tiles, device="cpu", on_device=device_mosaic_build,
                       **(dict(canvas=eng._canvas[:4], keep_hmax_raw=True) if streaming else {}))
    assert_tables(m, ref, normals_exact=True)


# ---- the goldens' scene -------------------------------------------------------------

def test_golden_scene_from_the_port_host_build():
    """`tests/helpers.py::small_scene` (the goldens' scene; its mosaic is
    JAX's host build) built by the port's own host build and rendered by
    the port: `perspective_96x64` against JAX's eager frame and the golden."""
    jm, cam, tile = small_scene(n=49, span_deg=0.04, height_above=500.0)
    pm = build_mosaic([_port_tile(tile)], on_device=False, device="cpu")
    assert_tables(pm, jm)
    cam = dataclasses.replace(cam, yaw=yaw_towards(cam, east_at(cam)), pitch=-0.06)
    kw = dict(width=96, height=64, n_steps=384, n_refine=16)
    out = render_perspective(pm, port_camera(cam), **kw)
    with jax.disable_jit():
        eager = jax_render_perspective(jm, cam, **kw)
    port, eager_u8 = to_srgb8_image(out["color"]).numpy(), np.asarray(jax_srgb8(eager["color"]))
    golden = np.load("tests/golden/perspective_96x64.npy")
    assert port.shape == golden.shape
    assert frac_bad(port, eager_u8) < 0.01, frac_bad(port, eager_u8)
    assert frac_bad(port, golden) <= frac_bad(eager_u8, golden) + 0.01
    assert (out["hit"].numpy() == np.asarray(eager["hit"])).mean() >= 0.999
