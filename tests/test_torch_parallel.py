"""The port's multi-device slice on the CPU: meshes and collectives, the
(dp, az) batch (`parallel/sharded.py`), and the geo-sharded engine and
application.

Port meshes name the CPU n times (``["cpu"] * n``), the counterpart of the
eight virtual XLA devices the JAX tests run on (`tests/conftest.py`). The
engine scene is `tests/test_engine.py::build_engine(n=33, span=0.03)`, its
JAX mosaic carried across with `mosaic_from_arrays`.

Tolerances:
- `render_batch_sharded` against the JAX package's, over dp x az = 4 x 2,
  2 x 4 and 8 x 1: the golden tolerance on the u8 frames (at most 1% of
  pixels beyond 2/255; the jitted JAX frame contracts multiply-adds, see
  `test_torch_panorama.py`), depth within 5e-3 relative (the exact
  frame's limit, `test_torch_streaming.py`; here the non-LOD profile's
  `atan2` differs from XLA's, by up to 1.3e-3 relative on 3% of pixels),
  hit masks equal on >= 99% of pixels, ``visible`` equal.
- Against the port's single-device panorama with the contour taken over the
  ring-wrapped depth, `tests/test_parallel.py`'s colour tolerance 1e-4 and
  depth tolerance 1e-6, each on >= 99.9% of pixels: a shard's azimuths
  (offset + span/az * (k + 0.5)/(W/az)) round differently from the full
  panorama's, as in the JAX design, so a ray may move by a last bit and
  pick another nearest texel (measured: up to 2 pixels of 4096 per eye on
  a 601^2 scene, none here).
- The geo-sharded engine and application against the port's replicated
  engine: bit for bit (frames, labels, tables).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_engine import build_engine
from tests.test_torch_app import _wait_loaded, backend  # noqa: F401 (the fixture)
from tests.test_torch_exact_frame import port_camera
from tests.test_torch_panorama import frac_bad
from tests.test_torch_streaming import port_tile
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.ops.panorama import PanoramaSpec as JaxSpec
from topo_renderer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from topo_renderer_tpu.parallel.sharded import render_batch_sharded as jax_render_batch_sharded
from topo_renderer_tpu_torch.app.application import Application
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.geo import GeoCoord
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.scene import build_mosaic
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.ops import crossing, window_slice
from topo_renderer_tpu_torch.ops import window_slice as ws_module
from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, render_panorama
from topo_renderer_tpu_torch.ops.postprocess import _contour_mix
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    make_mesh,
    pmax,
    psum_int,
    ring_halos,
    select,
)
from topo_renderer_tpu_torch.parallel.sharded import jit_sharded_step, render_batch_sharded
from topo_renderer_tpu_torch.parallel.sharded_mosaic import shard_mosaic
from topo_renderer_tpu_torch.render.engine import RenderEngine

COUNTERS = (crossing.crossing_search, window_slice.window_slice_multi,
            window_slice.window_slice_multi_batched, window_slice.window_slice)


@pytest.fixture(scope="module")
def scene():
    """JAX's n=33 engine scene: (JAX engine, JAX camera, port mosaic, port
    camera, padded peak positions and validity as numpy)."""
    engine, cam, _ = build_engine(n=33, span=0.03)
    _, pos, valid = engine._padded_peaks()
    return engine, cam, jax_mosaic_to_port(engine.mosaic), port_camera(cam), np.asarray(pos), np.asarray(valid)


# ---- meshes -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"dp": 4}, {"az": 4}, {"dp": 2, "az": 4}, {"dp": 8, "az": 1}])
def test_make_mesh_shapes_match_jax(kw):
    """JAX's defaults: all of ``dp`` unless ``dp`` or ``az`` is given."""
    want = jax_make_mesh(8, **kw)
    got = make_mesh(8, devices=["cpu"] * 8, **kw)
    assert got.shape == dict(want.shape) and got.axis_names == ("dp", "az")
    assert got.devices.shape == want.devices.shape and got.lead == torch.device("cpu")
    assert set(got.devices.flat) == {torch.device("cpu")}


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match=r"dp\(3\) \* az\(2\) != devices\(8\)"):
        make_mesh(8, dp=3, az=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="devices asked for"):
        make_mesh(4, devices=["cpu"] * 2)
    # No device list: the first n CUDA devices, never a silent CPU or repeat.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices and 0"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices and 1"):
        make_mesh(4, dp=2)
    assert make_mesh().shape == {"dp": 1, "az": 1}
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("dp", "az"))


# ---- collectives ---------------------------------------------------------------


def test_ring_psum_pmax():
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.normal(size=(2, 3, 5)).astype(np.float32)) for _ in range(4)]
    for i, (left, right) in enumerate(ring_halos(parts)):
        assert torch.equal(left, parts[(i - 1) % 4][..., -1:]) and torch.equal(right, parts[(i + 1) % 4][..., :1])
    ints = [torch.from_numpy(rng.integers(0, 2, 7).astype(np.int32)) for _ in range(3)]
    assert torch.equal(psum_int(ints, "cpu"), ints[0] + ints[1] + ints[2])
    assert torch.equal(pmax(parts, "cpu"), torch.stack(parts).amax(0))


def test_select_and_gather_rows_move_words():
    """Selection keeps every bit pattern a float sum would change: -0.0,
    NaN payloads and denormal words (packed normals)."""
    words = torch.from_numpy(np.array([0x80000000, 0x7FC00123, 0x00000007, 0x3F800000], np.uint32).view(np.int32))
    vals = words.view(torch.float32)
    owner = torch.tensor([0, 1, 0, 1])
    got = select([vals, vals.flip(0)], [owner == 0, owner == 1], "cpu")
    want = torch.where(owner == 0, words, words.flip(0))
    assert torch.equal(got.view(torch.int32), want)

    rng = np.random.default_rng(5)
    for cols in ((), (2,), (8,)):
        table = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (64, *cols), dtype=np.int64).astype(np.int32))
        table = table.view(torch.float32)
        bands = tuple(table[b * 16 : (b + 1) * 16].clone() for b in range(4))
        idx = torch.from_numpy(rng.integers(0, 64, (9, 11)))
        assert torch.equal(gather_rows(bands, idx).view(torch.int32), table.view(torch.int32)[idx])
        assert torch.equal(gather_rows(table, idx).view(torch.int32), table.view(torch.int32)[idx])


def test_launch_args_cache_keeps_recent_sets():
    """K2/K3's launch arguments are evicted least recently used first: a
    row-sharded mosaic's band sets do not push out a set in use."""
    rng = np.random.default_rng(2)
    origins = torch.zeros((1, 2), dtype=torch.int32)
    ws_module._args_cache.clear()
    keep = [torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(np.float32))]
    args = ws_module._launch_args(keep, origins, 8, 16, False)
    for _ in range(3 * ws_module._ARGS_CACHE_MAX):
        band = [torch.zeros((2, 16, 64))]
        ws_module._launch_args(band, origins, 8, 16, False)
        assert ws_module._launch_args(keep, origins, 8, 16, False) is args
    assert len(ws_module._args_cache) <= ws_module._ARGS_CACHE_MAX


# ---- the (dp, az) batch ------------------------------------------------------------


def _ring_reference(mosaic, eye, spec, sun):
    """The single-device panorama without its postprocess, and its colour
    times (1 - the contour of the ring-wrapped depth)."""
    raw = render_panorama(mosaic, eye, spec, sun, apply_postprocess=False)
    d = raw["depth"]
    mix = _contour_mix(torch.cat([d[:, -1:], d, d[:, :1]], dim=1))[:, 1:-1]
    return raw["color"] * (1.0 - mix[..., None]), d


def _check_against_ring_reference(color, depth, want_c, want_d):
    assert float(((depth - want_d).abs() <= 1e-6).float().mean()) >= 0.999
    assert float(((color - want_c).abs().amax(-1) <= 1e-4).float().mean()) >= 0.999


@pytest.mark.parametrize("dp, az", [(4, 2), (2, 4), (8, 1)])
def test_render_batch_sharded_matches_jax(scene, dp, az):
    jengine, jcam, pm, pcam, pos, valid = scene
    spec_kw = dict(width=128, height=32, n_steps=128, n_refine=2)
    eye, sun = pcam.eye, pcam.sun_angle.to_vec3()
    b = max(dp, 4)
    eyes = torch.stack([eye] * b)
    suns = torch.stack([sun] * b)
    for f in COUNTERS:
        f.launches = 0
    color, depth, visible = render_batch_sharded(
        pm, eyes, suns, PanoramaSpec(**spec_kw), make_mesh(8, dp=dp, az=az, devices=["cpu"] * 8),
        peak_positions=torch.tensor(pos), peak_valid=torch.tensor(valid),
    )
    assert color.shape == (b, 32, 128, 3) and depth.shape == (b, 32, 128) and visible.shape == (b, len(pos))
    assert [f.launches for f in COUNTERS] == [0, 0, 0, 0]
    jc, jd, jv = jax_render_batch_sharded(
        jengine.mosaic, eyes.numpy(), suns.numpy(), JaxSpec(**spec_kw), jax_make_mesh(8, dp=dp, az=az),
        peak_positions=jnp.asarray(pos), peak_valid=jnp.asarray(valid),
    )
    jc, jd, jv = np.asarray(jc), np.asarray(jd), np.asarray(jv)
    for i in range(b):
        assert frac_bad(to_srgb8_image(color[i]).numpy(), to_srgb8_image(torch.tensor(jc[i])).numpy()) <= 0.01
        assert ((depth[i].numpy() < 1.0) == (jd[i] < 1.0)).mean() >= 0.99
    np.testing.assert_allclose(depth.numpy(), jd, rtol=5e-3)
    np.testing.assert_array_equal(visible.numpy(), jv)
    assert visible[:, : int(valid.sum())].any()  # the summit peak is seen

    want_c, want_d = _ring_reference(pm, eye, PanoramaSpec(**spec_kw), sun)
    for i in range(b):
        _check_against_ring_reference(color[i], depth[i], want_c, want_d)
    # Identical viewpoints give identical outputs across the dp axis.
    assert torch.equal(color[0], color[-1]) and torch.equal(visible[0], visible[-1])


def test_render_batch_sharded_fast_spec_and_step(scene):
    """Azimuth sharding composes with the clipmap preset (test_parallel's
    hit-structure check), no peaks give ``visible[:, :0]``, and the step
    closure renders what the function does."""
    _, _, pm, pcam, _, _ = scene
    spec = PanoramaSpec.fast(width=128, height=32, n_steps=128)
    mesh = make_mesh(8, dp=2, az=4, devices=["cpu"] * 8)
    eyes = torch.stack([pcam.eye] * 2)
    suns = torch.stack([pcam.sun_angle.to_vec3()] * 2)
    color, depth, visible = render_batch_sharded(pm, eyes, suns, spec, mesh)
    assert color.shape == (2, 32, 128, 3) and bool(torch.isfinite(color).all()) and visible.shape == (2, 0)
    ref = render_panorama(pm, pcam.eye, spec, suns[0], apply_postprocess=False, quantize_rt=False)
    assert float(((depth[0] < 0.9999) == ref["hit"]).float().mean()) > 0.95
    want_c, want_d = _ring_reference(pm, pcam.eye, spec, suns[0])
    _check_against_ring_reference(color[0], depth[0], want_c, want_d)

    step = jit_sharded_step(pm, spec, mesh, fog="atmosphere")
    ppos, pvalid = torch.zeros((8, 3)), torch.zeros(8, dtype=torch.bool)
    got = step(eyes, suns, ppos, pvalid)
    want = render_batch_sharded(pm, eyes, suns, spec, mesh, fog="atmosphere", peak_positions=ppos, peak_valid=pvalid)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and got[2].shape == (2, 8)


# ---- the geo-sharded engine and application ---------------------------------------


def _geo_engine(geo_mesh):
    """`tests/test_sharded_mosaic.py::test_engine_geo_mesh_end_to_end`'s
    engines: two 33^2 tiles on one streaming canvas whose rows suit a
    2-band mesh, 2-D window tables and sharded levels at test scale."""
    eng = RenderEngine(device="cpu", streaming=True, geo_mesh=geo_mesh)
    eng._window_table_min = 500
    eng._shard_threshold = 10_000
    eng._canvas_multiple_override = 8 * 2 * 4  # the replicated reference on the same canvas
    a, b = port_tile(0, 0), port_tile(0, 1)
    for t in (a, b):
        eng.add_terrain(t.location, t.heights, t.transform)
    eng.add_peaks(a.location, [PeakInstance(position=ecef_from_geo(1860.0, 20.012, 48.988).numpy(), name="P0")])
    return eng


def test_engine_geo_mesh_end_to_end():
    """Every path of `RenderEngine(geo_mesh=...)` equals a replicated
    engine's on the same canvas bit for bit: exact, fast and wire frames,
    labels, a panorama, a batch, `height_at`, a streaming add applied to
    the bands, and the frames after it; no kernel launches on the CPU."""
    mesh = Mesh(["cpu"] * 2, ("geo",))
    ref, got = _geo_engine(None), _geo_engine(mesh)
    ref.mosaic  # settle both builds
    for f in COUNTERS:
        f.launches = 0
    assert got.mosaic.sharded_rows == (0,) and got.mosaic.cell_sharded and ref._canvas == got._canvas
    assert isinstance(got.mosaic.heights_flat, tuple) and len(got.mosaic.heights_flat) == 2
    cam = Camera().reset(GeoCoord(48.988, 20.006), 1700.0)

    def same(a, b):
        np.testing.assert_array_equal(a.color, b.color)
        np.testing.assert_array_equal(a.depth, b.depth)
        assert a.visible_labels == b.visible_labels and len(a.layouts) == len(b.layouts)

    for kw in (dict(fast=False, n_steps=192, n_refine=8), dict(fast=True, n_steps=128)):
        same(got.render(cam, 96, 64, **kw), ref.render(cam, 96, 64, **kw))
    w_ref = ref.render(cam, 96, 64, fast=True, n_steps=128, wire="rgb888")
    w_got = got.render(cam, 96, 64, fast=True, n_steps=128, wire="rgb888")
    f_ref, f_got = w_ref.finish(w_ref.color.numpy()), w_got.finish(w_got.color.numpy())
    np.testing.assert_array_equal(f_got[0], f_ref[0])
    assert f_got[1] == f_ref[1]

    spec = PanoramaSpec.fast(width=256, height=64, n_steps=128, clipmap_threshold=10_000)
    p_ref, p_got = ref.render_panorama(cam, spec), got.render_panorama(cam, spec)
    same(p_got, p_ref)
    assert p_ref.hit.mean() > 0.1 and sum(len(v) for v in p_ref.visible_labels.values()) == 1
    eyes = torch.stack([cam.eye, cam.eye * (1.0 + 1e-6)])
    suns = torch.stack([cam.sun_angle.to_vec3()] * 2)
    assert torch.equal(got.render_batch(eyes, spec, suns), ref.render_batch(eyes, spec, suns))
    assert got.height_at(GeoCoord(48.99, 20.01)) == ref.height_at(GeoCoord(48.99, 20.01))

    c = port_tile(1, 1)
    for eng in (ref, got):
        eng.add_terrain(c.location, c.heights, c.transform)
    assert got._pending and not got._dirty, "the sharded engine should queue a slot update"
    same(got.render(cam, 96, 64, fast=False, n_steps=192, n_refine=8),
         ref.render(cam, 96, 64, fast=False, n_steps=192, n_refine=8))
    want = _sharded_tables(shard_mosaic(ref.mosaic, mesh, size_threshold=10_000, keep_cell_table=True))
    assert _sharded_tables(got.mosaic).keys() == want.keys()
    assert [k for k, v in _sharded_tables(got.mosaic).items() if not torch.equal(v, want[k])] == []
    assert [f.launches for f in COUNTERS] == [0, 0, 0, 0]


def _sharded_tables(m):
    """`tests/test_torch_app.py::_tables` of a sharded mosaic: each band of
    a sharded table under its own name."""
    out = {}
    for name in ("heights_flat", "attr_packed_flat", "cell_heights_flat", "hmax", "bound_center", "bound_radius",
                 "mip_heights_flat", "mip_attr_flat", "mip_hmax_flat", "mip_hmax_raw_flat", "win_attr_2d"):
        leaf = getattr(m, name)
        levels = enumerate(leaf) if name.startswith(("mip", "win")) else [(None, leaf)]
        for lv, t in levels:
            key = name if lv is None else f"{name}[{lv}]"
            if isinstance(t, tuple):
                out.update({f"{key}/{b}": band.contiguous().view(torch.int32) for b, band in enumerate(t)})
            elif t is not None:
                out[key] = t.contiguous().view(torch.int32)
    return out


def test_engine_geo_mesh_refuses_bad_meshes():
    with pytest.raises(TypeError, match="'geo' axis"):
        RenderEngine(device="cpu", geo_mesh=make_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="lead device"):
        RenderEngine(device="cpu", geo_mesh=Mesh(["meta"] * 2, ("geo",)))
    eng = RenderEngine(geo_mesh=Mesh(["cpu"] * 2, ("geo",)))  # the device defaults to the mesh's lead
    assert eng.device == torch.device("cpu")


def test_application_geo_shard_steps(backend):  # noqa: F811
    """`Application` with ``geo_shard=2`` on the CPU: a ("geo",) mesh of the
    CPU named twice, fast and exact steps while tiles stream in, and the
    bands equal `shard_mosaic` of a fresh build in slot order."""
    srv, _ = backend
    app = Application(Settings(backend_url=srv.url, geo_shard=2), camera_speed=0.001, device="cpu")
    try:
        mesh = app.engine._geo_mesh
        assert mesh.shape == {"geo": 2} and set(mesh.devices.flat) == {torch.device("cpu")}
        app.viewport = (96, 64)
        app.start(GeoCoord(49.35135, 20.21139))
        app.wait_for_terrain(timeout=60)
        assert app.step(n_steps=64, fast=True, with_labels=True).color.shape == (64, 96, 3)
        _wait_loaded(app, 4)
        assert len(app.engine.loaded_locations) == 4 and app.engine.mosaic.sharded_rows
        view = GeoCoord(49.35135, 20.21139)
        app.data.camera = app.data.camera.reset(view, app.engine.height_at(view) + 300.0)
        assert app.step(n_steps=96, n_refine=4, with_labels=True).hit.any()
        eng = app.engine
        order = sorted(eng._slots, key=lambda loc: eng._slots[loc][0])
        fresh = build_mosaic([eng._tiles[loc] for loc in order], canvas=eng._canvas[:4], keep_hmax_raw=True,
                             window_table_min=eng._window_table_min, device="cpu")
        want = _sharded_tables(shard_mosaic(fresh, mesh, size_threshold=eng._shard_threshold, keep_cell_table=True))
        got = _sharded_tables(eng.mosaic)
        assert got.keys() == want.keys() and [k for k in want if not torch.equal(got[k], want[k])] == []
    finally:
        app.shutdown()
