"""The port's application shell and CLI end to end on the CPU
(`tests/test_app.py`), against the port's own backend serving
`tests/test_backend_pipeline.py`'s tile and three seeded neighbours.

The frames are held to JAX by `tests/test_torch_{engine,fast_frame,
exact_engine}.py`; here the application and the CLI must drive the port's
engine to exactly what the engine renders when called directly, with the
streaming tables equal to a fresh build listed in the engine's slot order
(tiles arrive in any order).
"""

import dataclasses
import logging
import math
import re
import time

import numpy as np
import pytest
import torch

from tests.test_backend_pipeline import TILE_N, make_fixtures
from topo_renderer_tpu_torch.app import application
from topo_renderer_tpu_torch.app.application import Application
from topo_renderer_tpu_torch.backend.server import BackendServer, dem_file_name
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.control.events import ChangeLocation, Key, KeyInput
from topo_renderer_tpu_torch.data.tiff import write_geotiff
from topo_renderer_tpu_torch.frontends import cli
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.scene import build_mosaic
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec
from topo_renderer_tpu_torch.render.engine import RenderEngine

VIEW = GeoCoord(49.35135, 20.21139)
NEIGHBOURS = ((48, 20), (49, 21), (48, 19))


@pytest.fixture()
def backend(tmp_path):
    loc, _ = make_fixtures(tmp_path)
    ps = 1.0 / (TILE_N - 1)
    rng = np.random.default_rng(9)
    for lat, lon in NEIGHBOURS:
        heights = rng.normal(1200.0, 150.0, (TILE_N, TILE_N)).astype(np.float32)
        path = tmp_path / dem_file_name(GeoLocation.from_coord(lat, lon))
        path.write_bytes(write_geotiff(heights, (ps, ps, 0.0), (0.0, 0.0, 0.0, float(lon), float(lat + 1), 0.0)))
    srv = BackendServer(Settings(address="127.0.0.1", port=0, data_dir=str(tmp_path)))
    srv.start()
    yield srv, GeoLocation.from_coord(49, 20)
    srv.stop()


def _tables(m):
    out = {name: getattr(m, name) for name in ("heights_flat", "attr_packed_flat", "cell_heights_flat", "hmax",
                                               "bound_center", "bound_radius")}
    for name in ("mip_heights_flat", "mip_attr_flat", "mip_hmax_flat", "mip_hmax_raw_flat", "win_attr_2d"):
        out.update({f"{name}[{lv}]": t for lv, t in enumerate(getattr(m, name)) if t is not None})
    return {k: v.contiguous().view(torch.int32) for k, v in out.items()}


def _assert_slot_order_build(engine):
    """The streaming engine's tables equal a fresh build of its tiles on
    its canvas, listed in its slot order."""
    order = sorted(engine._slots, key=lambda loc: engine._slots[loc][0])
    fresh = build_mosaic([engine._tiles[loc] for loc in order], canvas=engine._canvas[:4], keep_hmax_raw=True,
                         window_table_min=engine._window_table_min, device=engine.device)
    got, want = _tables(engine.mosaic), _tables(fresh)
    assert got.keys() == want.keys()
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    np.testing.assert_array_equal(engine.mosaic.host.valid, fresh.host.valid)


def _wait_loaded(app, n, timeout=60.0):
    deadline = time.time() + timeout
    while len(app.engine.loaded_locations) < n and time.time() < deadline:
        app.pump_events()
        time.sleep(0.02)
    app.background.drain(timeout=timeout)
    app.pump_events()


def test_application_end_to_end(backend):
    srv, loc = backend
    # W moves speed * 0.1 m per microsecond of step time: a slow step at
    # the reference's speed 1.0 would fly off the tiles.
    app = Application(Settings(backend_url=srv.url), camera_speed=0.001, device="cpu")
    try:
        assert app.engine.device.type == "cpu" and app.engine._streaming
        app.viewport = (96, 64)
        app.start(VIEW)
        app.wait_for_terrain(timeout=60)
        # Frames from the first tile on: later tiles land as slot updates or
        # rebuilds, in whatever order the workers finish.
        app.process_input(KeyInput(Key.W, True))
        res = app.step(n_steps=64, fast=True, with_labels=True)
        assert res is not None and res.color.shape == (64, 96, 3) and app.data.camera_changed
        app.process_input(KeyInput(Key.W, False))
        _wait_loaded(app, 4)
        assert app.engine.loaded_locations == {loc} | {GeoLocation.from_coord(*t) for t in NEIGHBOURS}
        assert app.data.loaded_locations == app.engine.loaded_locations
        eye_r = float(np.linalg.norm(np.asarray(app.data.camera.eye)))
        assert 6_371_000.0 + 500.0 < eye_r < 6_371_000.0 + 3_000.0
        # The spawn height is the nearest texel's + 50 m; on this noisy
        # fixture the surface between texels can be higher than that.
        app.data.camera = app.data.camera.reset(VIEW, app.engine.height_at(VIEW) + 300.0)
        res = app.step(n_steps=96, n_refine=4, with_labels=True)
        assert res.color.shape == (64, 96, 3) and res.hit.any()
        _assert_slot_order_build(app.engine)

        # Event bus: ChangeLocation routes through the UI controller.
        app.post_event(ChangeLocation(GeoCoord(49.4, 20.3)))
        app.pump_events()
        assert app.data.current_location == GeoCoord(49.4, 20.3)
    finally:
        app.shutdown()


def test_application_run_loop(backend):
    srv, _ = backend
    app = Application(Settings(backend_url=srv.url), device="cpu")
    try:
        app.viewport = (48, 32)
        app.start(VIEW)
        app.wait_for_terrain(timeout=60)
        frames = []
        app.run(on_frame=lambda res: frames.append(res.color.shape), max_frames=3, target_fps=60.0,
                fast=True, n_steps=64)
        assert len(frames) >= 1 and frames[0] == (32, 48, 3)
    finally:
        app.shutdown()


def _cli_run(monkeypatch, caplog, argv):
    """Run the CLI, returning the application it made and its label count."""
    made = []
    init = Application.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(Application, "__init__", keep)
    with caplog.at_level(logging.INFO):
        assert cli.main(argv) == 0
    n_labels = int(re.search(r"\((\d+) peak labels\)", caplog.text).group(1))
    return made[0], n_labels


def _reference_engine(app):
    """A fresh streaming engine on the CPU with the app's decoded tiles and
    peaks: it builds its canvas from the sorted tiles, as the app's first
    build did when every tile had landed."""
    order = sorted(app.engine._slots, key=lambda loc: app.engine._slots[loc][0])
    assert order == sorted(app.engine._tiles), "the CLI's build took every tile"
    ref = RenderEngine(device="cpu", streaming=True)
    for loc, tile in app.engine._tiles.items():
        ref.add_terrain(loc, tile.heights, tile.transform)
    for loc, peaks in app.engine._peaks.items():
        ref.add_peaks(loc, peaks)
    return ref


@pytest.mark.parametrize("command", ["panorama", "render"])
def test_cli_equals_engine(backend, tmp_path, monkeypatch, caplog, command):
    from PIL import Image

    srv, _ = backend
    out = tmp_path / f"{command}.png"
    monkeypatch.setenv("TOPO_BACKEND_URL", srv.url)
    above = 3000.0 if command == "panorama" else 300.0  # the panorama sees its peaks from high up
    argv = [command, "--lat", str(VIEW.latitude), "--lon", str(VIEW.longitude), "--height-above", str(above),
            "--device", "cpu", "-o", str(out)]
    if command == "panorama":
        argv += ["--width", "128", "--height", "32", "--steps", "128", "--fast", "--fog", "atmosphere"]
    else:
        argv += ["--width", "48", "--height", "32", "--steps", "128"]
    app, n_labels = _cli_run(monkeypatch, caplog, argv)
    assert app.engine.device.type == "cpu" and not app.background._thread.is_alive()
    img = np.asarray(Image.open(out))

    ref = _reference_engine(app)
    _assert_slot_order_build(app.engine)
    cam = Camera().reset(VIEW, ref.height_at(VIEW) + above)
    if command == "panorama":
        res = ref.render_panorama(cam, PanoramaSpec.fast(width=128, height=32, n_steps=128), fog="atmosphere")
    else:  # the CLI's pose flags at their defaults, as it applies them
        cam = dataclasses.replace(cam, yaw=math.radians(0.0), pitch=math.radians(0.0)).with_fovy(math.radians(45.0))
        res = ref.render(cam, 48, 32, n_steps=128)
    assert img.shape == res.color.shape and res.hit.any()
    np.testing.assert_array_equal(img, res.color)
    assert n_labels == len(res.layouts) and (n_labels > 0 or command == "render")


def test_geo_shard_refused(backend, monkeypatch):
    """More geo shards than CUDA devices raise RuntimeError naming the
    count, before any worker exists (JAX: `app/application.py:54-67`); on
    the CPU the shards name the one device (`tests/test_torch_parallel.py`)."""
    srv, _ = backend
    made = []
    monkeypatch.setattr(application, "BackgroundRunner", lambda *a, **k: made.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="TOPO_GEO_SHARD=2 but only 1 devices"):
        Application(Settings(backend_url=srv.url, geo_shard=2))
    assert made == []


def test_cuda_default_raises_before_any_fetch(backend, monkeypatch):
    srv, _ = backend
    made = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(application, "BackgroundRunner", lambda *a, **k: made.append(a))
    monkeypatch.setenv("TOPO_BACKEND_URL", srv.url)
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(Settings(backend_url=srv.url))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["panorama", "--lat", "49.35", "--lon", "20.21", "--width", "64", "--height", "16", "--fast"])
    assert made == []
