"""The port's desktop frontend (`topo_renderer_tpu_torch/frontends/desktop.py`),
headless, on the CPU: `tests/test_desktop.py`'s two cases against the
port's `BackendServer`, the Tk keysym map against JAX's, and the frames'
u8 images against the engine's own render. The Tk shell itself (`run`)
needs a display and is not driven here.
"""

import numpy as np
import pytest
import torch

from tests.test_backend_pipeline import make_fixtures
from topo_renderer_tpu.frontends import desktop as jax_desktop
from topo_renderer_tpu_torch.backend.server import BackendServer
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.frontends import desktop
from topo_renderer_tpu_torch.frontends.desktop import DesktopFrontend
from topo_renderer_tpu_torch.geo import GeoCoord

VIEW = GeoCoord(49.35135, 20.21139)


@pytest.fixture()
def backend(tmp_path):
    make_fixtures(tmp_path)
    server = BackendServer(Settings(address="127.0.0.1", port=0, data_dir=str(tmp_path)))
    server.start()
    yield server
    server.stop()


def test_keysym_map_equals_jax():
    assert {k: v.value for k, v in desktop._KEYSYM_TO_KEY.items()} == {
        k: v.value for k, v in jax_desktop._KEYSYM_TO_KEY.items()
    }


def test_desktop_core_free_fly(backend):
    fe = DesktopFrontend(Settings(backend_url=backend.url), width=96, height=64, device="cpu")
    try:
        fe.app.start(VIEW)
        fe.app.wait_for_terrain(timeout=60)

        frame = fe.render_frame()
        assert frame is not None and frame.shape == (64, 96, 3)
        assert frame.dtype == np.uint8

        eye0 = np.asarray(fe.app.data.camera.eye, np.float64)
        fe.feed_key("w", True)
        fe.render_frame()
        fe.feed_key("w", False)
        eye1 = np.asarray(fe.app.data.camera.eye, np.float64)
        assert np.linalg.norm(eye1 - eye0) > 0.05

        yaw0 = float(fe.app.data.camera.yaw)
        pitch0 = float(fe.app.data.camera.pitch)
        fe.feed_mouse_button("right", True)
        fe.feed_mouse_position(40.0, 30.0)
        fe.feed_mouse_position(70.0, 18.0)
        fe.feed_mouse_button("right", False)
        fe.render_frame()
        assert (
            abs(float(fe.app.data.camera.yaw) - yaw0) > 1e-4
            or abs(float(fe.app.data.camera.pitch) - pitch0) > 1e-4
        )

        fe.feed_key("Caps_Lock", True)  # unknown keysyms are ignored
        assert isinstance(fe.drain_notifications(), str)
    finally:
        fe.app.shutdown()


def test_desktop_release_stops_drag(backend):
    fe = DesktopFrontend(Settings(backend_url=backend.url), width=48, height=32, device="cpu")
    try:
        fe.app.start(VIEW)
        fe.app.wait_for_terrain(timeout=60)
        fe.render_frame()
        fe.feed_mouse_button("right", True)
        fe.feed_mouse_position(10.0, 10.0)
        fe.feed_mouse_button("right", False)
        yaw0 = float(fe.app.data.camera.yaw)
        fe.feed_mouse_position(40.0, 40.0)  # motion after release must not look
        fe.render_frame()
        assert float(fe.app.data.camera.yaw) == pytest.approx(yaw0, abs=1e-6)
    finally:
        fe.app.shutdown()


def test_desktop_frame_equals_engine_render(backend):
    """`render_frame` is the fast frame of the app's camera at the viewport,
    labels composited, bit for bit."""
    fe = DesktopFrontend(Settings(backend_url=backend.url), width=80, height=60, device="cpu")
    try:
        fe.app.start(VIEW)
        fe.app.wait_for_terrain(timeout=60)
        fe.app.background.drain(timeout=60)
        fe.app.pump_events()
        frame = fe.render_frame()
        res = fe.app.engine.render(fe.app.data.camera, 80, 60, fast=True, host_copy=False)
        np.testing.assert_array_equal(frame, res.color)
        assert isinstance(res.color, np.ndarray) and res.depth.device.type == "cpu"
    finally:
        fe.app.shutdown()


def test_desktop_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DesktopFrontend(Settings(backend_url="http://127.0.0.1:9"))


def test_desktop_imports_no_tk_until_run():
    """Tk and PIL.ImageTk are imported inside `run` only, so the module loads
    on a machine without Tk."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(desktop))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name for n in top for a in n.names} | {n.module for n in top if isinstance(n, ast.ImportFrom)}
    assert not any(name and name.split(".")[0] in ("tkinter", "PIL") for name in names), names
