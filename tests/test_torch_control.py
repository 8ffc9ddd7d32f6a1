"""The port's controllers vs the JAX package (`tests/test_control.py`,
`tests/test_misc.py`).

Tile neighbourhoods and the tile diff of a location change must be equal.
The camera after the same key, mouse, touch and pinch sequences with a
fixed ``dt`` must match JAX's `update_camera` within rtol 1e-6, from the
same starting camera (the camera tests' tolerance: `direction()` may differ
in a last bit).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_renderer_tpu.control import camera_controller as jcc
from topo_renderer_tpu.control import events as jev
from topo_renderer_tpu.control.controllers import ApplicationControllers as JaxControllers
from topo_renderer_tpu.control.ui_controller import UiController as JaxUi, get_locations_range as jrange
from topo_renderer_tpu.geo import GeoCoord as JaxCoord, GeoLocation as JaxLocation
from topo_renderer_tpu.models.camera import Camera as JaxCamera, LightAngle as JaxLight
from topo_renderer_tpu_torch.control import camera_controller as cc
from topo_renderer_tpu_torch.control import events as ev
from topo_renderer_tpu_torch.control.controllers import ApplicationControllers
from topo_renderer_tpu_torch.control.ui_controller import TILE_RANGE_M, UiController, get_locations_range
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera, LightAngle, ViewMode

RTOL = 1e-6


def _locs(locs):
    return [(loc.latitude.to_float(), loc.longitude.to_float()) for loc in locs]


def _coords(seed=0, n=24):
    rng = np.random.default_rng(seed)
    pts = [(float(rng.uniform(-89.9, 89.9)), float(rng.uniform(-180, 180))) for _ in range(n)]
    return pts + [(49.35135, 20.21139), (89.5, 10.0), (89.999, 0.0), (10.5, 179.9), (-10.5, -179.9),
                  (-89.7, 33.0), (0.0, 0.0), (45.5, 12.5), (-0.5, -0.5)]


@pytest.mark.parametrize("where", _coords(), ids=lambda c: f"{c[0]:.3f},{c[1]:.3f}")
def test_locations_range_equal(where):
    for dist in (TILE_RANGE_M, 250_000.0):
        got = get_locations_range(GeoCoord(*where), dist)
        want = jrange(JaxCoord(*where), dist)
        assert _locs(got) == _locs(want) and got


class _Engine:
    def __init__(self):
        self.unloaded = []

    def unload_terrain(self, loc):
        self.unloaded.append((loc.latitude.to_float(), loc.longitude.to_float()))


class _Data:
    def __init__(self, loaded):
        self.loaded_locations = set(loaded)
        self.current_location = None


@pytest.mark.parametrize("move", [((49.35135, 20.21139), (49.4, 20.3)), ((45.5, 12.5), (45.5, 13.5)),
                                  ((10.5, 179.9), (10.5, -179.2)), ((89.5, 10.0), (88.0, 10.0))])
def test_change_location_diff_equal(move):
    """Two moves in turn: the second unloads the tiles that left the range
    and requests the new ones, nearest first."""
    start, end = move
    runs = {}
    for name, ui_cls, coord, loc in (("port", UiController, GeoCoord, GeoLocation),
                                     ("jax", JaxUi, JaxCoord, JaxLocation)):
        requests = []
        ui = ui_cls(lambda req, cur: requests.append((req.latitude.to_float(), req.longitude.to_float())))
        data, engine = _Data([loc.from_coord(10, 10)]), _Engine()
        ui.change_location(coord(*start), data, engine)
        first = list(requests)
        data.loaded_locations |= {loc.from_coord(int(a), int(b)) for a, b in first}
        requests.clear()
        ui.change_location(coord(*end), data, engine)
        runs[name] = (first, list(requests), engine.unloaded, sorted(_locs(data.loaded_locations)),
                      (data.current_location.latitude, data.current_location.longitude))
    assert runs["port"] == runs["jax"]


def _start(seed):
    """(port, JAX) cameras with the same float32 eye and pose."""
    rng = np.random.default_rng(seed)
    lat, lon = float(rng.uniform(-60, 60)), float(rng.uniform(-170, 170))
    eye = np.asarray(JaxCamera().reset(JaxCoord(lat, lon), float(rng.uniform(300, 4000))).eye, np.float32)
    pose = dict(pitch=np.float32(rng.uniform(-0.8, 0.8)), yaw=np.float32(rng.uniform(-3, 3)),
                fov_y=np.float32(rng.uniform(0.4, 1.6)))
    sun = (float(rng.uniform(-180, 180)), float(rng.uniform(-80, 80)))
    port = Camera(eye=torch.from_numpy(eye.copy()), pitch=torch.tensor(pose["pitch"]), yaw=torch.tensor(pose["yaw"]),
                  fov_y=torch.tensor(pose["fov_y"]), sun_angle=LightAngle(*sun))
    jax_cam = JaxCamera(eye=jnp.asarray(eye), pitch=jnp.float32(pose["pitch"]), yaw=jnp.float32(pose["yaw"]),
                        fov_y=jnp.float32(pose["fov_y"]), sun_angle=JaxLight(*sun))
    return port, jax_cam


def _key(k, pressed):
    return ev.KeyInput(ev.Key[k], pressed), jev.KeyInput(jev.Key[k], pressed)


def _touch(phase, i, x, y):
    return ev.TouchInput(ev.TouchPhase[phase], i, x, y), jev.TouchInput(jev.TouchPhase[phase], i, x, y)


# Each step: ("event", (port event, JAX event)), ("device", (...)) or
# ("update", dt); the cameras are compared after every update.
SEQUENCES = {
    "keys": [("event", _key("W", True)), ("update", 0.016), ("event", _key("D", True)), ("update", 0.02),
             ("event", _key("W", False)), ("event", _key("SPACE", True)), ("update", 0.016),
             ("event", _key("SHIFT", True)), ("event", _key("A", True)), ("event", _key("S", True)),
             ("update", 0.033), ("event", (ev.CursorLeft(), jev.CursorLeft())), ("update", 0.016)],
    "fov keys": [("event", _key("Q", True)), ("update", 0.016), ("update", 10.0), ("event", _key("Q", False)),
                 ("event", _key("E", True)), ("update", 0.05), ("update", 10.0)],
    "mouse": [("event", (ev.MouseButtonInput("right", True), jev.MouseButtonInput("right", True))),
              ("device", (ev.MouseMotion(10.0, -4.0), jev.MouseMotion(10.0, -4.0))), ("update", 0.016),
              ("device", (ev.MouseMotion(-3.5, 170.0), jev.MouseMotion(-3.5, 170.0))), ("update", 0.016),
              ("event", _key("CTRL", True)),
              ("device", (ev.MouseMotion(3.0, 7.0), jev.MouseMotion(3.0, 7.0))), ("update", 0.016),
              ("event", _key("F", True)), ("update", 0.016), ("event", _key("F", True)), ("update", 0.016)],
    "touch pan": [("event", _touch("STARTED", 1, 100.0, 100.0)), ("event", _touch("MOVED", 1, 100.0, 110.0)),
                  ("update", 0.016), ("event", _touch("MOVED", 1, 93.0, 131.5)), ("update", 0.016),
                  ("event", _touch("ENDED", 1, 93.0, 131.5)), ("update", 0.016)],
    "pinch": [("event", _touch("STARTED", 1, 200.0, 300.0)), ("event", _touch("STARTED", 2, 400.0, 300.0)),
              ("update", 0.016), ("event", _touch("MOVED", 2, 500.0, 310.0)), ("event", _touch("MOVED", 1, 100.0, 290.0)),
              ("update", 0.016), ("event", _touch("STARTED", 3, 50.0, 50.0)), ("event", _touch("MOVED", 3, 60.0, 50.0)),
              ("event", _touch("MOVED", 2, 450.0, 310.0)), ("event", _touch("ENDED", 1, 100.0, 290.0)),
              ("update", 0.016), ("event", _touch("MOVED", 3, 20.0, 50.0)), ("update", 0.016),
              ("event", _touch("CANCELLED", 2, 450.0, 310.0)), ("update", 0.016)],
}


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", SEQUENCES)
def test_camera_sequences_match(name, seed):
    cam, jcam = _start(seed)
    ctl, jctl = cc.CameraController(speed=1.5), jcc.CameraController(speed=1.5)
    changes = []
    for kind, arg in SEQUENCES[name]:
        if kind == "event":
            assert ctl.process_event(arg[0]) == jctl.process_event(arg[1])
        elif kind == "device":
            ctl.process_device_event(arg[0])
            jctl.process_device_event(arg[1])
        else:
            cam, changed = ctl.update_camera(cam, (800, 600), arg)
            jcam, jchanged = jctl.update_camera(jcam, (800, 600), arg)
            changes.append(changed)
            assert changed == jchanged
            assert isinstance(cam.eye, torch.Tensor) and cam.eye.dtype == torch.float32
            for field in ("eye", "pitch", "yaw", "fov_y"):
                _close(getattr(cam, field), getattr(jcam, field), f"{name}: {field}")
            assert float(cam.sun_angle.theta) == float(jcam.sun_angle.theta)
            assert float(cam.sun_angle.phi) == float(jcam.sun_angle.phi)
            assert int(cam.view_mode) == int(jcam.view_mode)
    assert any(changes)


def test_keyboard_increment_rounds_as_jax():
    """One W step from the same float32 eye and direction lands on JAX's
    float32 eye exactly: speed * 0.1 * dt_micros rounds to float32 first."""
    cam, jcam = _start(5)
    jcam = dataclasses.replace(jcam, pitch=jnp.float32(0.0))
    cam = dataclasses.replace(cam, pitch=torch.tensor(np.float32(0.0)))
    ctl, jctl = cc.CameraController(speed=1.0), jcc.CameraController(speed=1.0)
    ctl.process_event(ev.KeyInput(ev.Key.W, True))
    jctl.process_event(jev.KeyInput(jev.Key.W, True))
    new, _ = ctl.update_camera(cam, (800, 600), 0.016)
    jnew, _ = jctl.update_camera(jcam, (800, 600), 0.016)
    step = np.asarray(cam.direction(), np.float32) * np.float32(1600.0)
    assert np.array_equal(new.eye.numpy(), cam.eye.numpy() + step)
    jstep = np.asarray(jcam.direction(), np.float32) * np.float32(1600.0)
    assert np.array_equal(np.asarray(jnew.eye), np.asarray(jcam.eye) + jstep)


@pytest.mark.parametrize("pinch", [(((200.0, 300.0), (400.0, 300.0)), ((100.0, 300.0), (500.0, 300.0))),
                                   (((300.0, 300.0), (500.0, 300.0)), ((400.0, 300.0), (400.5, 300.0))),
                                   (((10.0, 3.0), (90.0, 7.0)), ((30.0, 3.0), (61.0, 9.0)))])
def test_pinch_math_equal(pinch):
    for fov in (0.3, 0.785, 2.0):
        assert cc.get_rotation_and_fov_change(*pinch, fov, (800, 600)) == jcc.get_rotation_and_fov_change(
            *pinch, fov, (800, 600))


def test_controllers_hub():
    requested = []
    hub = ApplicationControllers(lambda loc, cur: requested.append(loc), camera_speed=1.0)
    jhub = JaxControllers(lambda loc, cur: None, camera_speed=1.0)
    cam = Camera().reset(GeoCoord(49.35, 20.21), 1500.0)
    assert hub.process_event(ev.KeyInput(ev.Key.W, True)) == jhub.process_event(jev.KeyInput(jev.Key.W, True))
    hub.process_device_event(ev.MouseMotion(1.0, 1.0))
    cam2, changed = hub.update(cam, (800, 600))
    assert changed and float(torch.linalg.norm(cam2.eye - cam.eye)) > 0
    assert cam2.view_mode == ViewMode.DEFAULT and requested == []
    hub.ui.change_location(GeoCoord(49.35135, 20.21139), _Data([]), _Engine())
    assert len(requested) == 6
