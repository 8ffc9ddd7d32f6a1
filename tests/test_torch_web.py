"""The port's web frontend (`topo_renderer_tpu_torch/frontends/web/server.py`)
against the JAX package's, on the CPU.

The wire parsing and the camera state must equal JAX's exactly. The flows
of `tests/test_web.py` run against the port's `WebFrontend(device="cpu")`
and its `BackendServer` over real HTTP. A served frame's u8 image, taken
just before its JPEG encode, must equal the engine's own render of the
session's camera bit for bit. The server's backlog must hold a burst of
64 connections, and a failed render must roll the session's camera back
unless another request advanced it.
"""

import dataclasses
import enum
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_backend_pipeline import make_fixtures
from topo_renderer_tpu.frontends.web import server as jax_server
from topo_renderer_tpu.geo import GeoCoord as JaxGeoCoord
from topo_renderer_tpu.models.camera import Camera as JaxCamera
from topo_renderer_tpu_torch.backend.server import BackendServer
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.control.events import Key, KeyInput
from topo_renderer_tpu_torch.frontends.web import server
from topo_renderer_tpu_torch.frontends.web.server import WebFrontend
from topo_renderer_tpu_torch.geo import GeoCoord
from topo_renderer_tpu_torch.models.camera import Camera, LightAngle, ViewMode
from topo_renderer_tpu_torch.render.overlay import composite_labels

VIEW = {"latitude": 49.35135, "longitude": 20.21139}


@pytest.fixture()
def frontend(tmp_path):
    make_fixtures(tmp_path)
    backend = BackendServer(Settings(address="127.0.0.1", port=0, data_dir=str(tmp_path)))
    backend.start()
    fe = WebFrontend(Settings(backend_url=backend.url), port=0, device="cpu")
    thread = threading.Thread(target=fe.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{fe._httpd.server_address[1]}"
    yield fe, base
    fe._httpd.shutdown()
    thread.join(timeout=10)
    fe.app.shutdown()
    backend.stop()


def _post(base, path, body=None, timeout=120):
    req = urllib.request.Request(base + path, data=json.dumps(body or {}).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.status, e.read(), dict(e.headers)


# ---- wire parsing and camera state vs JAX ------------------------------------

def _event_key(ev):
    """An event as (class name, field values), enums by value."""
    fields = {k: (v.value if isinstance(v, enum.Enum) else v) for k, v in dataclasses.asdict(ev).items()}
    return type(ev).__name__, fields


GOOD_EVENTS = [
    *({"type": "key", "key": k.value, "pressed": p} for k in Key for p in (True, False)),
    {"type": "key", "key": "w", "pressed": 0},
    {"type": "mouse_button", "button": "right", "pressed": True},
    {"type": "mouse_button", "button": "left", "pressed": False},
    {"type": "mouse_motion", "dx": 40, "dy": -2.5},
    *({"type": "touch", "phase": ph, "id": 3, "x": 10.5, "y": "7"} for ph in ("started", "moved", "ended",
                                                                               "cancelled")),
    {"type": "cursor_left"},
]
BAD_EVENTS = [
    {},
    {"type": "wheel", "dy": 1},
    {"type": "key", "key": "caps", "pressed": True},
    {"type": "key", "pressed": True},
    {"type": "mouse_motion", "dx": "left", "dy": 0},
    {"type": "mouse_motion", "dx": 1.0},
    {"type": "touch", "phase": "hover", "id": 1, "x": 0, "y": 0},
    {"type": "touch", "phase": "moved", "id": 1, "x": 0},
]


@pytest.mark.parametrize("d", GOOD_EVENTS, ids=lambda d: json.dumps(d, sort_keys=True))
def test_parse_input_event_equals_jax(d):
    (ev, dev), (jev, jdev) = server._parse_input_event(dict(d)), jax_server._parse_input_event(dict(d))
    assert dev == jdev
    assert _event_key(ev) == _event_key(jev)


@pytest.mark.parametrize("d", BAD_EVENTS, ids=lambda d: json.dumps(d, sort_keys=True))
def test_parse_input_event_rejects_as_jax(d):
    with pytest.raises(Exception) as want:
        jax_server._parse_input_event(dict(d))
    with pytest.raises(want.type):
        server._parse_input_event(dict(d))
    assert want.type in (KeyError, ValueError)  # both map to HTTP 400


def _camera_pair(seed):
    rng = np.random.default_rng(seed)
    lat, lon = rng.uniform(-80, 80), rng.uniform(-179, 179)
    height = float(rng.uniform(0.0, 9000.0))
    kw = dict(pitch=float(rng.uniform(-1.5, 1.5)), yaw=float(rng.uniform(-3, 3)), fov_y=float(rng.uniform(0.3, 2.0)))
    jcam = dataclasses.replace(JaxCamera().reset(JaxGeoCoord(lat, lon), height), **kw)
    pcam = Camera(eye=torch.from_numpy(np.array(jcam.eye, np.float32)), view_mode=ViewMode(int(jcam.view_mode)),
                  sun_angle=LightAngle(float(jcam.sun_angle.theta), float(jcam.sun_angle.phi)), **kw)
    return pcam, jcam


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_camera_state_equals_jax(seed):
    pcam, jcam = _camera_pair(seed)
    assert server._camera_state(pcam) == jax_server._camera_state(jcam)


def test_camera_state_at_the_origin_equals_jax():
    """r = 0 (no location set yet): finite values, valid JSON, as JAX's."""
    got = server._camera_state(Camera())
    assert got == jax_server._camera_state(JaxCamera())
    assert json.loads(json.dumps(got, allow_nan=False)) == got
    assert got["altitude"] == -server.R0


# ---- the flows of tests/test_web.py -------------------------------------------

def test_interactive_freefly_session(frontend):
    fe, base = frontend
    with urllib.request.urlopen(base + "/", timeout=30) as resp:
        page = resp.read().decode()
    assert "/frame?session=" in page and "pointerdown" in page and "TPU" not in page

    status, body, _ = _post(base, "/location", VIEW)
    assert status == 200
    info = json.loads(body)
    assert info["loaded"] >= 1
    assert abs(info["camera"]["latitude"] - VIEW["latitude"]) < 0.01

    status, body, _ = _post(base, "/session")
    assert status == 200
    sid = json.loads(body)["id"]

    small = {"width": 96, "height": 64}
    status, jpg, headers = _post(base, f"/frame?session={sid}", {"events": [], "force": True, **small})
    assert status == 200 and jpg[:2] == b"\xff\xd8"
    state0 = json.loads(headers["X-Camera-State"])

    status, body, headers = _post(base, f"/frame?session={sid}", {"events": [], **small})
    assert status == 204 and body == b"" and json.loads(headers["X-Camera-State"]) == state0

    events = [
        {"type": "key", "key": "w", "pressed": True},
        {"type": "mouse_button", "button": "right", "pressed": True},
        {"type": "mouse_motion", "dx": 40.0, "dy": 0.0},
    ]
    status, jpg, headers = _post(base, f"/frame?session={sid}", {"events": events, **small})
    assert status == 200 and jpg[:2] == b"\xff\xd8"
    state1 = json.loads(headers["X-Camera-State"])
    moved = abs(state1["latitude"] - state0["latitude"]) + abs(state1["longitude"] - state0["longitude"])
    assert moved > 0 or state1["yaw"] != state0["yaw"]

    for extra in ({"exact": True}, {"exact": True, "exact_quality": "interactive"}, {"pixfmt": "yuv420_half"}):
        status, img, _ = _post(base, f"/frame?session={sid}", {"events": [], "force": True, **small, **extra})
        assert status == 200 and img[:2] == b"\xff\xd8", extra
    import io

    from PIL import Image

    assert Image.open(io.BytesIO(img)).size == (96, 64)

    for bad in ({"pixfmt": "rgb565"}, {"exact": True, "exact_quality": "best"},
                {"events": [{"type": "wheel"}]}):
        status, body, _ = _post(base, f"/frame?session={sid}", {"force": True, **small, **bad})
        assert status == 400 and body.startswith(b"bad request"), bad

    status, _, _ = _post(base, "/frame?session=deadbeef", {"events": []})
    assert status == 410
    with urllib.request.urlopen(base + "/status", timeout=30) as resp:
        st = json.loads(resp.read())
    assert st["loaded"] >= 1 and st["running"] >= 0 and isinstance(st["errors"], list)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nowhere", timeout=30)
    assert ei.value.status == 404


def test_oneshot_render_cache(frontend):
    fe, base = frontend
    url = base + "/render?latitude=49.35135&longitude=20.21139&width=128&height=64&panorama=1"
    with urllib.request.urlopen(url, timeout=180) as resp:
        png1 = resp.read()
    assert png1[:8] == b"\x89PNG\r\n\x1a\n"
    t0 = time.monotonic()
    with urllib.request.urlopen(url, timeout=30) as resp:
        png2 = resp.read()
    assert png2 == png1
    assert time.monotonic() - t0 < 1.0
    assert len(fe._render_cache) == 1


def test_frame_before_location_fails_cleanly(frontend):
    fe, base = frontend
    status, body, _ = _post(base, "/session")
    sid = json.loads(body)["id"]
    status, body, _ = _post(base, f"/frame?session={sid}", {"width": 64, "height": 48, "force": True})
    assert status == 500 and b"no terrain" in body
    status, _, _ = _post(base, "/frame?session=doesnotexist", {"force": True})
    assert status == 410


# ---- the port's served frames ----------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"exact": True, "exact_quality": "interactive"}, {"pixfmt": "yuv420_half"}],
                         ids=["fast_yuv420", "exact_rgb888", "fast_yuv420_half"])
def test_served_frame_equals_engine_render(frontend, monkeypatch, extra):
    """The u8 image the server hands to the JPEG encoder equals the engine's
    own render of the session's camera, labels composited, bit for bit."""
    fe, base = frontend
    assert _post(base, "/location", VIEW)[0] == 200
    sid = json.loads(_post(base, "/session")[1])["id"]
    # The fixture's tile is noise: from the spawn height (terrain + 50 m) a
    # frame sees one slope. From 3200 m, looking down, it sees the tile.
    sess = fe._sessions[sid]
    sess.camera = dataclasses.replace(sess.camera.reset(GeoCoord(**VIEW), 3200.0), pitch=0.5)
    encoded = []
    encode = server.encode_jpeg
    monkeypatch.setattr(server, "encode_jpeg", lambda img, *a, **kw: (encoded.append(np.array(img)), encode(img))[1])
    events = [{"type": "mouse_button", "button": "right", "pressed": True},
              {"type": "mouse_motion", "dx": 6.0, "dy": 3.0}]  # a look that keeps the terrain in view
    status, _, _ = _post(base, f"/frame?session={sid}", {"events": events, "width": 96, "height": 64, **extra})
    assert status == 200 and len(encoded) == 1
    cam = fe._sessions[sid].camera
    exact = extra.get("exact", False)
    wire = extra.get("pixfmt") or ("rgb888" if exact else "yuv420")
    with fe._render_lock:
        res = fe.app.engine.render(cam, 96, 64, fast=not exact, host_copy=False, wire=wire,
                                   exact_quality=extra.get("exact_quality", "auto"))
    frame, _, layouts, names = res.finish(res.color.numpy())
    if layouts:
        frame = composite_labels(frame, layouts, names)
    assert frame.shape == (64, 96, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(encoded[0], frame)
    assert len(np.unique(frame.reshape(-1, 3), axis=0)) > 20


def test_busy_renderer_drops_then_redraws(frontend):
    """A frame that finds the renderer busy is dropped (204) and marks the
    session, so the next request renders with no new input."""
    fe, base = frontend
    assert _post(base, "/location", VIEW)[0] == 200
    sid = json.loads(_post(base, "/session")[1])["id"]
    small = {"width": 64, "height": 64}
    assert _post(base, f"/frame?session={sid}", {"force": True, **small})[0] == 200
    with fe._render_lock:
        status, _, _ = _post(base, f"/frame?session={sid}", {"events": [
            {"type": "key", "key": "d", "pressed": True}], **small})
    assert status == 204 and fe._sessions[sid].pending_redraw
    assert _post(base, f"/frame?session={sid}", {"events": [{"type": "key", "key": "d", "pressed": False}],
                                                 **small})[0] == 200
    assert not fe._sessions[sid].pending_redraw


def test_request_burst_does_not_stall(frontend):
    """The listen backlog holds a burst of 64 connections (socketserver's
    default of 5 drops SYNs past it), and all 64 requests are answered."""
    fe, base = frontend
    assert fe._httpd.request_queue_size >= 64
    bodies, errors = [], []

    def get():
        try:
            with urllib.request.urlopen(base + "/status", timeout=10) as r:
                bodies.append(r.read())
        except OSError as e:
            errors.append(e)

    threads = [threading.Thread(target=get) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads) and errors == [] and len(bodies) == 64
    assert all(json.loads(b)["loaded"] == 0 for b in bodies)


def test_failed_render_rolls_the_camera_back(frontend, monkeypatch):
    """A render that raises rolls the session's camera and clock back, so the
    consumed input cannot teleport the view; a camera another request
    advanced meanwhile is kept (compare-and-swap)."""
    fe, _ = frontend
    fe.set_location(VIEW)
    sid = fe.new_session()["id"]
    sess = fe._sessions[sid]
    cam0, t0 = sess.camera, sess.last_frame_t
    time.sleep(0.02)

    def fail(*args, **kw):
        raise RuntimeError("render failed")

    monkeypatch.setattr(fe.app.engine, "render", fail)
    body = {"events": [{"type": "key", "key": "w", "pressed": True}], "width": 64, "height": 64}
    with pytest.raises(RuntimeError, match="render failed"):
        fe.frame(sid, body)
    assert sess.camera is cam0 and sess.last_frame_t == t0

    other = dataclasses.replace(cam0, yaw=float(cam0.yaw) + 0.5)

    def advanced_then_fail(*args, **kw):
        sess.camera = other  # a pipelined request's input landed meanwhile
        raise RuntimeError("render failed")

    monkeypatch.setattr(fe.app.engine, "render", advanced_then_fail)
    with pytest.raises(RuntimeError):
        fe.frame(sid, {"events": [], "force": True, "width": 64, "height": 64})
    assert sess.camera is other


def test_failed_pull_gives_the_exact_pose_back(frontend, monkeypatch):
    """An exact frame whose pull to the host raises after the render
    returned gives the engine's exact-frame pose back with the camera, so
    the next "auto" frame back at the old pose gets the full budget, not the
    interactive rung; the exception reaches the caller."""
    from topo_renderer_tpu_torch.render import engine as engine_mod

    fe, _ = frontend
    fe.set_location(VIEW)
    fe.app.pump_events()
    sid = fe.new_session()["id"]
    sess = fe._sessions[sid]
    cam_a = dataclasses.replace(sess.camera.reset(GeoCoord(**VIEW), 3200.0), pitch=0.5)
    cam_b = dataclasses.replace(cam_a, yaw=float(cam_a.yaw) + 0.4)
    budgets = []
    march = engine_mod.render_perspective

    def spy(*args, **kw):
        budgets.append(kw["guided_kw"])
        return march(*args, **kw)

    monkeypatch.setattr(engine_mod, "render_perspective", spy)
    body = {"events": [], "force": True, "exact": True, "width": 64, "height": 64}
    sess.camera = cam_a
    fe.frame(sid, body)
    pose_a = fe.app.engine._camera_pose_key(sess.camera)
    assert fe.app.engine._last_exact_pose == pose_a

    def fail(wire):
        raise RuntimeError("pull failed")

    monkeypatch.setattr(server, "_start_pull", fail)
    sess.camera = cam_b
    with pytest.raises(RuntimeError, match="pull failed"):
        fe.frame(sid, body)
    assert fe.app.engine._last_exact_pose == pose_a
    monkeypatch.undo()
    monkeypatch.setattr(engine_mod, "render_perspective", spy)
    sess.camera = cam_a
    fe.frame(sid, body)
    assert fe.app.engine._camera_pose_key(sess.camera) == pose_a
    assert budgets == [(), tuple(sorted(fe.app.engine._EXACT_RUNG_INTERACTIVE)), ()]


def test_idle_sessions_are_collected(frontend, monkeypatch):
    fe, _ = frontend
    old = fe.new_session()["id"]
    monkeypatch.setattr(server, "SESSION_IDLE_TIMEOUT_S", 0.0)
    time.sleep(0.01)
    new = fe.new_session()["id"]
    assert set(fe._sessions) == {new} and old != new
    with pytest.raises(server.UnknownSession):
        fe.frame(old, {})


def test_frame_dt_is_clamped(frontend):
    """A stalled session integrates at most MAX_FRAME_DT_S of motion."""
    fe, _ = frontend
    sid = fe.new_session()["id"]
    sess = fe._sessions[sid]
    sess.last_frame_t -= 5.0
    seen = []
    update = sess.controller.update_camera
    sess.controller.update_camera = lambda cam, size, dt: (seen.append(dt), update(cam, size, dt))[1]
    sess.controller.process_event(KeyInput(Key.W, True))
    with pytest.raises(RuntimeError, match="no terrain"):
        fe.frame(sid, {"force": True})
    assert seen == [server.MAX_FRAME_DT_S]


def test_web_main_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TOPO_BACKEND_URL", "http://127.0.0.1:9")
    with pytest.raises(RuntimeError, match="CUDA"):
        WebFrontend(Settings(backend_url="http://127.0.0.1:9"), port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main(["--port", "0"])
