"""Web frontend: interactive browser free-fly over server-side rendering.

Copy of `topo_renderer_tpu/frontends/web/server.py` for the PyTorch port,
itself the counterpart of `topo-renderer-web` (`lib.rs:21-140`,
`index.html:228-330`): the browser streams input events to the server and
the server renders frames on the GPU. Feature parity:

  * ``set_location(latitude, longitude)`` — the form posts the same fields
    the reference's JS form does (`index.html:299-314`);
  * interactive free-fly: the full `CameraController` state machine
    (`camera_controller.rs:88-470`) runs server-side per session, fed by
    JSON input events from the browser;
  * status line driven by background-task notifications (`lib.rs:111-119`);
  * toast-style error reporting for failed tiles (`lib.rs:94-104`).

Endpoints:
  GET  /                  — UI page (interactive canvas + location form)
  POST /session           — new free-fly session -> {"id", "camera"}
  POST /frame?session=ID  — body {"events": [...], "width", "height",
                            "exact": bool, ...}: apply input, integrate the
                            camera, render one frame -> JPEG (204 when
                            nothing changed, or when another frame holds the
                            renderer); ``exact`` renders the triangle-exact
                            guided march instead of the LOD fast frame
  POST /location          — body {"latitude", "longitude"}: stream tiles,
                            notification-driven readiness (no fixed sleeps),
                            respawn session cameras at terrain + 50 m
  GET  /render?...        — one-shot PNG (cached per location/spec/tile-set)
  GET  /status            — JSON task counters + errors

The port's own choices: the server listens with a backlog of 128
(`backend/server.py::BacklogHTTPServer`), and a frame's wire vector is
copied into pinned host memory under the render lock, so that the pull
outside it waits for that frame's copy alone (`WebFrontend.frame`).
"""

from __future__ import annotations

import json
import math
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from topo_renderer_tpu_torch.app.application import Application
from topo_renderer_tpu_torch.backend.server import BacklogHTTPServer
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.control.camera_controller import CameraController
from topo_renderer_tpu_torch.control.events import (
    CursorLeft,
    Key,
    KeyInput,
    MouseButtonInput,
    MouseMotion,
    TouchInput,
    TouchPhase,
)
from topo_renderer_tpu_torch.geo import GeoCoord
from topo_renderer_tpu_torch.ops.geometry import R0
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec
from topo_renderer_tpu_torch.render import transport
from topo_renderer_tpu_torch.render.overlay import composite_labels
from topo_renderer_tpu_torch.utils.imageio import encode_jpeg, encode_png

INDEX_HTML = (Path(__file__).parent / "index.html").read_text(encoding="utf-8")

SESSION_IDLE_TIMEOUT_S = 600.0
MAX_FRAME_DT_S = 0.1  # clamp stalls so a delayed frame can't teleport the eye
RENDER_CACHE_ENTRIES = 32


class UnknownSession(Exception):
    """Requested session id is not (or no longer) registered."""


def _parse_input_event(d: dict):
    """JSON wire event -> (controller event, is a device event)."""
    t = d.get("type")
    if t == "key":
        return KeyInput(Key(d["key"]), bool(d["pressed"])), False
    if t == "mouse_button":
        return MouseButtonInput(str(d["button"]), bool(d["pressed"])), False
    if t == "mouse_motion":
        return MouseMotion(float(d["dx"]), float(d["dy"])), True
    if t == "touch":
        return (
            TouchInput(TouchPhase(d["phase"]), int(d["id"]), float(d["x"]), float(d["y"])),
            False,
        )
    if t == "cursor_left":
        return CursorLeft(), False
    raise ValueError(f"unknown input event type: {t!r}")


def _camera_state(camera) -> dict:
    eye = np.asarray(camera.eye, np.float64)
    r = float(np.linalg.norm(eye))
    common = {
        "fov_deg": math.degrees(float(camera.fov_y)),
        "pitch": float(camera.pitch),
        "yaw": float(camera.yaw),
        "view_mode": int(camera.view_mode),
    }
    # Before any location is set the default camera sits at the origin
    # (r == 0): dividing would make NaNs that json.dumps writes as `NaN`,
    # which the browser's JSON.parse rejects.
    if r <= 0.0:
        return {"latitude": 0.0, "longitude": 0.0, "altitude": -R0, **common}
    return {
        "latitude": math.degrees(math.asin(max(-1.0, min(1.0, eye[2] / r)))),
        "longitude": math.degrees(math.atan2(eye[1], eye[0])),
        "altitude": r - R0,
        **common,
    }


def _start_pull(wire: torch.Tensor):
    """Queue the copy of a frame's wire vector to the host: (host tensor,
    event to wait on, or None when it is already on the host). The pinned
    buffer comes from torch's caching host allocator, which hands a block
    out again only after the copies queued on it have completed."""
    if wire.device.type == "cpu":
        return wire, None
    host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
    host.copy_(wire, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


class _Session:
    """Per-browser free-fly state: its own controller + camera."""

    def __init__(self, camera, speed: float):
        self.controller = CameraController(speed)
        self.camera = camera
        self.lock = threading.Lock()
        self.last_frame_t = time.monotonic()
        self.last_seen = time.monotonic()
        self.pending_redraw = False


class WebFrontend:
    def __init__(self, settings: Settings | None = None, port: int = 8080, device=None):
        """``device``: where the application's engine renders (None: the
        CUDA device, which raises without CUDA)."""
        self.app = Application(settings, device=device)
        self._lock = threading.Lock()
        # One render at a time: the engine and the application state are
        # shared across the server's handler threads, and every engine call
        # and event pump happens under this lock.
        self._render_lock = threading.Lock()
        self._status = {"running": 0, "errors": [], "loaded": 0}
        self._sessions: dict[str, _Session] = {}
        self._render_cache: dict[tuple, bytes] = {}
        self._notes = self.app.subscribe_to_background_notifications()
        threading.Thread(target=self._watch_notifications, daemon=True).start()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, body: bytes = b"", ctype: str = "text/plain", headers: dict | None = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _body_json(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b"{}"
                return json.loads(raw or b"{}")

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    self._send(200, INDEX_HTML.encode(), "text/html; charset=utf-8")
                elif url.path == "/status":
                    with frontend._lock:
                        body = json.dumps(frontend._status).encode()
                    self._send(200, body, "application/json")
                elif url.path == "/render":
                    try:
                        self._send(200, frontend.render(q), "image/png")
                    except Exception as e:
                        self._send(500, str(e).encode(), "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                try:
                    if url.path == "/session":
                        self._send(200, json.dumps(frontend.new_session()).encode(), "application/json")
                    elif url.path == "/frame":
                        sid = q.get("session", [""])[0]
                        jpg, state, _changed = frontend.frame(sid, self._body_json())
                        headers = {"X-Camera-State": json.dumps(state)}
                        if jpg is None:
                            self._send(204, b"", "text/plain", headers)
                        else:
                            self._send(200, jpg, "image/jpeg", headers)
                    elif url.path == "/location":
                        body = frontend.set_location(self._body_json())
                        self._send(200, json.dumps(body).encode(), "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except UnknownSession as e:
                    self._send(410, f"unknown session {e}".encode(), "text/plain")
                except (KeyError, ValueError) as e:
                    # Malformed request body — distinct from a dead
                    # session (clients drop session state on 410).
                    self._send(400, f"bad request: {e!r}".encode(), "text/plain")
                except Exception as e:
                    self._send(500, str(e).encode(), "text/plain")

        self._httpd = BacklogHTTPServer(("0.0.0.0", port), Handler)

    def _watch_notifications(self):
        while True:
            note = self._notes.get()
            with self._lock:
                self._status["running"] = note.running
                if note.kind == "task_errored":
                    self._status["errors"] = (self._status["errors"] + [note.error])[-5:]
                elif note.kind == "task_finished":
                    # New tile: cached one-shot renders are stale.
                    self._render_cache.clear()

    # ---- sessions ----------------------------------------------------------

    def new_session(self) -> dict:
        with self._render_lock:
            self.app.pump_events()
            camera = self.app.data.camera
        sid = uuid.uuid4().hex[:16]
        with self._lock:
            self._gc_sessions()
            self._sessions[sid] = _Session(camera, self.app.camera_controller.speed)
        return {"id": sid, "camera": _camera_state(camera)}

    def _gc_sessions(self):
        now = time.monotonic()
        for sid in [s for s, v in self._sessions.items() if now - v.last_seen > SESSION_IDLE_TIMEOUT_S]:
            del self._sessions[sid]

    def frame(self, sid: str, body: dict):
        """Apply input events, integrate the camera, render one frame.

        Returns ``(jpeg|None, camera_state, changed)`` — None when the camera
        did not change and the client sent no ``force`` flag, or when
        another frame holds the renderer (HTTP 204; the browser keeps its
        previous frame).
        """
        with self._lock:
            try:
                sess = self._sessions[sid]
            except KeyError:
                raise UnknownSession(sid) from None
        width = max(64, min(2048, int(body.get("width", 800))))
        height = max(64, min(1152, int(body.get("height", 450))))
        with sess.lock:
            sess.last_seen = time.monotonic()
            prev_camera = sess.camera
            prev_frame_t = sess.last_frame_t
            for d in body.get("events", ()):
                ev, is_device = _parse_input_event(d)
                if is_device:
                    sess.controller.process_device_event(ev)
                else:
                    sess.controller.process_event(ev)
            now = time.monotonic()
            dt = min(now - sess.last_frame_t, MAX_FRAME_DT_S)
            sess.last_frame_t = now
            cam, changed = sess.controller.update_camera(sess.camera, (width, height), dt)
            sess.camera = cam
        state = _camera_state(cam)
        if not changed and not body.get("force") and not sess.pending_redraw:
            return None, state, False
        # Only the render's dispatch and the queued copy of its wire vector
        # happen under the render lock; the wait for that copy, the decode,
        # label compositing and the JPEG encode run outside it, overlapping
        # the next request's render. If another frame holds the lock, this
        # one is dropped (input was applied, so motion accumulates into the
        # next delivered frame) instead of queueing render latency.
        acquired = self._render_lock.acquire(timeout=0.0 if body.get("drop", True) else 30.0)
        if not acquired:
            # The next request renders even with no further events, so the
            # view does not freeze one gesture-step behind.
            sess.pending_redraw = True
            return None, state, False
        try:
            self.app.pump_events()
            with self._lock:
                self._status["loaded"] = len(self.app.engine.loaded_locations)
            if not self.app.engine.loaded_locations:
                raise RuntimeError("no terrain loaded yet")
            exact = bool(body.get("exact", False))
            # Motion (fast) frames default to the yuv420 wire: half the
            # bytes, and the JPEG encoder subsamples chroma anyway; exact
            # frames default to rgb888. A client can pin either.
            pixfmt = body.get("pixfmt") or ("rgb888" if exact else "yuv420")
            if pixfmt not in transport.MODES:
                raise ValueError(f"unknown pixfmt {pixfmt!r}")
            quality = body.get("exact_quality", "auto")
            if quality not in ("auto", "full", "interactive"):
                raise ValueError(f"unknown exact_quality {quality!r}")
            res = self.app.engine.render(
                cam, width, height, fast=not exact,
                with_labels=bool(body.get("labels", True)),
                host_copy=False, wire=pixfmt, exact_quality=quality,
            )
            try:
                host, ready = _start_pull(res.color)
            except Exception:
                self.app.engine.rollback_exact_pose()
                raise
        except Exception:
            # No frame was delivered: roll the camera back so the consumed
            # input cannot teleport the view once rendering recovers, but
            # only if no concurrent request advanced it since
            # (compare-and-swap; clobbering would discard its input).
            with sess.lock:
                if sess.camera is cam:
                    sess.camera = prev_camera
                    sess.last_frame_t = prev_frame_t
            raise
        finally:
            self._render_lock.release()
        sess.pending_redraw = False
        if ready is not None:
            ready.synchronize()  # this frame's copy only, not the next render
        frame, _visible, layouts, names = res.finish(host.numpy())
        if layouts:
            frame = composite_labels(frame, layouts, names)
        return encode_jpeg(frame), state, True

    # ---- location streaming ------------------------------------------------

    def _wait_ready(self, timeout: float = 30.0) -> None:
        """Wait until terrain arrived and the fetch pool idled. Every event
        pump happens under the render lock, released between polls so that
        frames keep flowing while tiles stream in."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._render_lock:
                self.app.pump_events()
                have_terrain = bool(self.app.engine.loaded_locations)
            if have_terrain and self.app.background.idle():
                break
            time.sleep(0.05)
        with self._render_lock:
            self.app.pump_events()

    def set_location(self, body: dict) -> dict:
        """`set_location` semantics (`lib.rs:26-36`): stream the 100 km tile
        neighbourhood, wait for readiness via background notifications (no
        fixed sleeps), respawn cameras at terrain + 50 m."""
        lat = float(body["latitude"])
        lon = float(body["longitude"])
        with self._render_lock:
            self.app.change_location(GeoCoord(lat, lon))
        self._wait_ready()
        with self._render_lock:
            self.app.pump_events()
            camera = self.app.data.camera
            loaded = len(self.app.engine.loaded_locations)
        with self._lock:
            self._status["loaded"] = loaded
            self._render_cache.clear()
            for sess in self._sessions.values():
                with sess.lock:
                    sess.camera = camera
        return {"ok": True, "loaded": loaded, "camera": _camera_state(camera)}

    # ---- one-shot rendering ------------------------------------------------

    def render(self, q: dict) -> bytes:
        lat = float(q.get("latitude", ["49.35135"])[0])
        lon = float(q.get("longitude", ["20.21139"])[0])
        width = int(q.get("width", ["1024"])[0])
        height = int(q.get("height", ["384"])[0])
        panorama = q.get("panorama", ["1"])[0] == "1"
        fog = q.get("fog", [None])[0] or None

        location = GeoCoord(lat, lon)
        with self._render_lock:
            if self.app.data.current_location != location:
                self.app.change_location(location)
        self._wait_ready()

        with self._render_lock:
            self.app.pump_events()
            with self._lock:
                self._status["loaded"] = len(self.app.engine.loaded_locations)
            key = (
                round(lat, 6), round(lon, 6), width, height, panorama, fog,
                tuple(sorted(self.app.engine.loaded_locations, key=str)),
            )
            with self._lock:
                cached = self._render_cache.get(key)
            if cached is not None:
                return cached
            cam = self.app.data.camera
            if panorama:
                res = self.app.engine.render_panorama(cam, PanoramaSpec.fast(width=width, height=height), fog=fog)
            else:
                res = self.app.engine.render(cam, width, height, fast=True)
            png = encode_png(res.color)
            with self._lock:
                self._render_cache[key] = png
                while len(self._render_cache) > RENDER_CACHE_ENTRIES:
                    self._render_cache.pop(next(iter(self._render_cache)))
            return png

    def serve_forever(self):
        self._httpd.serve_forever()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="topo-renderer web frontend (PyTorch port)")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--settings", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where frames render (cuda raises without CUDA)")
    args = p.parse_args(argv)
    settings = Settings.load(path=args.settings)
    WebFrontend(settings, port=args.port, device=None if args.device == "cuda" else args.device).serve_forever()


if __name__ == "__main__":
    main()
