"""Application shell: the event loop that owns everything.

Copy of `topo_renderer_tpu/app/application.py` for the PyTorch port, itself
the counterpart of `topo-renderer/src/app.rs` (winit ApplicationHandler)
and `src/control/application_controllers.rs`:
  * a typed event bus replaces the winit user-event proxy
    (`app.rs:33-51`): frontends post `ChangeLocation`; the background
    pipeline posts terrain/peaks/reset-camera events;
  * `ApplicationControllers` wires the camera controller, the UI controller
    and the background runner with per-frame timing
    (`application_controllers.rs:29-132`);
  * the default start viewpoint is the Tatra mountains
    (49.35135 N, 20.21139 E — `app.rs:197`), applied on the first frame;
  * camera spawn height is terrain + 50 m (`render_engine.rs:327`).

The loop is headless and pull-based: frontends call :meth:`step` (or
:meth:`run` with a frame callback) instead of the engine owning a window.
Background workers only post events; the engine (and so every CUDA launch)
runs on the thread that calls :meth:`pump_events` / :meth:`step`.
"""

from __future__ import annotations

import queue
import time
from typing import Callable

import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.app.state import ApplicationData
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.control.camera_controller import CameraController
from topo_renderer_tpu_torch.control.events import ChangeLocation, TerminateWithError
from topo_renderer_tpu_torch.control.ui_controller import UiController
from topo_renderer_tpu_torch.data.background import BackgroundRunner, DataRequested
from topo_renderer_tpu_torch.geo import GeoCoord
from topo_renderer_tpu_torch.parallel.mesh import Mesh
from topo_renderer_tpu_torch.render.engine import RenderEngine

DEFAULT_LOCATION = GeoCoord(49.35135, 20.21139)  # `app.rs:197`
CAMERA_SPAWN_HEIGHT_M = 50.0  # `render_engine.rs:327`
DEFAULT_CAMERA_SPEED = 1.0


class Application:
    """Owns engine + controllers + state; single-threaded event processing
    with a worker-pool data pipeline behind it (reference §3.1-§3.3)."""

    def __init__(
        self,
        settings: Settings | None = None,
        camera_speed: float = DEFAULT_CAMERA_SPEED,
        device=None,
    ):
        """``device``: where the engine's mosaic lives and frames render,
        passed to `RenderEngine`; None means the CUDA device, and raises
        without one before any tile is requested."""
        self.settings = settings or Settings.load()
        self.data = ApplicationData()
        # Streaming: tile add/unload during flight touches one slot
        # instead of rebuilding the mosaic — the reference's per-tile
        # `add_terrain`/`unload_terrain` behavior
        # (`terrain_renderer.rs:173-350,361-363`).
        # TOPO_GEO_SHARD=<n> row-shards the big terrain tables across the
        # first n devices of the engine's device type (scene capacity scales
        # with devices; every render path reads them through the sharded
        # programs, and streaming updates land on the bands). On the CPU the
        # n devices are one, named n times (the tests' virtual devices).
        geo_mesh = None
        n_shard = int(getattr(self.settings, "geo_shard", 0) or 0)
        if n_shard > 1:
            dev = resolve_device(device)
            if dev.type == "cpu":
                devices = [dev] * n_shard
            else:
                count = torch.cuda.device_count()
                if count < n_shard:
                    raise RuntimeError(f"TOPO_GEO_SHARD={n_shard} but only {count} devices")
                devices = [torch.device(dev.type, i) for i in range(n_shard)]
            geo_mesh = Mesh(devices, ("geo",))
        self.engine = RenderEngine(device=device, streaming=True, geo_mesh=geo_mesh)
        self.camera_controller = CameraController(camera_speed)
        self.ui_controller = UiController(self._request_tile)
        self._events: "queue.Queue" = queue.Queue()
        self.background = BackgroundRunner(self.settings, self._post_render_event)
        self.background.spawn()
        self._last_frame = time.monotonic()
        self._running = True
        self.viewport = (800, 600)  # reference desktop default

    # ---- event bus (reference EventLoopProxy, app.rs:85-124) -------------

    def post_event(self, event) -> None:
        self._events.put(event)

    def get_event_proxy(self) -> Callable:
        return self.post_event

    def subscribe_to_background_notifications(self):
        return self.background.subscribe()

    def _post_render_event(self, kind: str, payload) -> None:
        self._events.put(("render_event", kind, payload))

    def _request_tile(self, requested, current_location) -> None:
        self.background.send(
            DataRequested(requested=requested, current_location=current_location)
        )

    # ---- lifecycle -------------------------------------------------------

    def start(self, location: GeoCoord | None = None) -> None:
        """First-frame initialisation (`app.rs:176-213`)."""
        self.change_location(location or DEFAULT_LOCATION)

    def change_location(self, location: GeoCoord) -> None:
        self.ui_controller.change_location(location, self.data, self.engine)

    def shutdown(self) -> None:
        self._running = False
        self.background.shutdown()

    # ---- per-frame processing -------------------------------------------

    def process_input(self, event) -> bool:
        return self.camera_controller.process_event(event)

    def process_device_input(self, event) -> None:
        self.camera_controller.process_device_event(event)

    def _process_event(self, event) -> None:
        if isinstance(event, ChangeLocation):
            self.change_location(event.location)
        elif isinstance(event, TerminateWithError):
            self._running = False
            raise RuntimeError(event.message)
        elif isinstance(event, tuple) and event[0] == "render_event":
            _, kind, payload = event
            self._process_render_event(kind, payload)

    def _process_render_event(self, kind: str, payload) -> None:
        """`render_engine.rs:272-336` event handling."""
        if kind == "terrain_ready":
            self.engine.add_terrain(
                payload["location"], payload["heights"], payload["transform"]
            )
            self.data.loaded_locations.add(payload["location"])
        elif kind == "peaks_ready":
            self.engine.add_peaks(payload["location"], payload["peaks"])
        elif kind == "reset_camera":
            self.data.camera = self.data.camera.reset(
                payload["location"], payload["height"] + CAMERA_SPAWN_HEIGHT_M
            )
            self.data.camera_changed = True

    def pump_events(self) -> int:
        """Drain pending events; returns how many were processed."""
        n = 0
        while True:
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                return n
            self._process_event(ev)
            n += 1

    def step(self, render: bool = True, **render_kw):
        """One frame: pump events, integrate input, optionally render
        (reference redraw handler, `app.rs:224-262`)."""
        self.pump_events()
        now = time.monotonic()
        dt = now - self._last_frame
        self._last_frame = now
        cam, changed = self.camera_controller.update_camera(
            self.data.camera, self.viewport, dt
        )
        if changed:
            self.data.camera = cam
            self.data.camera_changed = True
        if not render or not self.engine.loaded_locations:
            return None
        w, h = self.viewport
        return self.engine.render(
            self.data.camera, w, h, pixelize_n=(
                self.data.pixelize_n if self.data.pixelize_n < 99.99999 else None
            ), **render_kw
        )

    def wait_for_terrain(self, timeout: float = 120.0) -> None:
        """Block until at least one tile is loaded (frontend convenience)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.pump_events()
            if self.engine.loaded_locations:
                return
            time.sleep(0.05)
        raise TimeoutError("no terrain arrived from the backend")

    def run(
        self,
        on_frame: Callable | None = None,
        max_frames: int | None = None,
        target_fps: float = 30.0,
        **render_kw,
    ) -> None:
        """Continuous loop for interactive frontends; ``render_kw`` goes to
        every :meth:`step` (``fast=True`` for the interactive frame)."""
        frame = 0
        period = 1.0 / target_fps
        while self._running and (max_frames is None or frame < max_frames):
            t0 = time.monotonic()
            result = self.step(**render_kw)
            if on_frame is not None and result is not None:
                on_frame(result)
            frame += 1
            elapsed = time.monotonic() - t0
            if elapsed < period:
                time.sleep(period - elapsed)
