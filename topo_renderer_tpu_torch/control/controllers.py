"""Controllers hub: camera + UI controllers with frame timing.

Copy of `topo_renderer_tpu/control/controllers.py` for the PyTorch port; it imports nothing
of the JAX package.

Parity with `topo-renderer/src/control/application_controllers.rs:29-132`:
wires the camera controller and UI controller together, owns the background
runner handle, and tracks the frame time delta fed into camera integration.
(`app/application.py` uses this same wiring inline; this hub is the
standalone embedding-facing composition.)
"""

from __future__ import annotations

import time
from typing import Callable

from topo_renderer_tpu_torch.control.camera_controller import CameraController
from topo_renderer_tpu_torch.control.ui_controller import UiController


class ApplicationControllers:
    def __init__(
        self,
        request_tile: Callable,
        camera_speed: float = 1.0,
    ):
        self.camera = CameraController(camera_speed)
        self.ui = UiController(request_tile)
        self._last_update = time.monotonic()

    def process_event(self, event) -> bool:
        return self.camera.process_event(event)

    def process_device_event(self, event) -> None:
        self.camera.process_device_event(event)

    def update(self, camera, size):
        """Per-frame integration with measured time delta
        (`application_controllers.rs:109-124`). Returns (camera, changed)."""
        now = time.monotonic()
        dt = now - self._last_update
        self._last_update = now
        return self.camera.update_camera(camera, size, dt)
