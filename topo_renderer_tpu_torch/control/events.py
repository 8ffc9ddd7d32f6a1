"""Window-system-agnostic input and application events.

Copy of `topo_renderer_tpu/control/events.py` for the PyTorch port; it imports nothing
of the JAX package.

The reference couples its controllers to winit event types
(`topo-renderer/src/control/camera_controller.rs:120-341`,
`src/app.rs:33-51`). The renderer keeps the same event *semantics* behind
plain dataclasses so controllers are testable headlessly and any frontend
(CLI, web, notebook) can feed them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation


class Key(enum.Enum):
    W = "w"
    A = "a"
    S = "s"
    D = "d"
    Q = "q"
    E = "e"
    F = "f"
    UP = "up"
    DOWN = "down"
    LEFT = "left"
    RIGHT = "right"
    SPACE = "space"
    SHIFT = "shift"
    CTRL = "ctrl"


class TouchPhase(enum.Enum):
    STARTED = "started"
    MOVED = "moved"
    ENDED = "ended"
    CANCELLED = "cancelled"


@dataclasses.dataclass(frozen=True)
class KeyInput:
    key: Key
    pressed: bool


@dataclasses.dataclass(frozen=True)
class MouseButtonInput:
    button: str  # "left" | "right" | "middle"
    pressed: bool


@dataclasses.dataclass(frozen=True)
class MouseMotion:
    dx: float
    dy: float


@dataclasses.dataclass(frozen=True)
class CursorLeft:
    pass


@dataclasses.dataclass(frozen=True)
class TouchInput:
    phase: TouchPhase
    id: int
    x: float
    y: float


# ---- application events (reference `ApplicationEvent`, app.rs:33-39) ------


@dataclasses.dataclass
class ChangeLocation:
    location: GeoCoord


@dataclasses.dataclass
class TerminateWithError:
    message: str


@dataclasses.dataclass
class RenderEventMsg:
    """Wrapper for render events posted back from the background pipeline
    (reference `RenderEvent`, `render_engine.rs:24-30`)."""

    kind: str  # "terrain_ready" | "peaks_ready" | "reset_camera" | ...
    payload: Any = None
    location: GeoLocation | None = None
