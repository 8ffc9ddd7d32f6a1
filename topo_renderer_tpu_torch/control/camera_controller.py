"""Camera input controller: keyboard / mouse / multi-touch state machine.

Faithful port of `topo-renderer/src/control/camera_controller.rs`:
  * key map W/↑ forward, S/↓ back, A/← left, D/→ right, Q/E fov out/in,
    Shift down, Space up along local up, F toggles view mode
    (`camera_controller.rs:120-196`)
  * right-mouse drag accumulates a look delta; Ctrl+mouse drags the sun
    angles (`camera_controller.rs:343-357`)
  * cursor leaving the window releases all keys (`camera_controller.rs:197-202`)
  * per-frame integration: increment = speed * 0.1 * dt_micros;
    fov +- 0.001*increment; yaw -= 0.01*dx; pitch += 0.01*dy; sun angles +=
    raw ctrl deltas (`camera_controller.rs:359-412`)
  * single-touch pans (MOVE_SCALING = 5), two-finger pinch rotates yaw and
    rescales fov via `get_rotation_and_fov_change`
    (`camera_controller.rs:413-470,472-497`)

The controller operates on the immutable `Camera`: `update_camera` returns
``(new_camera, changed)`` instead of mutating in place.

Copy of `topo_renderer_tpu/control/camera_controller.py` for the PyTorch
port. The camera's eye is a float32 CPU tensor (`models/camera.py`); every
increment is one float32 op in the JAX package's order, with Python floats
rounded to float32 where they meet a tensor, as JAX's weak types are, so
each update rounds as JAX's eager one does.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from topo_renderer_tpu_torch.control.events import (
    CursorLeft,
    Key,
    KeyInput,
    MouseButtonInput,
    MouseMotion,
    TouchInput,
    TouchPhase,
)
from topo_renderer_tpu_torch.models.camera import Camera, LightAngle
from topo_renderer_tpu_torch.ops.geometry import f32

MOVE_SCALING = 5.0  # single-touch pan (`camera_controller.rs:415`)

_KEY_TO_CONTROL = {
    Key.W: "up",
    Key.UP: "up",
    Key.S: "down",
    Key.DOWN: "down",
    Key.A: "left",
    Key.LEFT: "left",
    Key.D: "right",
    Key.RIGHT: "right",
    Key.Q: "q",
    Key.E: "e",
    Key.SPACE: "space",
    Key.SHIFT: "shift",
    Key.CTRL: "ctrl",
}


@dataclasses.dataclass
class _TouchPoint:
    id: int
    x: float
    y: float


class CameraController:
    def __init__(self, speed: float):
        self.speed = speed
        self._pressed: dict[str, bool] = {}
        self._mouse_view_delta = [0.0, 0.0]
        self._mouse_ctrl_delta = [0.0, 0.0]
        # touch state: None | _TouchPoint | (p1, p2, deque(others))
        self._touch: object = None
        self._touch_single_delta = [0.0, 0.0]
        self._touch_multi_start: tuple | None = None
        self._events: deque = deque()

    def _is_pressed(self, name: str) -> bool:
        return self._pressed.get(name, False)

    # ---- event intake ----------------------------------------------------

    def process_event(self, event) -> bool:
        """Window events (`camera_controller.rs:120-341`). Returns True when
        the event was consumed."""
        if isinstance(event, KeyInput):
            if event.key == Key.F:
                if event.pressed:
                    self._events.append(("toggle_view_mode",))
                return True
            name = _KEY_TO_CONTROL.get(event.key)
            if name is None:
                return False
            self._pressed[name] = event.pressed
            return True
        if isinstance(event, CursorLeft):
            self._pressed = {k: False for k in self._pressed}
            return False  # the reference returns false here too
        if isinstance(event, MouseButtonInput):
            if event.button == "right":
                self._pressed["mouse_right"] = event.pressed
                return True
            return False
        if isinstance(event, TouchInput):
            self._process_touch(event)
            return True
        return False

    def process_device_event(self, event) -> None:
        """Raw mouse motion (`camera_controller.rs:343-357`)."""
        if isinstance(event, MouseMotion):
            if self._is_pressed("ctrl"):
                self._mouse_ctrl_delta[0] += event.dx
                self._mouse_ctrl_delta[1] += event.dy
            elif self._is_pressed("mouse_right"):
                self._mouse_view_delta[0] += event.dx
                self._mouse_view_delta[1] += event.dy

    def _process_touch(self, t: TouchInput) -> None:
        state = self._touch
        new_state = None
        if t.phase == TouchPhase.STARTED:
            if state is None:
                new_state = _TouchPoint(t.id, t.x, t.y)
            elif isinstance(state, _TouchPoint):
                if state.id != t.id:
                    new_state = (state, _TouchPoint(t.id, t.x, t.y), deque())
                else:
                    state.x, state.y = t.x, t.y
            else:
                p1, p2, others = state
                if t.id == p1.id:
                    p1.x, p1.y = t.x, t.y
                elif t.id == p2.id:
                    p2.x, p2.y = t.x, t.y
                else:
                    others.append(_TouchPoint(t.id, t.x, t.y))
        elif t.phase == TouchPhase.MOVED:
            if isinstance(state, _TouchPoint) and state.id == t.id:
                self._touch_single_delta[0] += t.x - state.x
                self._touch_single_delta[1] += t.y - state.y
                state.x, state.y = t.x, t.y
            elif isinstance(state, tuple):
                p1, p2, others = state
                if t.id == p1.id:
                    p1.x, p1.y = t.x, t.y
                elif t.id == p2.id:
                    p2.x, p2.y = t.x, t.y
                else:
                    for o in others:
                        if o.id == t.id:
                            o.x, o.y = t.x, t.y
        else:  # ENDED / CANCELLED
            if isinstance(state, _TouchPoint) and state.id == t.id:
                new_state = "off"
            elif isinstance(state, tuple):
                p1, p2, others = state
                if t.id in (p1.id, p2.id):
                    keep = p2 if t.id == p1.id else p1
                    if self._touch_multi_start is not None:
                        self._events.append(
                            (
                                "pinch",
                                self._touch_multi_start,
                                ((p1.x, p1.y), (p2.x, p2.y)),
                            )
                        )
                        self._touch_multi_start = None
                    if others:
                        new_state = (keep, others.popleft(), others)
                    else:
                        new_state = keep
                else:
                    for i, o in enumerate(others):
                        if o.id == t.id:
                            del others[i]
                            break
        if new_state is not None:
            self._touch = None if new_state == "off" else new_state
            if isinstance(self._touch, tuple):
                p1, p2, _ = self._touch
                self._touch_multi_start = ((p1.x, p1.y), (p2.x, p2.y))
            else:
                self._touch_multi_start = None

    # ---- per-frame integration ------------------------------------------

    def update_camera(
        self, camera: Camera, size: tuple[int, int], dt_seconds: float
    ) -> tuple[Camera, bool]:
        """`camera_controller.rs:359-470` with immutable-camera semantics."""
        changed = False
        increment = self.speed * 0.1 * (dt_seconds * 1e6)

        fov = float(camera.fov_y)
        if self._is_pressed("q"):
            camera = camera.with_fovy(fov - 0.001 * increment)
            fov = float(camera.fov_y)
            changed = True
        if self._is_pressed("e"):
            camera = camera.with_fovy(fov + 0.001 * increment)
            changed = True

        eye = f32(camera.eye)
        move = None
        if self._is_pressed("up"):
            move = (move if move is not None else 0) + camera.direction() * increment
        if self._is_pressed("down"):
            move = (move if move is not None else 0) - camera.direction() * increment
        if self._is_pressed("right"):
            move = (move if move is not None else 0) + camera.direction_right() * increment
        if self._is_pressed("left"):
            move = (move if move is not None else 0) - camera.direction_right() * increment
        if self._is_pressed("shift"):
            move = (move if move is not None else 0) - camera.up() * increment
        if self._is_pressed("space"):
            move = (move if move is not None else 0) + camera.up() * increment
        if move is not None:
            camera = dataclasses.replace(camera, eye=eye + move)
            changed = True

        if self._mouse_ctrl_delta != [0.0, 0.0]:
            camera = dataclasses.replace(
                camera,
                sun_angle=LightAngle(
                    theta=float(camera.sun_angle.theta) + self._mouse_ctrl_delta[0],
                    phi=float(camera.sun_angle.phi) + self._mouse_ctrl_delta[1],
                ),
            )
            self._mouse_ctrl_delta = [0.0, 0.0]
            changed = True

        if self._mouse_view_delta != [0.0, 0.0]:
            camera = camera.rotate_yaw(-self._mouse_view_delta[0] * 0.01)
            camera = camera.rotate_pitch(self._mouse_view_delta[1] * 0.01)
            self._mouse_view_delta = [0.0, 0.0]
            changed = True

        if self._touch_single_delta != [0.0, 0.0]:
            camera = dataclasses.replace(
                camera,
                eye=f32(camera.eye)
                + camera.direction() * (MOVE_SCALING * self._touch_single_delta[1])
                - camera.direction_right() * (MOVE_SCALING * self._touch_single_delta[0]),
            )
            self._touch_single_delta = [0.0, 0.0]
            changed = True

        while self._events:
            ev = self._events.popleft()
            if ev[0] == "toggle_view_mode":
                camera = camera.toggle_view_mode()
                changed = True
            elif ev[0] == "pinch":
                rot, new_fov = get_rotation_and_fov_change(
                    ev[1], ev[2], float(camera.fov_y), size
                )
                if rot != 0.0 or new_fov != 0.0:
                    camera = camera.rotate_yaw(-rot).with_fovy(new_fov)
                    changed = True

        if self._touch_multi_start is not None and isinstance(self._touch, tuple):
            p1, p2, _ = self._touch
            rot, new_fov = get_rotation_and_fov_change(
                self._touch_multi_start,
                ((p1.x, p1.y), (p2.x, p2.y)),
                float(camera.fov_y),
                size,
            )
            if rot != 0.0 or new_fov != 0.0:
                camera = camera.rotate_yaw(-rot).with_fovy(new_fov)
                changed = True
            self._touch_multi_start = ((p1.x, p1.y), (p2.x, p2.y))

        return camera, changed


def get_rotation_and_fov_change(start, end, fov, size):
    """Two-finger pinch: yaw rotation + fov rescale
    (`camera_controller.rs:472-497`).

    ``start``/``end`` are ((x1, y1), (x2, y2)) finger-position pairs.
    """
    (s1x, _), (s2x, _) = start
    (e1x, _), (e2x, _) = end
    if abs(int(e2x - e1x)) < 1:
        return (0.0, fov)
    fov_p = (s2x - s1x) / (e2x - e1x) * fov
    h = float(size[1])
    angle_change = (
        fov
        / h
        / (e2x - e1x)
        * ((s1x * e2x - e1x * s2x) + 0.5 * h * (s2x - s1x - e2x + e1x))
    )
    return (angle_change, fov_p)
