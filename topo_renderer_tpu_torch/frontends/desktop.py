"""Desktop frontend: a windowed live free-fly viewer.

Copy of `topo_renderer_tpu/frontends/desktop.py` for the PyTorch port,
itself the counterpart of `topo-renderer-desktop/src/main.rs:7-66`: the
reference opens an 800x600 winit/X11 window, spawns the background runner
on a tokio runtime, logs background notifications, and hands input to the
camera controller. This drives the same `Application` loop (`app/`) under
a Tk window (stdlib — no extra display deps beyond a running X server):

  * keyboard WASD / Q / E / Shift / Space move exactly as the reference's
    `CameraController` defines (`camera_controller.rs:120-341`) — the
    controller instance is shared with every other frontend;
  * right-mouse drag looks, Ctrl + drag moves the sun, F toggles view mode
    (all via the same window-system-agnostic events, `control/events.py`);
  * background notifications stream into the window title, matching the
    reference desktop's notification logging (`main.rs:26-60`).

The Tk shell is deliberately thin: every frame decision lives in
`DesktopFrontend.render_frame()` / `feed_*`, which tests drive headlessly
(`tests/test_torch_desktop.py`); only `run()` imports and touches Tk. On a
machine without a display, use the browser free-fly frontend
(`frontends/web`) instead. Frames render on the CUDA device unless
``device`` names another (`--device cpu`).
"""

from __future__ import annotations

import time

import numpy as np

from topo_renderer_tpu_torch.app.application import Application
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.control.events import (
    Key,
    KeyInput,
    MouseButtonInput,
    MouseMotion,
)
from topo_renderer_tpu_torch.geo import GeoCoord

_KEYSYM_TO_KEY = {
    "w": Key.W, "a": Key.A, "s": Key.S, "d": Key.D,
    "q": Key.Q, "e": Key.E, "f": Key.F,
    "Up": Key.UP, "Down": Key.DOWN, "Left": Key.LEFT, "Right": Key.RIGHT,
    "space": Key.SPACE,
    "Shift_L": Key.SHIFT, "Shift_R": Key.SHIFT,
    "Control_L": Key.CTRL, "Control_R": Key.CTRL,
}


class DesktopFrontend:
    """Owns the application loop; the Tk window is attached by `run()`."""

    def __init__(
        self,
        settings: Settings | None = None,
        width: int = 800,  # reference desktop default (main.rs:12-16)
        height: int = 600,
        target_fps: float = 30.0,
        device=None,
    ):
        self.app = Application(settings, device=device)
        self.app.viewport = (width, height)
        self.width, self.height = width, height
        self.target_fps = target_fps
        self.status = ""
        self._notes = self.app.subscribe_to_background_notifications()
        self._drag_last: tuple[float, float] | None = None

    # ---- headless-testable core -----------------------------------------

    def feed_key(self, keysym: str, pressed: bool) -> None:
        key = _KEYSYM_TO_KEY.get(keysym)
        if key is not None:
            self.app.process_input(KeyInput(key, pressed))

    def feed_mouse_button(self, button: str, pressed: bool) -> None:
        self.app.process_input(MouseButtonInput(button, pressed))
        if not pressed:
            self._drag_last = None

    def feed_mouse_position(self, x: float, y: float) -> None:
        """Absolute pointer position during a drag -> relative motion (the
        controller consumes winit-style deltas)."""
        if self._drag_last is not None:
            dx = x - self._drag_last[0]
            dy = y - self._drag_last[1]
            self.app.process_device_input(MouseMotion(dx, dy))
        self._drag_last = (x, y)

    def drain_notifications(self) -> str:
        """Latest background status line (reference main.rs:26-60 logging)."""
        while True:
            try:
                note = self._notes.get_nowait()
            except Exception:
                break
            if note.kind == "task_errored":
                self.status = f"error: {note.error}"
            else:
                self.status = f"{note.running} background task(s)"
        return self.status

    def render_frame(self):
        """One application step -> sRGB u8 frame on the host (or None
        pre-terrain)."""
        res = self.app.step(fast=True, host_copy=False)
        return None if res is None else np.asarray(res.color)

    # ---- Tk shell --------------------------------------------------------

    def run(self, location: GeoCoord | None = None) -> None:
        import tkinter as tk

        from PIL import Image, ImageTk

        self.app.start(location)
        self.app.wait_for_terrain()

        root = tk.Tk()
        root.title("topo-renderer")
        label = tk.Label(root)
        label.pack()

        root.bind("<KeyPress>", lambda e: self.feed_key(e.keysym, True))
        root.bind("<KeyRelease>", lambda e: self.feed_key(e.keysym, False))
        for btn, name in ((1, "left"), (2, "middle"), (3, "right")):
            root.bind(
                f"<ButtonPress-{btn}>",
                lambda e, n=name: (
                    self.feed_mouse_button(n, True),
                    self.feed_mouse_position(e.x, e.y),
                ),
            )
            root.bind(
                f"<ButtonRelease-{btn}>",
                lambda e, n=name: self.feed_mouse_button(n, False),
            )
            root.bind(
                f"<B{btn}-Motion>",
                lambda e: self.feed_mouse_position(e.x, e.y),
            )

        period_ms = max(1, int(1000.0 / self.target_fps))
        state = {"photo": None, "frames": 0, "t0": time.monotonic()}

        def tick():
            frame = self.render_frame()
            if frame is not None:
                img = Image.fromarray(frame, "RGB")
                state["photo"] = ImageTk.PhotoImage(img)
                label.configure(image=state["photo"])
                state["frames"] += 1
            status = self.drain_notifications()
            fps = state["frames"] / max(time.monotonic() - state["t0"], 1e-3)
            root.title(f"topo-renderer — {fps:.1f} fps — {status}")
            root.after(period_ms, tick)

        root.after(period_ms, tick)
        try:
            root.mainloop()
        finally:
            self.app.shutdown()


def main():
    import argparse

    p = argparse.ArgumentParser(description="topo-renderer desktop viewer (PyTorch port)")
    p.add_argument("--lat", type=float, default=None)
    p.add_argument("--lon", type=float, default=None)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--settings", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where frames render (cuda raises without CUDA)")
    args = p.parse_args()
    settings = Settings.load(path=args.settings)
    loc = (
        GeoCoord(args.lat, args.lon)
        if args.lat is not None and args.lon is not None
        else None
    )
    device = None if args.device == "cuda" else args.device
    DesktopFrontend(settings, width=args.width, height=args.height, device=device).run(loc)


if __name__ == "__main__":
    main()
