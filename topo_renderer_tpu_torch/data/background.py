"""Background data pipeline: async tile fetch + decode + peak preparation.

Parity with `topo-renderer/src/control/background_runner.rs`:
  * consumes ``DataRequested{requested, current_location}`` events from a
    queue (`background_runner.rs:60-66,276-312`), a worker pool standing in
    for the tokio JoinSet;
  * per tile: parallel fetch of DEM + peaks (`:106-109`), GeoTIFF decode with
    geo-tag extraction (`:113-136`), peaks CSV parse, elevation-descending
    sort, per-peak terrain height lookup and ECEF transform with the +10 m
    offset (`:138-162`);
  * posts results back to the application as render events in the same
    order: ``reset_camera`` (if the requested tile contains the current
    location, with terrain height at that point, `:232-245`), then
    ``peaks_ready``, then ``terrain_ready`` (`:247-269`);
  * emits ``TaskStarted/TaskFinished/TaskErrored`` notifications on a
    broadcast fan-out with a live running count (`:80-86,276-312`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.data import fetch as fetch_mod
from topo_renderer_tpu_torch.data.coordinate_transform import (
    CoordinateTransform,
    get_height_value_at,
)
from topo_renderer_tpu_torch.data.peak import read_peaks, sort_by_elevation_desc
from topo_renderer_tpu_torch.data.tiff import read_geotiff
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo

PEAK_HEIGHT_OFFSET_M = 10.0  # `background_runner.rs:158`


@dataclasses.dataclass
class DataRequested:
    requested: GeoLocation
    current_location: GeoCoord


@dataclasses.dataclass
class BackgroundNotification:
    kind: str  # "task_started" | "task_finished" | "task_errored"
    name: str
    running: int
    error: str | None = None


def fetch_terrain(location: GeoLocation, settings: Settings):
    """Fetch + decode one tile (`background_runner.rs:99-168`).

    Returns ``(peaks, (heights, transform, size))`` where ``peaks`` is a list
    of PeakInstance sorted by elevation descending.
    """
    tiff_bytes = fetch_mod.get_tiff_from_http(settings.backend_url, location)
    peaks_bytes = fetch_mod.get_peaks_from_http(settings.backend_url, location)

    if tiff_bytes is None:
        raise ValueError("Empty terrain map for location")

    heights, info = read_geotiff(tiff_bytes)
    transform = CoordinateTransform.from_geo_tag_data(
        info.pixel_scale, info.tiepoint, info.model_transformation
    )
    size = (info.width, info.height)

    peaks: list[PeakInstance] = []
    if peaks_bytes is not None:
        records, heights_m = [], []
        for p in sort_by_elevation_desc(read_peaks(peaks_bytes)):
            h = get_height_value_at(heights, transform, size, p.longitude, p.latitude)
            if h is None:
                continue
            records.append(p)
            heights_m.append(h + PEAK_HEIGHT_OFFSET_M)
        if records:
            # float64 heights: R0 + h rounds once, as the JAX package's
            # Python-float sum does (`ecef_from_geo`).
            pos = ecef_from_geo(
                torch.tensor(heights_m, dtype=torch.float64),
                torch.tensor([p.longitude for p in records], dtype=torch.float32),
                torch.tensor([p.latitude for p in records], dtype=torch.float32),
            ).numpy()
            peaks = [PeakInstance(position=pos[i].copy(), name=p.name) for i, p in enumerate(records)]
    return peaks, (heights, transform, size)


class BackgroundRunner:
    """Worker pool around `fetch_terrain` with the reference's notification
    fan-out (`background_runner.rs:201-317`)."""

    def __init__(
        self,
        settings: Settings,
        post_event: Callable[[str, Any], None],
        max_workers: int = 8,
    ):
        self._settings = settings
        self._post = post_event
        self._events: "queue.Queue[DataRequested | None]" = queue.Queue(maxsize=128)
        self._subscribers: list["queue.Queue[BackgroundNotification]"] = []
        self._running = 0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._thread: threading.Thread | None = None

    # -- notifications (broadcast channel, `background_runner.rs:80-86`) ---

    def subscribe(self) -> "queue.Queue[BackgroundNotification]":
        q: "queue.Queue[BackgroundNotification]" = queue.Queue()
        self._subscribers.append(q)
        return q

    def _notify(self, kind: str, name: str, error: str | None = None):
        with self._lock:
            if kind == "task_started":
                self._running += 1
            else:
                self._running -= 1
            note = BackgroundNotification(kind, name, self._running, error)
        for q in self._subscribers:
            q.put(note)

    # -- event intake ------------------------------------------------------

    def send(self, event: DataRequested) -> None:
        self._events.put(event)

    def run(self) -> None:
        """Blocking event loop (`background_runner.rs:276-312`); usually
        started via :meth:`spawn`."""
        while True:
            ev = self._events.get()
            if ev is None:
                break
            self._pool.submit(self._process, ev)

    def spawn(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        # Join the dispatcher first: it exits on the sentinel, guaranteeing no
        # further pool.submit() races against pool.shutdown() (which would
        # raise "cannot schedule new futures after shutdown" and drop events).
        self._events.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)

    def idle(self) -> bool:
        """True when no task is running and no event is queued (a snapshot —
        callers polling for readiness should re-check after pumping)."""
        with self._lock:
            return self._running == 0 and self._events.empty()

    def drain(self, timeout: float = 60.0) -> None:
        """Wait until the queue is empty and the pool is idle (test helper)."""
        import time

        deadline = time.time() + timeout
        quiet = 0
        while time.time() < deadline:
            with self._lock:
                idle = self._running == 0 and self._events.empty()
            quiet = quiet + 1 if idle else 0
            if quiet >= 3:  # stayed idle across consecutive checks
                return
            time.sleep(0.02)
        raise TimeoutError("background runner did not drain")

    # -- per-tile task (`background_runner.rs:217-273`) --------------------

    def _process(self, ev: DataRequested) -> None:
        name = f"terrain fetching: {ev.requested.to_request_params()}"
        self._notify("task_started", name)
        try:
            peaks, (heights, transform, size) = fetch_terrain(
                ev.requested, self._settings
            )
            cur = ev.current_location
            if GeoLocation.from_geo_coord(cur) == ev.requested:
                h = get_height_value_at(
                    heights, transform, size, cur.longitude, cur.latitude
                )
                if h is not None:
                    self._post(
                        "reset_camera", {"location": cur, "height": float(h)}
                    )
            self._post("peaks_ready", {"location": ev.requested, "peaks": peaks})
            # Non-Latin peak names pull in their script's font
            # (`background_runner.rs:250-254`). Fire-and-forget on its own
            # thread: a slow font CDN (30 s/URL timeout) must never delay
            # terrain_ready — labels just use the fallback face until the
            # font registers. Failures never block tiles either way.
            try:
                from topo_renderer_tpu_torch.render.fonts import default_library
                from topo_renderer_tpu_torch.render.text import get_scripts

                scripts = get_scripts(p.name for p in peaks) - {"Latn"}
                if scripts:
                    threading.Thread(
                        target=default_library().load_additional_fonts,
                        args=(scripts,),
                        daemon=True,
                    ).start()
            except Exception:
                pass
            self._post(
                "terrain_ready",
                {
                    "location": ev.requested,
                    "heights": heights,
                    "transform": transform,
                    "size": size,
                },
            )
            self._notify("task_finished", name)
        except Exception as e:  # graceful degradation (`:291-308`)
            self._notify("task_errored", name, error=str(e))
