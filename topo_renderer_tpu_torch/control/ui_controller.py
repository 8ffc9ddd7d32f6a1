"""UI controller: location changes -> tile neighborhood diff -> fetch requests.

Copy of `topo_renderer_tpu/control/ui_controller.py` for the PyTorch port; it imports nothing
of the JAX package.

Parity with `topo-renderer/src/control/ui_controller.rs`:
  * ``get_locations_range(location, 100 km)`` computes the 1°-tile
    neighborhood via great-circle half-chord math
    (`ui_controller.rs:61-83`), sorted nearest-to-center first with
    longitude wrapping;
  * ``change_location`` diffs the new neighborhood against the loaded set,
    unloads leavers and emits ``DataRequested`` events for newcomers
    (`ui_controller.rs:23-59`).

Note on the center used for the request ordering: the reference computes
``(lat.floor() as i32).min(-90).max(89)`` (`ui_controller.rs:64`), whose Rust
`min`/`max`-chain pins the latitude component to 89 for every input — the
request *order* is therefore mostly longitude-driven. We replicate it
verbatim (it only prioritizes fetches; the tile *set* is unaffected).
"""

from __future__ import annotations

import math
from typing import Callable

from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.ops.geometry import R0

TILE_RANGE_M = 100_000.0  # `ui_controller.rs:30`


def get_locations_range(location: GeoCoord, range_dist: float = TILE_RANGE_M) -> list[GeoLocation]:
    """All 1°x1° tiles within ``range_dist`` of the viewpoint
    (`ui_controller.rs:61-83`)."""
    center = (
        max(min(math.floor(location.latitude), -90), 89),  # reference quirk
        (math.floor(location.longitude) + 540) % 360 - 180,
    )
    lat_cos = math.cos(math.radians(location.latitude))
    arc_factor = 0.5 * range_dist / R0
    afs = math.sin(arc_factor)
    afs_sq = afs * afs
    # Near the poles 1 - afs^2/cos^2(lat) drops below -1; the reference's f32
    # acos yields NaN there and its casts flush to 0 — Python's math.acos
    # would raise instead, so clamp and cover the whole longitude ring.
    dlon_arg = 1.0 - afs_sq / lat_cos / lat_cos if lat_cos > 1e-9 else -1.0
    dlon = math.degrees(math.acos(max(min(dlon_arg, 1.0), -1.0)))
    dlat = math.degrees(math.acos(max(min(1.0 - afs_sq, 1.0), -1.0)))
    lat_start = max(math.floor(location.latitude - dlat), -90)
    lat_end = min(math.floor(location.latitude + dlat), 89)
    lon_start = math.floor(location.longitude - dlon)
    lon_end = math.floor(location.longitude + dlon)

    pairs = [
        (lat, lon)
        for lat in range(lat_start, lat_end + 1)
        for lon in range(lon_start, lon_end + 1)
    ]
    pairs.sort(key=lambda p: (abs(p[0] - center[0]), abs(p[1] - center[1])))
    return [
        GeoLocation.from_coord(lat, (lon + 540) % 360 - 180) for lat, lon in pairs
    ]


class UiController:
    """Streams the tile working set as the viewpoint moves
    (`ui_controller.rs:17-59`)."""

    def __init__(self, request_tile: Callable[[GeoLocation, GeoCoord], None]):
        self._request_tile = request_tile

    def change_location(self, location: GeoCoord, data, engine) -> None:
        """``data`` is the ApplicationData (has ``current_location`` and
        ``loaded_locations``); ``engine`` must expose ``unload_terrain``."""
        data.current_location = location
        new_locations = set(get_locations_range(location, TILE_RANGE_M))

        to_unload = []
        for loc in data.loaded_locations:
            if loc in new_locations:
                new_locations.remove(loc)
            else:
                to_unload.append(loc)

        for loc in to_unload:
            data.loaded_locations.discard(loc)
            engine.unload_terrain(loc)

        # Preserve the sorted (nearest-first) request order.
        ordered = [
            loc for loc in get_locations_range(location, TILE_RANGE_M)
            if loc in new_locations
        ]
        for requested in ordered:
            self._request_tile(requested, location)
