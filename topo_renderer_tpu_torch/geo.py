"""Geographic primitive types: 1°x1° tile ids and fractional coordinates.

Parity with the reference crate `topo-common` (`topo-common/src/lib.rs:7-173`):
  * ``Latitude`` / ``Longitude`` — integer degree + hemisphere direction
    (`lib.rs:19-29`).
  * ``GeoLocation`` — identifies one 1°x1° DEM tile (`lib.rs:31-37`).
  * ``GeoCoord`` — fractional lat/lon in degrees, float32 semantics
    (`lib.rs:39-43`).
  * ``GeoLocation.from_coord`` — floor()-based tile id from signed integers
    (`lib.rs:100-119`).
  * ``to_request_params`` — ``"latitude=49N&longitude=20E"`` query-string
    encoding used by the tile backend (`lib.rs:121-123`).
  * string parsing of ``"49N"``-style values (`lib.rs:139-173`), surfaced here
    both as ``parse_latitude``/``parse_longitude`` and via ``GeoLocation.from_json``.

Ordering of ``GeoLocation`` replicates the reference's derived Ord so that
iteration order over tile maps (and therefore label-layout priority) matches:
Rust derives Ord field-by-field — degree first, then direction with S < N and
W < E (enum declaration order, `lib.rs:7-17`).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import Iterable


class LatitudeDirection(enum.IntEnum):
    """Hemisphere for latitude. Declaration order S, N gives S < N like the
    reference enum (`topo-common/src/lib.rs:8-11`)."""

    S = 0
    N = 1


class LongitudeDirection(enum.IntEnum):
    """Hemisphere for longitude; W < E (`topo-common/src/lib.rs:13-17`)."""

    W = 0
    E = 1


@dataclasses.dataclass(frozen=True, order=True)
class Latitude:
    degree: int
    direction: LatitudeDirection

    def to_float(self) -> float:
        # `topo-common/src/lib.rs:45-52`
        return float(self.degree) if self.direction == LatitudeDirection.N else -float(self.degree)

    def __str__(self) -> str:
        # `topo-common/src/lib.rs:69-73`
        return f"{self.degree}{self.direction.name}"


@dataclasses.dataclass(frozen=True, order=True)
class Longitude:
    degree: int
    direction: LongitudeDirection

    def to_float(self) -> float:
        # `topo-common/src/lib.rs:54-61`
        return float(self.degree) if self.direction == LongitudeDirection.E else -float(self.degree)

    def __str__(self) -> str:
        return f"{self.degree}{self.direction.name}"


def parse_latitude(s: str) -> Latitude:
    """Parse ``"49N"`` / ``"12S"`` (`topo-common/src/lib.rs:139-146,157-173`)."""
    degree, direction = _parse_degree_direction(s, LatitudeDirection)
    return Latitude(degree, direction)


def parse_longitude(s: str) -> Longitude:
    """Parse ``"20E"`` / ``"3W"`` (`topo-common/src/lib.rs:148-155`)."""
    degree, direction = _parse_degree_direction(s, LongitudeDirection)
    return Longitude(degree, direction)


def _parse_degree_direction(s: str, direction_enum):
    if not s:
        raise ValueError("Can't deserialize empty string to degree and direction")
    deg_str, dir_str = s[:-1], s[-1:]
    try:
        direction = direction_enum[dir_str]
    except KeyError as e:
        raise ValueError(f"invalid direction {dir_str!r} in {s!r}") from e
    return int(deg_str), direction


@dataclasses.dataclass(frozen=True, order=True)
class GeoLocation:
    """Identity of one 1°x1° DEM tile (`topo-common/src/lib.rs:31-37`)."""

    latitude: Latitude
    longitude: Longitude

    @staticmethod
    def from_coord(latitude: int, longitude: int) -> "GeoLocation":
        """Signed integer degrees -> tile id (`topo-common/src/lib.rs:100-119`).

        Matches the reference exactly, including `signum() > 0` meaning that
        latitude/longitude 0 maps to the S/W hemisphere label (``0S``/``0W``).
        """
        return GeoLocation(
            Latitude(
                abs(latitude),
                LatitudeDirection.N if latitude > 0 else LatitudeDirection.S,
            ),
            Longitude(
                abs(longitude),
                LongitudeDirection.E if longitude > 0 else LongitudeDirection.W,
            ),
        )

    @staticmethod
    def from_geo_coord(coord: "GeoCoord") -> "GeoLocation":
        # `topo-common/src/lib.rs:82-89`: floor() of fractional coordinates.
        return GeoLocation.from_coord(
            math.floor(coord.latitude), math.floor(coord.longitude)
        )

    @staticmethod
    def from_json(payload: str | dict) -> "GeoLocation":
        """Deserialize ``{"latitude": "49N", "longitude": "20E"}``
        (`topo-common/src/lib.rs:31-37,139-173`)."""
        if isinstance(payload, str):
            payload = json.loads(payload)
        return GeoLocation(
            parse_latitude(payload["latitude"]),
            parse_longitude(payload["longitude"]),
        )

    def to_request_params(self) -> str:
        # `topo-common/src/lib.rs:121-123`
        return f"latitude={self.latitude}&longitude={self.longitude}"

    def to_numerical(self) -> tuple[float, float]:
        # `topo-common/src/lib.rs:125-127` — returns (latitude, longitude).
        return (self.latitude.to_float(), self.longitude.to_float())

    def to_geo_coord(self) -> "GeoCoord":
        # `topo-common/src/lib.rs:91-98`
        return GeoCoord(self.latitude.to_float(), self.longitude.to_float())


@dataclasses.dataclass(frozen=True)
class GeoCoord:
    """Fractional latitude/longitude in degrees (`topo-common/src/lib.rs:39-43`)."""

    latitude: float
    longitude: float

    def to_lon_lat(self) -> tuple[float, float]:
        # `topo-common/src/lib.rs:63-67` — (longitude, latitude) f64 pair.
        return (float(self.longitude), float(self.latitude))


def sort_locations(locations: Iterable[GeoLocation]) -> list[GeoLocation]:
    """Sort tile ids in the reference's BTreeMap iteration order."""
    return sorted(locations)
