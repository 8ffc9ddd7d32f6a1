"""Peak data model and fault-tolerant CSV reader.

Copy of `topo_renderer_tpu/data/peak.py` for the PyTorch port; it imports nothing
of the JAX package.

Parity with `topo-renderer/src/data/peak.rs`:
  * ``Peak`` record {latitude, longitude, name, elevation}, float32 semantics
    (`peak.rs:9-15`).
  * ``read_peaks`` parses the whole CSV and — like the reference
    (`peak.rs:46-64`) — aggregates *all* row errors into one exception rather
    than failing on the first.

CSV schema comes from the backend's ``/peaks`` endpoint
(`topo-backend/src/main.rs:31-61`): header ``latitude,longitude,name,elevation``.
"""

from __future__ import annotations

import csv
import dataclasses
import io
from typing import IO, Iterable

import numpy as np


@dataclasses.dataclass
class Peak:
    latitude: float
    longitude: float
    name: str
    elevation: float


class PeakCsvError(ValueError):
    """Aggregate of all row-level parse failures (`peak.rs:55-63`)."""

    def __init__(self, errors: list[Exception]):
        self.errors = errors
        msgs = "; ".join(str(e) for e in errors)
        super().__init__(
            f"encountered multiple errors while reading peaks csv: {msgs}"
        )


def read_peaks(source: str | bytes | IO) -> list[Peak]:
    """Parse a peaks CSV stream; collect every row error before raising.

    Mirrors `Peak::read_peaks` (`peak.rs:46-64`): if any record fails to
    deserialize, every failure is reported together. Values are cast through
    float32 to match the reference's f32 fields.
    """
    if isinstance(source, bytes):
        source = io.StringIO(source.decode("utf-8"))
    elif isinstance(source, str):
        source = io.StringIO(source)
    elif isinstance(source, io.BufferedIOBase) or (
        hasattr(source, "read") and isinstance(source.read(0), bytes)
    ):
        source = io.TextIOWrapper(source, encoding="utf-8")

    reader = csv.DictReader(source)
    peaks: list[Peak] = []
    errors: list[Exception] = []
    for i, row in enumerate(reader):
        try:
            if row.get("latitude") is None or row.get("elevation") is None:
                raise ValueError(f"row {i}: missing fields in {row!r}")
            peaks.append(
                Peak(
                    latitude=float(np.float32(row["latitude"])),
                    longitude=float(np.float32(row["longitude"])),
                    name=row["name"],
                    elevation=float(np.float32(row["elevation"])),
                )
            )
        except (ValueError, TypeError, KeyError) as e:
            errors.append(e if isinstance(e, ValueError) else ValueError(str(e)))
    if errors:
        raise PeakCsvError(errors)
    return peaks


def sort_by_elevation_desc(peaks: Iterable[Peak]) -> list[Peak]:
    """Highest peaks first, as done right after fetch
    (`topo-renderer/src/control/background_runner.rs:142-147`)."""
    return sorted(peaks, key=lambda p: -p.elevation)
