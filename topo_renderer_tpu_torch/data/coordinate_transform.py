"""GeoTIFF raster <-> model (lon/lat) affine mapping and heightfield lookup.

Parity with `topo-renderer/src/common/coordinate_transform.rs`:
  * Built from ModelPixelScale + ModelTiepoint geo tags; the presence of a
    ModelTransformation tag is rejected (`coordinate_transform.rs:24-57`).
  * ``to_model`` / ``to_raster`` with the y axis negated (raster rows grow
    southward while latitude grows northward) (`coordinate_transform.rs:59-70`).
  * ``get_height_value_at`` — nearest lookup by float truncation
    (`coordinate_transform.rs:72-87`).

All arithmetic is float32 to match the reference's f32 fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class CoordinateTransformError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class CoordinateTransform:
    raster_point: tuple[float, float]
    model_point: tuple[float, float]
    pixel_scale: tuple[float, float]

    @staticmethod
    def from_geo_tag_data(
        pixel_scale_data,
        tie_points_data,
        model_transformation_data=None,
    ) -> "CoordinateTransform":
        """Validate and extract the affine transform from geo-tag payloads
        (`coordinate_transform.rs:24-57`)."""
        if model_transformation_data is not None:
            raise CoordinateTransformError(
                "Incorrect geo tags: only ModelPixelScaleTag and ModelTiepointTag "
                "without ModelTransformationTag supported"
            )
        if pixel_scale_data is None or tie_points_data is None:
            raise CoordinateTransformError(
                "Incorrect geo tags: only ModelPixelScaleTag and ModelTiepointTag "
                "without ModelTransformationTag supported"
            )
        if len(pixel_scale_data) != 3 or len(tie_points_data) != 6:
            raise CoordinateTransformError(
                "Incorrect geo tag data: ModelPixelScaleTag should have 3 and "
                "ModelTiepointTag should have 6 values"
            )
        psx, psy, _ = (np.float32(v) for v in pixel_scale_data)
        rx, ry, _, mx, my, _ = (np.float32(v) for v in tie_points_data)
        return CoordinateTransform(
            raster_point=(float(rx), float(ry)),
            model_point=(float(mx), float(my)),
            pixel_scale=(float(psx), float(psy)),
        )

    def to_model(self, coord: tuple[float, float]) -> tuple[float, float]:
        """(raster x, raster y) -> (longitude, latitude) (`coordinate_transform.rs:59-64`)."""
        x = (np.float32(coord[0]) - np.float32(self.raster_point[0])) * np.float32(
            self.pixel_scale[0]
        ) + np.float32(self.model_point[0])
        y = (np.float32(coord[1]) - np.float32(self.raster_point[1])) * -np.float32(
            self.pixel_scale[1]
        ) + np.float32(self.model_point[1])
        return (float(x), float(y))

    def to_raster(self, coord: tuple[float, float]) -> tuple[float, float]:
        """(longitude, latitude) -> (raster x, raster y) (`coordinate_transform.rs:66-70`)."""
        x = (np.float32(coord[0]) - np.float32(self.model_point[0])) / np.float32(
            self.pixel_scale[0]
        ) + np.float32(self.raster_point[0])
        y = (np.float32(coord[1]) - np.float32(self.model_point[1])) / -np.float32(
            self.pixel_scale[1]
        ) + np.float32(self.raster_point[1])
        return (float(x), float(y))


def get_height_value_at(
    height_map: np.ndarray,
    transform: CoordinateTransform,
    size: tuple[int, int],
    longitude: float,
    latitude: float,
) -> float | None:
    """Nearest-texel height lookup by float truncation
    (`coordinate_transform.rs:72-87`).

    ``height_map`` is the decoded heightfield — either flat ``[H*W]`` or
    ``[H, W]``; ``size`` is ``(width, height)`` like the reference's TIFF
    decoder dimensions. Returns ``None`` when out of bounds (the reference's
    ``vec.get(index)``).
    """
    rx, ry = transform.to_raster((float(longitude), float(latitude)))
    # Intentional divergence: Rust float->usize `as` casts *saturate* to 0
    # (since 1.45), so the reference returns the row/col-0 texel for slightly
    # negative raster coords; we treat out-of-raster points as missing, which
    # is the more correct behavior for a point outside the tile.
    if rx < 0 or ry < 0:
        return None
    ix, iy = int(rx), int(ry)
    width = int(size[0])
    flat = np.asarray(height_map).reshape(-1)
    index = iy * width + ix
    if index >= flat.shape[0]:
        return None
    return float(np.float32(flat[index]))
