"""Uniforms, tile rotations and peak instances.

Port of `topo_renderer_tpu/models/uniforms.py` (parity with
`topo-renderer/src/render/data.rs`):
  * ``Uniforms`` {camera_proj, normal_proj, camera_pos, sun_direction,
    view_mode} (`data.rs:33-72`);
  * ``PostprocessingUniforms`` {viewport, pixelize_n} (`data.rs:74-94`);
    pixelize_n >= 100 disables pixelization;
  * ``TerrainUniforms`` {raster_point, model_point, pixel_scale, size,
    normal_to_world_rot} (`data.rs:113-152`), the rotation built from the
    tile's tiepoint (`data.rs:120-127`);
  * ``PeakInstance`` {position, name, visible} (`data.rs:96-111`).
The frames take their values straight from the camera and the mosaic; the
uniform records are the reference's data contract, kept for its callers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from topo_renderer_tpu_torch.ops import mathx
from topo_renderer_tpu_torch.ops.geometry import f32, radians


@dataclasses.dataclass(frozen=True)
class Uniforms:
    camera_proj: Any
    normal_proj: Any
    camera_pos: Any
    sun_direction: Any
    view_mode: Any

    @staticmethod
    def new(camera, width, height) -> "Uniforms":
        # `data.rs:42-58`
        return Uniforms(
            camera_proj=camera.build_view_proj_matrix(width, height),
            normal_proj=camera.build_view_normal_matrix(),
            camera_pos=camera.position(),
            sun_direction=camera.sun_angle.to_vec3(),
            view_mode=torch.tensor(int(camera.view_mode), dtype=torch.int32),
        )


@dataclasses.dataclass(frozen=True)
class PostprocessingUniforms:
    viewport: Any
    pixelize_n: Any = 100.0  # disabled (`application_data.rs:31`)

    @staticmethod
    def new(width, height, pixelize_n=100.0) -> "PostprocessingUniforms":
        return PostprocessingUniforms(
            viewport=torch.tensor([width, height], dtype=torch.float32),
            pixelize_n=f32(pixelize_n),
        )


def normal_to_world_rotation(model_lon_deg, model_lat_deg):
    """Tile-local normal frame -> ECEF rotation (`data.rs:120-127`), built
    from the tile tiepoint's (longitude, latitude). Returns ``f32[4, 4]``."""
    m3 = mathx.mat3_from_euler_xyz_ex(
        f32(0.0), radians(90.0 - f32(model_lat_deg)), radians(f32(model_lon_deg))
    )
    return mathx.mat4_from_mat3(m3)


@dataclasses.dataclass(frozen=True)
class TerrainUniforms:
    raster_point: Any
    model_point: Any
    pixel_scale: Any
    size: Any
    normal_to_world_rot: Any

    @staticmethod
    def new(transform, width: int, height: int) -> "TerrainUniforms":
        # `data.rs:119-151`
        return TerrainUniforms(
            raster_point=torch.tensor(transform.raster_point, dtype=torch.float32),
            model_point=torch.tensor(transform.model_point, dtype=torch.float32),
            pixel_scale=torch.tensor(transform.pixel_scale, dtype=torch.float32),
            size=torch.tensor([width, height], dtype=torch.float32),
            normal_to_world_rot=normal_to_world_rotation(transform.model_point[0], transform.model_point[1]),
        )


@dataclasses.dataclass
class PeakInstance:
    """Host-side peak instance (`data.rs:96-111`): ECEF position (+10 m
    offset applied at construction, `background_runner.rs:158`), label text,
    and the latest visibility decision."""

    position: Any
    name: str
    visible: bool = False
