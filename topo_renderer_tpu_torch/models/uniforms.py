"""Tile rotations and peak instances.

Port of the parts of `topo_renderer_tpu/models/uniforms.py` the panorama
path uses (parity with `topo-renderer/src/render/data.rs`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from topo_renderer_tpu_torch.ops import mathx
from topo_renderer_tpu_torch.ops.geometry import f32, radians


def normal_to_world_rotation(model_lon_deg, model_lat_deg):
    """Tile-local normal frame -> ECEF rotation (`data.rs:120-127`), built
    from the tile tiepoint's (longitude, latitude). Returns ``f32[4, 4]``."""
    m3 = mathx.mat3_from_euler_xyz_ex(
        f32(0.0), radians(90.0 - f32(model_lat_deg)), radians(f32(model_lon_deg))
    )
    return mathx.mat4_from_mat3(m3)


@dataclasses.dataclass
class PeakInstance:
    """Host-side peak instance (`data.rs:96-111`): ECEF position (+10 m
    offset applied at construction, `background_runner.rs:158`), label text,
    and the latest visibility decision."""

    position: Any
    name: str
    visible: bool = False
