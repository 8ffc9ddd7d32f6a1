"""Camera model: ECEF free-fly camera on the sphere.

Port of `topo_renderer_tpu/models/camera.py` (parity with
`topo-renderer/src/data/camera.rs`): NEAR=50, FAR=500,000, FOV 45° clamped to
[10°, 160°]; ``up`` = normalized eye; ``direction`` rotates a pitch/yaw
direction from the canonical frame (whose "up" is (0,-1,0)) onto the local
frame by a shortest-arc quaternion (`camera.rs:99-111`).

The camera is immutable: ``reset`` returns a new camera. Its tensors live
on the CPU; the engine moves what it needs to its device.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any

import torch

from topo_renderer_tpu_torch.geo import GeoCoord
from topo_renderer_tpu_torch.ops import mathx
from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo, f32, radians

NEAR = 50.0
FAR = 500_000.0
MIN_FOV = math.radians(10.0)
MAX_FOV = math.radians(160.0)
DEFAULT_FOV = math.radians(45.0)


def dist_from_depth(depth):
    """0..1 perspective depth -> metric distance (`camera.rs:12-14`)."""
    return FAR * NEAR / (FAR - depth * (FAR - NEAR))


def depth_from_dist(dist):
    """Inverse of :func:`dist_from_depth` (algebraic inverse of
    `camera.rs:12-14`)."""
    return (FAR - FAR * NEAR / dist) / (FAR - NEAR)


class ViewMode(enum.IntEnum):
    DEFAULT = 0
    NORMALS = 1
    POSITION = 2


@dataclasses.dataclass(frozen=True)
class LightAngle:
    """Sun direction angles in degrees (`camera.rs:36-43`)."""

    theta: Any = 0.0
    phi: Any = 0.0

    def to_vec3(self):
        # `camera.rs:45-53`: Mat3::from_euler(XYZEx, 0, (90-phi)°, theta°) @ Z.
        m = mathx.mat3_from_euler_xyz_ex(
            f32(0.0), radians(90.0 - f32(self.phi)), radians(f32(self.theta))
        )
        return m @ torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: Any = dataclasses.field(default_factory=lambda: torch.zeros(3, dtype=torch.float32))
    pitch: Any = 0.0
    yaw: Any = 0.0
    fov_y: Any = DEFAULT_FOV
    near: Any = NEAR
    far: Any = FAR
    view_mode: ViewMode = ViewMode.DEFAULT
    sun_angle: LightAngle = dataclasses.field(
        default_factory=lambda: LightAngle(theta=45.0, phi=0.0)
    )

    def up(self):
        # `camera.rs:95-97`
        return mathx.normalize(f32(self.eye))

    def direction(self):
        # `camera.rs:99-111`
        rot = mathx.quat_from_rotation_arc(
            torch.tensor([0.0, -1.0, 0.0], dtype=torch.float32), self.up()
        )
        pitch = f32(self.pitch)
        yaw = f32(self.yaw)
        d = torch.stack(
            [torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch), torch.sin(yaw) * torch.cos(pitch)]
        )
        return mathx.quat_rotate(rot, d)

    def reset(self, coord: GeoCoord, height) -> "Camera":
        # `camera.rs:88-93`: move to the location and put the sun at its zenith.
        eye = ecef_from_geo(f32(height), f32(coord.longitude), f32(coord.latitude))
        return dataclasses.replace(
            self, eye=eye, sun_angle=LightAngle(theta=coord.longitude, phi=coord.latitude)
        )
