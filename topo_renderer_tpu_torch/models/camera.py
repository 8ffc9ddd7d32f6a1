"""Camera model: ECEF free-fly camera on the sphere.

Port of `topo_renderer_tpu/models/camera.py` (parity with
`topo-renderer/src/data/camera.rs`): NEAR=50, FAR=500,000, FOV 45° clamped to
[10°, 160°]; ``up`` = normalized eye; ``direction`` rotates a pitch/yaw
direction from the canonical frame (whose "up" is (0,-1,0)) onto the local
frame by a shortest-arc quaternion (`camera.rs:99-111`); view = glam
``look_to_rh``, projection = ``perspective_rh`` with 0..1 depth
(`camera.rs:118-128`).

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

    def toggle(self) -> "ViewMode":
        # `camera.rs:25-32`
        return ViewMode((int(self) + 1) % 3)


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

    def direction_right(self):
        # `camera.rs:113-115`: rotate direction -90° about up.
        q = mathx.quat_from_axis_angle(self.up(), f32(-0.5 * math.pi))
        return mathx.quat_rotate(q, self.direction())

    def direction_down(self):
        # `camera.rs:117`
        return -self.up()

    # -- matrices ---------------------------------------------------------

    def get_view(self):
        # `camera.rs:118-120`
        return mathx.look_to_rh(f32(self.eye), self.direction(), self.up())

    def build_view_proj_matrix(self, width, height):
        # `camera.rs:122-128`
        aspect = f32(width) / f32(height)
        proj = mathx.perspective_rh(f32(self.fov_y), aspect, f32(self.near), f32(self.far))
        return mathx.mat4_mul(proj, self.get_view())

    def build_view_normal_matrix(self):
        # `camera.rs:130-132`
        return torch.linalg.inv(self.get_view()).T

    def position(self):
        # `camera.rs:134-136`: vec4(eye, 0)
        return torch.cat([f32(self.eye), torch.zeros(1, dtype=torch.float32)])

    # -- functional "mutators" -------------------------------------------

    def reset(self, coord: GeoCoord, height) -> "Camera":
        # `camera.rs:88-93`: move to the location and put the sun at its zenith.
        eye = ecef_from_geo(f32(height), f32(coord.longitude), f32(coord.latitude))
        return dataclasses.replace(
            self, eye=eye, sun_angle=LightAngle(theta=coord.longitude, phi=coord.latitude)
        )

    def with_fovy(self, fov) -> "Camera":
        # clamp [10°, 160°] (`camera.rs:160-162`)
        return dataclasses.replace(self, fov_y=torch.clamp(f32(fov), MIN_FOV, MAX_FOV))

    def rotate_yaw(self, clockwise_rotation) -> "Camera":
        # `camera.rs:164-166`
        return dataclasses.replace(self, yaw=f32(self.yaw) + clockwise_rotation)

    def rotate_pitch(self, clockwise_rotation) -> "Camera":
        # `camera.rs:168-172`: the reference only guards the +90° side; the
        # rotation is skipped entirely when it would exceed it.
        new_pitch = f32(self.pitch) + clockwise_rotation
        pitch = torch.where(new_pitch <= radians(f32(90.0)), new_pitch, f32(self.pitch))
        return dataclasses.replace(self, pitch=pitch)

    def toggle_view_mode(self) -> "Camera":
        return dataclasses.replace(self, view_mode=self.view_mode.toggle())
