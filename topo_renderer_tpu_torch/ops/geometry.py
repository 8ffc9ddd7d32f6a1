"""Sphere geometry: geographic coordinates -> ECEF positions.

Port of `topo_renderer_tpu/ops/geometry.py` (parity with
`topo-renderer/src/render/geometry.rs:5,12-20`): the Earth is a sphere of
radius R0 = 6,371,000 m; a point at longitude λ, latitude φ and height h sits
at r = R0 + h, x = r cos φ cos λ, y = r cos φ sin λ, z = r sin φ.

All functions take float32 tensors and broadcast over leading axes.
"""

from __future__ import annotations

import math

import torch

R0 = 6_371_000.0


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)`` without stalling the host on a host-to-GPU copy: a
    copy from pageable memory waits for all the work queued on the stream,
    a copy from pinned memory is queued behind it."""
    if device is None:
        return t
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def f32(x, device=None) -> torch.Tensor:
    """Python number or tensor -> float32 tensor (the JAX package's
    ``jnp.float32(x)``) on ``device`` (`to_device`)."""
    return to_device(torch.as_tensor(x, dtype=torch.float32), device)


def radians(x: torch.Tensor) -> torch.Tensor:
    """``jnp.radians``: one float32 multiply by f32(pi/180)."""
    return x * f32(math.pi / 180.0, x.device)


def degrees(x: torch.Tensor) -> torch.Tensor:
    """``jnp.degrees``: one float32 multiply by f32(180/pi)."""
    return x * f32(180.0 / math.pi, x.device)


def ecef_from_geo(height, longitude_deg, latitude_deg):
    """`geometry::transform` (`geometry.rs:12-20`): (h, lon°, lat°) -> ECEF [...,3].

    A float32 ``height`` is added to R0 in float32. A Python number or a
    float64 tensor is added in float64 and the sum rounded once to float32,
    as the JAX package's Python-float ``R0 + height`` is before its weak
    type meets the float32 products."""
    longitude_deg, latitude_deg = (
        f32(v) if not isinstance(v, torch.Tensor) else v for v in (longitude_deg, latitude_deg)
    )
    if isinstance(height, torch.Tensor) and height.dtype == torch.float32:
        r = R0 + height
    else:
        r = (R0 + torch.as_tensor(height, dtype=torch.float64)).to(torch.float32)
    lon = radians(longitude_deg)
    lat = radians(latitude_deg)
    cos_lat = torch.cos(lat)
    return torch.stack(
        [r * cos_lat * torch.cos(lon), r * cos_lat * torch.sin(lon), r * torch.sin(lat)],
        dim=-1,
    )


def geo_from_ecef(p):
    """Inverse mapping: ECEF [..., 3] -> (height, lon°, lat°); the norm sums
    its squares in index order."""
    p = torch.as_tensor(p, dtype=torch.float32)
    r = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2])
    lat = degrees(torch.asin(torch.clamp(p[..., 2] / r, -1.0, 1.0)))
    lon = degrees(torch.atan2(p[..., 1], p[..., 0]))
    return r - R0, lon, lat


def local_frame(lon_deg, lat_deg):
    """Orthonormal (east, north, up) at a geographic position, ECEF axes
    (the reference gets the same from its camera's quaternions,
    `camera.rs:99-116`)."""
    lon = radians(torch.as_tensor(lon_deg, dtype=torch.float32))
    lat = radians(torch.as_tensor(lat_deg, dtype=torch.float32))
    sin_lon, cos_lon = torch.sin(lon), torch.cos(lon)
    sin_lat, cos_lat = torch.sin(lat), torch.cos(lat)
    east = torch.stack([-sin_lon, cos_lon, torch.zeros_like(sin_lon)], dim=-1)
    north = torch.stack([-sin_lat * cos_lon, -sin_lat * sin_lon, cos_lat], dim=-1)
    up = torch.stack([cos_lat * cos_lon, cos_lat * sin_lon, sin_lat], dim=-1)
    return east, north, up
