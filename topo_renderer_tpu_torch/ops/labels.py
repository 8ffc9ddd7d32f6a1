"""Peak-label visibility against the panorama depth buffer.

Port of `topo_renderer_tpu/ops/labels.py::peak_visibility_panorama`: peaks
project via azimuth/elevation around the eye, and a peak is visible iff its
distance minus the tolerance is closer than the terrain distance at its
pixel (`render_engine.rs:372-376`'s 10 m, plus ``tolerance_rel`` of the
distance for LOD renders). Only the visibility vector and pixel positions
reach the host.
"""

from __future__ import annotations

import math

import torch

from topo_renderer_tpu_torch.models.camera import dist_from_depth
from topo_renderer_tpu_torch.ops.geometry import f32
from topo_renderer_tpu_torch.ops.mathx import norm

OCCLUSION_TOLERANCE_M = 10.0  # `render_engine.rs:374`


def peak_visibility_panorama(
    positions,
    valid,
    eye,
    spec,
    depth,
    azimuth_offset=0.0,
    elev_offset=0.0,
    tolerance_rel: float = 0.0,
):
    """Visibility + pixel positions of a padded peak array.

    ``positions f32[P, 3]`` ECEF, ``valid bool[P]``, ``depth f32[H, W]``.
    Returns ``{"visible" bool[P], "x" i32[P], "y" i32[P], "in_frustum"}``.
    """
    dev = depth.device
    W, H = spec.width, spec.height
    e_norm = norm(eye)
    up = eye / e_norm
    lon0 = torch.atan2(eye[1], eye[0])
    lat0 = torch.asin(torch.clamp(eye[2] / e_norm, -1.0, 1.0))
    east = torch.stack([-torch.sin(lon0), torch.cos(lon0), torch.zeros_like(lon0)])
    north = torch.stack(
        [-torch.sin(lat0) * torch.cos(lon0), -torch.sin(lat0) * torch.sin(lon0), torch.cos(lat0)]
    )

    w = positions - eye
    dist = norm(w)

    def dot(v):
        return w[:, 0] * v[0] + w[:, 1] * v[1] + w[:, 2] * v[2]

    w_up, w_n, w_e = dot(up), dot(north), dot(east)
    azimuth = torch.atan2(w_e, w_n)  # 0 = north, increasing eastward
    elev = torch.asin(torch.clamp(w_up / torch.clamp(dist, min=1e-6), -1.0, 1.0))

    rel = (azimuth - spec.azimuth_start - f32(azimuth_offset, dev)) % (2.0 * math.pi)
    u = rel / spec.azimuth_span
    e_lo, e_hi = spec.elevation_range()
    v = (f32(elev_offset, dev) + f32(e_hi, dev) - elev) / f32(e_hi - e_lo, dev)

    x = (u * W).to(torch.int32)
    y = (v * H).to(torch.int32)
    in_view = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0) & valid

    xc = torch.clamp(x, 0, W - 1).long()
    yc = torch.clamp(y, 0, H - 1).long()
    terrain_dist = dist_from_depth(depth[yc, xc])
    tol = OCCLUSION_TOLERANCE_M + f32(tolerance_rel, dev) * dist
    visible = in_view & (dist - tol < terrain_dist)
    return {"visible": visible, "x": x, "y": y, "in_frustum": in_view}
