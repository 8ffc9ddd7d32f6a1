"""Peak-label visibility against the frame's depth buffer.

Port of `topo_renderer_tpu/ops/labels.py`. ``peak_visibility`` projects
peaks with the camera's view-projection (perspective frames),
``peak_visibility_panorama`` via azimuth/elevation around the eye. A peak
is visible iff its distance minus the tolerance is closer than the terrain
distance at its pixel (`render_engine.rs:372-376`'s 10 m, plus
``tolerance_rel`` of the distance for LOD renders). Only the visibility
vector and pixel positions reach the host.
"""

from __future__ import annotations

import math

import torch

from topo_renderer_tpu_torch.models.camera import dist_from_depth
from topo_renderer_tpu_torch.ops.geometry import f32
from topo_renderer_tpu_torch.ops.mathx import norm, rows_times_mat_t

OCCLUSION_TOLERANCE_M = 10.0  # `render_engine.rs:374`
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def to_int32_saturating(x):
    """float32 -> int32 as XLA converts: truncation toward zero, out-of-range
    values and ±inf saturate, NaN gives 0. Torch's own conversion gives
    INT32_MIN for all of those on the CPU and saturates on CUDA; a peak near
    or behind the eye plane projects to such values, and they reach the
    wire's label bytes."""
    big = x >= 2.0**31
    small = x < -(2.0**31)
    out = torch.where(big | small | torch.isnan(x), 0.0, x).to(torch.int32)
    out = torch.where(big, _I32_MAX, out)
    return torch.where(small, _I32_MIN, out)


def peak_visibility(positions, valid, view_proj, depth, *, width: int, height: int,
                    tolerance_rel: float = 0.0):
    """Visibility + screen positions of a padded peak array
    (`render_engine.rs:349-377`).

    ``positions f32[P, 3]`` ECEF, ``valid bool[P]``, ``view_proj f32[4, 4]``
    of the depth snapshot, ``depth f32[H, W]`` 0..1. The frustum test is
    -1 < ndc.x, ndc.y < 1 and ndc.z < 1 (no near-side test, as the
    reference); pixel x = trunc(0.5 (ndc.x + 1) W), y = trunc(-0.5 (ndc.y -
    1) H). Returns ``{"visible" bool[P], "x" i32[P], "y" i32[P],
    "in_frustum"}``.
    """
    ph = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=-1)
    clip = rows_times_mat_t(ph, view_proj)
    ndc = clip[:, :3] / clip[:, 3:4]
    in_frustum = (
        (ndc[:, 0] > -1.0) & (ndc[:, 0] < 1.0) & (ndc[:, 1] > -1.0) & (ndc[:, 1] < 1.0)
        & (ndc[:, 2] < 1.0) & valid
    )
    x = to_int32_saturating(0.5 * (ndc[:, 0] + 1.0) * width)
    y = to_int32_saturating(-0.5 * (ndc[:, 1] - 1.0) * height)
    xc = torch.clamp(x, 0, width - 1).long()
    yc = torch.clamp(y, 0, height - 1).long()
    terrain_dist = dist_from_depth(depth[yc, xc])
    peak_dist = dist_from_depth(ndc[:, 2])
    # The reference's 10 m assumes an exact depth buffer; LOD renders carry
    # a distance-proportional error, covered by ``tolerance_rel``.
    tol = OCCLUSION_TOLERANCE_M + f32(tolerance_rel, depth.device) * peak_dist
    visible = in_frustum & (peak_dist - tol < terrain_dist)
    return {"visible": visible, "x": x, "y": y, "in_frustum": in_frustum}


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
