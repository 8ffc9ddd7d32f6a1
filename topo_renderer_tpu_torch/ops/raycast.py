"""Perspective frames through the panorama engine.

Port of the fast path of `topo_renderer_tpu/ops/raycast.py`: per-pixel
camera rays (`camera_rays`), the static angular window of the fast frame
(`fast_view_spec`) and `render_perspective_fast`, which renders that window
as a panorama section centred on the view direction and warps it onto the
perspective pixel grid by each pixel's ray direction. The triangle-exact
march (`render_perspective`) belongs to the exact-frame slice of the port.
"""

from __future__ import annotations

import math

import torch

from topo_renderer_tpu_torch.models.camera import FAR, NEAR, Camera, depth_from_dist
from topo_renderer_tpu_torch.ops import mathx
from topo_renderer_tpu_torch.ops import shading as shd
from topo_renderer_tpu_torch.ops.geometry import f32
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, _eye_frame, render_panorama
from topo_renderer_tpu_torch.ops.postprocess import postprocess_soa

DEFAULT_FOV_HINT = 0.7853981633974483  # 45°


def camera_rays(camera: Camera, width: int, height: int, device=None):
    """World-space unit ray direction planes (dx, dy, dz) ``f32[H, W]`` for
    pixel centres on ``device``, plus the forward axis ``f32[3]`` there.

    The wgpu viewport mapping: ndc_x = 2(px+0.5)/W - 1, ndc_y = 1 -
    2(py+0.5)/H, camera axes from `look_to_rh` (s, u, -f). The axes are
    computed on the camera's (host) tensors and cross to ``device`` in one
    copy.
    """
    f = camera.direction()
    up = camera.up()
    s = mathx.normalize(mathx.cross(f, up))
    u = mathx.cross(s, f)
    tan_v = torch.tan(0.5 * f32(camera.fov_y))
    tan_h = tan_v * (f32(width) / f32(height))
    f, s, u, tan = f32(torch.stack([f, s, u, torch.stack([tan_v, tan_h, tan_h])]), device).unbind(0)
    tan_v, tan_h = tan[0], tan[1]

    ndc_x = (2.0 * (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width - 1.0)[None, :]
    ndc_y = (1.0 - 2.0 * (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height)[:, None]
    dx = f[0] + ndc_x * tan_h * s[0] + ndc_y * tan_v * u[0]
    dy = f[1] + ndc_x * tan_h * s[1] + ndc_y * tan_v * u[1]
    dz = f[2] + ndc_x * tan_h * s[2] + ndc_y * tan_v * u[2]
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (dx * inv, dy * inv, dz * inv), f


def fast_view_spec(
    *,
    width: int,
    height: int,
    fov_hint: float = DEFAULT_FOV_HINT,
    supersample: float = 1.25,
    n_steps: int = 384,
):
    """The panorama spec that `render_perspective_fast` renders, with the
    window's half height and azimuth span: ``(spec, half_win, az_span)``.

    Host arithmetic in Python floats, as the JAX package derives it, so the
    window's static shapes are the same: the window covers the frustum's
    diagonal half-angle plus a margin, at ``supersample`` x the pixel
    density; widths round up to 256, heights to 8.
    """
    half_diag = min(
        math.atan(math.tan(0.5 * float(fov_hint)) * math.sqrt(1.0 + (width / height) ** 2)),
        0.49 * math.pi,
    )
    half_win = min(1.03 * half_diag + 0.01, 0.49 * math.pi)
    az_span = min(2.0 * math.pi, 2.0 * half_win / max(math.cos(half_win), 0.3))
    px_per_rad = supersample * height / float(fov_hint)
    wp = max(256, min(int(math.ceil(az_span * px_per_rad / 256.0)) * 256, 8192))
    hp = max(64, min(int(math.ceil(2.0 * half_win * px_per_rad / 8.0)) * 8, 4096))
    spec = PanoramaSpec.fast(
        width=wp, height=hp, n_steps=n_steps,
        azimuth_start=-0.5 * az_span, azimuth_span=az_span,
        elev_min=-half_win, elev_max=half_win,
    )
    return spec, half_win, az_span


def _unpack_rgb(bits):
    return tuple(((bits >> s) & 0x3FF).to(torch.float32) / 1023.0 for s in (0, 10, 20))


def render_perspective_fast(
    mosaic,
    camera: Camera,
    *,
    width: int,
    height: int,
    supersample: float = 1.25,
    n_steps: int = 384,
    pixelize_n=None,
    fov_hint: float = DEFAULT_FOV_HINT,
):
    """Interactive perspective frame on the mosaic's device.

    Renders the frustum's azimuth/elevation window (`fast_view_spec`,
    sized from ``fov_hint``, an upper bound on the camera's fov) with the
    LOD panorama engine, centred on the view direction, then warps it onto
    the perspective grid: each pixel takes the bilinear blend of the four
    window texels around its ray's azimuth and elevation, gathered as one
    8-word row (colour as a 10/10/10 code, distance) per pixel. The rows are
    int32 words: a packed colour whose blue code is below 8 is a denormal
    as a float.

    Returns ``{"color" f32[H, W, 3], "depth" (0..1 reference convention),
    "distance", "hit"}``.
    """
    dev = mosaic.device
    (dx, dy, dz), fwd = camera_rays(camera, width, height, device=dev)
    eye = f32(camera.eye, dev)

    # Eye-local azimuth/elevation of every pixel ray.
    _, (ux, uy, uz), (ex_, ey_), (nx0, ny0, nz0), _ = _eye_frame(eye)
    d_e = dx * ex_ + dy * ey_
    d_n = dx * nx0 + dy * ny0 + dz * nz0
    d_u = dx * ux + dy * uy + dz * uz
    az = torch.atan2(d_e, d_n)  # [H, W], 0 = north
    el = torch.asin(torch.clamp(d_u, -1.0, 1.0))

    spec, half_win, az_span = fast_view_spec(
        width=width, height=height, fov_hint=fov_hint, supersample=supersample,
        n_steps=n_steps,
    )
    wp, hp = spec.width, spec.height

    # The window's centre: the view direction's azimuth/elevation.
    az_c = torch.atan2(fwd[0] * ex_ + fwd[1] * ey_, fwd[0] * nx0 + fwd[1] * ny0 + fwd[2] * nz0)
    el_c = torch.asin(torch.clamp(fwd[0] * ux + fwd[1] * uy + fwd[2] * uz, -1.0, 1.0))
    pano = render_panorama(
        mosaic, eye, spec, camera.sun_angle.to_vec3(), view_mode=int(camera.view_mode),
        quantize_rt=False, apply_postprocess=False,
        azimuth_offset=az_c, elev_offset=el_c,
    )

    enc = torch.round(torch.clamp(pano["color"], 0.0, 1.0) * 1023.0).to(torch.int32)
    packed_rgb = enc[..., 0] | (enc[..., 1] << 10) | (enc[..., 2] << 20)
    dist_p = pano["distance"].view(torch.int32)
    cosf = dx * fwd[0] + dy * fwd[1] + dz * fwd[2]

    # Divisors are device tensors: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which moves a last bit.
    span_d, half_d, win_d = f32([az_span, half_win, 2.0 * half_win], dev).unbind(0)
    rel_az = (az - az_c + math.pi) % (2.0 * math.pi) - math.pi  # floor modulo, as jnp's %
    gx = (rel_az + 0.5 * az_span) / span_d * wp - 0.5
    gy = (half_d - (el - el_c)) / win_d * hp - 0.5

    def shift_x(a):
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)

    def shift_y(a):
        return torch.cat([a[1:], a[-1:]], dim=0)

    p01, d01 = shift_x(packed_rgb), shift_x(dist_p)
    quad = torch.stack(
        [packed_rgb, dist_p, p01, d01, shift_y(packed_rgb), shift_y(dist_p), shift_y(p01), shift_y(d01)],
        dim=-1,
    ).reshape(-1, 8)

    x0 = torch.clamp(torch.floor(gx).to(torch.int32), 0, wp - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int32), 0, hp - 2)
    fx = torch.clamp(gx - x0, 0.0, 1.0)
    fy = torch.clamp(gy - y0, 0.0, 1.0)
    rows8 = quad[(y0 * wp + x0).long()]

    c00, c01 = _unpack_rgb(rows8[..., 0]), _unpack_rgb(rows8[..., 2])
    c10, c11 = _unpack_rgb(rows8[..., 4]), _unpack_rgb(rows8[..., 6])
    chans = tuple(
        (c00[i] * (1 - fx) + c01[i] * fx) * (1 - fy) + (c10[i] * (1 - fx) + c11[i] * fx) * fy
        for i in range(3)
    )
    d = rows8[..., 1::2].view(torch.float32)
    dist = (d[..., 0] * (1 - fx) + d[..., 1] * fx) * (1 - fy) + (d[..., 2] * (1 - fx) + d[..., 3] * fx) * fy
    hit = dist < 0.98 * FAR  # sky carries FAR distance

    # Reference-convention depth for the label pass: ray distance to view-axis
    # distance, then to ndc depth.
    depth = torch.where(hit, depth_from_dist(torch.clamp(dist * cosf, NEAR, FAR)), 1.0)

    chans = tuple(shd.quantize_srgb8(c) for c in chans)
    chans = postprocess_soa(chans, depth, pixelize_n=pixelize_n)
    return {
        "color": torch.stack(chans, dim=-1),
        "depth": depth,
        "distance": torch.where(hit, dist, FAR),
        "hit": hit,
    }
