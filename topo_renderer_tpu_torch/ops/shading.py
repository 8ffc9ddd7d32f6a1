"""Fragment shading: diffuse sun lighting, hash dither, view modes, sRGB.

Port of `topo_renderer_tpu/ops/shading.py` (parity with the terrain
fragment shader, `resources/shaders/render_shader.wgsl:75-115`): ambient
0.01, diffuse 0.7 * max(dot(n, sun), 0), the fract-hash dither seeded with
``clip_position.xy + camera_pos.xy - world_position.xy``, view modes 0/1/2,
and the sRGB conversion of the swapchain. The channels-last functions
(`hash12n`, `hash42n`, `dither_rgb`, `shade`) are the JAX package's
array-of-structs helpers; the frames use the plane-by-plane ``*_soa`` ones.
"""

from __future__ import annotations

import torch

AMBIENT_STRENGTH = 0.01
DIFFUSE_STRENGTH = 0.7
# sky clear colour, linear RGB (`terrain_renderer.rs:379-384`)
SKY_COLOR = (0.0, 0.71, 0.885)


def _fract(x):
    return x - torch.floor(x)


def hash12n(seed):
    """`render_shader.wgsl:75-79` — 2D -> 1D fract hash of ``seed[..., 2]``."""
    seed = torch.as_tensor(seed, dtype=torch.float32)
    p = _fract(seed * torch.tensor([5.3987, 5.4421], dtype=torch.float32, device=seed.device))
    # dot(p.yx, p.xy + vec2(21.5351, 14.3137)) added to both components
    d = p[..., 1] * (p[..., 0] + 21.5351) + p[..., 0] * (p[..., 1] + 14.3137)
    p = p + d[..., None]
    return _fract(p[..., 0] * p[..., 1] * 95.4307)


def hash42n(p):
    """`render_shader.wgsl:81-83` — three decorrelated hashes ``[..., 3]``."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return torch.stack([hash12n(p), hash12n(p + 0.07), hash12n(p + 0.11)], dim=-1)


def dither_rgb(color, p):
    """`render_shader.wgsl:85-87`: +- 1/255 triangular-ish hash noise."""
    p = torch.as_tensor(p, dtype=torch.float32)
    noise = hash42n(p) + hash42n(p + 0.13) - 1.0
    return torch.as_tensor(color, dtype=torch.float32) + noise / 255.0


def shade(world_normal, sun_direction, view_mode, dither_seed):
    """Terrain fragment shading (`render_shader.wgsl:96-115`) on
    channels-last arrays: ``world_normal f32[..., 3]`` (normalized here),
    ``sun_direction f32[3]``, ``view_mode`` 0/1/2, ``dither_seed
    f32[..., 2]``. Returns linear RGB ``f32[..., 3]``."""
    world_normal = torch.as_tensor(world_normal, dtype=torch.float32)
    view_mode = int(view_mode)
    if view_mode == 2:
        return 0.5 * (world_normal + 1.0)
    sun = torch.as_tensor(sun_direction, dtype=torch.float32, device=world_normal.device)
    # The norm and the dot product sum their three terms in index order,
    # as JAX's reductions over a length-3 axis do.
    wx, wy, wz = world_normal[..., 0], world_normal[..., 1], world_normal[..., 2]
    n = world_normal / torch.clamp(torch.sqrt(wx * wx + wy * wy + wz * wz), min=1e-20)[..., None]
    ndots = n[..., 0] * sun[..., 0] + n[..., 1] * sun[..., 1] + n[..., 2] * sun[..., 2]
    intensity = AMBIENT_STRENGTH + DIFFUSE_STRENGTH * torch.clamp(ndots, min=0.0)
    result_lin = intensity[..., None].expand(n.shape).contiguous()
    return result_lin if view_mode == 1 else dither_rgb(result_lin, dither_seed)


def hash12n_soa(sx, sy):
    """`render_shader.wgsl:75-79` on separate seed planes."""
    px = _fract(sx * 5.3987)
    py = _fract(sy * 5.4421)
    d = py * (px + 21.5351) + px * (py + 14.3137)
    px = px + d
    py = py + d
    return _fract(px * py * 95.4307)


def shade_soa(nx, ny, nz, sun_direction, view_mode, seed_x, seed_y):
    """Shade scalar planes; returns (r, g, b) planes
    (`render_shader.wgsl:96-115`)."""
    norm2 = nx * nx + ny * ny + nz * nz
    inv = 1.0 / torch.sqrt(torch.clamp(norm2, min=1e-30))
    sun = sun_direction
    ndots = (nx * sun[0] + ny * sun[1] + nz * sun[2]) * inv
    intensity = AMBIENT_STRENGTH + DIFFUSE_STRENGTH * torch.clamp(ndots, min=0.0)

    view_mode = int(view_mode)
    if view_mode == 2:
        return (0.5 * (nx + 1.0), 0.5 * (ny + 1.0), 0.5 * (nz + 1.0))
    if view_mode == 1:
        return (intensity, intensity, intensity)
    channels = []
    for off in (0.0, 0.07, 0.11):
        noise = (
            hash12n_soa(seed_x + off, seed_y + off)
            + hash12n_soa(seed_x + 0.13 + off, seed_y + 0.13 + off)
            - 1.0
        ) / 255.0
        channels.append(intensity + noise)
    return tuple(channels)


def linear_to_srgb(c):
    """Standard sRGB OETF — what the wgpu sRGB surface applies on write."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp(c, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def srgb_to_linear(c):
    """Inverse OETF — what sampling an sRGB texture applies on read."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c / 12.92
    hi = torch.pow((c + 0.055) / 1.055, 2.4)
    return torch.where(c <= 0.04045, lo, hi)


def quantize_srgb8(linear_rgb):
    """Store linear colour into an 8-bit sRGB target and read it back
    (`render_engine.rs:75-85`)."""
    return srgb_to_linear(torch.round(linear_to_srgb(linear_rgb) * 255.0) / 255.0)


def to_srgb8_image(linear_rgb):
    """Final framebuffer conversion: linear f32 -> u8 sRGB."""
    return torch.round(linear_to_srgb(linear_rgb) * 255.0).to(torch.uint8)
