"""Fragment shading: diffuse sun lighting, hash dither, view modes, sRGB.

Port of `topo_renderer_tpu/ops/shading.py` (parity with the terrain
fragment shader, `resources/shaders/render_shader.wgsl:75-115`): ambient
0.01, diffuse 0.7 * max(dot(n, sun), 0), the fract-hash dither seeded with
``clip_position.xy + camera_pos.xy - world_position.xy``, view modes 0/1/2,
and the sRGB conversion of the swapchain.
"""

from __future__ import annotations

import torch

AMBIENT_STRENGTH = 0.01
DIFFUSE_STRENGTH = 0.7
# sky clear colour, linear RGB (`terrain_renderer.rs:379-384`)
SKY_COLOR = (0.0, 0.71, 0.885)


def _fract(x):
    return x - torch.floor(x)


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
