"""Postprocessing pass: depth-contour outlines, pixelization, fog.

Port of `topo_renderer_tpu/ops/postprocess.py` (parity with
`resources/shaders/postprocessing_shader.wgsl:52-96`): contour = 3x3
Laplacian of linearized depth, final = mix(render, black,
smoothstep(0.05, 0.15, contour / centre)); pixelization when
``pixelize_n < 99.99999``. Distance fog and the two-term atmosphere are the
JAX package's extensions. Everything runs on single-channel [H, W] planes;
`postprocess`, `distance_fog` and `atmospheric_shading` are channels-last
wrappers (``color[..., H, W, 3]``), as in the JAX package.
"""

from __future__ import annotations

import torch

from topo_renderer_tpu_torch.models.camera import dist_from_depth
from topo_renderer_tpu_torch.ops.sampling import bilinear_sample_hw


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _sum3_last(x):
    """Edge-clamped 3-tap box sum along the last axis."""
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return left + x + right


def _sum3_rows(x):
    """Edge-clamped 3-tap box sum along the second-to-last axis."""
    up = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    down = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    return up + x + down


def _contour_mix(depth):
    lin = dist_from_depth(depth)
    total = _sum3_rows(_sum3_last(lin))  # includes the centre tap
    contour = 9.0 * lin - total
    return smoothstep(0.05, 0.15, contour / lin)


def postprocess_soa(channels, depth, pixelize_n=None):
    """Postprocess a tuple of channel planes; returns a same-length tuple."""
    h, w = depth.shape[-2], depth.shape[-1]
    if pixelize_n is not None and float(pixelize_n) < 99.99999:
        n = float(pixelize_n)
        ys = (torch.arange(h, dtype=torch.float32, device=depth.device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=depth.device) + 0.5) / w
        u = xs[None, :].expand(h, w)
        v = ys[:, None].expand(h, w)
        up = torch.floor(u * n) / n
        vp = torch.floor(v * n) / n
        sx = up * w - 0.5
        sy = vp * h - 0.5
        channels = tuple(bilinear_sample_hw(c, sx, sy) for c in channels)

    mixf = _contour_mix(depth)
    return tuple(c * (1.0 - mixf) for c in channels)


def _planes(color):
    color = torch.as_tensor(color, dtype=torch.float32)
    return tuple(color[..., c] for c in range(color.shape[-1]))


def postprocess(color, depth, pixelize_n=None):
    """Channels-last wrapper of :func:`postprocess_soa`."""
    out = postprocess_soa(_planes(color), torch.as_tensor(depth, dtype=torch.float32), pixelize_n)
    return torch.stack(out, dim=-1)


def distance_fog_soa(channels, distance, fog_color, density=1.0 / 80_000.0, sky_mask=None):
    f = 1.0 - torch.exp(-distance * density)
    out = []
    for c, fc in zip(channels, fog_color):
        mixed = c + (fc - c) * f
        if sky_mask is not None:
            mixed = torch.where(sky_mask, c, mixed)
        out.append(mixed)
    return tuple(out)


def atmospheric_shading_soa(
    channels,
    distance,
    sky_color,
    rayleigh_density=1.0 / 60_000.0,
    mie_density=1.0 / 220_000.0,
    sky_mask=None,
):
    """Two-term aerial perspective: wavelength-dependent extinction toward
    the sky colour plus neutral haze."""
    wavelength = (1.8, 1.0, 0.65)
    t_m = torch.exp(-distance * mie_density)
    out = []
    for c, sc, wl in zip(channels, sky_color, wavelength):
        t_r = torch.exp(-distance * (rayleigh_density / wl))
        mixed = c * t_r * t_m + sc * (1.0 - t_r)
        if sky_mask is not None:
            mixed = torch.where(sky_mask, c, mixed)
        out.append(mixed)
    return tuple(out)


def distance_fog(color, distance, fog_color, density=1.0 / 80_000.0, sky_mask=None):
    """Exponential distance fog on ``color[..., 3]`` (the JAX package's
    extension, BASELINE config 2)."""
    out = distance_fog_soa(_planes(color)[:3], torch.as_tensor(distance, dtype=torch.float32),
                           fog_color, density, sky_mask)
    return torch.stack(out, dim=-1)


def atmospheric_shading(
    color,
    distance,
    sky_color,
    rayleigh_density=1.0 / 60_000.0,
    mie_density=1.0 / 220_000.0,
    sky_mask=None,
):
    """Two-term aerial perspective on ``color[..., 3]`` (the JAX package's
    extension, BASELINE config 4)."""
    out = atmospheric_shading_soa(_planes(color)[:3], torch.as_tensor(distance, dtype=torch.float32),
                                  sky_color, rayleigh_density, mie_density, sky_mask)
    return torch.stack(out, dim=-1)
