"""Texture-style sampling (clamp-to-edge, texel centres at i + 0.5).

Port of `topo_renderer_tpu/ops/sampling.py`: wgpu samplers in the reference
default to clamp-to-edge addressing
(`topo-renderer/src/render/bound_texture_view.rs:24-105`). These helpers
reproduce that convention for tensors, batched over leading axes.
`bilinear_sample_hw` serves the pixelize effect of `ops/postprocess.py`.
"""

from __future__ import annotations

import torch


def bilinear_sample(img, x, y):
    """Sample ``img[..., H, W]`` or ``img[..., H, W, C]`` at texel-space
    coordinates (x, y), (0, 0) being the centre of texel (0, 0). A trailing
    axis of at most 8 behind an H above 8 is taken for channels (the JAX
    package's heuristic); prefer the explicit wrappers."""
    img = torch.as_tensor(img)
    has_channels = img.ndim >= 3 and img.shape[-1] <= 8 and img.shape[-3] > 8
    return _bilinear(img, x, y, has_channels)


def bilinear_sample_hw(img, x, y):
    """``img[..., H, W]`` single-channel variant."""
    return _bilinear(img, x, y, has_channels=False)


def bilinear_sample_hwc(img, x, y):
    """``img[..., H, W, C]`` multi-channel variant; returns ``[..., C]``."""
    return _bilinear(img, x, y, has_channels=True)


def _bilinear(img, x, y, has_channels):
    img = torch.as_tensor(img)
    if has_channels:
        h, w = img.shape[-3], img.shape[-2]
    else:
        h, w = img.shape[-2], img.shape[-1]
    x = torch.as_tensor(x, dtype=torch.float32, device=img.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=img.device)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    xi = x0f.to(torch.int64)
    yi = y0f.to(torch.int64)
    x0 = torch.clamp(xi, 0, w - 1)
    x1 = torch.clamp(xi + 1, 0, w - 1)
    y0 = torch.clamp(yi, 0, h - 1)
    y1 = torch.clamp(yi + 1, 0, h - 1)
    if has_channels:
        v00 = img[..., y0, x0, :]
        v01 = img[..., y0, x1, :]
        v10 = img[..., y1, x0, :]
        v11 = img[..., y1, x1, :]
        fx = fx[..., None]
        fy = fy[..., None]
    else:
        v00 = img[..., y0, x0]
        v01 = img[..., y0, x1]
        v10 = img[..., y1, x0]
        v11 = img[..., y1, x1]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def nearest_sample_hw(img, x, y):
    """Nearest (textureLoad-style) lookup with clamping, ``img[..., H, W]``;
    coordinates truncate toward zero, as an int32 conversion does."""
    img = torch.as_tensor(img)
    h, w = img.shape[-2], img.shape[-1]
    xi = torch.clamp(torch.as_tensor(x, device=img.device).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.as_tensor(y, device=img.device).to(torch.int64), 0, h - 1)
    return img[..., yi, xi]
