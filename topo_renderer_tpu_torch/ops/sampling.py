"""Texture-style bilinear sampling (clamp-to-edge, texel centres at i + 0.5).

Port of `topo_renderer_tpu/ops/sampling.py::bilinear_sample_hw`, used by
the pixelize effect of `ops/postprocess.py`.
"""

from __future__ import annotations

import torch


def bilinear_sample_hw(img, x, y):
    """Sample ``img[H, W]`` at texel-space coordinates (x, y), (0, 0) being
    the centre of texel (0, 0)."""
    h, w = img.shape[-2], img.shape[-1]
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
    v00 = img[..., y0, x0]
    v01 = img[..., y0, x1]
    v10 = img[..., y1, x0]
    v11 = img[..., y1, x1]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy
