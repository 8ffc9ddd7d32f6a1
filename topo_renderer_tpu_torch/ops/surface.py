"""Raster <-> geographic mappings of the mosaic.

Port of the parts of `topo_renderer_tpu/ops/surface.py` the LOD panorama
uses. The triangle-exact samplers and the Dekker-pair track helpers belong
to the exact-frame slice of the port.
"""

from __future__ import annotations

import torch

from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT
from topo_renderer_tpu_torch.ops.geometry import degrees, radians

INVALID_HEIGHT = POISON_HEIGHT


def raster_from_geo(mosaic, lon_deg, lat_deg):
    """Geographic degrees -> mosaic raster coordinates (gx, gy)."""
    gx = (lon_deg - mosaic.model_point[0]) / mosaic.pixel_scale[0]
    gy = (mosaic.model_point[1] - lat_deg) / mosaic.pixel_scale[1]
    return gx, gy


def raster_from_ecef(mosaic, px, py, pz, r):
    """ECEF position (+ its radius) -> raster coordinates, origin-relative.

    Rotating into the mosaic origin's frame before the inverse trig keeps
    both angles origin-relative (`surface.py:74-117`):
      dlon = atan2(py cos m0 - px sin m0, px cos m0 + py sin m0)
      dlat = asin(sin(lat) cos m1 - cos(lat) sin m1)
    """
    m0 = radians(mosaic.model_point[0])
    m1 = radians(mosaic.model_point[1])
    c0, s0 = torch.cos(m0), torch.sin(m0)
    c1, s1 = torch.cos(m1), torch.sin(m1)
    dlon = torch.atan2(py * c0 - px * s0, px * c0 + py * s0)
    sl = pz / r
    cl = torch.sqrt(torch.clamp(px * px + py * py, min=0.0)) / r
    dsin = sl * c1 - cl * s1
    dlat = torch.asin(torch.clamp(dsin, -1.0, 1.0))
    gx = degrees(dlon) / mosaic.pixel_scale[0]
    gy = -degrees(dlat) / mosaic.pixel_scale[1]
    return gx, gy
