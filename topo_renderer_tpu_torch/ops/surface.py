"""Raster <-> geographic mappings and heightfield surface sampling.

Port of `topo_renderer_tpu/ops/surface.py` for the panorama paths: the
coordinate mappings, and the samplers of the triangle-exact surface the
reference rasterizes (`render_buffer.rs:191-219`: each cell split into two
triangles along a diagonal that alternates with ``(i + j) % 2``).

Cell-local convention (matching the raster): fx grows east (columns), fy
grows south (rows); the NW corner is texel (cy, cx).
  parity 0: diagonal NW-SE; lower-left triangle {NW, SW, SE} where fx <= fy,
            upper-right {NW, NE, SE}
  parity 1: diagonal SW-NE; upper {NW, NE, SW} where fx + fy <= 1,
            lower {SE, NE, SW}

Packed normals are read as int32 words (`models/scene.py`). The Dekker-pair
track helpers and `sample_attributes_cell` belong to the exact-frame slice.
"""

from __future__ import annotations

import torch

from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT, unpack_normals
from topo_renderer_tpu_torch.ops.geometry import degrees, radians

INVALID_HEIGHT = POISON_HEIGHT


def cell_rows(mosaic, idx):
    """Per-cell corner rows ``cell_heights_flat[idx]`` (unsharded form)."""
    if mosaic.cell_sharded:
        raise NotImplementedError("row-sharded cell tables: ROADMAP.md slice 7")
    return mosaic.cell_heights_flat[idx.long()]


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


def geo_from_raster(mosaic, gx, gy):
    lon = gx * mosaic.pixel_scale[0] + mosaic.model_point[0]
    lat = mosaic.model_point[1] - gy * mosaic.pixel_scale[1]
    return lon, lat


def tri_interp(v_nw, v_ne, v_sw, v_se, fx, fy, parity):
    """Interpolate a per-vertex attribute triangle-exactly within a cell.
    All arguments broadcast elementwise; ``parity`` in {0, 1}."""
    # parity 0: diagonal NW-SE
    lower0 = v_nw + (v_se - v_sw) * fx + (v_sw - v_nw) * fy
    upper0 = v_nw + (v_ne - v_nw) * fx + (v_se - v_ne) * fy
    p0 = torch.where(fx <= fy, lower0, upper0)
    # parity 1: diagonal SW-NE
    upper1 = v_nw + (v_ne - v_nw) * fx + (v_sw - v_nw) * fy
    lower1 = v_se + (v_ne - v_se) * (1.0 - fy) + (v_sw - v_se) * (1.0 - fx)
    p1 = torch.where(fx + fy <= 1.0, upper1, lower1)
    return torch.where(parity == 0, p0, p1)


def _cell_setup(mosaic, gx, gy):
    """(flat index of the NW corner (int64), row width, fx, fy, parity,
    in-bounds mask) of the cell holding each raster coordinate."""
    h, w = mosaic.shape
    in_bounds = (gx >= 0.0) & (gy >= 0.0) & (gx <= w - 1.0) & (gy <= h - 1.0)
    cx = torch.clamp(torch.floor(gx).to(torch.int32), 0, w - 2)
    cy = torch.clamp(torch.floor(gy).to(torch.int32), 0, h - 2)
    fx = gx - cx
    fy = gy - cy
    parity = (cx + cy) % 2
    idx = cy.long() * w + cx.long()
    return idx, w, fx, fy, parity, in_bounds


def sample_height(mosaic, gx, gy):
    """Triangle-exact surface height at raster coords; INVALID_HEIGHT
    outside the mosaic. One row gather from the per-cell corner table where
    the mosaic has one, four corner gathers otherwise."""
    idx, w, fx, fy, parity, in_bounds = _cell_setup(mosaic, gx, gy)
    if mosaic.has_cell_table:
        rows = cell_rows(mosaic, idx)
        h = tri_interp(rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3], fx, fy, parity)
    else:
        flat = mosaic.heights_flat
        h = tri_interp(flat[idx], flat[idx + 1], flat[idx + w], flat[idx + w + 1], fx, fy, parity)
    return torch.where(in_bounds, h, INVALID_HEIGHT)


def sample_height_level(mosaic, level: int, gx, gy, nearest: bool = False):
    """Height at raster coords from mip ``level`` (0 = triangle-exact base).

    Level-L texel (i, j) averages base texels [2^L i, 2^L (i+1)); its centre
    sits at base coords 2^L i + (2^L - 1)/2. Coarse levels sample
    bilinearly, or by nearest texel.
    """
    if level == 0 and not nearest:
        return sample_height(mosaic, gx, gy)
    if level == 0:
        h0, w0 = mosaic.shape
        ix = torch.clamp(torch.round(gx).to(torch.int32), 0, w0 - 1)
        iy = torch.clamp(torch.round(gy).to(torch.int32), 0, h0 - 1)
        in_b = (gx >= 0.0) & (gy >= 0.0) & (gx <= w0 - 1.0) & (gy <= h0 - 1.0)
        h = mosaic.heights_flat[iy.long() * w0 + ix.long()]
        return torch.where(in_b, h, INVALID_HEIGHT)

    flat = mosaic.mip_heights_flat[level - 1]
    h_l, w_l = mosaic.mip_shapes[level - 1]
    s = float(2**level)
    off = (s - 1.0) / 2.0
    gxl = (gx - off) / s
    gyl = (gy - off) / s
    in_b = (gxl >= -0.5) & (gyl >= -0.5) & (gxl <= w_l - 0.5) & (gyl <= h_l - 0.5)
    if nearest:
        ix = torch.clamp(torch.round(gxl).to(torch.int32), 0, w_l - 1)
        iy = torch.clamp(torch.round(gyl).to(torch.int32), 0, h_l - 1)
        h = flat[iy.long() * w_l + ix.long()]
    else:
        x0 = torch.clamp(torch.floor(gxl).to(torch.int32), 0, w_l - 2)
        y0 = torch.clamp(torch.floor(gyl).to(torch.int32), 0, h_l - 2)
        fx = torch.clamp(gxl - x0, 0.0, 1.0)
        fy = torch.clamp(gyl - y0, 0.0, 1.0)
        i = y0.long() * w_l + x0.long()
        a, b, c, d = flat[i], flat[i + 1], flat[i + w_l], flat[i + w_l + 1]
        h = (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
    return torch.where(in_b, h, INVALID_HEIGHT)


def sample_attributes_nearest(mosaic, gx, gy):
    """Nearest texel height + normal from one row gather of the packed
    (height, normal-bits) table. Returns ``(h, nx, ny, nz, ok)``."""
    h0, w0 = mosaic.shape
    ix = torch.clamp(torch.round(gx).to(torch.int32), 0, w0 - 1)
    iy = torch.clamp(torch.round(gy).to(torch.int32), 0, h0 - 1)
    in_b = (gx >= 0.0) & (gy >= 0.0) & (gx <= w0 - 1.0) & (gy <= h0 - 1.0)
    rows = mosaic.attr_packed_flat[iy.long() * w0 + ix.long()]  # [..., 2]
    h = rows[..., 0]
    nx, ny, nz = unpack_normals(rows[..., 1])
    ok = in_b & (h > 0.5 * INVALID_HEIGHT)
    return torch.where(ok, h, INVALID_HEIGHT), nx, ny, nz, ok


def sample_attributes_soa(mosaic, gx, gy):
    """Height + world-space normal planes at raster coords, the three
    vertex normals of the containing triangle interpolated with the
    rasterizer's triangle weights. Returns ``(h, nx, ny, nz, ok)``."""
    idx, w, fx, fy, parity, in_bounds = _cell_setup(mosaic, gx, gy)
    attr = mosaic.attr_packed_flat
    corners = [attr[i] for i in (idx, idx + 1, idx + w, idx + w + 1)]  # NW, NE, SW, SE
    h = tri_interp(*(r[..., 0] for r in corners), fx, fy, parity)
    bits = [r[..., 1].view(torch.int32) for r in corners]
    out = []
    for shift in (0, 10, 20):
        codes = [((b >> shift) & 0x3FF).to(torch.float32) for b in bits]
        comp = tri_interp(*codes, fx, fy, parity)
        out.append(2.0 * (comp / 1023.0) - 1.0)
    nx, ny, nz = out
    ok = in_bounds & (h > 0.5 * INVALID_HEIGHT)
    return torch.where(ok, h, INVALID_HEIGHT), nx, ny, nz, ok
