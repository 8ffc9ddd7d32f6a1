"""Raster <-> geographic mappings and heightfield surface sampling.

Port of `topo_renderer_tpu/ops/surface.py`: the coordinate mappings, and
the samplers of the triangle-exact surface the reference rasterizes (`render_buffer.rs:191-219`: each cell split into two
triangles along a diagonal that alternates with ``(i + j) % 2``).

Cell-local convention (matching the raster): fx grows east (columns), fy
grows south (rows); the NW corner is texel (cy, cx).
  parity 0: diagonal NW-SE; lower-left triangle {NW, SW, SE} where fx <= fy,
            upper-right {NW, NE, SE}
  parity 1: diagonal SW-NE; upper {NW, NE, SW} where fx + fy <= 1,
            lower {SE, NE, SW}

Packed normals are read as int32 words (`models/scene.py`).

Every table read goes through `parallel/mesh.py::gather_rows`, so the
samplers also read a row-sharded mosaic (`parallel/sharded_mosaic.py`):
each band gathers the rows it owns and the owner's rows are selected onto
the mosaic's lead device.

The exact frame's track helpers (`track_coeffs`, `raster_from_coeffs`)
expand the ray's raster track in its parameter t: every large quantity is a
per-frame scalar, computed on the host in float32 as an error-free
(Dekker/Knuth) pair and crossed to the device once; every per-sample
operation is a small polynomial. The pairs are plain float32 tensor ops on
the CPU, one rounding each, never fused or reassociated.
"""

from __future__ import annotations

import torch

from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT, unpack_normals
from topo_renderer_tpu_torch.ops.geometry import degrees, f32, radians
from topo_renderer_tpu_torch.parallel.mesh import gather_rows

INVALID_HEIGHT = POISON_HEIGHT


def index_i32(x, hi: int):
    """``jnp.clip(x.astype(jnp.int32), 0, hi)`` for ``x`` an integral float
    (a floor or a round): as XLA converts, NaN gives 0 and values past the
    int32 range saturate, so the clamped index is XLA's on both devices
    (torch's CPU conversion gives INT32_MIN for NaN and ±inf)."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, hi).to(torch.int32)


def cell_rows(mosaic, idx):
    """Per-cell corner rows ``cell_heights_flat[idx]``. On a row-sharded
    cell table (``mosaic.cell_sharded``) each band gathers the rows it owns
    and the single owner's row is selected onto the lead device, where the
    JAX package adds every device's masked rows with a `psum`."""
    return gather_rows(mosaic.cell_heights_flat, idx.long())


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


# ---- error-free float32 arithmetic (Dekker/Knuth) ----------------------------
# Float32 tensors in, (head, tail) pairs out: head + tail equals the exact
# sum or product. Only O(1) per-frame scalars go through these.


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """a*b as (head, tail) with head + tail == a*b exactly (Veltkamp split:
    2^12 + 1 splits the 24-bit mantissa 12 + 12)."""
    p = a * b
    sp = torch.tensor(4097.0, dtype=torch.float32, device=a.device)
    ca = a * sp
    ah = ca - (ca - a)
    al = a - ah
    cb = b * sp
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _df_add(x, y):
    """(hi, lo) + (hi, lo) -> normalized pair (add22)."""
    s, e = _two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return _two_sum(s, e)


def _df_mul(x, y):
    """(hi, lo) * (hi, lo) -> normalized pair (mul22)."""
    p, e = _two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return _two_sum(p, e)


def _df_neg(x):
    return -x[0], -x[1]


def track_frame_terms(mosaic, eye_host):
    """The expansion's per-frame scalars, on the host in float32: a tensor
    [u0 (pair), v0, A (pair), rho0 (pair), c0, s0, c1, s1, c1^2, s1^2].

    ``eye_host`` is the eye as a CPU float32 tensor; the mosaic origin comes
    from the host copy of ``model_point``. u0 = ey c0 - ex s0 and the
    latitude numerator's constant A = c1^2 ez^2 - s1^2 (ex^2 + ey^2) are
    small differences of ~6.4e6-scale terms, so they are error-free pairs.
    """
    ex, ey, ez = torch.as_tensor(eye_host, dtype=torch.float32).cpu().unbind(0)
    mp = f32(mosaic.host.model_point)
    m0, m1 = radians(mp[0]), radians(mp[1])
    c0, s0 = torch.cos(m0), torch.sin(m0)
    c1, s1 = torch.cos(m1), torch.sin(m1)
    zero = torch.zeros((), dtype=torch.float32)
    u0 = _df_add(_two_prod(ey, c0), _df_neg(_two_prod(ex, s0)))
    v0 = ex * c0 + ey * s0
    c1sq = _df_mul((c1, zero), (c1, zero))
    s1sq = _df_mul((s1, zero), (s1, zero))
    rho0 = _df_add(_two_prod(ex, ex), _two_prod(ey, ey))
    A = _df_add(_df_mul(c1sq, _two_prod(ez, ez)), _df_neg(_df_mul(s1sq, rho0)))
    return torch.stack([*u0, v0, *A, *rho0, c0, s0, c1, s1, c1sq[0], s1sq[0]])


def track_coeffs(mosaic, eye, eye_host, dirs):
    """Per-ray expansion of `raster_from_ecef` along ``p(t) = eye + t*dir``
    (`topo_renderer_tpu/ops/surface.py:167-222`).

    Materialising ``p(t)`` quantizes each component at the ECEF magnitude
    (~0.5 m per sample in float32). Expanded in t, the rotated components
    are:

      east:   u(t) = u0 + t*du,  u0 = ey c0 - ex s0   (pair),
              v(t) = v0 + t*dv
      north:  n(t) = N(t) / D(t),  N(t) = A + 2 B t + C t^2,
              A = c1^2 ez^2 - s1^2 rho^2   (pair),   D(t) = c1 pz + rho s1.

    ``eye`` is the eye on the rays' device, ``eye_host`` the same values as
    a CPU tensor: the per-frame scalars (`track_frame_terms`) are computed
    there and cross in one copy. Returns a dict of per-ray coefficient
    planes and per-frame scalars (pairs as ``(head, tail)``).
    """
    dx, dy, dz = dirs
    t = f32(track_frame_terms(mosaic, eye_host), dx.device)
    u0h, u0l, v0, ah, al, r0h, r0l, c0, s0, c1, s1, c1sq, s1sq = t.unbind(0)
    ex, ey, ez = eye[0], eye[1], eye[2]
    rho_b = ex * dx + ey * dy  # d(rho^2)/dt / 2, per ray
    rho_c = dx * dx + dy * dy
    return {
        "u0": (u0h, u0l), "du": dy * c0 - dx * s0, "v0": v0, "dv": dx * c0 + dy * s0,
        "A": (ah, al), "B": c1sq * (ez * dz) - s1sq * rho_b, "C": c1sq * (dz * dz) - s1sq * rho_c,
        "rho0": (r0h, r0l), "rho_b": rho_b, "rho_c": rho_c, "ez": ez, "dz": dz, "c1": c1, "s1": s1,
    }


def raster_from_coeffs(mosaic, k, t, r):
    """The expanded track at parameter ``t`` -> ``(gx, gy)``; ``r`` is the
    geocentric radius at t (from the altitude quadratic)."""
    u = (k["u0"][0] + t * k["du"]) + k["u0"][1]
    v = k["v0"] + t * k["dv"]
    dlon = torch.atan2(u, v)

    n = (k["A"][0] + t * (2.0 * k["B"] + t * k["C"])) + k["A"][1]
    pz = k["ez"] + t * k["dz"]
    rho_sq = k["rho0"][0] + t * (2.0 * k["rho_b"] + t * k["rho_c"])
    rho = torch.sqrt(torch.clamp(rho_sq, min=0.0))
    d = pz * k["c1"] + rho * k["s1"]
    # D -> 0 only toward the antipodal meridian plane (never inside a
    # mosaic window); keep the quotient finite there.
    dsin = n / torch.clamp(r * torch.abs(d), min=1.0) * torch.sign(d)
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
    cx = index_i32(torch.floor(gx), w - 2)
    cy = index_i32(torch.floor(gy), h - 2)
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
        h = tri_interp(*(gather_rows(flat, i) for i in (idx, idx + 1, idx + w, idx + w + 1)), fx, fy, parity)
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
        h = gather_rows(mosaic.heights_flat, iy.long() * w0 + ix.long())
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
        h = gather_rows(flat, iy.long() * w_l + ix.long())
    else:
        x0 = torch.clamp(torch.floor(gxl).to(torch.int32), 0, w_l - 2)
        y0 = torch.clamp(torch.floor(gyl).to(torch.int32), 0, h_l - 2)
        fx = torch.clamp(gxl - x0, 0.0, 1.0)
        fy = torch.clamp(gyl - y0, 0.0, 1.0)
        i = y0.long() * w_l + x0.long()
        a, b, c, d = (gather_rows(flat, j) for j in (i, i + 1, i + w_l, i + w_l + 1))
        h = (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
    return torch.where(in_b, h, INVALID_HEIGHT)


def sample_attributes_nearest(mosaic, gx, gy):
    """Nearest texel height + normal from one row gather of the packed
    (height, normal-bits) table. Returns ``(h, nx, ny, nz, ok)``."""
    h0, w0 = mosaic.shape
    ix = torch.clamp(torch.round(gx).to(torch.int32), 0, w0 - 1)
    iy = torch.clamp(torch.round(gy).to(torch.int32), 0, h0 - 1)
    in_b = (gx >= 0.0) & (gy >= 0.0) & (gx <= w0 - 1.0) & (gy <= h0 - 1.0)
    rows = gather_rows(mosaic.attr_packed_flat, iy.long() * w0 + ix.long())  # [..., 2]
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
    corners = [gather_rows(attr, i) for i in (idx, idx + 1, idx + w, idx + w + 1)]  # NW, NE, SW, SE
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


def sample_attributes_cell(mosaic, gx, gy):
    """Height + world-space normal planes from one 32 B cell-row gather: the
    rows carry the four corner heights and the corners' packed normals
    (columns 4-7, int32 words, some of them float32 denormals, so the rows
    are gathered and read as int32). The interpolation is
    `sample_attributes_soa`'s. Returns ``(h, nx, ny, nz, ok)``."""
    idx, _, fx, fy, parity, in_bounds = _cell_setup(mosaic, gx, gy)
    rows = cell_rows(mosaic, idx).view(torch.int32)
    heights = rows[..., :4].view(torch.float32)
    h = tri_interp(*heights.unbind(-1), fx, fy, parity)
    bits = rows[..., 4:].unbind(-1)
    out = []
    for shift in (0, 10, 20):
        codes = [((b >> shift) & 0x3FF).to(torch.float32) for b in bits]
        comp = tri_interp(*codes, fx, fy, parity)
        out.append(2.0 * (comp / 1023.0) - 1.0)
    nx, ny, nz = out
    ok = in_bounds & (h > 0.5 * INVALID_HEIGHT)
    return torch.where(ok, h, INVALID_HEIGHT), nx, ny, nz, ok


def sample_attributes(mosaic, gx, gy):
    """`sample_attributes_soa` with the normal stacked channels-last:
    ``(h, n_world [..., 3], ok)``."""
    h, nx, ny, nz, ok = sample_attributes_soa(mosaic, gx, gy)
    return h, torch.stack([nx, ny, nz], dim=-1), ok
