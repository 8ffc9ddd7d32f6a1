"""Terrain surface normals: latitude-corrected central differences.

Port of `topo_renderer_tpu/ops/normals.py` (`compute_normals_soa` and
`compute_normals`), the replacement for the reference's three WGSL normal
compute shaders (`compute_normals_shader.wgsl:22-58` and its edge/corner
variants): once the tiles form one mosaic, one dense central difference
reproduces interior and seams alike. Reference semantics kept exactly:
metric spacing with the cos-latitude factor on the *latitude* spacing
(``correct_axes=False``), normal = normalize(cross(right-left,
top-bottom)), the Rgba8Unorm round trip, and the zero-encoded normal for
texels without a complete 4-neighbourhood.
"""

from __future__ import annotations

import torch

from topo_renderer_tpu_torch.ops.geometry import R0, radians, to_device


def quantize_unorm8(v):
    """Rgba8Unorm storage-texture round trip: clamp to [0,1], round to the
    nearest of 256 levels. The level is divided by 255 in float64 and
    rounded once: PyTorch's CUDA kernel divides a float32 tensor by a scalar
    as a multiply by its reciprocal, which misses k / 255 by an ulp."""
    return (torch.round(torch.clamp(v, 0.0, 1.0) * 255.0).double() / 255.0).float()


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """``jnp.pad(x, 1, mode="edge")`` on the two trailing axes."""
    x = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
    return torch.cat([x[..., :1], x, x[..., -1:]], dim=-1)


def compute_normals_soa(
    heights: torch.Tensor,
    pixel_scale,
    raster_point,
    model_point,
    valid: torch.Tensor | None = None,
    quantize: bool = True,
    correct_axes: bool = False,
    row_span: tuple[int, int] | None = None,
):
    """Decoded normal planes ``(nx, ny, nz)`` of ``heights f32[H, W]``.

    ``pixel_scale``/``model_point`` entries may be Python numbers or float32
    scalar tensors on the host (a CUDA scalar is read back). Scalar-precision
    trap: the JAX package evaluates ``jnp.float32(pixel_scale)`` and
    ``jnp.radians(ps_x) * R0`` (`normals.py:62-79`) in float32; doing them on
    Python floats (float64) moves the metric spacing by an ulp and flips
    packed normal codes. So every scalar step here runs on float32 tensors.

    Device independence: a last bit before the u8 round trip can flip a
    texel by one u8 step, four 10-bit codes once packed. So the per-row
    spacing terms (one ``cos`` per row; CUDA documents ``cosf`` to 2 ulps)
    are computed on the host in float32 and copied to ``heights``' device
    (`to_device`: pinned, no host sync), and the square root and the
    divisions run in float64, rounded once: PyTorch's CUDA float32 ``sqrt``
    is not correctly rounded. Every other step is a correctly rounded
    float32 operation on either device, so the normals on the card equal
    the CPU's bit for bit.

    ``row_span=(y0, n)``: ``heights`` holds rows ``y0 .. y0 + H`` of a raster
    of ``n`` rows. The per-row spacing terms are then computed over all ``n``
    rows and sliced, so a slice's normals equal the whole raster's bit for
    bit: PyTorch's CPU ``cos`` runs a vectorized body and a scalar tail, and
    one row's value may depend on where it sits in the vector.
    """
    dev = heights.device
    h, w = heights.shape[-2], heights.shape[-1]

    def host32(v):
        return torch.as_tensor(v, dtype=torch.float32, device="cpu")

    ps_x = host32(pixel_scale[0])
    ps_y = host32(pixel_scale[1])
    y0, n_rows = (0, h) if row_span is None else row_span

    rows = torch.arange(n_rows, dtype=torch.float32)
    lat_deg = (rows - host32(raster_point[1])) * -ps_y + host32(model_point[1])

    x_m = radians(ps_x) * R0
    y_m = radians(ps_y) * R0
    cos_lat = torch.cos(radians(lat_deg))
    if correct_axes:
        x_row = x_m * cos_lat
        y_row = y_m.expand(cos_lat.shape)
    else:
        # Reference behaviour: cos on the latitude spacing
        # (`compute_normals_shader.wgsl:39-40`).
        x_row = x_m.expand(cos_lat.shape)
        y_row = y_m * cos_lat
    x_row, y_row = (to_device(r[y0 : y0 + h].contiguous(), dev) for r in (x_row, y_row))

    hp = _pad_edge(heights)
    dhx = hp[..., 1:-1, 2:] - hp[..., 1:-1, :-2]  # h(right) - h(left)
    dhy = hp[..., :-2, 1:-1] - hp[..., 2:, 1:-1]  # h(top=row-1) - h(bottom=row+1)

    x_b = x_row.reshape(h, 1)
    y_b = y_row.reshape(h, 1)
    # cross((2x,0,dhx), (0,2y,dhy)) = (-2y*dhx, -2x*dhy, 4xy)
    nx = -2.0 * y_b * dhx
    ny = -2.0 * x_b * dhy
    nz = (4.0 * x_b * y_b).expand(dhx.shape)
    # The square root and the divisions in float64, each rounded once to
    # float32: that is the correctly rounded float32 result (53 >= 2 * 24 + 2
    # bits), which the CPU's float32 kernels give and PyTorch's CUDA float32
    # sqrt misses by an ulp on ~0.6% of inputs.
    nrm = torch.sqrt((nx * nx + ny * ny + nz * nz).double()).float().double()
    nx, ny, nz = ((c.double() / nrm).float() for c in (nx, ny, nz))

    row_idx = torch.arange(h, device=dev).reshape(h, 1)
    col_idx = torch.arange(w, device=dev).reshape(1, w)
    interior = (row_idx > 0) & (row_idx < h - 1) & (col_idx > 0) & (col_idx < w - 1)
    if valid is not None:
        vp = _pad_edge(valid)
        neigh_ok = (
            vp[1:-1, 1:-1] & vp[1:-1, 2:] & vp[1:-1, :-2] & vp[:-2, 1:-1] & vp[2:, 1:-1]
        )
        interior = interior & neigh_ok

    out = []
    for comp in (nx, ny, nz):
        encoded = 0.5 * (comp + 1.0)
        if quantize:
            encoded = quantize_unorm8(encoded)
        encoded = torch.where(interior, encoded, 0.0)
        # Decode like the vertex shader: 2*texel - 1 (`render_shader.wgsl:66`).
        out.append(2.0 * encoded - 1.0)
    return tuple(out)


def compute_normals(
    heights: torch.Tensor,
    pixel_scale,
    raster_point,
    model_point,
    valid: torch.Tensor | None = None,
    quantize: bool = True,
    correct_axes: bool = False,
):
    """Per-texel decoded normals ``f32[H, W, 3]`` in the tile-local frame
    (x=east, y=north, z=up): :func:`compute_normals_soa`'s planes stacked
    on the last axis, as the vertex shader reads them back
    (`render_shader.wgsl:66`)."""
    nx, ny, nz = compute_normals_soa(
        heights, pixel_scale, raster_point, model_point, valid=valid, quantize=quantize,
        correct_axes=correct_axes,
    )
    return torch.stack([nx, ny, nz], dim=-1)
