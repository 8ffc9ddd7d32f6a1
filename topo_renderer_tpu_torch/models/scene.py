"""Scene model: terrain tiles assembled into a device-resident mosaic.

Port of `topo_renderer_tpu/models/scene.py`. Adjacent COP-90 tiles share
their seam row/column, so all loaded tiles become one mosaic array; tile
identity survives as a per-texel owner index that applies each tile's own
normal->world rotation (`src/render/data.rs:120-127`).

``build_mosaic`` assembles the raw heights on the host (numpy, as the JAX
package does) and builds every derived table either on the engine's device
in PyTorch (:func:`_device_mosaic_tables`, the JAX package's device build)
or, with ``on_device=False``, on the host in numpy
(:func:`_host_mosaic_tables`, the JAX package's host build, which the
goldens' scenes take): normals, packed attribute rows, the average and
dilated-max mip pyramids, the 2-D window tables and the per-cell corner
rows.

Packed normals are 10-bit codes in 32-bit words that travel bitcast to
float32 (`attr_packed_flat[:, 1]`, `win_attr_2d[l][1]`, the last four
columns of `cell_heights_flat`). Words with a z code below 8 are float32
denormals, so they are built as ``torch.int32`` and reinterpreted with
``.view(torch.float32)``; no float arithmetic ever touches them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models.uniforms import normal_to_world_rotation
from topo_renderer_tpu_torch.ops.normals import compute_normals, compute_normals_soa

# Texels outside any loaded tile carry this height: no ray can hit a
# triangle with a poisoned corner (`terrain_renderer.rs:361-363`).
POISON_HEIGHT = -1.0e12


def pack_normals(normals_world: np.ndarray) -> np.ndarray:
    """Pack world-space normals ``[..., 3]`` into 10-bit-per-channel uint32
    words (host helper, as in the JAX package)."""
    enc = np.round(np.clip(0.5 * (normals_world + 1.0), 0.0, 1.0) * 1023.0).astype(np.uint32)
    return enc[..., 0] | (enc[..., 1] << 10) | (enc[..., 2] << 20)


def unpack_normals(packed: torch.Tensor, scale=1023.0):
    """Packed words (int32, or uint32 or float32 carrying the bits) -> three
    decoded float planes. CUDA divides by a host scalar as a multiply by its
    reciprocal; ``scale`` as a tensor on ``packed``'s device gives the
    correctly rounded quotient there, as JAX's decode is."""
    if packed.dtype in (torch.float32, torch.uint32):
        packed = packed.view(torch.int32)
    nx = 2.0 * ((packed & 0x3FF).to(torch.float32) / scale) - 1.0
    ny = 2.0 * (((packed >> 10) & 0x3FF).to(torch.float32) / scale) - 1.0
    nz = 2.0 * (((packed >> 20) & 0x3FF).to(torch.float32) / scale) - 1.0
    return nx, ny, nz


@dataclasses.dataclass
class TerrainTile:
    """One decoded DEM tile on the host (`background_runner.rs:267-269`)."""

    location: GeoLocation
    heights: np.ndarray  # f32[H, W], rows north -> south
    transform: CoordinateTransform

    @property
    def size(self) -> tuple[int, int]:
        return (self.heights.shape[1], self.heights.shape[0])


class MosaicHostData:
    """Host bookkeeping (valid mask, cell ownership, tile rotations) and host
    copies of ``model_point`` and ``pixel_scale`` (f32[2]), so that per-frame
    host arithmetic never reads them back from the device."""

    def __init__(self, valid, cell_tile, tile_rot, model_point, pixel_scale):
        self.valid = valid
        self.cell_tile = cell_tile
        self.tile_rot = tile_rot
        self.model_point = np.array(model_point, np.float32)
        self.pixel_scale = np.array(pixel_scale, np.float32)


@dataclasses.dataclass(frozen=True)
class TerrainMosaic:
    """Device-resident stitched terrain; the JAX package's fields, one for
    one. Raster<->model mapping: lon = gx * pixel_scale[0] + model_point[0],
    lat = -gy * pixel_scale[1] + model_point[1]."""

    heights_flat: Any  # f32[Hm*Wm], POISON_HEIGHT outside valid tiles
    attr_packed_flat: Any  # f32[Hm*Wm, 2]: (height, bitcast(normal)) rows
    cell_heights_flat: Any  # f32[Hm*Wm, 8]: corner heights NW, NE, SW, SE,
    # then the corners' bitcast packed normals; [1, 8] zeros when disabled
    has_cell_table: bool
    shape: tuple  # (Hm, Wm)
    mip_heights_flat: tuple  # per-level flat f32 height pyramids (level 1..)
    mip_attr_flat: tuple  # per-level packed (height, normal) rows (level 1..)
    mip_hmax_flat: tuple  # per-level dilated max-height bounds (level 1..)
    mip_shapes: tuple
    host: MosaicHostData
    model_point: Any  # f32[2] (lon, lat) of texel (0, 0)
    pixel_scale: Any  # f32[2] degrees per texel
    hmax: Any  # f32 scalar
    bound_center: Any  # f32[3] ECEF bounding-sphere centre
    bound_radius: Any  # f32 scalar
    # Per-level 2-D copies f32[2, h_l, w_l] (plane 0 heights, plane 1 packed
    # normal bits); None below the build's window_table_min.
    win_attr_2d: tuple = ()
    mip_hmax_raw_flat: tuple = ()  # undilated max pyramid (level 1..), streaming builds only
    # Row-sharded mosaics (`parallel/sharded_mosaic.py::shard_mosaic`): the
    # levels (0 = base) whose tables are tuples of per-band tensors, one per
    # device of a ("geo",) mesh; ``cell_sharded`` where the cell table is too.
    sharded_rows: tuple = ()
    cell_sharded: bool = False
    texel_m: float = 92.6  # base texel size hint, 3 significant digits

    @property
    def device(self) -> torch.device:
        """Where the replicated tables live and frames render (a sharded
        mosaic's lead device)."""
        return self.model_point.device

    @property
    def cell_width(self) -> int:
        """Columns of a cell-table row (8, or 8 in the [1, 8] placeholder)."""
        cell = self.cell_heights_flat
        return (cell[0] if isinstance(cell, tuple) else cell).shape[-1]

    def _rows(self, leaf):
        """A level-0 table whole: a sharded mosaic's bands joined in row
        order on the lead device, their padded rows included, as the JAX
        package's sharded arrays read."""
        if isinstance(leaf, tuple):
            return torch.cat([band.to(self.device) for band in leaf])
        return leaf

    # Accessors of the JAX package's mosaic; no render path reads them.
    @property
    def heights(self):
        """f32[Hm, Wm]."""
        return self._rows(self.heights_flat).reshape(self.shape)

    @property
    def normals_packed(self):
        """The packed normal words, uint32[Hm, Wm]."""
        words = self._rows(self.attr_packed_flat)[:, 1].view(torch.int32).contiguous()
        return words.view(torch.uint32).reshape(self.shape)

    @property
    def normals(self):
        """Decoded world-space normals, f32[Hm, Wm, 3], equal to JAX's decode
        on either device."""
        packed = self.normals_packed
        scale = torch.full((), 1023.0, dtype=torch.float32, device=packed.device)
        return torch.stack(unpack_normals(packed, scale), dim=-1)

    @property
    def valid(self):
        return self.host.valid

    @property
    def cell_tile(self):
        return self.host.cell_tile

    @property
    def tile_rot(self):
        return self.host.tile_rot


# The mosaic's tensor fields: what `mosaic_from_arrays` carries across.
ARRAY_FIELDS = (
    "heights_flat",
    "attr_packed_flat",
    "cell_heights_flat",
    "mip_heights_flat",
    "mip_attr_flat",
    "mip_hmax_flat",
    "model_point",
    "pixel_scale",
    "hmax",
    "bound_center",
    "bound_radius",
    "win_attr_2d",
    "mip_hmax_raw_flat",
)


def _texel_m_hint(ps_y_deg: float) -> float:
    """Metres per texel from the latitude pixel scale (meridian arc
    ~111,132 m/degree), 3 significant digits."""
    return float(f"{abs(float(ps_y_deg)) * 111_132.0:.3g}")


def build_max_mips(heights: np.ndarray, shapes, return_raw: bool = False):
    """Dilated max-height pyramid matching ``shapes`` (numpy, a copy of the
    JAX package's): each level-L texel bounds every height within its 2^L
    footprint plus a 1-texel ring; odd remainder rows/columns fold into the
    last texel's bound. ``return_raw`` also returns the undilated pyramid."""
    out = []
    raw = []
    cur = heights
    for (h2, w2) in shapes:
        ch = cur[: 2 * h2, : 2 * w2]
        pooled = ch.reshape(h2, 2, w2, 2).max(axis=(1, 3))
        if cur.shape[0] > 2 * h2:
            pooled[-1] = np.maximum(pooled[-1], cur[2 * h2 :, : 2 * w2].reshape(-1, w2, 2).max(axis=(0, 2)))
        if cur.shape[1] > 2 * w2:
            pooled[:, -1] = np.maximum(pooled[:, -1], cur[: 2 * h2, 2 * w2 :].reshape(h2, 2, -1).max(axis=(1, 2)))
        p = np.pad(pooled, 1, mode="edge")
        dil = pooled
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                dil = np.maximum(dil, p[dy : dy + h2, dx : dx + w2])
        out.append(dil.astype(np.float32))
        raw.append(pooled.astype(np.float32))
        cur = pooled
    return (out, raw) if return_raw else out


def build_height_mips(heights: np.ndarray, n_levels: int | None = None):
    """Average-pooled height pyramid (numpy, a copy of the JAX package's):
    poisoned texels stay poisoned, and anything an average touched with a
    poisoned texel is poisoned again. Levels stop before a dimension falls
    below 4 texels. Returns (mips, shapes)."""
    mips = []
    shapes = []
    cur = heights
    level = 0
    while True:
        h, w = cur.shape
        if (n_levels is not None and level >= n_levels) or min(h, w) < 8:
            break
        h2, w2 = h // 2, w // 2
        pooled = cur[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))
        pooled = np.maximum(pooled, np.float32(POISON_HEIGHT)).astype(np.float32)
        pooled[pooled < 0.1 * POISON_HEIGHT] = POISON_HEIGHT
        mips.append(pooled)
        shapes.append((h2, w2))
        cur = pooled
        level += 1
    return mips, shapes


def _pool_mean(c: torch.Tensor) -> torch.Tensor:
    # Mip pooling order: the JAX build sums 0.25*((a+b)+(c+d))
    # (`scene.py:397`); another association changes low bits and the mips
    # stop matching exactly.
    return 0.25 * ((c[0::2, 0::2] + c[0::2, 1::2]) + (c[1::2, 0::2] + c[1::2, 1::2]))


def _dilate3(pooled: torch.Tensor) -> torch.Tensor:
    """3x3 max over an edge-padded plane."""
    h2, w2 = pooled.shape
    p = torch.cat([pooled[:1], pooled, pooled[-1:]], dim=0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)
    dil = pooled
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            dil = torch.maximum(dil, p[dy : dy + h2, dx : dx + w2])
    return dil


def _shifts(x: torch.Tensor):
    """x and its edge-clamped east, south and south-east neighbours."""
    e = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    s_ = torch.cat([x[1:], x[-1:]], dim=0)
    se = torch.cat([s_[:, 1:], s_[:, -1:]], dim=1)
    return x, e, s_, se


def _enc10(c):
    return torch.round(torch.clamp(0.5 * (c + 1.0), 0.0, 1.0) * 1023.0).to(torch.int32)


def world_packed(h_for_normals, v, owner_l, rot_flat, geo, level: int, *, quantize_normals: bool,
                 correct_axes: bool, row_span=None):
    """World-space packed normal words (int32) of one pyramid level: the
    level's normals rotated by each texel's owning tile and packed 10/10/10.
    ``owner_l`` indexes the tiles of ``rot_flat`` f32[T*9]; ``geo`` f32[4] =
    (lon_nw, lat_nw, ps_x, ps_y) of the mosaic, on the host (the per-row
    terms are host work, `compute_normals_soa`); ``row_span`` as in
    `compute_normals_soa` (a slot update's slice of the level)."""
    lon_nw, lat_nw, ps_x, ps_y = geo[0], geo[1], geo[2], geo[3]
    s = float(2**level)
    off = (s - 1.0) / 2.0
    nx, ny, nz = compute_normals_soa(
        h_for_normals,
        (ps_x * s, ps_y * s),
        raster_point=(0.0, 0.0),
        model_point=(lon_nw + ps_x * off, lat_nw - ps_y * off),
        valid=v,
        quantize=quantize_normals,
        correct_axes=correct_axes,
        row_span=row_span,
    )

    def R(i, j):
        return rot_flat[3 * i + j :: 9][owner_l]

    wx = R(0, 0) * nx + R(0, 1) * ny + R(0, 2) * nz
    wy = R(1, 0) * nx + R(1, 1) * ny + R(1, 2) * nz
    wz = R(2, 0) * nx + R(2, 1) * ny + R(2, 2) * nz
    # 30-bit codes fit int32 with the sign bit clear.
    packed = _enc10(wx) | (_enc10(wy) << 10) | (_enc10(wz) << 20)
    # Invalid texels pack 0 whatever tile the borrow-clamp assigns them, so
    # a slot update can reproduce their bytes.
    return torch.where(v, packed, 0)


def _device_mosaic_tables(
    heights_raw: torch.Tensor,
    valid: torch.Tensor,
    owner: torch.Tensor,
    rot_flat: torch.Tensor,
    geo: torch.Tensor,
    *,
    quantize_normals: bool,
    correct_axes: bool,
    exact_tables: bool,
    window_table_min: int,
    keep_hmax_raw: bool = False,
):
    """Derived mosaic tables on ``heights_raw.device`` (port of
    `scene.py:310-479`; the reference's GPU normal compute shaders).

    Args: ``heights_raw`` f32[H, W] with zeros outside ``valid``; ``owner``
    int64[H, W] owning-tile index; ``rot_flat`` f32[T*9] row-major tile
    rotations; ``geo`` f32[4] = (lon_nw, lat_nw, ps_x, ps_y), a CPU tensor.
    ``keep_hmax_raw`` also returns the undilated max pyramid (``mip_hmax_raw``)
    that slot updates read.
    """
    poison = torch.tensor(POISON_HEIGHT, dtype=torch.float32, device=heights_raw.device)
    heights_p = torch.where(valid, heights_raw, poison)
    flags = dict(quantize_normals=quantize_normals, correct_axes=correct_axes)

    def pack_rows(h2d, packed2d):
        return torch.stack([h2d.reshape(-1), packed2d.view(torch.float32).reshape(-1)], dim=-1)

    def win2d(h2d, packed2d):
        return torch.stack([h2d, packed2d.view(torch.float32)], dim=0)

    packed0 = world_packed(heights_raw, valid, owner, rot_flat, geo, 0, **flags)

    mips = []
    cur = heights_p
    while min(cur.shape) >= 8:
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        pooled = torch.maximum(_pool_mean(cur[: 2 * h2, : 2 * w2]), poison)
        pooled = torch.where(pooled < 0.1 * POISON_HEIGHT, poison, pooled)
        mips.append(pooled)
        cur = pooled

    mip_attrs = []
    win_tables = [win2d(heights_p, packed0) if heights_raw.numel() > window_table_min else None]
    for level, mh in enumerate(mips, start=1):
        s = 2**level
        h_l, w_l = mh.shape
        v_l = mh > 0.5 * POISON_HEIGHT
        owner_l = owner[::s, ::s][:h_l, :w_l]
        packed_l = world_packed(torch.where(v_l, mh, 0.0), v_l, owner_l, rot_flat, geo, level, **flags)
        mip_attrs.append(pack_rows(mh, packed_l))
        win_tables.append(win2d(mh, packed_l) if mh.numel() > window_table_min else None)

    # Dilated max pyramid, folding odd remainder rows/cols into the last
    # texel's bound; the undilated levels are the raw pyramid.
    mip_hmax, mip_hmax_raw = [], []
    cur = heights_p
    for mh in mips:
        h2, w2 = mh.shape
        c = cur[: 2 * h2, : 2 * w2]
        pooled = torch.maximum(
            torch.maximum(c[0::2, 0::2], c[0::2, 1::2]),
            torch.maximum(c[1::2, 0::2], c[1::2, 1::2]),
        )
        if cur.shape[0] > 2 * h2:
            er = cur[2 * h2 :, : 2 * w2]
            em = torch.maximum(er[:, 0::2], er[:, 1::2]).amax(dim=0)
            pooled[-1] = torch.maximum(pooled[-1], em)
        if cur.shape[1] > 2 * w2:
            ec = cur[: 2 * h2, 2 * w2 :]
            em = torch.maximum(ec[0::2], ec[1::2]).amax(dim=1)
            pooled[:, -1] = torch.maximum(pooled[:, -1], em)
        mip_hmax.append(_dilate3(pooled))
        if keep_hmax_raw:
            mip_hmax_raw.append(pooled)
        cur = pooled

    if exact_tables:
        # Rows carry the 4 corner heights and the 4 corners' packed normals.
        planes = _shifts(heights_p) + _shifts(packed0.view(torch.float32))
        cell = torch.stack([p.reshape(-1) for p in planes], dim=-1)
        del planes
    else:
        cell = torch.zeros((1, 8), dtype=torch.float32, device=heights_raw.device)

    return dict(
        heights=heights_p.reshape(-1),
        attr=pack_rows(heights_p, packed0),
        cell=cell,
        mips=tuple(m.reshape(-1) for m in mips),
        mip_attrs=tuple(mip_attrs),
        mip_hmax=tuple(m.reshape(-1) for m in mip_hmax),
        mip_hmax_raw=tuple(m.reshape(-1) for m in mip_hmax_raw),
        win_attr_2d=tuple(win_tables),
    )


def _host_mosaic_tables(
    heights_raw: np.ndarray,
    valid: np.ndarray,
    owner: np.ndarray,
    rotations: np.ndarray,
    geo,
    *,
    quantize_normals: bool,
    correct_axes: bool,
    exact_tables: bool,
    window_table_min: int,
    keep_hmax_raw: bool = False,
):
    """Derived mosaic tables on the host, as numpy arrays (port of the JAX
    package's host build, `scene.py:700-822`). The normals come from
    :func:`compute_normals` on CPU tensors, as JAX's come from its eager
    `compute_normals`; rotation, packing, pyramids and cell rows are the
    same numpy code. Packed words are uint32 arrays until they are laid
    into float32 tables as bit patterns (``.view``), never as values.

    Args as :func:`_device_mosaic_tables`, but numpy, ``rotations``
    f32[T, 3, 3] and ``geo`` the Python floats (lon_nw, lat_nw, ps_x,
    ps_y): the level anchors are computed in float64, as JAX's host build
    does, and rounded to float32 inside `compute_normals`.
    """
    lon_nw, lat_nw, ps_x, ps_y = geo

    def world_packed_np(h, v, owner_l, s, model_point):
        n = compute_normals(
            torch.from_numpy(h), (ps_x * s, ps_y * s), raster_point=(0.0, 0.0), model_point=model_point,
            valid=torch.from_numpy(v), quantize=quantize_normals, correct_axes=correct_axes,
        ).numpy()
        # Rotate to world space per owning tile.
        nw = np.empty_like(n)
        for idx in range(len(rotations)):
            mask = owner_l == idx
            if mask.any():
                nw[mask] = n[mask] @ rotations[idx].T
        packed = pack_normals(nw)
        packed[~v] = 0  # slot-order-independent bytes for invalid texels
        return packed

    packed0 = world_packed_np(heights_raw, valid, owner, 1.0, (lon_nw, lat_nw))
    heights = heights_raw.copy()
    heights[~valid] = POISON_HEIGHT

    mips, mip_shapes = build_height_mips(heights)
    attr = np.stack([heights.reshape(-1), packed0.reshape(-1).view(np.float32)], axis=-1)
    win_tables = [
        np.stack([heights, packed0.view(np.float32)], axis=0) if heights.size > window_table_min else None
    ]
    mip_attrs = []
    for level, (mh, (h_l, w_l)) in enumerate(zip(mips, mip_shapes), start=1):
        s = float(2**level)
        off = (s - 1.0) / 2.0
        v_l = mh > 0.5 * POISON_HEIGHT
        packed_l = world_packed_np(
            np.where(v_l, mh, 0.0).astype(np.float32), v_l, owner[:: 2**level, :: 2**level][:h_l, :w_l], s,
            (lon_nw + ps_x * off, lat_nw - ps_y * off),
        )
        mip_attrs.append(np.stack([mh.reshape(-1), packed_l.reshape(-1).view(np.float32)], axis=-1))
        win_tables.append(np.stack([mh, packed_l.view(np.float32)], axis=0) if mh.size > window_table_min else None)

    if exact_tables:
        def shifts_np(x):
            e = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
            s_ = np.concatenate([x[1:], x[-1:]], axis=0)
            se = np.concatenate([s_[:, 1:], s_[:, -1:]], axis=1)
            return x, e, s_, se

        cell = np.stack(shifts_np(heights) + shifts_np(packed0.view(np.float32)), axis=-1).reshape(-1, 8)
    else:
        cell = np.zeros((1, 8), np.float32)

    hmax_dil, hmax_raw = build_max_mips(heights, mip_shapes, return_raw=True)
    return dict(
        heights=heights.reshape(-1),
        attr=attr,
        cell=cell,
        mips=tuple(m.reshape(-1) for m in mips),
        mip_attrs=tuple(mip_attrs),
        mip_hmax=tuple(m.reshape(-1) for m in hmax_dil),
        mip_hmax_raw=tuple(m.reshape(-1) for m in hmax_raw) if keep_hmax_raw else (),
        win_attr_2d=tuple(win_tables),
    )


def _words_to_device(a, device):
    """A numpy float32 table onto ``device`` as 32-bit words: packed
    normals in it are denormal bit patterns, so it crosses as int32."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_words_to_device(x, device) for x in a)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device).view(torch.float32)


def _resample_tile_lon(tile: TerrainTile, ps_fine: float, lon_anchor: float) -> TerrainTile:
    """Linearly resample a tile's rows onto the mosaic's fine longitude
    lattice (COP-90 bands above 50°N have wider longitude spacing)."""
    t = tile.transform
    ps_c = t.pixel_scale[0]
    lon0, lat0 = t.to_model((0.0, 0.0))
    lon_last = lon0 + ps_c * (tile.heights.shape[1] - 1)
    k0 = int(np.ceil((lon0 - lon_anchor) / ps_fine - 1e-6))
    k1 = int(np.floor((lon_last - lon_anchor) / ps_fine + 1e-6))
    lons = lon_anchor + ps_fine * np.arange(k0, k1 + 1)
    coarse_coords = (lons - lon0) / ps_c
    i0 = np.clip(np.floor(coarse_coords).astype(int), 0, tile.heights.shape[1] - 2)
    frac = (coarse_coords - i0).astype(np.float32)
    resampled = (tile.heights[:, i0] * (1.0 - frac) + tile.heights[:, i0 + 1] * frac).astype(
        np.float32
    )
    return TerrainTile(
        location=tile.location,
        heights=resampled,
        transform=CoordinateTransform(
            raster_point=(0.0, 0.0),
            model_point=(float(lons[0]), float(lat0)),
            pixel_scale=(float(ps_fine), float(t.pixel_scale[1])),
        ),
    )


def _mip_shapes(h_m: int, w_m: int) -> tuple:
    shapes = []
    while min(h_m, w_m) >= 8:
        h_m, w_m = h_m // 2, w_m // 2
        shapes.append((h_m, w_m))
    return tuple(shapes)


def bound_sphere(lon_nw, lat_nw, h_m, w_m, ps_x, ps_y, hmax: float):
    """The mosaic's bounding sphere over its geographic extent from 0 to
    ``hmax`` metres, in float64 on the host: ``(centre f32[3], radius
    f32)`` as numpy values."""
    lon_se = lon_nw + ps_x * (w_m - 1)
    lat_se = lat_nw - ps_y * (h_m - 1)
    corners = []
    for lon, lat in ((lon_nw, lat_nw), (lon_se, lat_nw), (lon_nw, lat_se), (lon_se, lat_se)):
        for hh in (0.0, hmax):
            lam, phi = np.radians(lon), np.radians(lat)
            r = 6_371_000.0 + hh
            corners.append((r * np.cos(phi) * np.cos(lam), r * np.cos(phi) * np.sin(lam), r * np.sin(phi)))
    corners = np.asarray(corners, np.float64)
    center = corners.mean(axis=0)
    radius = float(np.linalg.norm(corners - center, axis=1).max()) * 1.001 + 1.0
    return np.asarray(center, np.float32), np.float32(radius)


def build_mosaic(
    tiles: Sequence[TerrainTile],
    quantize_normals: bool = True,
    correct_axes: bool = False,
    exact_tables: bool = True,
    window_table_min: int = 262_144,
    device=None,
    canvas: tuple | None = None,
    keep_hmax_raw: bool = False,
    on_device: bool = True,
) -> TerrainMosaic:
    """Assemble decoded tiles into one stitched mosaic on ``device``.

    Host assembly as in the JAX package (`scene.py:542-657`): tiles share a
    latitude pixel scale, coarser longitude bands are resampled onto the
    finest lattice, texels land on a common grid with seam texels written
    once, and each texel's rotation comes from the tile owning its cell.
    The derived tables are then built on the device, or with
    ``on_device=False`` on the host (numpy; normals on CPU tensors) and
    copied to the device. The JAX package defaults to its host build; here
    the device build is the default, and the host build's tables equal
    it but for packed normals, within one 10-bit code.

    ``canvas=(lon_nw, lat_nw, h_m, w_m)`` pins the raster to a frame larger
    than the tiles' box (texels outside every tile stay poisoned); a tile
    outside it raises ValueError. The streaming engine builds on such a
    canvas so that slot updates (`models/mosaic_update.py`) keep static
    shapes and reproduce this build bit for bit. ``keep_hmax_raw`` keeps the
    undilated max pyramid (``mip_hmax_raw_flat``) they read.
    """
    from topo_renderer_tpu_torch import resolve_device

    device = resolve_device(device)
    if not tiles:
        raise ValueError("build_mosaic needs at least one tile")

    ps_y = tiles[0].transform.pixel_scale[1]
    for t in tiles:
        if not np.isclose(t.transform.pixel_scale[1], ps_y, rtol=1e-5):
            raise ValueError("mixed latitude pixel scales are not supported")
    ps_x = min(t.transform.pixel_scale[0] for t in tiles)
    if canvas is not None:
        lon_nw, lat_nw = float(canvas[0]), float(canvas[1])
    else:
        lon_nw = min(t.transform.to_model((0.0, 0.0))[0] for t in tiles)
        lat_nw = max(t.transform.to_model((0.0, 0.0))[1] for t in tiles)

    native_res = [bool(np.isclose(t.transform.pixel_scale[0], ps_x, rtol=1e-5)) for t in tiles]
    tiles = [
        t if native else _resample_tile_lon(t, ps_x, lon_nw)
        for t, native in zip(tiles, native_res)
    ]

    offsets = []
    for t in tiles:
        lon0, lat0 = t.transform.to_model((0.0, 0.0))
        ox = round((lon0 - lon_nw) / ps_x)
        oy = round((lat_nw - lat0) / ps_y)
        if abs((lon0 - lon_nw) / ps_x - ox) > 0.02 or abs((lat_nw - lat0) / ps_y - oy) > 0.02:
            raise ValueError("tile grids are not aligned to a common raster")
        offsets.append((ox, oy))

    if canvas is not None:
        h_m, w_m = int(canvas[2]), int(canvas[3])
        for (ox, oy), t in zip(offsets, tiles):
            if ox < 0 or oy < 0 or oy + t.heights.shape[0] > h_m or ox + t.heights.shape[1] > w_m:
                raise ValueError("tile falls outside the pinned canvas")
    else:
        h_m = max(oy + t.heights.shape[0] for (ox, oy), t in zip(offsets, tiles))
        w_m = max(ox + t.heights.shape[1] for (ox, oy), t in zip(offsets, tiles))

    heights = np.zeros((h_m, w_m), np.float32)
    valid = np.zeros((h_m, w_m), bool)
    cell_tile = np.full((h_m, w_m), -1, np.int32)
    rotations = np.zeros((len(tiles), 3, 3), np.float32)

    # Resampled tiles first so native data wins shared seam texels, then
    # the reference's BTreeMap location order.
    order = sorted(range(len(tiles)), key=lambda i: (1 if native_res[i] else 0, tiles[i].location))
    for idx in order:
        t = tiles[idx]
        ox, oy = offsets[idx]
        th, tw = t.heights.shape
        heights[oy : oy + th, ox : ox + tw] = t.heights
        valid[oy : oy + th, ox : ox + tw] = True
        cell_tile[oy : oy + th - 1, ox : ox + tw - 1] = idx
        rotations[idx] = normal_to_world_rotation(
            t.transform.model_point[0], t.transform.model_point[1]
        )[:3, :3].numpy()

    # The last row/column have no own cell: they borrow the adjacent cell's
    # owner.
    owner = cell_tile[
        np.minimum(np.arange(h_m), h_m - 2)[:, None],
        np.minimum(np.arange(w_m), w_m - 2)[None, :],
    ]
    owner = np.where(owner < 0, 0, owner)

    hmax = float(heights[valid].max()) if valid.any() else 0.0
    center, radius = bound_sphere(lon_nw, lat_nw, h_m, w_m, ps_x, ps_y, hmax)

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(device)

    model_point = np.array([lon_nw, lat_nw], np.float32)
    pixel_scale = np.array([abs(ps_x), abs(ps_y)], np.float32)
    flags = dict(
        quantize_normals=bool(quantize_normals),
        correct_axes=bool(correct_axes),
        exact_tables=bool(exact_tables),
        window_table_min=int(window_table_min),
        keep_hmax_raw=bool(keep_hmax_raw),
    )
    if on_device:
        arrs = _device_mosaic_tables(
            dev(heights),
            dev(valid),
            dev(owner, torch.int64),
            dev(rotations.reshape(-1)),
            torch.tensor([lon_nw, lat_nw, ps_x, ps_y], dtype=torch.float32),
            **flags,
        )
    else:
        host = _host_mosaic_tables(heights, valid, owner, rotations, (lon_nw, lat_nw, ps_x, ps_y), **flags)
        arrs = {k: _words_to_device(v, device) for k, v in host.items()}
        del host
    return TerrainMosaic(
        heights_flat=arrs["heights"],
        attr_packed_flat=arrs["attr"],
        cell_heights_flat=arrs["cell"],
        has_cell_table=bool(exact_tables),
        shape=(h_m, w_m),
        mip_heights_flat=arrs["mips"],
        mip_attr_flat=arrs["mip_attrs"],
        mip_hmax_flat=arrs["mip_hmax"],
        mip_hmax_raw_flat=arrs["mip_hmax_raw"],
        mip_shapes=_mip_shapes(h_m, w_m),
        win_attr_2d=arrs["win_attr_2d"],
        host=MosaicHostData(valid, cell_tile, rotations, model_point, pixel_scale),
        model_point=dev(model_point),
        pixel_scale=dev(pixel_scale),
        hmax=dev(np.float32(hmax)),
        bound_center=dev(center),
        bound_radius=dev(radius),
        texel_m=_texel_m_hint(ps_y),
    )


def mosaic_from_arrays(
    arrays: Mapping[str, Any], *, shape, mip_shapes, texel_m: float, device=None
) -> TerrainMosaic:
    """A `TerrainMosaic` from another build's tables given as numpy arrays
    (``ARRAY_FIELDS``; tuples per level, ``None`` entries of
    ``win_attr_2d`` stay ``None``). Bits are carried unchanged."""
    from topo_renderer_tpu_torch import resolve_device

    device = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            return tuple(conv(x) for x in a)
        return torch.from_numpy(np.array(a)).to(device)

    t = {name: conv(arrays[name]) for name in ARRAY_FIELDS}
    return TerrainMosaic(
        **t,
        has_cell_table=t["cell_heights_flat"].shape[0] > 1,
        shape=tuple(shape),
        mip_shapes=tuple(tuple(s) for s in mip_shapes),
        host=MosaicHostData(None, None, None, arrays["model_point"], arrays["pixel_scale"]),
        texel_m=float(texel_m),
    )


@dataclasses.dataclass(frozen=True)
class Scene:
    """Everything a render call needs (reference: `ApplicationData` +
    `Uniforms`, `src/data/application_data.rs:16-45`)."""

    mosaic: TerrainMosaic
    camera: Any  # models.camera.Camera
    pixelize_n: Any = 100.0  # disabled by default (`application_data.rs:31`)
