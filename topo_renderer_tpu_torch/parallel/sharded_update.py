"""Incremental slot updates against a row-sharded mosaic.

Port of `topo_renderer_tpu/parallel/sharded_update.py`: streaming
(`models/mosaic_update.py`) composed with sharded capacity
(`parallel/sharded_mosaic.py`), so that a tile change at multi-device scale
touches one slot, not every band.

One update:
  1. the update math needs tile-sized halo regions of a few tables
     (`models/mosaic_update.region_sizes`); a sharded table's region is
     assembled on the lead device from the rows each band owns;
  2. `models/mosaic_update.compute_slot_blocks`, the function the
     replicated update runs, computes every derived block from those
     regions once, on the lead device;
  3. each block is written in place: into the rows of each band it meets
     on a sharded table (`_band_write`, `_band_write_axis1`), with `copy_`
     on int32 views as the replicated update writes; `hmax` is the `pmax`
     of the bands' maxima.

Region and block bounds are Python ints, as in the replicated update, so a
band's share of a region or a block is a static slice: no mask is needed
and no device value is read. Because step 2 is shared code on equal region
values, the result equals `shard_mosaic(apply_slot_update(replicated))`
bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from topo_renderer_tpu_torch.models.mosaic_update import (
    _clamp,
    _cut,
    _paste,
    _words,
    check_halvable,
    compute_slot_blocks,
    region_sizes,
)
from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT, TerrainMosaic
from topo_renderer_tpu_torch.parallel.mesh import pmax
from topo_renderer_tpu_torch.parallel.sharded_mosaic import GEO_AXIS, _check_mesh, n_bands


def _band_rows(bands, y: int, n: int):
    """(band, first row inside it, first row of the span, rows) for every
    band that rows [y, y + n) of a row-sharded table meet."""
    h_loc = bands[0].shape[0]
    out = []
    for b, band in enumerate(bands):
        lo, hi = max(y, b * h_loc), min(y + n, (b + 1) * h_loc)
        if lo < hi:
            out.append((band, lo - b * h_loc, lo - y, hi - lo))
    return out


def _band_read(bands, y: int, x: int, h: int, w: int, device):
    """`_cut` of a row-sharded table (bands with rows on axis 0): the
    ``[h, w]`` region at (y, x), clamped into the table, each row taken
    from the band that owns it, on ``device``."""
    y = _clamp(y, 0, bands[0].shape[0] * len(bands) - h)
    x = _clamp(x, 0, bands[0].shape[1] - w)
    return torch.cat([band[r0 : r0 + n, x : x + w].to(device) for band, r0, _, n in _band_rows(bands, y, h)])


def _band_write(bands, block, y: int, x: int):
    """`_paste` into a row-sharded table: each band's rows of ``block``
    (global origin (y, x), clamped as `_paste` clamps) copied in place."""
    bh, bw = block.shape[0], block.shape[1]
    y = _clamp(y, 0, bands[0].shape[0] * len(bands) - bh)
    x = _clamp(x, 0, bands[0].shape[1] - bw)
    for band, r0, k0, n in _band_rows(bands, y, bh):
        band[r0 : r0 + n, x : x + bw].copy_(block[k0 : k0 + n])


def _band_write_axis1(bands, block, y: int, x: int):
    """`_band_write` for the ``[C, h, w]`` window tables (rows on axis 1)."""
    _band_write(tuple(t.permute(1, 2, 0) for t in bands), block.permute(1, 2, 0), y, x)


def apply_slot_update_sharded(
    mosaic: TerrainMosaic,
    blk,
    oy: int,
    ox: int,
    owner_slices,
    rot_flat,
    geo,
    mesh=None,
    *,
    th: int,
    tw: int,
    quantize_normals: bool = True,
    correct_axes: bool = False,
    axis: str = GEO_AXIS,
) -> TerrainMosaic:
    """Sharded-table counterpart of `models.mosaic_update.apply_slot_update`
    (its argument convention; ``blk``, ``owner_slices`` and ``rot_flat`` on
    the lead device). Needs a mosaic from `shard_mosaic` over a streaming
    canvas built with ``keep_hmax_raw=True`` whose sharded levels needed no
    padding (`RenderEngine` sizes its canvas rows to a multiple of ``8 *
    n_dev * 4``), so that the mip chain still halves exactly. Writes the
    tables in place and returns the mosaic with its new ``hmax``."""
    _check_mesh(mosaic, mesh, axis)
    n_dev = n_bands(mosaic)
    h_m, w_m = mosaic.shape
    check_halvable(mosaic.shape, mosaic.mip_shapes)
    if len(mosaic.mip_hmax_raw_flat) != len(mosaic.mip_shapes):
        raise ValueError("apply_slot_update_sharded needs build_mosaic(keep_hmax_raw=True)")
    if tuple(blk.shape) != (th, tw):
        raise ValueError(f"slot block of shape {tuple(blk.shape)}, not {(th, tw)}")
    if h_m % n_dev:
        raise ValueError(f"canvas rows {h_m} not divisible by {axis}={n_dev}")
    lead = mosaic.device

    def rows2d(table, lv, *tail):
        """Row-leading view(s) of a level's table: a tensor, or per band."""
        h_l, w_l = (h_m, w_m) if lv == 0 else mosaic.mip_shapes[lv - 1]
        if isinstance(table, tuple):
            return tuple(t.view(h_l // n_dev, w_l, *tail) for t in table)
        return table.view(h_l, w_l, *tail)

    def words(table):
        return tuple(_words(t) for t in table) if isinstance(table, tuple) else _words(table)

    heights = rows2d(mosaic.heights_flat, 0)
    attr = rows2d(words(mosaic.attr_packed_flat), 0, 2)
    sizes = region_sizes(th, tw, mosaic.shape, mosaic.mip_shapes)

    def read(kind, lv, gy, gx):
        gh, gw = sizes[lv]
        if lv == 0:
            src = tuple(a[..., 1] for a in attr) if kind == "attr1" else heights
        else:
            src = rows2d(mosaic.mip_hmax_raw_flat[lv - 1] if kind == "raw" else mosaic.mip_heights_flat[lv - 1], lv)
        if isinstance(src, tuple):
            return _band_read(src, gy, gx, gh, gw, lead)
        return _cut(src, gy, gx, gh, gw).clone()

    win_levels = {lv for lv, t in enumerate(mosaic.win_attr_2d) if t is not None}
    blocks = compute_slot_blocks(
        read, mosaic.shape, mosaic.mip_shapes, win_levels,
        blk, oy, ox, owner_slices, rot_flat, geo,
        th=th, tw=tw, quantize_normals=quantize_normals,
        correct_axes=correct_axes, has_cell_table=mosaic.has_cell_table,
    )

    def target(table, lv):
        if table == "heights":
            return heights
        if table == "attr":
            return attr
        if table == "cell":
            return rows2d(words(mosaic.cell_heights_flat), 0, 8)
        if table == "mip_avg":
            return rows2d(mosaic.mip_heights_flat[lv - 1], lv)
        if table == "mip_raw":
            return rows2d(mosaic.mip_hmax_raw_flat[lv - 1], lv)
        if table == "mip_dil":
            return rows2d(mosaic.mip_hmax_flat[lv - 1], lv)
        return rows2d(words(mosaic.mip_attr_flat[lv - 1]), lv, 2)  # mip_attr

    for table, lv, block, y, x in blocks:
        if table == "win":  # [2, h_l, w_l] planes
            win = words(mosaic.win_attr_2d[lv])
            if isinstance(win, tuple):
                _band_write_axis1(win, block, y, x)
            else:
                _paste(win.permute(1, 2, 0), block.permute(1, 2, 0), y, x)
            continue
        dst = target(table, lv)
        if isinstance(dst, tuple):
            _band_write(dst, block, y, x)
        else:
            _paste(dst, block, y, x)

    # As the build: the max over valid heights, 0.0 when none is valid.
    hmax_raw = pmax([band.max() for band in heights], lead)  # level 0 is always sharded
    hmax = torch.where(hmax_raw < 0.5 * POISON_HEIGHT, 0.0, hmax_raw)
    return dataclasses.replace(mosaic, hmax=hmax)
