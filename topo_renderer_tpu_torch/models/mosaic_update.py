"""Incremental mosaic slot updates: one tile added or unloaded in O(tile).

Port of `topo_renderer_tpu/models/mosaic_update.py`. The reference adds and
removes one tile's GPU buffers per streaming event
(`terrain_renderer.rs:173-350,361-363`); here one slot update writes the
tile's region of the heights and recomputes every derived table (packed
attribute rows, per-cell corner rows, the average-height mips with their
attributes, the undilated and dilated max pyramids, the 2-D window tables)
on halo-padded slices around the slot only.

Bit-identity contract: updates applied to a mosaic built on a pinned canvas
(`build_mosaic(..., canvas=..., keep_hmax_raw=True)`) give tables equal bit
for bit to a fresh `build_mosaic` of the resulting tile set on that canvas,
provided the canvas halves exactly through every mip level
(`streaming_canvas_dim`) and tiles share their seam row/column or abut, so
that a texel's owner is decided by its location.

In the JAX package every slice start is traced and clamped on the device;
here starts and clamps are Python ints (``jax.lax.dynamic_slice``'s clamp
is `_cut`), so no device scalar is read. Blocks are written in place into
the mosaic's tables with ``copy_`` on views of the flat tensors, in place of
JAX's donation. Packed-normal words are float32 denormals, so every block
that holds them is built, sliced and written as int32 words.
"""

from __future__ import annotations

import dataclasses

import torch

from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT, TerrainMosaic, _pool_mean, world_packed


def streaming_canvas_dim(n: int, multiple: int = 1) -> int:
    """Smallest dimension >= n of the form b * 2^a with 4 <= b < 8 (or n for
    tiny n), so that the mip chain halves exactly at every level.
    ``multiple`` also forces divisibility (row-sharded canvases)."""
    if n < 8 and multiple <= 1:
        return n
    # d = b * 2^a with b in 4..7, so the odd part of ``multiple`` must
    # divide some b: raise instead of searching forever.
    p = multiple
    while p % 2 == 0:
        p //= 2
    if p > 1 and all(b % p for b in range(4, 8)):
        raise ValueError(
            f"canvas multiple {multiple} has odd factor {p}, incompatible "
            "with an exactly-halving (b * 2^a, 4 <= b < 8) canvas — use a "
            "power-of-two (or 3/5/7 x power-of-two) device count"
        )
    a = 0
    m = n
    while m >= 8:
        m = (m + 1) // 2
        a += 1
    while True:
        for b in range(max(m, 4), 8):
            d = b * (1 << a)
            if d >= n and d % multiple == 0:
                return d
        m = 4
        a += 1


def _packed_from_slice(h_slice, owner_slice, rot_flat, geo, level: int, y_abs: int, h_level: int,
                       quantize_normals: bool, correct_axes: bool):
    """Packed normal words (int32) of a level slice whose first row is the
    level's row ``y_abs`` (of ``h_level``): equal bit for bit to the canvas
    build's `world_packed` on those rows, since the per-row terms come from
    the level's whole row range."""
    v = h_slice > 0.5 * POISON_HEIGHT
    return world_packed(torch.where(v, h_slice, 0.0), v, owner_slice, rot_flat, geo, level,
                        quantize_normals=quantize_normals, correct_axes=correct_axes,
                        row_span=(y_abs, h_level))


HALO = 2


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(v, hi))


def _win(start: int, inner: int, table: int, pad: int):
    """Clamped slice bounds: (slice_start, size) for an ``inner`` + ``pad``
    halo window into a table of length ``table``."""
    size = min(inner + 2 * pad, table)
    return _clamp(start - pad, 0, table - size), size


def _region_geom(o: int, table: int, size: int) -> int:
    """Origin of the halo region a level's update reads: a ``size`` window
    clamped into ``[0, table]`` around the slot (slack 8 against the widest
    slice's 4)."""
    return _clamp(o - 8, 0, table - size)


def region_sizes(th: int, tw: int, shape, mip_shapes):
    """The (gh, gw) region sizes per level 0..L that `compute_slot_blocks`
    reads."""
    h_m, w_m = shape
    out = [(min(th + 16, h_m), min(tw + 16, w_m))]
    for lv, (h_l, w_l) in enumerate(mip_shapes, start=1):
        out.append((min((th >> lv) + 16, h_l), min((tw >> lv) + 16, w_l)))
    return out


def _cut(a, y: int, x: int, h: int, w: int):
    """``jax.lax.dynamic_slice`` over the two leading axes: the start clamps
    so that the window stays inside ``a``."""
    y = _clamp(y, 0, a.shape[0] - h)
    x = _clamp(x, 0, a.shape[1] - w)
    return a[y : y + h, x : x + w]


def _paste(a, b, y: int, x: int):
    """``jax.lax.dynamic_update_slice`` over the two leading axes, in place
    on ``a``; returns ``a``."""
    _cut(a, y, x, b.shape[0], b.shape[1]).copy_(b)
    return a


def _clamped_index(start: int, n: int, last: int, origin: int, size: int, device):
    """Region-relative indices of table rows ``min(start + k, last)`` for k
    in [0, n), clamped into the region as XLA's gather clamps them."""
    idx = torch.clamp(torch.arange(n, device=device) + start, 0, last) - origin
    return torch.clamp(idx, 0, size - 1)


def _words(x):
    """float32 plane -> its int32 words (a view)."""
    return x.view(torch.int32)


def compute_slot_blocks(
    read,  # read(kind, level, gy, gx) -> a copy of the [gh, gw] region
    shape, mip_shapes, win_levels,
    blk, oy, ox, owner_slices, rot_flat, geo,
    *,
    th: int,
    tw: int,
    quantize_normals: bool,
    correct_axes: bool,
    has_cell_table: bool,
):
    """The slot update's arithmetic, over a ``read`` of table regions.

    ``read`` kinds: ``"h"`` (average heights, f32; level 0 = base heights),
    ``"raw"`` (undilated max, f32; level 0 = base heights), ``"attr1"`` (the
    level-0 packed-normal plane as int32 words). Regions are the
    `region_sizes` windows at `_region_geom` origins, copies of the
    PRE-update tables; the slot write and every dependency inside the update
    are overlaid here.

    Returns ``[(table, level, block, y, x)]``, ``table`` one of
    ``heights/attr/win/cell/mip_avg/mip_attr/mip_raw/mip_dil`` in order of
    application; ``attr``, ``win``, ``cell`` and ``mip_attr`` blocks are
    int32 words.
    """
    h_m, w_m = shape
    dev = blk.device
    sizes = region_sizes(th, tw, shape, mip_shapes)
    oy = _clamp(int(oy), 0, h_m - th)
    ox = _clamp(int(ox), 0, w_m - tw)
    flags = dict(quantize_normals=quantize_normals, correct_axes=correct_axes)
    poison = torch.full((), POISON_HEIGHT, dtype=torch.float32, device=dev)  # no host copy
    blocks = []

    # ---- level 0: slot write, packed attrs, window table, cell rows -------
    gh0, gw0 = sizes[0]
    gy0 = _region_geom(oy, h_m, gh0)
    gx0 = _region_geom(ox, w_m, gw0)
    r0 = _paste(read("h", 0, gy0, gx0), blk, oy - gy0, ox - gx0)
    blocks.append(("heights", 0, blk, oy, ox))

    a_h, a_w = min(th + 4, h_m), min(tw + 4, w_m)  # attr inner: region +-1 (+2 slack)
    sy0, sh0 = _win(oy - 2, a_h, h_m, HALO)
    sx0, sw0 = _win(ox - 2, a_w, w_m, HALO)
    h_sl = _cut(r0, sy0 - gy0, sx0 - gx0, sh0, sw0)
    packed_sl = _packed_from_slice(h_sl, owner_slices[0], rot_flat, geo, 0, sy0, h_m, **flags)
    # Values are trusted HALO or more from the slice border, unless that
    # border is the table's.
    iy0 = _clamp(oy - 2, 0, h_m - a_h)
    ix0 = _clamp(ox - 2, 0, w_m - a_w)
    h_in = _words(_cut(h_sl, iy0 - sy0, ix0 - sx0, a_h, a_w))
    p_in = _cut(packed_sl, iy0 - sy0, ix0 - sx0, a_h, a_w)
    blocks.append(("attr", 0, torch.stack([h_in, p_in], dim=-1), iy0, ix0))
    if 0 in win_levels:
        blocks.append(("win", 0, torch.stack([h_in, p_in], dim=0), iy0, ix0))

    if has_cell_table:
        # Cells whose corner normals can change: validity flips at the
        # region's edge move the normals at region +-1, and cells at row
        # oy-2 take those texels as their south corners.
        c_h, c_w = min(th + 4, h_m), min(tw + 4, w_m)
        cy0 = _clamp(oy - 2, 0, h_m - c_h)
        cx0 = _clamp(ox - 2, 0, w_m - c_w)
        # Heights and the updated normals over the cell window +1 east and
        # south, clamped at the table edge as the build's shifts are.
        ra = _paste(read("attr1", 0, gy0, gx0), p_in, iy0 - gy0, ix0 - gx0)
        iy = _clamped_index(cy0, c_h + 1, h_m - 1, gy0, gh0, dev)[:, None]
        ix = _clamped_index(cx0, c_w + 1, w_m - 1, gx0, gw0, dev)[None, :]
        hc, pc = _words(r0)[iy, ix], ra[iy, ix]
        cell_blk = torch.stack(
            [hc[:-1, :-1], hc[:-1, 1:], hc[1:, :-1], hc[1:, 1:],
             pc[:-1, :-1], pc[:-1, 1:], pc[1:, :-1], pc[1:, 1:]],
            dim=-1,
        )
        blocks.append(("cell", 0, cell_blk, cy0, cx0))

    # ---- mip chains -------------------------------------------------------
    prev_avg, prev_raw = r0, r0  # level L-1 regions
    pg_y, pg_x = gy0, gx0  # their origins
    for lv in range(1, len(mip_shapes) + 1):
        h_l, w_l = mip_shapes[lv - 1]
        th_l = (th >> lv) + 2
        tw_l = (tw >> lv) + 2
        oy_l, ox_l = oy >> lv, ox >> lv
        gh, gw = sizes[lv]
        gy_l = _region_geom(oy_l, h_l, gh)
        gx_l = _region_geom(ox_l, w_l, gw)

        # Average pool over the inner (th_l + 2) window.
        p_h, p_w = min(th_l + 2, h_l), min(tw_l + 2, w_l)
        py = _clamp(oy_l - 1, 0, h_l - p_h)
        px = _clamp(ox_l - 1, 0, w_l - p_w)
        pooled = torch.maximum(_pool_mean(_cut(prev_avg, 2 * py - pg_y, 2 * px - pg_x, 2 * p_h, 2 * p_w)), poison)
        pooled = torch.where(pooled < 0.1 * POISON_HEIGHT, poison, pooled)
        blocks.append(("mip_avg", lv, pooled, py, px))
        avg_rg = _paste(read("h", lv, gy_l, gx_l), pooled, py - gy_l, px - gx_l)

        # Undilated max pool on a wider inner window (+2 ring for dilation).
        m_h, m_w = min(th_l + 4, h_l), min(tw_l + 4, w_l)
        my = _clamp(oy_l - 2, 0, h_l - m_h)
        mx = _clamp(ox_l - 2, 0, w_l - m_w)
        c = _cut(prev_raw, 2 * my - pg_y, 2 * mx - pg_x, 2 * m_h, 2 * m_w)
        pooledm = torch.maximum(torch.maximum(c[0::2, 0::2], c[0::2, 1::2]),
                                torch.maximum(c[1::2, 0::2], c[1::2, 1::2]))
        blocks.append(("mip_raw", lv, pooledm, my, mx))
        raw_rg = _paste(read("raw", lv, gy_l, gx_l), pooledm, my - gy_l, mx - gx_l)

        # 3x3 dilation of the raw table over the inner (th_l + 2) window.
        d_h, d_w = min(th_l + 2, h_l), min(tw_l + 2, w_l)
        dy = _clamp(oy_l - 1, 0, h_l - d_h)
        dx = _clamp(ox_l - 1, 0, w_l - d_w)
        iy = _clamped_index(dy - 1, d_h + 2, h_l - 1, gy_l, gh, dev)[:, None]
        ix = _clamped_index(dx - 1, d_w + 2, w_l - 1, gx_l, gw, dev)[None, :]
        rawp = raw_rg[iy, ix]
        dil = rawp[1:-1, 1:-1]
        for ddy in (0, 1, 2):
            for ddx in (0, 1, 2):
                dil = torch.maximum(dil, rawp[ddy : ddy + d_h, ddx : ddx + d_w])
        blocks.append(("mip_dil", lv, dil, dy, dx))

        # The level's packed attrs (and window table) from the new averages.
        al_h, al_w = min(th_l + 4, h_l), min(tw_l + 4, w_l)
        syl, shl = _win(oy_l - 2, al_h, h_l, HALO)
        sxl, swl = _win(ox_l - 2, al_w, w_l, HALO)
        h_sll = _cut(avg_rg, syl - gy_l, sxl - gx_l, shl, swl)
        packed_l = _packed_from_slice(h_sll, owner_slices[lv], rot_flat, geo, lv, syl, h_l, **flags)
        iyl = _clamp(oy_l - 2, 0, h_l - al_h)
        ixl = _clamp(ox_l - 2, 0, w_l - al_w)
        h_inl = _words(_cut(h_sll, iyl - syl, ixl - sxl, al_h, al_w))
        p_inl = _cut(packed_l, iyl - syl, ixl - sxl, al_h, al_w)
        blocks.append(("mip_attr", lv, torch.stack([h_inl, p_inl], dim=-1), iyl, ixl))
        if lv in win_levels:
            blocks.append(("win", lv, torch.stack([h_inl, p_inl], dim=0), iyl, ixl))

        prev_avg, prev_raw = avg_rg, raw_rg
        pg_y, pg_x = gy_l, gx_l

    return blocks


def check_halvable(shape, mip_shapes):
    h_m, w_m = shape
    for lv, (hl, wl) in enumerate([(h_m, w_m)] + list(mip_shapes)[:-1]):
        hn, wn = mip_shapes[lv]
        if hl != 2 * hn or wl != 2 * wn:
            raise ValueError(
                "apply_slot_update needs a canvas whose mip chain halves "
                "exactly (use streaming_canvas_dim)"
            )


def apply_slot_update(
    mosaic: TerrainMosaic,
    blk,
    oy: int,
    ox: int,
    owner_slices,
    rot_flat,
    geo,
    *,
    th: int,
    tw: int,
    quantize_normals: bool = True,
    correct_axes: bool = False,
) -> TerrainMosaic:
    """Write one tile slot (add: the tile's heights; unload: an all-POISON
    block) and recompute every derived table on halo slices, in place in
    ``mosaic``'s tensors. Returns the mosaic with its new ``hmax`` (the
    device max over the heights), carrying ``mosaic.host``.

    Args after ``mosaic``, on its device but for ``geo``: ``blk``
    (f32[th, tw] heights of the slot region, POISON outside tiles), ``oy,
    ox`` (its NW texel, ints), ``owner_slices`` (per level 0..L, the integer
    owner windows that `attr_slice_geometry` bounds), ``rot_flat``
    (f32[cap*9] slot rotations), ``geo`` (f32[4] lon_nw, lat_nw, ps_x, ps_y
    on the host, as the build's); ``th, tw`` the block's shape, and the
    normal-build flags.
    """
    h_m, w_m = mosaic.shape
    check_halvable(mosaic.shape, mosaic.mip_shapes)
    if len(mosaic.mip_hmax_raw_flat) != len(mosaic.mip_shapes):
        raise ValueError("apply_slot_update needs the raw max pyramid (build_mosaic(keep_hmax_raw=True))")
    if tuple(blk.shape) != (th, tw):
        raise ValueError(f"slot block of shape {tuple(blk.shape)}, not {(th, tw)}")

    def level(flat, lv, *tail):
        return flat.view(*mosaic.mip_shapes[lv - 1], *tail)

    heights = mosaic.heights_flat.view(h_m, w_m)
    attr = _words(mosaic.attr_packed_flat).view(h_m, w_m, 2)
    sizes = region_sizes(th, tw, mosaic.shape, mosaic.mip_shapes)

    def read(kind, lv, gy, gx):
        gh, gw = sizes[lv]
        if lv == 0:
            src = attr[..., 1] if kind == "attr1" else heights
        else:
            src = level(mosaic.mip_hmax_raw_flat[lv - 1] if kind == "raw" else mosaic.mip_heights_flat[lv - 1], lv)
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
        if table == "win":  # [2, h_l, w_l] planes, rows and columns first
            return _words(mosaic.win_attr_2d[lv]).permute(1, 2, 0)
        if table == "cell":
            return _words(mosaic.cell_heights_flat).view(h_m, w_m, 8)
        if table == "mip_avg":
            return level(mosaic.mip_heights_flat[lv - 1], lv)
        if table == "mip_raw":
            return level(mosaic.mip_hmax_raw_flat[lv - 1], lv)
        if table == "mip_dil":
            return level(mosaic.mip_hmax_flat[lv - 1], lv)
        return level(_words(mosaic.mip_attr_flat[lv - 1]), lv, 2)  # mip_attr

    for table, lv, block, y, x in blocks:
        _paste(target(table, lv), block.permute(1, 2, 0) if table == "win" else block, y, x)

    # As the build: the max over valid heights, 0.0 when none is valid.
    hmax_raw = heights.max()
    hmax = torch.where(hmax_raw < 0.5 * POISON_HEIGHT, 0.0, hmax_raw)
    return dataclasses.replace(mosaic, hmax=hmax)


def attr_slice_geometry(oy: int, ox: int, th: int, tw: int, shape, mip_shapes):
    """The slot update's packed-attr slices as [(level, sy, sx, sh, sw)];
    the engine cuts each level's owner window with exactly these bounds."""
    out = []
    for lv, (h_l, w_l) in enumerate([tuple(shape), *mip_shapes]):
        grow = 4 if lv == 0 else 6  # the inner window: the slot (+2 per side past level 0) +-2
        sy, sh = _win((oy >> lv) - 2, min((th >> lv) + grow, h_l), h_l, HALO)
        sx, sw = _win((ox >> lv) - 2, min((tw >> lv) + grow, w_l), w_l, HALO)
        out.append((lv, sy, sx, sh, sw))
    return out
