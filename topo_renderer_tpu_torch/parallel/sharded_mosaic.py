"""Row-sharded mosaic: scene capacity scales with the device count.

Port of `topo_renderer_tpu/parallel/sharded_mosaic.py`. `shard_mosaic`
splits the large tables (base heights and attributes, the 2-D window tables
and every mip level above a size threshold, and on request the per-cell
corner table) into contiguous row bands, one per device of a ``("geo",)``
mesh; a sharded leaf of the `TerrainMosaic` is a tuple of per-band tensors,
each on its device. Every small table is replicated on the mesh's lead
device.

The JAX package runs the whole render on every device inside a `shard_map`
and returns replicated outputs. Here the render runs once, on the lead
device; only the reads of sharded tables run per band:

  * clipmap window extraction (`extract_clipmap_windows_sharded`): each band
    copies the part of the eye-centred window that meets its rows with
    kernel K2 (one launch per band and window shape), clamped into the band
    on the device, and the window's rows are selected from their owner
    bands onto the lead device (`_sharded_windows`); windows taller than a
    band are assembled from every band they span. The render then consumes
    windows equal to the replicated extraction's, so frames are equal bit
    for bit (`render_perspective_fast_sharded`, the engine's panoramas);
  * batched extraction (`render_batch_scan_sharded`): pass 1 copies every
    eye's band windows with one K3 launch per band, then each level's
    windows are assembled once, then each eye renders from its own;
  * the triangle-exact frame (`render_perspective_sharded`): every cell-row
    read goes through `ops/surface.py::cell_rows`, which gathers in each
    band and selects the owner's rows (`parallel/mesh.py::gather_rows`).

Band bounds are Python ints from the static shapes; window origins and row
masks stay on the device, so a sharded frame reads no device value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT, TerrainMosaic
from topo_renderer_tpu_torch.ops.geometry import f32
from topo_renderer_tpu_torch.ops.panorama import (
    EYES_PER_LAUNCH,
    PanoramaSpec,
    _bilinear_levels,
    _clipmap_window_plan,
    _extract_windows,
    _eye_raster,
    _quad_rows,
    _texel_m,
    _window_batch,
    _window_origin,
    render_panorama,
)
from topo_renderer_tpu_torch.ops.window_slice import window_slice_multi, window_slice_multi_batched

GEO_AXIS = "geo"


def _band_devices(mesh, axis: str) -> list:
    """The devices along ``axis`` (the first along every other axis)."""
    i = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, i, 0).reshape(mesh.devices.shape[i], -1)[:, 0])


def _split_rows(t, n_rows: int, h_loc: int, devices, row_axis: int, poison_at):
    """Per-band copies of ``t``'s rows along ``row_axis`` (``h_loc`` rows
    each, band b on ``devices[b]``), moved as int32 words. Rows past
    ``n_rows`` are padding: zero words, with ``POISON_HEIGHT`` at
    ``pad[poison_at]``."""
    words = t.view(torch.int32)
    bands = []
    for b, dev in enumerate(devices):
        lo = b * h_loc
        n_real = max(0, min(n_rows, lo + h_loc) - lo)
        shape = list(t.shape)
        shape[row_axis] = h_loc
        band = torch.empty(shape, dtype=t.dtype, device=dev)
        if n_real:
            band.view(torch.int32).narrow(row_axis, 0, n_real).copy_(words.narrow(row_axis, lo, n_real))
        if n_real < h_loc:
            pad = band.narrow(row_axis, n_real, h_loc - n_real)
            pad.zero_()
            pad[poison_at] = POISON_HEIGHT
        bands.append(band)
    return tuple(bands)


def shard_mosaic(
    mosaic: TerrainMosaic,
    mesh,
    *,
    axis: str = GEO_AXIS,
    size_threshold: int = 2_000_000,
    keep_cell_table: bool = False,
) -> TerrainMosaic:
    """A copy of ``mosaic`` with its large tables split into row bands over
    ``mesh``'s ``axis``.

    Row counts are padded with poisoned texels (never hit) to a multiple of
    ``8 * n_dev``, so bands split evenly and window origins keep their
    8-row alignment. Level 0 is always sharded, a mip level where it holds
    more than ``size_threshold`` texels, its 2-D window table with it;
    ``keep_cell_table`` shards the per-cell corner table too (the exact
    frame's), else the copy has none. Every other table is copied to the
    mesh's lead device, so the sharded mosaic owns all its memory and an
    update of either mosaic leaves the other as it was.
    """
    if mosaic.sharded_rows:
        raise ValueError("shard_mosaic takes a replicated mosaic")
    devices = _band_devices(mesh, axis)
    n_dev = len(devices)
    lead = mesh.lead
    h, w = mosaic.shape

    def rows_padded(hh):
        m = 8 * n_dev
        return -(-hh // m) * m

    def own(x):
        return None if x is None else x.to(lead, copy=True)

    def split(t, n_rows, poison_at, row_axis=0):
        return _split_rows(t, n_rows, rows_padded(n_rows) // n_dev, devices, row_axis, poison_at)

    heights_flat = tuple(b.reshape(-1) for b in split(mosaic.heights_flat.view(h, w), h, ...))
    attr_flat = tuple(b.reshape(-1, 2) for b in split(mosaic.attr_packed_flat.view(h, w, 2), h, (..., 0)))

    sharded_levels = [0]
    mip_h, mip_a, mip_shapes = [], [], []
    for lv, (hl, wl) in enumerate(mosaic.mip_shapes):
        if hl * wl > size_threshold:
            sharded_levels.append(lv + 1)
            mip_h.append(tuple(b.reshape(-1) for b in split(mosaic.mip_heights_flat[lv].view(hl, wl), hl, ...)))
            mip_a.append(tuple(b.reshape(-1, 2) for b in split(mosaic.mip_attr_flat[lv].view(hl, wl, 2), hl,
                                                                (..., 0))))
            mip_shapes.append((rows_padded(hl), wl))
        else:
            mip_h.append(own(mosaic.mip_heights_flat[lv]))
            mip_a.append(own(mosaic.mip_attr_flat[lv]))
            mip_shapes.append((hl, wl))

    win2d = []
    for lv, t in enumerate(mosaic.win_attr_2d):
        if t is None or lv not in sharded_levels:
            win2d.append(own(t))
        else:
            win2d.append(split(t, t.shape[1], (0,), row_axis=1))  # plane 0 holds heights

    if keep_cell_table and mosaic.has_cell_table:
        cw = mosaic.cell_width
        cell = tuple(b.reshape(-1, cw) for b in split(mosaic.cell_heights_flat.view(h, w, cw), h,
                                                       (..., slice(0, min(4, cw)))))
        has_cell = True
    else:
        cell = torch.zeros((1, 8), dtype=torch.float32, device=lead)
        has_cell = False

    return dataclasses.replace(
        mosaic,
        heights_flat=heights_flat,
        attr_packed_flat=attr_flat,
        cell_heights_flat=cell,
        has_cell_table=has_cell,
        cell_sharded=has_cell,
        shape=(rows_padded(h), w),
        mip_heights_flat=tuple(mip_h),
        mip_attr_flat=tuple(mip_a),
        mip_hmax_flat=tuple(own(x) for x in mosaic.mip_hmax_flat),
        mip_hmax_raw_flat=tuple(own(x) for x in mosaic.mip_hmax_raw_flat),
        mip_shapes=tuple(mip_shapes),
        win_attr_2d=tuple(win2d),
        sharded_rows=tuple(sharded_levels),
        model_point=own(mosaic.model_point),
        pixel_scale=own(mosaic.pixel_scale),
        hmax=own(mosaic.hmax),
        bound_center=own(mosaic.bound_center),
        bound_radius=own(mosaic.bound_radius),
    )


def n_bands(mosaic) -> int:
    return len(mosaic.heights_flat)


def _check_mesh(mosaic, mesh, axis: str):
    if not mosaic.sharded_rows:
        raise ValueError("a sharded path needs a mosaic from shard_mosaic()")
    if mesh is not None and mesh.shape[axis] != n_bands(mosaic):
        raise ValueError(f"mosaic has {n_bands(mosaic)} row bands, mesh axis {axis!r} {mesh.shape[axis]} devices")


def _level_bands(mosaic, level: int, use_attr: bool):
    """A sharded level's bands that its windows are cut from, and their
    kind: the 2-D window table ("win", [2, h_loc, w]), else the flat
    attribute rows ("attr") or heights ("h")."""
    win2d = mosaic.win_attr_2d[level] if level < len(mosaic.win_attr_2d) else None
    if use_attr and win2d is not None:
        return win2d, "win"
    if use_attr:
        return (mosaic.attr_packed_flat if level == 0 else mosaic.mip_attr_flat[level - 1]), "attr"
    return (mosaic.heights_flat if level == 0 else mosaic.mip_heights_flat[level - 1]), "h"


def _masked_rows_3d_local(sl, lo: int, h_loc: int, cs, sy, wsy: int):
    """One band's contribution to B windows of ``wsy`` rows (JAX's
    `_masked_rows_3d_local`, after the band-local slice): ``sl [B, C,
    size_s, wsx]`` holds band rows ``[lo + cs, lo + cs + size_s)``. Returns
    each window row taken from the slice as int32 words ``[B, C, wsy,
    wsx]``, and the mask ``[B, 1, wsy, 1]`` of the rows this band owns."""
    size_s = sl.shape[2]
    rows_g = sy[:, None] + torch.arange(wsy, dtype=torch.int32, device=sy.device)  # wanted global rows
    k = rows_g - (lo + cs[:, None])  # their index inside the clamped slice
    ok = (rows_g >= lo) & (rows_g < lo + h_loc) & (k >= 0) & (k < size_s)
    b, c, _, wsx = sl.shape
    idx = torch.clamp(k, 0, size_s - 1).long()[:, None, :, None].expand(b, c, wsy, wsx)
    return sl.view(torch.int32).gather(2, idx), ok[:, None, :, None]


def _sharded_windows(mosaic, gx_e, gy_e, spec: PanoramaSpec, *, batched: bool):
    """Every windowed sharded level's windows for the eyes at raster
    coordinates ``gx_e``, ``gy_e`` ``f32[B]``: ``{level: (win f32[B, C,
    wsy, wsx], sx i32[B], sy i32[B])}`` on the lead device (C = 2: height
    and normal-bit planes, or 1: heights for specs without profile
    attributes).

    Per band, each level's window is cut where it meets the band: the
    origin row clamped into the band on the device (``size_s = min(wsy,
    h_loc)`` rows), one launch per band and window shape, K3 for
    ``batched`` (B eyes), else K2 (one eye). Flat attribute rows are cut as
    a ``[h_loc, 2 W]`` table of words. Then each window row is selected
    from the band that owns it.
    """
    lead = mosaic.device
    n_levels = len(mosaic.mip_shapes)
    use_attr = bool(spec.attrs_from_profile and spec.lod and n_levels)
    todo = [(level, wsy, wsx, h_t, w_t) for level, use, wsy, wsx, (h_t, w_t) in _clipmap_window_plan(spec, mosaic)
            if use and level in mosaic.sharded_rows]
    n_dev = n_bands(mosaic)
    origin = {level: _window_origin(gx_e, gy_e, level, wsy, wsx, h_t, w_t) for level, wsy, wsx, h_t, w_t in todo}
    acc: dict = {}  # level -> the selected window words so far
    for b in range(n_dev):
        groups: dict = {}
        for level, wsy, wsx, h_t, w_t in todo:
            bands, kind = _level_bands(mosaic, level, use_attr)
            h_loc = h_t // n_dev
            size_s = min(wsy, h_loc)
            sx, sy = origin[level]
            cs = torch.clamp(sy - b * h_loc, 0, h_loc - size_s)
            if kind == "win":
                table, ox, wx = bands[b], sx, wsx
            elif kind == "attr":
                table, ox, wx = bands[b].view(h_loc, 2 * w_t), 2 * sx, 2 * wsx
            else:
                table, ox, wx = bands[b].view(h_loc, w_t), sx, wsx
            groups.setdefault((size_s, wx), []).append((level, kind, wsy, wsx, h_loc, table, cs,
                                                        torch.stack([cs, ox], dim=-1)))
        for (size_s, wx), items in groups.items():
            dev = items[0][5].device
            origins = torch.stack([it[7] for it in items], dim=1).to(dev)  # [B, L, 2]
            tables = [it[5] for it in items]
            if batched:
                wins = window_slice_multi_batched(tables, origins.contiguous(), wsy=size_s, wsx=wx)
            else:
                wins = tuple(w_[None] for w_ in window_slice_multi(tables, origins[0].contiguous(),
                                                                  wsy=size_s, wsx=wx))
            for (level, kind, wsy, wsx, h_loc, _, cs, _), win in zip(items, wins):
                if kind == "attr":
                    win = win.reshape(win.shape[0], size_s, wsx, 2).permute(0, 3, 1, 2)
                elif kind == "h":
                    win = win[:, None]
                rows, ok = _masked_rows_3d_local(win.to(lead), b * h_loc, h_loc, cs, origin[level][1], wsy)
                # Selection (`parallel/mesh.py::select`) one band at a time.
                prev = acc.get(level)
                acc[level] = torch.where(ok, rows, 0 if prev is None else prev)
    return {level: (acc[level].view(torch.float32), *origin[level]) for level, *_ in todo}


def _window_entry(win, sx, sy, use_attr: bool, quad: bool):
    """One eye's window ``f32[C, wsy, wsx]`` in `extract_clipmap_windows`'
    per-level form ``(tbl_h, tbl_a, tbl_q, ox, oy)``."""
    if use_attr:
        return (None, win.reshape(2, -1).T, _quad_rows(win) if quad else None, sx, sy)
    return (win[0].reshape(-1), None, None, sx, sy)


def extract_clipmap_windows_sharded(mosaic: TerrainMosaic, eye, spec: PanoramaSpec, mesh=None,
                                    axis: str = GEO_AXIS):
    """Sharded-table counterpart of `ops.panorama.extract_clipmap_windows`:
    the same origins, each sharded level cut band by band (K2) and its rows
    selected onto the lead device (`_sharded_windows`), the replicated
    windowed levels as the replicated extraction cuts them. The windows
    equal the replicated extraction's texel for texel."""
    _check_mesh(mosaic, mesh, axis)
    eye = f32(eye, mosaic.device)
    n_levels = len(mosaic.mip_shapes)
    use_attr = bool(spec.attrs_from_profile and spec.lod and n_levels)
    quad_levels = _bilinear_levels(spec, n_levels, _texel_m(spec, mosaic)) if use_attr else set()
    gx_e, gy_e = _eye_raster(mosaic, eye[None])
    sharded = _sharded_windows(mosaic, gx_e, gy_e, spec, batched=False)
    out = list(_extract_windows(mosaic, gx_e[0], gy_e[0], spec, skip=frozenset(sharded)))
    for level, (win, sx, sy) in sharded.items():
        out[level] = _window_entry(win[0], sx[0], sy[0], use_attr, level in quad_levels)
    return tuple(out)


def render_perspective_sharded(
    mosaic: TerrainMosaic,
    camera,
    mesh=None,
    *,
    width: int,
    height: int,
    n_steps: int = 1024,
    n_refine: int = 24,
    guided: bool = True,
    fov_hint: float | None = None,
    guided_kw: tuple = (),
    pixelize_n=None,
    axis: str = GEO_AXIS,
):
    """Triangle-exact perspective frame against a row-sharded mosaic
    (``shard_mosaic(..., keep_cell_table=True)``): `render_perspective` on
    the lead device, every cell-row read gathered band by band and the
    owner's rows selected (`ops/surface.py::cell_rows`). Equals the
    replicated frame bit for bit where no ray reaches the poisoned padding
    rows south of the scene."""
    from topo_renderer_tpu_torch.ops.raycast import render_perspective

    if not mosaic.cell_sharded:
        raise ValueError("render_perspective_sharded needs shard_mosaic(keep_cell_table=True)")
    _check_mesh(mosaic, mesh, axis)
    return render_perspective(
        mosaic, camera, width=width, height=height, n_steps=n_steps, n_refine=n_refine, guided=guided,
        fov_hint=fov_hint, guided_kw=guided_kw, pixelize_n=pixelize_n,
    )


def render_perspective_fast_sharded(
    mosaic: TerrainMosaic,
    camera,
    mesh=None,
    *,
    width: int,
    height: int,
    n_steps: int = 384,
    supersample: float = 1.25,
    pixelize_n=None,
    fov_hint: float = 0.7853981633974483,
    clipmap_threshold: int | None = None,
    axis: str = GEO_AXIS,
):
    """Interactive fast frame against a row-sharded mosaic: the frustum
    spec from `ops/raycast.py::fast_view_spec` (the fast frame's own
    derivation), its windows extracted band by band
    (`extract_clipmap_windows_sharded`), then `render_perspective_fast` on
    those windows, which reads only them and the replicated tables. Pass a
    ``clipmap_threshold`` at or below the shard ``size_threshold``, so that
    every sharded level is windowed (a sharded level read in full is
    gathered band by band at every sample)."""
    from topo_renderer_tpu_torch.ops.raycast import fast_view_spec, render_perspective_fast

    spec, _, _ = fast_view_spec(
        width=width, height=height, fov_hint=fov_hint, supersample=supersample, n_steps=n_steps,
        clipmap_threshold=clipmap_threshold,
    )
    win = extract_clipmap_windows_sharded(mosaic, camera.eye, spec, mesh, axis)
    return render_perspective_fast(
        mosaic, camera, width=width, height=height, supersample=supersample, n_steps=n_steps,
        pixelize_n=pixelize_n, fov_hint=fov_hint, windows=win, clipmap_threshold=clipmap_threshold,
    )


def render_batch_scan_sharded(
    mosaic: TerrainMosaic,
    eyes,
    suns,
    spec: PanoramaSpec,
    mesh=None,
    view_mode=0,
    fog: str | None = None,
    axis: str = GEO_AXIS,
):
    """Panoramas of B viewpoints against a row-sharded mosaic:
    ``f32[B, H, W, 3]`` colours on the lead device, equal to
    `ops/panorama.py::render_batch_scan` on the replicated tables.

    Per chunk of up to ``EYES_PER_LAUNCH`` eyes: pass 1 cuts every eye's
    band windows with one K3 launch per band and selects each sharded
    level's rows once for all eyes (`_sharded_windows`); the replicated
    windowed levels take one K3 launch on the lead device where the batched
    copy applies (`_window_batch`); then each eye renders from its own
    windows. Pass 1 holds every eye's windows of the chunk (for 256 eyes at
    config 5, four levels of 2 x 272 x 512 words: 1.14 GB, and one band's
    share of it beside them).
    """
    _check_mesh(mosaic, mesh, axis)
    dev = mosaic.device
    eyes = f32(eyes, dev)
    suns = f32(suns, dev)
    n_levels = len(mosaic.mip_shapes)
    clip = bool(spec.lod and spec.clipmap and n_levels)
    use_attr = bool(spec.attrs_from_profile and spec.lod and n_levels)
    quad_levels = _bilinear_levels(spec, n_levels, _texel_m(spec, mosaic)) if use_attr else set()
    colors = torch.empty((eyes.shape[0], spec.height, spec.width, 3), dtype=torch.float32, device=dev)
    for b0 in range(0, eyes.shape[0], EYES_PER_LAUNCH):
        chunk = eyes[b0 : b0 + EYES_PER_LAUNCH]
        if clip:
            gx_e, gy_e = _eye_raster(mosaic, chunk)
            sharded = _sharded_windows(mosaic, gx_e, gy_e, spec, batched=True)
            skip = frozenset(sharded)
            rep = _window_batch(mosaic, chunk, spec, skip=skip)
        for i, eye in enumerate(chunk):
            windows = None
            if clip:
                windows = list(rep.windows(i) if rep is not None
                               else _extract_windows(mosaic, gx_e[i], gy_e[i], spec, skip=skip))
                for level, (win, sx, sy) in sharded.items():
                    windows[level] = _window_entry(win[i], sx[i], sy[i], use_attr, level in quad_levels)
                windows = tuple(windows)
            colors[b0 + i] = render_panorama(
                mosaic, eye, spec, suns[b0 + i], view_mode=view_mode, fog=fog, windows=windows
            )["color"]
    return colors
