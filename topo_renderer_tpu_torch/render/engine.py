"""RenderEngine: the top-level rendering API.

Port of `topo_renderer_tpu/render/engine.py`: the loaded tile set and
per-tile peak lists (`render_engine.rs:34-44`), a mosaic rebuilt on the
engine's device when tiles change (or, with ``streaming=True``, updated one
tile slot at a time), ``render_panorama`` with its peak-label pass,
``render_batch`` for many viewpoints without labels, ``render``, the
perspective frame (triangle-exact, or ``fast=True`` for the interactive
warp), with its label pass and the one-transfer wire (`render/transport.py`),
and ``render_batch_sharded`` over a (dp, az) device mesh. With
``geo_mesh`` the mosaic's large tables are row-sharded over a ``("geo",)``
mesh and every path reads them through the sharded programs
(`parallel/sharded_mosaic.py`, `parallel/sharded_update.py`). The JAX
package fuses render, label visibility and wire encoding into one jitted
program per variant; here they are plain calls on the device, and at most
one buffer per frame crosses to the host on its own: the packed
visibility, or the wire vector.

Peak arrays are padded to power-of-two capacities, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.mosaic_update import (
    apply_slot_update,
    attr_slice_geometry,
    streaming_canvas_dim,
)
from topo_renderer_tpu_torch.models.scene import (
    POISON_HEIGHT,
    TerrainMosaic,
    TerrainTile,
    bound_sphere,
    build_mosaic,
)
from topo_renderer_tpu_torch.models.uniforms import PeakInstance, normal_to_world_rotation
from topo_renderer_tpu_torch.ops import shading
from topo_renderer_tpu_torch.ops.geometry import f32, to_device
from topo_renderer_tpu_torch.ops.labels import peak_visibility, peak_visibility_panorama
from topo_renderer_tpu_torch.ops.panorama import (
    PanoramaSpec,
    extract_clipmap_windows,
    render_batch_scan,
    render_panorama,
)
from topo_renderer_tpu_torch.ops.raycast import render_perspective, render_perspective_fast
from topo_renderer_tpu_torch.ops.surface import raster_from_geo, sample_height
from topo_renderer_tpu_torch.parallel.mesh import Mesh, canonical
from topo_renderer_tpu_torch.parallel.sharded import render_batch_sharded
from topo_renderer_tpu_torch.parallel.sharded_mosaic import GEO_AXIS, shard_mosaic
from topo_renderer_tpu_torch.parallel.sharded_update import apply_slot_update_sharded
from topo_renderer_tpu_torch.render import text as text_mod
from topo_renderer_tpu_torch.render import transport
from topo_renderer_tpu_torch.render.overlay import composite_labels

_FOV_BUCKETS_DEG = (30.0, 45.0, 60.0, 90.0, 120.0, 160.0)
_EXACT_QUALITIES = ("auto", "full", "interactive")


def _frame_labels(camera, out, pos, valid, *, width, height, tolerance_rel):
    """Label visibility of a perspective frame against its depth, on the
    frame's device: packed ``i32[3, P]`` (visible, x, y)."""
    vp = f32(camera.build_view_proj_matrix(float(width), float(height)), out["depth"].device)
    vis = peak_visibility(
        pos, valid, vp, out["depth"], width=width, height=height, tolerance_rel=tolerance_rel,
    )
    return torch.stack([vis["visible"].to(torch.int32), vis["x"], vis["y"]])


def _panorama_with_labels(
    mosaic, eye, spec, sun_direction, view_mode, pos, valid, windows, *,
    fog, pixelize_n, tolerance_rel,
):
    """Panorama + label visibility; the depth stays on the device and the
    visibility comes back as one packed ``i32[3, P]`` tensor."""
    out = render_panorama(
        mosaic, eye, spec, sun_direction, view_mode=view_mode,
        fog=fog, pixelize_n=pixelize_n, windows=windows,
    )
    vis = peak_visibility_panorama(
        pos, valid, eye, spec, out["depth"], tolerance_rel=tolerance_rel
    )
    packed = torch.stack([vis["visible"].to(torch.int32), vis["x"], vis["y"]])
    return out, packed


@dataclasses.dataclass
class RenderResult:
    color: np.ndarray  # u8 sRGB [H, W, 3]
    # With host_copy=False these four stay device tensors.
    color_linear: object  # f32 [H, W, 3]
    depth: object  # f32 [H, W]
    distance: object
    hit: object
    visible_labels: dict  # {GeoLocation: [(label_id, (x, y)), ...]}
    layouts: list  # [LabelLayout]
    # Wire frames (`render(wire=...)`): ``color`` is the flat u8 wire vector
    # on the device, and ``finish(buf)`` decodes the pulled buffer on the
    # host -> (u8 frame, visible_labels, layouts, names). None otherwise.
    finish: object = None


class RenderEngine:
    _LAYOUT_MEMO_CAP = 8

    def __init__(self, device=None, streaming: bool = False, geo_mesh=None, device_mosaic_build: bool = True):
        """``device``: where the mosaic lives and frames render; None means
        the CUDA device (and raises without one).

        ``device_mosaic_build``: full builds make the derived tables
        (normals, packing, pyramids, windows, cell rows) on the device; with
        False they are made on the host in numpy and copied over
        (``build_mosaic(on_device=False)``, the goldens' build). Slot
        updates run on the device either way.

        ``streaming``: tile changes update the mosaic one slot at a time (the
        reference's `add_terrain`/`unload_terrain` touch one tile's buffers,
        `terrain_renderer.rs:173-350,361-363`). The mosaic lives on a pinned
        canvas, the tiles' box plus a one-tile margin, and a tile change
        inside it runs `models/mosaic_update.apply_slot_update`; a tile
        outside it, or off its grid, rebuilds on a fresh canvas. The canvas
        holds at most 64 tiles, as the JAX package's does.

        ``geo_mesh``: a `parallel/mesh.py::Mesh` with a ``"geo"`` axis. The
        mosaic's large tables are row-sharded over it (`shard_mosaic`, with
        the cell table); every render path reads them band by band
        (`parallel/sharded_mosaic.py`), computing once on the mesh's lead
        device, and streaming slot updates write the bands in place
        (`apply_slot_update_sharded`). The streaming canvas's rows are then
        a multiple of ``8 * n_dev * 4``, so that sharding adds no padding.
        ``device`` defaults to the mesh's lead device, and must be it."""
        if geo_mesh is not None:
            if not isinstance(geo_mesh, Mesh) or GEO_AXIS not in geo_mesh.axis_names:
                raise TypeError(f"geo_mesh must be a parallel.mesh.Mesh with a {GEO_AXIS!r} axis")
            if device is not None and canonical(device) != geo_mesh.lead:
                raise ValueError(f"device {device} is not the geo mesh's lead device {geo_mesh.lead}")
            device = geo_mesh.lead
        self.device = resolve_device(device)
        self._geo_mesh = geo_mesh
        self._shard_threshold = 2_000_000  # texels; tests lower it
        self._canvas_multiple_override = None  # canvas rows' multiple; tests align a replicated engine
        self._tiles: dict[GeoLocation, TerrainTile] = {}
        self._peaks: dict[GeoLocation, list[PeakInstance]] = {}
        self._mosaic: TerrainMosaic | None = None
        self._dirty = True
        self._streaming = bool(streaming)
        self._device_mosaic_build = bool(device_mosaic_build)
        self._window_table_min = 262_144  # build_mosaic's default; tests lower it
        self._canvas = None  # (lon_nw, lat_nw, h_m, w_m, ps_x, ps_y)
        self._slots: dict[GeoLocation, tuple] = {}  # loc -> (slot, oy, ox, th, tw)
        self._rot_cap = 64
        self._rotations = np.zeros((self._rot_cap, 3, 3), np.float32)
        self._pending: list[tuple] = []  # queued slot updates
        self._label_lock = threading.Lock()
        self._peaks_gen = 0  # bumped on peak-set changes; part of memo keys
        self._layout_memo: OrderedDict = OrderedDict()
        self._last_exact_pose = None  # `_resolve_exact_quality`'s motion test
        self._pose_before_frame = None  # what `rollback_exact_pose` gives back

    # ---- tile management (reference: terrain_renderer.rs:173,361) --------

    def add_terrain(
        self, location: GeoLocation, heights: np.ndarray, transform: CoordinateTransform
    ) -> None:
        tile = TerrainTile(location, np.asarray(heights, np.float32), transform)
        self._tiles[location] = tile
        if self._streaming and not self._dirty and self._mosaic is not None:
            if self._queue_streaming_op("add", location, tile):
                return
        self._dirty = True

    def unload_terrain(self, location: GeoLocation) -> None:
        tile = self._tiles.pop(location, None)
        if self._peaks.pop(location, None) is not None:
            self._peaks_gen += 1
        if tile is None:
            return
        if self._streaming and not self._dirty and self._mosaic is not None:
            if location in self._slots and self._queue_streaming_op("remove", location, tile):
                return
        self._dirty = True

    def add_peaks(self, location: GeoLocation, peaks: Sequence[PeakInstance]) -> None:
        """Peaks must already be elevation-sorted with ECEF positions
        (+10 m), as produced by the fetch pipeline."""
        self._peaks[location] = list(peaks)
        self._peaks_gen += 1

    @property
    def loaded_locations(self) -> set[GeoLocation]:
        return set(self._tiles.keys())

    # ---- streaming (slot updates) ----------------------------------------

    def _tile_grid_offset(self, tile: TerrainTile):
        """(oy, ox) of the tile on the current canvas, or None on any grid
        mismatch (pixel scale, alignment, bounds)."""
        lon_nw, lat_nw, h_m, w_m, ps_x, ps_y = self._canvas
        t = tile.transform
        if not (np.isclose(t.pixel_scale[0], ps_x, rtol=1e-5) and np.isclose(t.pixel_scale[1], ps_y, rtol=1e-5)):
            return None
        lon0, lat0 = t.to_model((0.0, 0.0))
        fx = (lon0 - lon_nw) / ps_x
        fy = (lat_nw - lat0) / ps_y
        ox, oy = round(fx), round(fy)
        if abs(fx - ox) > 0.02 or abs(fy - oy) > 0.02:
            return None
        th, tw = tile.heights.shape
        if ox < 0 or oy < 0 or oy + th > h_m or ox + tw > w_m:
            return None
        return oy, ox

    def _queue_streaming_op(self, op: str, location: GeoLocation, tile: TerrainTile) -> bool:
        """Queue a slot update; False where the tile needs a full rebuild
        (no canvas, off the canvas's grid, or no free slot)."""
        if self._canvas is None:
            return False
        if op == "add":
            off = self._tile_grid_offset(tile)
            if off is None:
                return False
            if location in self._slots:
                slot = self._slots[location][0]
            else:
                used = {s for s, *_ in self._slots.values()}
                slot = next(i for i in range(self._rot_cap + 1) if i not in used)
                if slot >= self._rot_cap:
                    return False
            rec = (slot, *off, *tile.heights.shape)
            self._slots[location] = rec
            self._pending.append(("add", location, rec))
            return True
        self._pending.append(("remove", location, self._slots.pop(location)))
        return True

    def _assemble_region(self, oy, ox, th, tw):
        """The (heights, cell owners) of one canvas region from the current
        tile set, in the full build's order, so the updated tables match a
        fresh build on the same canvas at shared seam texels too."""
        blk = np.full((th, tw), np.float32(POISON_HEIGHT), np.float32)
        cells = np.full((th, tw), -1, np.int32)
        for loc in sorted(self._slots.keys()):
            slot, ty, tx, tth, ttw = self._slots[loc]
            tile = self._tiles.get(loc)
            if tile is None:
                continue
            y0, y1 = max(oy, ty), min(oy + th, ty + tth)
            x0, x1 = max(ox, tx), min(ox + tw, tx + ttw)
            if y0 < y1 and x0 < x1:
                blk[y0 - oy : y1 - oy, x0 - ox : x1 - ox] = tile.heights[y0 - ty : y1 - ty, x0 - tx : x1 - tx]
            cy1, cx1 = min(oy + th, ty + tth - 1), min(ox + tw, tx + ttw - 1)
            if y0 < cy1 and x0 < cx1:
                cells[y0 - oy : cy1 - oy, x0 - ox : cx1 - ox] = slot
        return blk, cells

    def _apply_pending(self):
        """Run the queued slot updates on the device. The host copies of the
        valid mask, the cell owners and the rotations follow every op; the
        bounding sphere's refresh reads ``hmax`` back once."""
        lon_nw, lat_nw, h_m, w_m, ps_x, ps_y = self._canvas
        host = self._mosaic.host
        dev = self.device
        geo = f32(np.asarray([lon_nw, lat_nw, ps_x, ps_y], np.float32))  # host values, as the build's
        while self._pending:
            op, location, (slot, oy, ox, th, tw) = self._pending.pop(0)
            if op == "add":
                tile = self._tiles.get(location)
                if tile is None:
                    # Added, then unloaded before any render: the queued
                    # remove rebuilds the region.
                    continue
                mp = tile.transform.model_point
                self._rotations[slot] = normal_to_world_rotation(mp[0], mp[1])[:3, :3].numpy()
            blk, cells = self._assemble_region(oy, ox, th, tw)
            host.valid[oy : oy + th, ox : ox + tw] = blk > 0.5 * np.float32(POISON_HEIGHT)
            host.cell_tile[oy : oy + th, ox : ox + tw] = cells
            # The full capacity: after unloads, cell owners may name slots
            # above the tile count.
            host.tile_rot = self._rotations.copy()

            # Owner windows per level, slice by slice from the host owners
            # (the whole owner map would be a canvas-sized array per op).
            slices = []
            for lv, sy, sx, sh, sw in attr_slice_geometry(oy, ox, th, tw, (h_m, w_m), self._mosaic.mip_shapes):
                s = 1 << lv
                ys = np.minimum((sy + np.arange(sh)) * s, h_m - 2)
                xs = np.minimum((sx + np.arange(sw)) * s, w_m - 2)
                owners = host.cell_tile[ys[:, None], xs[None, :]]
                slices.append(to_device(torch.from_numpy(np.where(owners < 0, 0, owners).astype(np.int64)), dev))
            update = apply_slot_update if self._geo_mesh is None else apply_slot_update_sharded
            self._mosaic = update(
                self._mosaic, to_device(torch.from_numpy(blk), dev), oy, ox, tuple(slices),
                f32(self._rotations.reshape(-1), dev), geo, th=th, tw=tw,
            )
        self._refresh_bound_sphere()

    def _refresh_bound_sphere(self):
        """The bounding sphere of the canvas at the new ``hmax``: one scalar
        read from the device, then the build's float64 formula."""
        lon_nw, lat_nw, h_m, w_m, ps_x, ps_y = self._canvas
        hmax = float(self._mosaic.hmax)
        center, radius = bound_sphere(lon_nw, lat_nw, h_m, w_m, ps_x, ps_y, hmax)
        self._mosaic = dataclasses.replace(
            self._mosaic, bound_center=f32(center, self.device), bound_radius=f32(radius, self.device)
        )

    def _full_streaming_rebuild(self):
        """Full build on a fresh pinned canvas: the tiles' box plus a
        one-tile margin on every side, each dimension rounded up so that
        the mip chain halves exactly. Slot ids are the build's tile indices
        (sorted order)."""
        order = sorted(self._tiles.keys())
        if len(order) > self._rot_cap:
            raise ValueError(
                f"the streaming canvas holds at most {self._rot_cap} tile slots, not {len(order)} tiles"
            )
        tiles = [self._tiles[k] for k in order]
        ps_x = min(t.transform.pixel_scale[0] for t in tiles)
        ps_y = tiles[0].transform.pixel_scale[1]
        th, tw = tiles[0].heights.shape
        lon_min = min(t.transform.to_model((0.0, 0.0))[0] for t in tiles)
        lat_max = max(t.transform.to_model((0.0, 0.0))[1] for t in tiles)
        lon_max = max(t.transform.to_model((0.0, 0.0))[0] + ps_x * (t.heights.shape[1] - 1) for t in tiles)
        lat_min = min(t.transform.to_model((0.0, 0.0))[1] - ps_y * (t.heights.shape[0] - 1) for t in tiles)
        margin_y, margin_x = th - 1, tw - 1
        lon_nw = lon_min - ps_x * margin_x
        lat_nw = lat_max + ps_y * margin_y
        need_h = int(round((lat_nw - lat_min) / ps_y)) + 1 + margin_y
        need_w = int(round((lon_max - lon_nw) / ps_x)) + 1 + margin_x
        # Row-sharded streaming needs shard_mosaic to add no padding: rows a
        # multiple of 8 * n_dev, down to the top sharded mip level.
        mult = self._canvas_multiple_override or (
            8 * self._geo_mesh.shape[GEO_AXIS] * 4 if self._geo_mesh is not None else 1
        )
        h_m, w_m = streaming_canvas_dim(need_h, mult), streaming_canvas_dim(need_w)
        self._canvas = (lon_nw, lat_nw, h_m, w_m, ps_x, ps_y)
        self._mosaic = None  # free the old tables before building anew
        self._mosaic = build_mosaic(
            tiles, canvas=(lon_nw, lat_nw, h_m, w_m), keep_hmax_raw=True,
            window_table_min=self._window_table_min, device=self.device,
            on_device=self._device_mosaic_build,
        )
        self._slots = {}
        self._rotations = np.zeros((self._rot_cap, 3, 3), np.float32)
        for i, loc in enumerate(order):
            t = self._tiles[loc]
            off = self._tile_grid_offset(t)
            if off is None:
                raise RuntimeError("tile misaligned with its own canvas")
            self._slots[loc] = (i, *off, *t.heights.shape)
            mp = t.transform.model_point
            self._rotations[i] = normal_to_world_rotation(mp[0], mp[1])[:3, :3].numpy()

    @property
    def mosaic(self) -> TerrainMosaic:
        """The stitched mosaic: rebuilt in full after a tile change, or, in
        a streaming engine, with the queued slot updates applied."""
        if self._dirty or self._mosaic is None:
            if not self._tiles:
                raise RuntimeError("no terrain loaded")
            self._pending.clear()
            native = len({(round(t.transform.pixel_scale[0], 9), t.heights.shape)
                          for t in self._tiles.values()}) == 1
            if self._streaming and native:
                self._full_streaming_rebuild()
            else:
                # Mixed resolutions or shapes: a plain build, no slot updates.
                self._canvas = None
                self._slots = {}
                self._mosaic = None  # free the old tables before building anew
                order = sorted(self._tiles.keys())
                self._mosaic = build_mosaic([self._tiles[k] for k in order], device=self.device,
                                            on_device=self._device_mosaic_build)
            if self._geo_mesh is not None:
                shape0 = self._mosaic.shape
                self._mosaic = shard_mosaic(
                    self._mosaic, self._geo_mesh, size_threshold=self._shard_threshold, keep_cell_table=True,
                )
                if self._streaming and self._mosaic.shape != shape0:
                    # Padding breaks the halving chain slot updates rely on;
                    # the streaming canvas is sized aligned, so only a plain
                    # build (mixed tiles, no slot updates) gets here.
                    self._canvas = None
                    self._slots = {}
            self._dirty = False
        elif self._pending:
            self._apply_pending()
        return self._mosaic

    def height_at(self, coord) -> float | None:
        """Triangle-exact terrain height at a coordinate, or None outside the
        loaded tiles (the reference's `get_height_value_at`). Reads one value
        back from the device."""
        m = self.mosaic
        gx, gy = raster_from_geo(m, f32(coord.longitude, m.device), f32(coord.latitude, m.device))
        h = float(sample_height(m, gx, gy))
        return None if h < -1.0e9 else h

    # ---- labels ----------------------------------------------------------

    def _padded_peaks(self):
        entries = []  # (location, index_within_location, instance)
        for loc in sorted(self._peaks.keys()):
            if loc not in self._tiles:
                continue
            for i, inst in enumerate(self._peaks[loc]):
                entries.append((loc, i, inst))
        n = len(entries)
        cap = max(8, 1 << (n - 1).bit_length()) if n else 8
        pos = np.zeros((cap, 3), np.float32)
        valid = np.zeros((cap,), bool)
        for j, (_, _, inst) in enumerate(entries):
            pos[j] = np.asarray(inst.position, np.float32)
            valid[j] = True
        return entries, f32(pos, self.device), to_device(torch.from_numpy(valid), self.device)

    def _label_pass_packed(self, entries, packed):
        """Packed visibility -> per-tile label lists + greedy row layout,
        memoized on (peak-set generation, visibility bytes)."""
        key = (self._peaks_gen, len(entries), packed.tobytes())
        with self._label_lock:
            memo = self._layout_memo
            cached = memo.get(key)
            if cached is not None:
                memo.move_to_end(key)
                for j, (_, _, inst) in enumerate(entries):
                    inst.visible = bool(packed[0][j])
                return cached
            visible, xs, ys = packed[0].astype(bool), packed[1], packed[2]
            visible_labels: dict[GeoLocation, list] = {}
            for j, (loc, i, inst) in enumerate(entries):
                inst.visible = bool(visible[j])
                if inst.visible:
                    visible_labels.setdefault(loc, []).append((i, (int(xs[j]), int(ys[j]))))
            layouts = text_mod.layout_labels(
                visible_labels, lambda loc, i: text_mod.measure_text(self._peaks[loc][i].name)
            )
            memo[key] = (visible_labels, layouts)
            while len(memo) > self._LAYOUT_MEMO_CAP:
                memo.popitem(last=False)
            return visible_labels, layouts

    def _make_finish(self, entries, names, height, width, mode, n_peaks):
        """Host half of a wire frame: decode the pulled buffer and run the
        memoized label pass. ``names`` is taken at render time, so peak
        changes between render and finish do not skew the labels."""

        def finish(buf):
            img, lab = transport.decode_frame(np.asarray(buf), height, width, n_peaks, mode=mode)
            if lab is None:
                return img, {}, [], {}
            visible_labels, layouts = self._label_pass_packed(entries, lab)
            return img, visible_labels, layouts, names

        return finish

    @staticmethod
    def _fov_bucket_rad(camera) -> float:
        """The smallest fov bucket at or above the camera's fov: the fast
        frame's window is sized from it, so a fov change within a bucket
        keeps the window's shapes."""
        fov = math.degrees(float(camera.fov_y))
        bucket = next((b for b in _FOV_BUCKETS_DEG if b >= fov - 1e-6), _FOV_BUCKETS_DEG[-1])
        return math.radians(bucket)

    # The exact march's interactive rung: one union pooled leg and the own
    # leg, 9 gather rounds against the full budget's 13
    # (`ops/raycast.py::guided_march_rounds`).
    _EXACT_RUNG_INTERACTIVE = (("n_window", 3), ("split_brackets", False))

    @staticmethod
    def _camera_pose_key(camera):
        return (
            np.asarray(camera.eye, np.float32).tobytes(),
            float(camera.pitch), float(camera.yaw), float(camera.fov_y), camera.view_mode,
        )

    def _resolve_exact_quality(self, camera, exact_quality, guided_kw):
        """The exact march's budget for this frame. "auto" gives the full
        13-round budget to the first exact frame and to a frame at the pose
        of the one before (a settle frame), and the interactive rung to a
        frame whose pose moved; "full" and "interactive" pin either.
        ``guided_kw`` entries override the rung's."""
        if exact_quality not in _EXACT_QUALITIES:
            raise ValueError(f"unknown exact_quality {exact_quality!r}")
        pose = self._camera_pose_key(camera)
        moving = self._last_exact_pose is not None and pose != self._last_exact_pose
        self._last_exact_pose = pose
        if exact_quality == "interactive" or (exact_quality == "auto" and moving):
            merged = dict(self._EXACT_RUNG_INTERACTIVE)
            merged.update(dict(guided_kw))
            return tuple(sorted(merged.items()))
        return guided_kw

    # ---- perspective frames ---------------------------------------------

    def render(
        self,
        camera: Camera,
        width: int,
        height: int,
        *,
        n_steps: int = 1024,
        n_refine: int = 24,
        pixelize_n=None,
        with_labels: bool = True,
        composite: bool = True,
        fast: bool = False,
        guided: bool = True,
        host_copy: bool = True,
        u8_host: bool = True,
        wire: str | None = None,
        guided_kw: tuple = (),
        exact_quality: str = "auto",
    ) -> RenderResult:
        """One perspective frame with the peak-label pass.

        ``fast=False`` (the default) is the triangle-exact frame
        (`render_perspective`): with ``guided`` the panorama-prepass guided
        march with ``guided_kw`` (`march_guided_panorama`, its window sized
        from the camera's fov bucket), else the uniform or two-level
        ``march`` of ``n_steps`` steps and ``n_refine`` bisections (strict
        parity work). ``exact_quality`` picks the guided march's budget:
        "auto" marches a frame whose pose moved since the previous exact
        frame on the interactive rung and other frames on the full budget;
        "full" and "interactive" pin either (`_resolve_exact_quality`).
        ``fast=True`` renders through the LOD panorama engine and warps to
        the perspective grid (`render_perspective_fast`, ``n_steps`` capped
        at 512).

        ``host_copy=False`` leaves ``color_linear``, ``depth``, ``distance``
        and ``hit`` on the device; ``u8_host=False`` leaves the u8 frame
        there too and skips compositing. ``wire`` (a `render/transport.py`
        mode) makes ``color`` the flat u8 wire vector on the device, pixels
        and label bytes together: the caller pulls it and calls
        ``finish(buf)`` -> ``(u8 frame, visible_labels, layouts, names)``.
        """
        if wire is not None and wire not in transport.MODES:
            raise ValueError(f"unknown wire mode {wire!r}")
        self._pose_before_frame = self._last_exact_pose
        if not fast and guided:
            guided_kw = self._resolve_exact_quality(camera, exact_quality, guided_kw)
        elif exact_quality not in _EXACT_QUALITIES:
            raise ValueError(f"unknown exact_quality {exact_quality!r}")
        # A frame that fails to build leaves the pose of the last exact frame
        # built, so that the next frame at that pose is not taken for motion.
        try:
            fov_hint = self._fov_bucket_rad(camera)
            if fast:
                # A geo-sharded mosaic's sharded levels are all windowed (JAX's
                # `_render_sharded`): its windows come band by band.
                clip = min(self._shard_threshold, 2_000_000) if self._geo_mesh is not None else None
                out = render_perspective_fast(
                    self.mosaic, camera, width=width, height=height, n_steps=min(n_steps, 512),
                    pixelize_n=pixelize_n, fov_hint=fov_hint, clipmap_threshold=clip,
                )
            else:
                out = render_perspective(
                    self.mosaic, camera, width=width, height=height, n_steps=n_steps, n_refine=n_refine,
                    pixelize_n=pixelize_n, guided=guided, fov_hint=fov_hint if guided else None,
                    guided_kw=guided_kw,
                )
            entries, packed = [], None
            if with_labels and self._peaks:
                entries, pos, valid = self._padded_peaks()
                # LOD depth carries a distance-proportional error; the exact
                # frame takes the reference's absolute 10 m alone.
                packed = _frame_labels(camera, out, pos, valid, width=width, height=height,
                                       tolerance_rel=0.05 if fast else 0.0)
            if wire is not None:
                names = {(loc, i): self._peaks[loc][i].name for (loc, i, _) in entries}
                n_peaks = 0 if packed is None else int(packed.shape[1])
                return self._result(
                    out, transport.encode_frame(out["color"], packed, mode=wire), {}, [], host_copy=host_copy,
                    finish=self._make_finish(entries, names, height, width, wire, n_peaks),
                )
            visible_labels: dict[GeoLocation, list] = {}
            layouts: list = []
            if packed is not None:
                visible_labels, layouts = self._label_pass_packed(entries, packed.cpu().numpy())
            return self._finalize_plain(
                out, visible_labels, layouts, composite=composite, host_copy=host_copy, u8_host=u8_host
            )
        except BaseException:
            self.rollback_exact_pose()
            raise

    def rollback_exact_pose(self):
        """Give back the exact-frame pose that the last `render` call found,
        for a frame that failed after `render` returned (its pull to the
        host raised), so that the next frame at that pose is not taken for
        motion. `render` calls it itself when building the frame raises."""
        self._last_exact_pose = self._pose_before_frame

    def _finalize_plain(self, out, visible_labels, layouts, *, composite, host_copy, u8_host):
        """Non-wire tail of a frame or panorama: the u8 sRGB frame, label
        compositing and the RenderResult."""
        color_u8 = shading.to_srgb8_image(out["color"])
        if u8_host:
            color_u8 = color_u8.cpu().numpy()
            if composite and layouts:
                color_u8 = composite_labels(color_u8, layouts, self.label_names(visible_labels))
        return self._result(out, color_u8, visible_labels, layouts, host_copy=host_copy)

    def label_names(self, visible_labels) -> dict:
        """Names map for `composite_labels`, for callers that composite
        outside the render call."""
        return {(loc, i): self._peaks[loc][i].name for loc in visible_labels for i, _ in visible_labels[loc]}

    @staticmethod
    def _result(out, color, visible_labels, layouts, *, host_copy, finish=None):
        cp = (lambda a: a.cpu().numpy()) if host_copy else (lambda a: a)
        return RenderResult(
            color=color,
            color_linear=cp(out["color"]),
            depth=cp(out["depth"]),
            distance=cp(out["distance"]),
            hit=cp(out["hit"]),
            visible_labels=visible_labels,
            layouts=layouts,
            finish=finish,
        )

    # ---- panorama --------------------------------------------------------

    def render_panorama(
        self,
        camera_or_eye,
        spec: PanoramaSpec,
        *,
        sun_direction=None,
        view_mode=0,
        fog: str | None = None,
        pixelize_n=None,
        with_labels: bool = True,
        composite: bool = True,
        host_copy: bool = True,
    ) -> RenderResult:
        """Cylindrical panorama with the peak-label pass."""
        if isinstance(camera_or_eye, Camera):
            eye = camera_or_eye.eye
            if sun_direction is None:
                sun_direction = camera_or_eye.sun_angle.to_vec3()
            view_mode = int(camera_or_eye.view_mode)
        else:
            eye = camera_or_eye
            if sun_direction is None:
                raise ValueError("sun_direction required when passing a raw eye")
        eye = f32(eye, self.device)
        sun = f32(sun_direction, self.device)
        mosaic = self.mosaic

        windows = None
        if spec.lod and spec.clipmap and mosaic.mip_shapes:
            # A geo-sharded mosaic's windows come band by band
            # (`extract_clipmap_windows_sharded`).
            windows = extract_clipmap_windows(mosaic, eye, spec)

        visible_labels: dict[GeoLocation, list] = {}
        layouts: list = []
        if with_labels and self._peaks:
            entries, pos, valid = self._padded_peaks()
            out, packed = _panorama_with_labels(
                mosaic, eye, spec, sun, view_mode, pos, valid, windows,
                fog=fog, pixelize_n=pixelize_n,
                tolerance_rel=0.05 if spec.lod else 0.0,
            )
            visible_labels, layouts = self._label_pass_packed(entries, packed.cpu().numpy())
        else:
            out = render_panorama(
                mosaic, eye, spec, sun, view_mode=view_mode,
                fog=fog, pixelize_n=pixelize_n, windows=windows,
            )

        return self._finalize_plain(
            out, visible_labels, layouts, composite=composite, host_copy=host_copy, u8_host=True
        )

    def render_batch(self, eyes, spec: PanoramaSpec, sun_directions, view_mode=0, fog=None):
        """Panoramas of many viewpoints without labels: ``eyes f32[B, 3]``,
        ``sun_directions f32[B, 3]`` -> colour ``f32[B, H, W, 3]``, a tensor
        on the engine's device.

        Clipmap (LOD) specs go through `render_batch_scan`: one launch of
        kernel K3 extracts every eye's windows (a geo-sharded mosaic's: one
        per band, `render_batch_scan_sharded`), then each eye renders from
        its own. Other specs render eye by eye with the reduction crossing
        (``use_pallas=False``), as the JAX package's vmapped fallback forces
        it (`engine.py:1173-1182`).
        """
        eyes = f32(eyes, self.device)
        suns = f32(sun_directions, self.device)
        if spec.lod and spec.clipmap:
            return render_batch_scan(self.mosaic, eyes, suns, spec, view_mode=view_mode, fog=fog)
        vspec = dataclasses.replace(spec, use_pallas=False)
        return torch.stack([
            render_panorama(self.mosaic, e, vspec, s, view_mode=view_mode, fog=fog)["color"]
            for e, s in zip(eyes, suns)
        ])

    def render_batch_sharded(self, eyes, spec: PanoramaSpec, sun_directions, mesh, fog=None, view_mode=0):
        """Panoramas of many viewpoints over a (dp, az) device mesh, with
        the label decisions merged across the azimuth shards
        (`parallel/sharded.py`): ``(color [B, H, W, 3], depth [B, H, W],
        visible [B, P])`` on the mesh's lead device."""
        _, pos, valid = self._padded_peaks()
        return render_batch_sharded(
            self.mosaic, eyes, sun_directions, spec, mesh, view_mode=view_mode, fog=fog,
            peak_positions=pos, peak_valid=valid,
        )
