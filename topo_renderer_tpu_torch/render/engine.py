"""RenderEngine: the top-level rendering API (panorama paths).

Port of the parts of `topo_renderer_tpu/render/engine.py` the panoramas
use: the loaded tile set and per-tile peak lists (`render_engine.rs:34-44`),
a mosaic rebuilt on the engine's device when tiles change,
``render_panorama`` with its peak-label pass, and ``render_batch`` for many
viewpoints without labels. The JAX package fuses render and label
visibility into one jitted program; here they are two plain calls on the
device, and only the packed visibility crosses to the host.

Peak arrays are padded to power-of-two capacities, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.scene import TerrainMosaic, TerrainTile, build_mosaic
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.ops import shading
from topo_renderer_tpu_torch.ops.geometry import f32
from topo_renderer_tpu_torch.ops.labels import peak_visibility_panorama
from topo_renderer_tpu_torch.ops.panorama import (
    PanoramaSpec,
    extract_clipmap_windows,
    render_batch_scan,
    render_panorama,
)
from topo_renderer_tpu_torch.render import text as text_mod
from topo_renderer_tpu_torch.render.overlay import composite_labels


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


class RenderEngine:
    _LAYOUT_MEMO_CAP = 8

    def __init__(self, device=None, streaming: bool = False, geo_mesh=None):
        """``device``: where the mosaic lives and frames render; None means
        the CUDA device (and raises without one). ``streaming`` (incremental
        slot updates) and ``geo_mesh`` (multi-device tables) belong to later
        slices of the port and raise NotImplementedError."""
        if streaming:
            raise NotImplementedError("streaming slot updates: ROADMAP.md slice 5")
        if geo_mesh is not None:
            raise NotImplementedError("geo-sharded tables: ROADMAP.md slice 7")
        self.device = resolve_device(device)
        self._tiles: dict[GeoLocation, TerrainTile] = {}
        self._peaks: dict[GeoLocation, list[PeakInstance]] = {}
        self._mosaic: TerrainMosaic | None = None
        self._dirty = True
        self._label_lock = threading.Lock()
        self._peaks_gen = 0  # bumped on peak-set changes; part of memo keys
        self._layout_memo: OrderedDict = OrderedDict()

    # ---- tile management (reference: terrain_renderer.rs:173,361) --------

    def add_terrain(
        self, location: GeoLocation, heights: np.ndarray, transform: CoordinateTransform
    ) -> None:
        self._tiles[location] = TerrainTile(location, np.asarray(heights, np.float32), transform)
        self._dirty = True

    def add_peaks(self, location: GeoLocation, peaks: Sequence[PeakInstance]) -> None:
        """Peaks must already be elevation-sorted with ECEF positions
        (+10 m), as produced by the fetch pipeline."""
        self._peaks[location] = list(peaks)
        self._peaks_gen += 1

    @property
    def mosaic(self) -> TerrainMosaic:
        """The stitched mosaic, rebuilt in full after a tile change."""
        if self._dirty or self._mosaic is None:
            if not self._tiles:
                raise RuntimeError("no terrain loaded")
            self._mosaic = None  # free the old tables before building anew
            order = sorted(self._tiles.keys())
            self._mosaic = build_mosaic([self._tiles[k] for k in order], device=self.device)
            self._dirty = False
        return self._mosaic

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
        return entries, torch.from_numpy(pos).to(self.device), torch.from_numpy(valid).to(self.device)

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
        eye = f32(eye).to(self.device)
        sun = f32(sun_direction).to(self.device)
        mosaic = self.mosaic

        windows = None
        if spec.lod and spec.clipmap and mosaic.mip_shapes:
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

        cp = (lambda a: a.cpu().numpy()) if host_copy else (lambda a: a)
        color_u8 = shading.to_srgb8_image(out["color"]).cpu().numpy()
        if composite and layouts:
            names = {
                (loc, i): self._peaks[loc][i].name
                for loc in visible_labels
                for i, _ in visible_labels[loc]
            }
            color_u8 = composite_labels(color_u8, layouts, names)

        return RenderResult(
            color=color_u8,
            color_linear=cp(out["color"]),
            depth=cp(out["depth"]),
            distance=cp(out["distance"]),
            hit=cp(out["hit"]),
            visible_labels=visible_labels,
            layouts=layouts,
        )

    def render_batch(self, eyes, spec: PanoramaSpec, sun_directions, view_mode=0, fog=None):
        """Panoramas of many viewpoints without labels: ``eyes f32[B, 3]``,
        ``sun_directions f32[B, 3]`` -> colour ``f32[B, H, W, 3]``, a tensor
        on the engine's device.

        Clipmap (LOD) specs go through `render_batch_scan`: one launch of
        kernel K3 extracts every eye's windows, then each eye renders from
        its own. Other specs render eye by eye with the reduction crossing
        (``use_pallas=False``), as the JAX package's vmapped fallback forces
        it (`engine.py:1173-1182`).
        """
        eyes = f32(eyes).to(self.device)
        suns = f32(sun_directions).to(self.device)
        if spec.lod and spec.clipmap:
            return render_batch_scan(self.mosaic, eyes, suns, spec, view_mode=view_mode, fog=fog)
        vspec = dataclasses.replace(spec, use_pallas=False)
        return torch.stack([
            render_panorama(self.mosaic, e, vspec, s, view_mode=view_mode, fog=fog)["color"]
            for e, s in zip(eyes, suns)
        ])
