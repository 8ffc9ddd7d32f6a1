"""Cylindrical panorama renderer: great-circle column marching.

Port of `topo_renderer_tpu/ops/panorama.py`. Every vertical image column of
a panorama lies in a plane through the eye and the Earth's centre, so one
column needs:

  1. a 1-D profile of terrain elevation along its ground trace: for LOD
     specs tan-elevation ratios sampled from the distance-matched mip level,
     through eye-centred clipmap windows where a level is large
     (`extract_clipmap_windows`, kernel K2; for a batch of viewpoints
     `extract_clipmap_windows_batched`, kernel K3); otherwise elevation
     angles of the triangle-exact surface (`_surface_elevation`);
  2. per pixel row, the first profile step whose running max exceeds the
     row's threshold: kernel K1 (`ops/crossing.py::crossing_search`) for
     specs whose profile carries the shading attributes, the global
     reductions (`ops/crossing.py::crossing_reductions`) otherwise;
  3. optionally ``n_refine`` bisection steps against the true surface,
     then the hit height and normal (from the profile sample, or sampled
     per pixel from the mosaic), shading, fog and postprocessing.

`render_batch_scan` renders B viewpoints: one K3 launch extracts every
eye's windows, then each eye renders from its own windows.

`panorama_crossing_prepass` renders no pixels: it gives the exact frame's
guided march (`ops/raycast.py::march_guided_panorama`) per-texel crossing
brackets from the triangle-exact and the dilated-bound profiles, with one
K1 launch each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from topo_renderer_tpu_torch.models.camera import FAR, NEAR, depth_from_dist
from topo_renderer_tpu_torch.ops import shading as shd
from topo_renderer_tpu_torch.ops.crossing import crossing_reductions, crossing_search
from topo_renderer_tpu_torch.ops.geometry import R0, degrees, f32, to_device
from topo_renderer_tpu_torch.ops.mathx import norm
from topo_renderer_tpu_torch.ops.postprocess import (
    atmospheric_shading_soa,
    distance_fog_soa,
    postprocess_soa,
)
from topo_renderer_tpu_torch.ops.surface import (
    INVALID_HEIGHT,
    raster_from_ecef,
    raster_from_geo,
    sample_attributes_nearest,
    sample_attributes_soa,
    sample_height_level,
)
from topo_renderer_tpu_torch.ops.window_slice import window_slice_multi, window_slice_multi_batched
from topo_renderer_tpu_torch.parallel.mesh import gather_rows

NEG_RATIO = -1.0e30  # profile samples outside the mosaic
# Viewpoints per K3 launch in `render_batch_scan`: at config 5 (four
# 2 x 272 x 512 windows per eye) 256 eyes hold 1.14 GB of windows.
EYES_PER_LAUNCH = 256


@dataclasses.dataclass(frozen=True)
class PanoramaSpec:
    """Static panorama parameters; the JAX package's fields, one for one."""

    width: int = 2048
    height: int = 512
    azimuth_start: float = 0.0  # radians, 0 = north, increasing eastward
    azimuth_span: float = 6.283185307179586  # full circle
    elev_min: float | None = None  # radians; default: square pixels
    elev_max: float | None = None
    n_steps: int = 1024
    s_near: float = 5.0  # metres along the ground
    s_far: float = FAR
    n_refine: int = 2
    lod: bool = False  # sample distance-matched height mips for the profile
    lod_texel_m: float | None = None  # texel-size override (m)
    profile_stride: int = 1  # compute the profile on every k-th column
    profile_nearest: bool = False
    attrs_nearest: bool = False
    attrs_from_profile: bool = False  # shade from per-sample attrs (needs lod)
    clipmap: bool = False  # gather from eye-centred windows, not full tables
    clipmap_threshold: int = 2_000_000  # tables above this size are windowed
    near_bilinear_m: float = 0.0  # bilinear profile steps closer than this
    profile_far_stride_m: float = 0.0  # double the azimuth stride beyond this
    profile_far_stride4_m: float = 0.0  # quadruple it beyond this
    use_pallas: bool = True  # the JAX name for "use the crossing kernel"

    def elevation_range(self) -> tuple[float, float]:
        if self.elev_min is not None and self.elev_max is not None:
            return (self.elev_min, self.elev_max)
        half = 0.5 * self.azimuth_span * self.height / self.width
        return (-half, half)

    @staticmethod
    def fast(width=2048, height=512, n_steps=512, **kw) -> "PanoramaSpec":
        """Throughput preset: clipmapped mip LOD, nearest profile sampling,
        attributes carried by the profile samples, no refinement."""
        kw.setdefault("lod", True)
        kw.setdefault("profile_stride", 2)
        kw.setdefault("profile_nearest", True)
        kw.setdefault("attrs_from_profile", True)
        kw.setdefault("clipmap", True)
        kw.setdefault("near_bilinear_m", 3000.0)
        kw.setdefault("n_refine", 0)
        return PanoramaSpec(width=width, height=height, n_steps=n_steps, **kw)


def _eye_frame(eye):
    """(a0, up, east, north components, (lon0, lat0)) for the eye position.

    Scalar-precision trap: the eye radius is ``jnp.linalg.norm(eye)`` in
    float32 (`panorama.py:144`); `norm` sums the squares in the same order.
    """
    e_norm = norm(eye)
    a0 = e_norm - R0
    ux, uy, uz = eye[0] / e_norm, eye[1] / e_norm, eye[2] / e_norm
    lon0 = torch.atan2(eye[1], eye[0])
    lat0 = torch.asin(torch.clamp(eye[2] / e_norm, -1.0, 1.0))
    ex, ey = -torch.sin(lon0), torch.cos(lon0)
    nx = -torch.sin(lat0) * torch.cos(lon0)
    ny = -torch.sin(lat0) * torch.sin(lon0)
    nz = torch.cos(lat0)
    return a0, (ux, uy, uz), (ex, ey), (nx, ny, nz), (lon0, lat0)


def _surface_elevation(mosaic, a0, up, h_col, sig, level: int = 0, nearest: bool = False):
    """Elevation angle of the terrain surface along columns at angular
    ground distance ``sig`` (broadcastable against the planes in ``h_col``).
    Cancellation-free at ECEF scale:
      y = h cos(sig) - a0 - 2 R0 sin^2(sig/2),   x = (R0 + h) sin(sig).
    """
    ux, uy, uz = up
    hx, hy, hz = h_col
    cs = torch.cos(sig)
    sn = torch.sin(sig)
    sdx = ux * cs + hx * sn
    sdy = uy * cs + hy * sn
    sdz = uz * cs + hz * sn
    gx, gy = raster_from_ecef(mosaic, sdx, sdy, sdz, 1.0)
    h = sample_height_level(mosaic, level, gx, gy, nearest=nearest)
    y = h * cs - a0 - 2.0 * R0 * torch.sin(0.5 * sig) ** 2
    x = (R0 + h) * sn
    return torch.atan2(y, x)


def _texel_m(spec: PanoramaSpec, mosaic) -> float:
    """Effective base texel size: the spec override, else the mosaic's hint."""
    if spec.lod_texel_m is not None:
        return float(spec.lod_texel_m)
    return float(getattr(mosaic, "texel_m", 92.6))


def _log_schedule(spec: PanoramaSpec, dev):
    """``sigma_of(kf)``: the ground angle of profile step ``kf`` on the log
    schedule from ``s_near`` to ``s_far``. Scalar-precision trap: its
    constants are float32 logs (`panorama.py:472-476`), not Python
    (float64) ones."""
    log_near = torch.log(f32(spec.s_near, dev))
    log_ratio = torch.log(f32(spec.s_far / spec.s_near, dev))
    n = spec.n_steps

    def sigma_of(kf):
        return torch.exp(log_near + log_ratio * (kf / (n - 1))) / R0

    return sigma_of


def _lod_segments(spec: PanoramaSpec, n_levels: int, texel_m: float):
    """Static per-step mip level from the log step schedule: level L once the
    step length reaches ~2^L base texels. Returns [(level, k0, k1), ...]."""
    k = np.arange(spec.n_steps)
    s = spec.s_near * (spec.s_far / spec.s_near) ** (k / (spec.n_steps - 1))
    ds = s * (np.log(spec.s_far / spec.s_near) / (spec.n_steps - 1))
    level = np.clip(
        np.floor(np.log2(np.maximum(ds / texel_m, 1e-6))) + 1, 0, n_levels
    ).astype(int)
    segments = []
    k0 = 0
    for i in range(1, spec.n_steps + 1):
        if i == spec.n_steps or level[i] != level[k0]:
            segments.append((int(level[k0]), k0, i))
            k0 = i
    return segments


def _clipmap_window_plan(spec: PanoramaSpec, mosaic):
    """Static clipmap plan: [(level, use_window, wsy, wsx, table_shape)].

    Each mip level is only sampled within a constant texel radius
    (~2.5/dlog) of the eye, so window sizes depend on the spec alone. The
    sizes keep the JAX package's (8, 128) rounding and slack so that windows
    land where the reference's do.
    """
    n_levels = len(mosaic.mip_shapes)
    dlog = np.log(spec.s_far / spec.s_near) / (spec.n_steps - 1)
    ratio = max(1.0, _texel_m(spec, mosaic) / float(getattr(mosaic, "texel_m", 92.6)))
    need = int(np.ceil(2.5 * ratio / dlog)) + 16
    wsy_req = -(-(2 * need + 16) // 8) * 8
    wsx_req = -(-(2 * need + 256) // 128) * 128
    plan = []
    for level in range(n_levels + 1):
        shape_l = mosaic.shape if level == 0 else mosaic.mip_shapes[level - 1]
        h_t, w_t = shape_l
        use_window = (
            spec.clipmap
            and (h_t * w_t > spec.clipmap_threshold)
            and h_t >= wsy_req
            and w_t >= wsx_req
        )
        plan.append((level, use_window, wsy_req, wsx_req, shape_l))
    return plan


def _bilinear_levels(spec: PanoramaSpec, n_levels: int, texel_m: float) -> set:
    """Levels whose schedule segment overlaps the bilinear near field."""
    if spec.near_bilinear_m <= 0.0:
        return set()
    s = spec.s_near * (spec.s_far / spec.s_near) ** (np.arange(spec.n_steps) / (spec.n_steps - 1))
    k_cut = int(np.searchsorted(s, spec.near_bilinear_m))
    return {level for level, k0, k1 in _lod_segments(spec, n_levels, texel_m) if k0 < k_cut}


def _window_origin(gx_e, gy_e, level: int, wsy: int, wsx: int, h_t: int, w_t: int):
    """Eye-centred window origin for one clipmap level, clipped into the
    table and aligned DOWN to (8, 128) exactly as the JAX package aligns it
    (for its TPU tiling), so the windows hold the same texels. Works
    elementwise, so batched ``gx_e``/``gy_e`` give each eye's origin."""
    s = float(2**level)
    off = (s - 1.0) / 2.0
    sx = torch.clamp(torch.round((gx_e - off) / s).to(torch.int32) - wsx // 2, 0, w_t - wsx)
    sx = (sx // 128) * 128
    sy = torch.clamp(torch.round((gy_e - off) / s).to(torch.int32) - wsy // 2, 0, h_t - wsy)
    sy = (sy // 8) * 8
    return sx, sy


def _quad_rows(win):
    """Pack each texel's 2x2 bilinear neighbourhood into one gather row.

    ``win f32[..., 2, wsy, wsx]`` -> ``f32[..., wsy*wsx, 8]`` rows (h00,
    b00, h01, b01, h10, b10, h11, b11), 01 = east, 10 = south, 11 =
    south-east (edge-clamped). Moved as int32 words: plane 1 holds normal
    bits.
    """
    w = win.view(torch.int32)
    e = torch.cat([w[..., 1:], w[..., -1:]], dim=-1)
    s_ = torch.cat([w[..., 1:, :], w[..., -1:, :]], dim=-2)
    se = torch.cat([s_[..., 1:], s_[..., -1:]], dim=-1)
    planes = [x[..., c, :, :] for x in (w, e, s_, se) for c in (0, 1)]
    return torch.stack([p.flatten(-2) for p in planes], dim=-1).view(torch.float32)


def _slice_level_flat(mosaic, level, use_attr, quad_levels, sy, sx, wsy, wsx, h_t, w_t):
    """One level's window cut from the flat gather tables, for a level
    without a ``win_attr_2d`` table or a spec without profile attributes
    (`panorama.py:285-322`'s slicing forms). Returns ``(tbl_h, tbl_a,
    tbl_q)``: ``tbl_a f32[wsy*wsx, 2]`` (height, normal-bits) rows and
    their quad rows with profile attributes, else ``tbl_h f32[wsy*wsx]``
    heights. The origin stays on the device: the window is gathered by
    index, clamped into the table as DynamicSlice clamps it.
    """
    dev = mosaic.device
    sy = torch.clamp(sy, 0, h_t - wsy).long()
    sx = torch.clamp(sx, 0, w_t - wsx).long()
    rows = sy + torch.arange(wsy, device=dev)
    cols = sx + torch.arange(wsx, device=dev)
    idx = (rows[:, None] * w_t + cols[None, :]).reshape(-1)
    if not use_attr:
        hf = mosaic.heights_flat if level == 0 else mosaic.mip_heights_flat[level - 1]
        return hf[idx], None, None
    af = mosaic.attr_packed_flat if level == 0 else mosaic.mip_attr_flat[level - 1]
    tbl_a = af.view(torch.int32)[idx].view(torch.float32)
    tbl_q = _quad_rows(tbl_a.T.reshape(2, wsy, wsx)) if level in quad_levels else None
    return None, tbl_a, tbl_q


def _eye_raster(mosaic, eyes):
    """Raster coordinates of the eyes' ground points, elementwise over any
    leading axes of ``eyes f32[..., 3]``. `norm` sums the squares in index
    order, so a batch gives each eye the bits of its single-eye call."""
    e_norm = norm(eyes)
    lon0 = degrees(torch.atan2(eyes[..., 1], eyes[..., 0]))
    lat0 = degrees(torch.asin(torch.clamp(eyes[..., 2] / e_norm, -1.0, 1.0)))
    return raster_from_geo(mosaic, lon0, lat0)


def extract_clipmap_windows(mosaic, eye, spec: PanoramaSpec):
    """Slice the eye-centred clipmap windows out of the mosaic's tables.

    Levels with a 2-D window table go through one launch of kernel K2 when
    the spec's profile carries attributes; other windowed levels are cut
    from the flat tables (`_slice_level_flat`). A row-sharded mosaic takes
    `parallel/sharded_mosaic.py::extract_clipmap_windows_sharded`.

    Returns a tuple over levels of ``(tbl_h, tbl_a, tbl_q, ox, oy)``:
    ``tbl_a f32[wsy*wsx, 2]`` (height, normal-bits) rows, ``tbl_q
    f32[wsy*wsx, 8]`` quad rows for levels with a bilinear segment, ``tbl_h
    f32[wsy*wsx]`` heights for specs without profile attributes, and the
    int32 origin. Entries are None where the level is gathered in full.
    """
    if mosaic.sharded_rows:
        from topo_renderer_tpu_torch.parallel.sharded_mosaic import extract_clipmap_windows_sharded

        return extract_clipmap_windows_sharded(mosaic, eye, spec)
    eye = f32(eye, mosaic.device)
    return _extract_windows(mosaic, *_eye_raster(mosaic, eye), spec)


def _extract_windows(mosaic, gx_e, gy_e, spec: PanoramaSpec, skip=frozenset()):
    """`extract_clipmap_windows` from the eye's raster coordinates, leaving
    the levels in ``skip`` (the sharded ones) as if gathered in full."""
    n_levels = len(mosaic.mip_shapes)
    use_attr = bool(spec.attrs_from_profile and spec.lod and n_levels)
    quad_levels = _bilinear_levels(spec, n_levels, _texel_m(spec, mosaic)) if use_attr else set()
    plan = _clipmap_window_plan(spec, mosaic)
    levels, tables, origins = [], [], []
    out = []
    for level, use_window, wsy, wsx, (h_t, w_t) in plan:
        if not use_window or level in skip:
            out.append((None, None, None, None, None))
            continue
        sx, sy = _window_origin(gx_e, gy_e, level, wsy, wsx, h_t, w_t)
        win2d = mosaic.win_attr_2d[level] if level < len(mosaic.win_attr_2d) else None
        if use_attr and win2d is not None:
            levels.append(level)
            tables.append(win2d)
            origins.append(torch.stack([sy, sx]))
            out.append((None, None, None, sx, sy))
        else:
            tbls = _slice_level_flat(mosaic, level, use_attr, quad_levels, sy, sx, wsy, wsx, h_t, w_t)
            out.append((*tbls, sx, sy))

    if tables:
        wsy, wsx = plan[0][2], plan[0][3]
        wins = window_slice_multi(tables, torch.stack(origins), wsy=wsy, wsx=wsx)
        for level, win in zip(levels, wins):
            sx, sy = out[level][3], out[level][4]
            tbl_q = _quad_rows(win) if level in quad_levels else None
            out[level] = (None, win.reshape(2, -1).T, tbl_q, sx, sy)
    return tuple(out)


@dataclasses.dataclass
class _WindowBatch:
    """B eyes' windows from one K3 launch: per windowed level, ``wins
    f32[B, 2, wsy, wsx]`` and the origins ``sx``, ``sy`` ``i32[B]``."""

    n_levels: int
    wins: dict
    sx: dict
    sy: dict
    quad_levels: set

    def windows(self, b=slice(None)):
        """Eye b's windows in `extract_clipmap_windows`' form, or with the
        default every eye's, with a leading B axis. Quad rows are built
        here, for the eyes asked for."""
        out = []
        for level in range(self.n_levels + 1):
            if level not in self.wins:
                out.append((None, None, None, None, None))
                continue
            win = self.wins[level][b]
            tbl_a = win.flatten(-2).transpose(-1, -2)  # [..., wsy*wsx, 2]
            tbl_q = _quad_rows(win) if level in self.quad_levels else None
            out.append((None, tbl_a, tbl_q, self.sx[level][b], self.sy[level][b]))
        return tuple(out)


def _window_batch(mosaic, eyes, spec: PanoramaSpec, skip=frozenset()):
    """One K3 launch for the windows of ``eyes f32[B, 3]``, or None where
    the batched copy does not apply: a spec without profile attributes, no
    windowed level, or a windowed level without its 2-D table
    (`panorama.py:714-736`). Levels in ``skip`` are left out."""
    n_levels = len(mosaic.mip_shapes)
    use_attr = bool(spec.attrs_from_profile and spec.lod and n_levels)
    plan = _clipmap_window_plan(spec, mosaic)
    windowed = [p for p in plan if p[1] and p[0] not in skip]
    have_2d = all(
        lv < len(mosaic.win_attr_2d) and mosaic.win_attr_2d[lv] is not None for lv, *_ in windowed
    )
    if not (use_attr and windowed and have_2d):
        return None
    gx_e, gy_e = _eye_raster(mosaic, eyes)  # [B]
    sxs, sys_, origins = {}, {}, []
    for level, _, wsy, wsx, (h_t, w_t) in windowed:
        sxs[level], sys_[level] = _window_origin(gx_e, gy_e, level, wsy, wsx, h_t, w_t)
        origins.append(torch.stack([sys_[level], sxs[level]], dim=-1))  # [B, 2]
    _, _, wsy, wsx, _ = windowed[0]
    wins = window_slice_multi_batched(
        [mosaic.win_attr_2d[lv] for lv, *_ in windowed],
        torch.stack(origins, dim=1).contiguous(),  # [B, L, 2]
        wsy=wsy, wsx=wsx,
    )
    return _WindowBatch(
        n_levels=n_levels,
        wins={lv: w for (lv, *_), w in zip(windowed, wins)},
        sx=sxs,
        sy=sys_,
        quad_levels=_bilinear_levels(spec, n_levels, _texel_m(spec, mosaic)),
    )


def extract_clipmap_windows_batched(mosaic, eyes, spec: PanoramaSpec):
    """B viewpoints' clipmap windows with one launch of kernel K3.

    Returns `extract_clipmap_windows`' per-level tuple with a leading B
    axis on every tensor: ``tbl_a f32[B, wsy*wsx, 2]``, ``tbl_q f32[B,
    wsy*wsx, 8]`` for the quad levels, origins ``i32[B]``. Where the batched
    copy does not apply (see `_window_batch`) the eyes are extracted one by
    one and stacked, as the JAX package vmaps its single-eye extraction.
    """
    eyes = f32(eyes, mosaic.device)
    batch = _window_batch(mosaic, eyes, spec)
    if batch is None:
        per_eye = [extract_clipmap_windows(mosaic, e, spec) for e in eyes]
        return tuple(
            tuple(None if parts[0] is None else torch.stack(parts) for parts in zip(*level))
            for level in zip(*per_eye)
        )
    return batch.windows()


def _build_lod_profile(mosaic, spec: PanoramaSpec, windows, a0, up, h_prof_b, sigma):
    """LOD visibility profile ``e_prof f32[N, ws]`` (tan-elevation ratios,
    -1e30 outside the mosaic) and, for specs with profile attributes, the
    three normal-code planes carried by each sample (else None). Each
    log-schedule segment samples the mip level matching its step length,
    through the clipmap windows where the level is large.
    """
    N = spec.n_steps
    n_levels = len(mosaic.mip_shapes)
    use_attr_prof = bool(spec.attrs_from_profile and spec.lod and n_levels)
    plan = _clipmap_window_plan(spec, mosaic)
    parts_e, parts_attr = [], []
    segments = _lod_segments(spec, n_levels, _texel_m(spec, mosaic))
    s_np = spec.s_near * (spec.s_far / spec.s_near) ** (np.arange(N) / (N - 1))
    cuts = [
        c
        for c in (spec.near_bilinear_m, spec.profile_far_stride_m, spec.profile_far_stride4_m)
        if c > 0.0
    ]
    for cut in cuts:
        # Statically split segments at the bilinear / far-stride boundaries.
        k_cut = int(np.searchsorted(s_np, cut))
        split = []
        for level, k0, k1 in segments:
            if k0 < k_cut < k1:
                split += [(level, k0, k_cut), (level, k_cut, k1)]
            else:
                split.append((level, k0, k1))
        segments = split
    ws_cols = h_prof_b[0].shape[1]
    for level, k0, k1 in segments:
        seg_bilinear = (
            spec.near_bilinear_m > 0.0 and use_attr_prof and s_np[k1 - 1] <= spec.near_bilinear_m
        )
        far4 = (
            spec.profile_far_stride4_m > 0.0
            and not seg_bilinear
            and s_np[k0] >= spec.profile_far_stride4_m
            and ws_cols % 4 == 0
        )
        far2 = (
            not far4
            and spec.profile_far_stride_m > 0.0
            and not seg_bilinear
            and s_np[k0] >= spec.profile_far_stride_m
            and ws_cols % 2 == 0
        )
        stride = 4 if far4 else (2 if far2 else 1)
        hp_seg = tuple(c[:, ::stride] for c in h_prof_b) if stride > 1 else h_prof_b
        _, use_window, wsy, wsx, (h_t, w_t) = plan[level]
        s = float(2**level)
        off = (s - 1.0) / 2.0
        if use_window:
            tbl_h, tbl_a, tbl_q, ox, oy = windows[level]
            tw, th_ = wsx, wsy
        else:
            # The whole level; a row-sharded one is read band by band.
            tbl_h = mosaic.heights_flat if level == 0 else mosaic.mip_heights_flat[level - 1]
            tbl_a = mosaic.attr_packed_flat if level == 0 else mosaic.mip_attr_flat[level - 1]
            tbl_q = None
            tw, th_, ox, oy = w_t, h_t, 0, 0

        sig_seg = sigma[k0:k1]
        cs = torch.cos(sig_seg)
        sn = torch.sin(sig_seg)
        sh2 = torch.sin(0.5 * sig_seg) ** 2
        sdx = up[0] * cs + hp_seg[0] * sn
        sdy = up[1] * cs + hp_seg[1] * sn
        sdz = up[2] * cs + hp_seg[2] * sn
        gx0, gy0 = raster_from_ecef(mosaic, sdx, sdy, sdz, 1.0)
        lx = (gx0 - off) / s - ox
        ly = (gy0 - off) / s - oy
        if seg_bilinear:
            # Near field: bilinear height + normal codes, the whole 2x2
            # neighbourhood from one quad-row gather where there is one.
            ok = (lx >= 0) & (lx <= tw - 1) & (ly >= 0) & (ly <= th_ - 1)
            x0 = torch.clamp(torch.floor(lx).to(torch.int32), 0, tw - 2)
            y0 = torch.clamp(torch.floor(ly).to(torch.int32), 0, th_ - 2)
            fxs = torch.clamp(lx - x0, 0.0, 1.0)
            fys = torch.clamp(ly - y0, 0.0, 1.0)
            i00 = (y0 * tw + x0).long()
            if tbl_q is not None:
                q = tbl_q[i00]
                r00, r01, r10, r11 = q[..., 0:2], q[..., 2:4], q[..., 4:6], q[..., 6:8]
            else:
                r00, r01, r10, r11 = (gather_rows(tbl_a, i00 + d) for d in (0, 1, tw, tw + 1))

            def blend(v00, v01, v10, v11):
                return (v00 * (1 - fxs) + v01 * fxs) * (1 - fys) + (v10 * (1 - fxs) + v11 * fxs) * fys

            h = blend(r00[..., 0], r01[..., 0], r10[..., 0], r11[..., 0])
            bbits = [r[..., 1].view(torch.int32) for r in (r00, r01, r10, r11)]
            comps = []
            for sh in (0, 10, 20):
                c = blend(*(((b >> sh) & 0x3FF).to(torch.float32) for b in bbits))
                comps.append(torch.where(ok, torch.round(c), 0.0))
            parts_attr.append(tuple(comps))
        else:
            ix = torch.round(lx).to(torch.int32)
            iy = torch.round(ly).to(torch.int32)
            ok = (ix >= 0) & (ix <= tw - 1) & (iy >= 0) & (iy <= th_ - 1)
            idx = (torch.clamp(iy, 0, th_ - 1) * tw + torch.clamp(ix, 0, tw - 1)).long()
            if use_attr_prof:
                # One row gather serves the height and the packed normal.
                rows = gather_rows(tbl_a, idx)
                h = rows[..., 0]
                bits = rows[..., 1].view(torch.int32)
                comps_part = tuple(
                    torch.where(ok, ((bits >> sh) & 0x3FF).to(torch.float32), 0.0)
                    for sh in (0, 10, 20)
                )
                if stride > 1:
                    comps_part = tuple(torch.repeat_interleave(c, stride, dim=1) for c in comps_part)
                parts_attr.append(comps_part)
            else:
                h = gather_rows(tbl_h, idx)
        ok = ok & (h > 0.5 * INVALID_HEIGHT)
        y = h * cs - a0 - 2.0 * R0 * sh2
        x = (R0 + h) * sn
        # Ratio space: y/x == tan(e) (x > 0 along the march).
        e_part = torch.where(ok, y / x, -1.0e30)
        if stride > 1:
            e_part = torch.repeat_interleave(e_part, stride, dim=1)
        parts_e.append(e_part)
    e_prof = torch.cat(parts_e, dim=0)
    attr_prof = None
    if use_attr_prof:
        attr_prof = tuple(torch.cat([p[c] for p in parts_attr], dim=0) for c in range(3))
    return e_prof, attr_prof


def render_panorama(
    mosaic,
    eye,
    spec: PanoramaSpec,
    sun_direction,
    view_mode=0,
    pixelize_n=None,
    quantize_rt: bool = True,
    apply_postprocess: bool = True,
    fog: str | None = None,
    fog_density: float = 1.0 / 80_000.0,
    azimuth_offset=0.0,
    elev_offset=0.0,
    pixel_offset_x=0.0,
    windows=None,
    soa: bool = False,
):
    """Render a cylindrical panorama around ``eye`` on the mosaic's device.

    Returns ``{"color" f32[H, W, 3] (or "chans" with soa=True), "depth"
    (reference 0..1 convention), "distance", "hit"}``. ``fog``: None |
    "distance" | "atmosphere". ``windows``: pre-extracted clipmap windows
    (`extract_clipmap_windows`), extracted here when None.
    """
    dev = mosaic.device
    eye = f32(eye, dev)
    W, H, N = spec.width, spec.height, spec.n_steps
    n_levels = len(mosaic.mip_shapes)
    lod = bool(spec.lod and n_levels)
    use_attr_prof = bool(spec.attrs_from_profile and lod)

    a0, up, (ex, ey), (nx0, ny0, nz0), _ = _eye_frame(eye)

    def azimuths(n_cols):
        base = f32(spec.azimuth_start, dev) + f32(azimuth_offset, dev)
        return base + spec.azimuth_span * (
            (torch.arange(n_cols, dtype=torch.float32, device=dev) + 0.5) / n_cols
        )

    phi = azimuths(W)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    hx = (nx0 * cphi + ex * sphi)[None, :]  # per-pixel-column ground direction
    hy = (ny0 * cphi + ey * sphi)[None, :]
    hz = (nz0 * cphi)[None, :]

    sigma_of = _log_schedule(spec, dev)
    sigma = sigma_of(torch.arange(N, dtype=torch.float32, device=dev)[:, None])  # [N, 1]

    st = max(1, int(spec.profile_stride))
    if W % st:
        raise ValueError("width must be divisible by profile_stride")
    ws = W // st
    if st > 1:
        phi_sub = azimuths(ws)
        cps, sps = torch.cos(phi_sub), torch.sin(phi_sub)
        h_prof = (nx0 * cps + ex * sps, ny0 * cps + ey * sps, nz0 * cps)
    else:
        h_prof = (hx[0], hy[0], hz[0])
    h_prof_b = tuple(c[None, :] for c in h_prof)

    if lod:
        if windows is None:
            windows = extract_clipmap_windows(mosaic, eye, spec)
        e_prof, attr_prof = _build_lod_profile(mosaic, spec, windows, a0, up, h_prof_b, sigma)
    else:
        e_prof = _surface_elevation(mosaic, a0, up, h_prof_b, sigma, nearest=spec.profile_nearest)
        attr_prof = None

    # Pixel elevations, row 0 at the top. The LOD profile holds tan(e)
    # ratios, so its row thresholds are tan(e_pix); the exact profile holds
    # angles.
    e_lo, e_hi = spec.elevation_range()
    rows = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    e_pix = (f32(elev_offset, dev) + f32(e_hi, dev) - rows * f32(e_hi - e_lo, dev))[:, None]
    t_pix = torch.tan(e_pix)  # [H, 1]
    thresh = t_pix if lod else e_pix

    n_payload = None
    if use_attr_prof and spec.use_pallas:
        kstar, theta_hi, m_lo, p0, p1, p2 = crossing_search(
            e_prof, attr_prof[0], attr_prof[1], attr_prof[2], thresh.reshape(H)
        )
        n_payload = (p0, p1, p2)
    else:
        m_prof = torch.cummax(e_prof, dim=0).values
        kstar, theta_hi, m_lo, n_payload = crossing_reductions(m_prof, thresh.reshape(H), attr_prof)
    if st > 1:
        kstar, theta_hi, m_lo = (torch.repeat_interleave(x, st, dim=1) for x in (kstar, theta_hi, m_lo))
        if n_payload is not None:
            n_payload = tuple(torch.repeat_interleave(p, st, dim=1) for p in n_payload)

    hit = kstar < N
    kstar = torch.clamp(kstar, 0.0, float(N - 1))

    sig_hi = sigma_of(kstar)
    sig_lo = torch.where(kstar > 0, sigma_of(torch.clamp(kstar - 1.0, min=0.0)), sigma_of(0.0))
    denom = theta_hi - m_lo
    tfrac = torch.clamp(
        (thresh - m_lo) / torch.where(torch.abs(denom) < 1e-12, 1.0, denom), 0.0, 1.0
    )
    tfrac = torch.where(kstar > 0, tfrac, 0.0)
    sig_star = sig_lo + tfrac * (sig_hi - sig_lo)

    if spec.n_refine > 0:
        # Bisection against the true surface between the bracketing samples.
        slo, shi = sig_lo, sig_hi
        for _ in range(spec.n_refine):
            mid = 0.5 * (slo + shi)
            below = _surface_elevation(mosaic, a0, up, (hx, hy, hz), mid) < e_pix
            slo, shi = torch.where(below, mid, slo), torch.where(below, shi, mid)
        sig_star = torch.where(kstar > 0, shi, sig_star)

    cs = torch.cos(sig_star)
    sn = torch.sin(sig_star)
    ux, uy, uz = up
    sdx = ux * cs + hx * sn
    sdy = uy * cs + hy * sn
    if use_attr_prof:
        # Analytic hit height: the crossing lies on the pixel ray at ground
        # angle sig*, so h cos - a0 - 2 R0 sin^2(s/2) = tan(e) x.
        tanp = t_pix
        sh2s = torch.sin(0.5 * sig_star) ** 2
        h_star = (a0 + 2.0 * R0 * sh2s + tanp * R0 * sn) / (cs - tanp * sn)
        n_x, n_y, n_z = (2.0 * (p / 1023.0) - 1.0 for p in n_payload)
    else:
        sdz = uz * cs + hz * sn
        gx, gy = raster_from_ecef(mosaic, sdx, sdy, sdz, 1.0)
        sample = sample_attributes_nearest if spec.attrs_nearest else sample_attributes_soa
        h_star, n_x, n_y, n_z, _ = sample(mosaic, gx, gy)
    h_star = torch.clamp(h_star, min=-1e4)  # keep sky distances sane

    y_ip = h_star * cs - a0 - 2.0 * R0 * torch.sin(0.5 * sig_star) ** 2
    x_ip = (R0 + h_star) * sn
    dist = torch.sqrt(x_ip * x_ip + y_ip * y_ip)
    depth = torch.where(hit, depth_from_dist(torch.clamp(dist, NEAR, FAR)), 1.0)

    # Dither seed: pixel centre + eye.xy - world position.xy
    # (`render_shader.wgsl:103`), all in float32 like the reference.
    pos_x = (R0 + h_star) * sdx
    pos_y = (R0 + h_star) * sdy
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5 + f32(pixel_offset_x, dev)
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    seed_x = px + eye[0] - pos_x
    seed_y = py + eye[1] - pos_y

    sun = f32(sun_direction, dev)
    r, g, b = shd.shade_soa(n_x, n_y, n_z, sun, view_mode, seed_x, seed_y)
    sky = shd.SKY_COLOR
    channels = tuple(torch.where(hit, c, sc) for c, sc in zip((r, g, b), sky))

    if fog == "distance":
        channels = distance_fog_soa(channels, dist, sky, density=fog_density, sky_mask=~hit)
    elif fog == "atmosphere":
        channels = atmospheric_shading_soa(channels, dist, sky, sky_mask=~hit)

    if quantize_rt:
        channels = tuple(shd.quantize_srgb8(c) for c in channels)
    if apply_postprocess:
        channels = postprocess_soa(channels, depth, pixelize_n=pixelize_n)

    out = {"depth": depth, "distance": torch.where(hit, dist, FAR), "hit": hit}
    if soa:
        out["chans"] = channels
    else:
        out["color"] = torch.stack(channels, dim=-1)
    return out


def _prepass_bound_plan(spec: PanoramaSpec, mosaic, seg: int, bound_stride: int):
    """Static plan of the prepass's bound profile, on the host from shapes
    alone: ``(levels, src)``. ``levels`` maps each pyramid level to the
    profile steps sampled from it; ``src`` gives each step its sampled
    row's position in those levels' concatenated samples (in ``levels``'
    order), or that count (a row of NEG) in near segments.

    Segments whose last step is closer than 32 texels skip the bound (the
    exact profile samples every triangle piece there). A segment samples
    every ``bound_stride``-th step at the level whose dilation covers the
    step gap plus log2(stride) more, and each step repeats its group's
    first sample: the elevation ratio of a fixed height falls with
    distance, so the repeat bounds every step of the group.
    """
    n = spec.n_steps
    n_levels = len(mosaic.mip_shapes)
    texel = _texel_m(spec, mosaic)
    s = spec.s_near * (spec.s_far / spec.s_near) ** (np.arange(n) / (n - 1))
    ds = s * (np.log(spec.s_far / spec.s_near) / (n - 1))
    lvl = np.clip(np.ceil(np.log2(np.maximum(ds / texel, 1.0))), 1, max(n_levels, 1)).astype(int)
    levels: dict[int, list] = {}
    step_sample = np.full(n, -1)
    step_level = np.zeros(n, int)
    for k0 in range(0, n, seg):
        k1 = min(k0 + seg, n)
        if s[k1 - 1] < 32.0 * texel:
            continue
        lv = min(int(lvl[k0:k1].max()) + (bound_stride - 1).bit_length(), n_levels)
        rows = levels.setdefault(lv, [])
        for k in range(k0, k1):
            if (k - k0) % bound_stride == 0:
                rows.append(k)
            step_sample[k], step_level[k] = len(rows) - 1, lv
    base, total = {}, 0
    for lv, rows in levels.items():
        base[lv], total = total, total + len(rows)
    src = np.where(step_sample >= 0, [base.get(lv, 0) for lv in step_level] + step_sample, total)
    return levels, src


def _prepass_profiles(mosaic, eye, spec: PanoramaSpec, azimuth_offset, elev_offset, *, seg: int,
                      conservative: bool, bound_stride: int):
    """The prepass's profiles along every azimuth column's ground trace:
    ``(a0, e_prof, e_bound, e_pix)``. ``e_prof f32[N, W]`` holds the exact
    surface's tan-elevation ratios, ``e_bound`` the dilated max pyramid's
    (None unless ``conservative`` and the mosaic has mips), NEG_RATIO
    outside the mosaic; ``e_pix f32[H, 1]`` the rows' elevations."""
    from topo_renderer_tpu_torch.ops.raycast import _cell_h, _sample_hmax

    dev = mosaic.device
    W, N = spec.width, spec.n_steps
    a0, up, (ex, ey), (nx0, ny0, nz0), _ = _eye_frame(eye)
    ux, uy, uz = up

    phi = f32(spec.azimuth_start, dev) + f32(azimuth_offset, dev) + spec.azimuth_span * (
        (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    )
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    hx = nx0 * cphi + ex * sphi
    hy = ny0 * cphi + ey * sphi
    hz = nz0 * cphi

    sigma_of = _log_schedule(spec, dev)

    def ground_raster(sig):
        """Raster coordinates of every column's trace at ground angles
        ``sig [..., 1]``: ``[..., W]`` each."""
        cs, sn = torch.cos(sig), torch.sin(sig)
        return raster_from_ecef(mosaic, ux * cs + hx * sn, uy * cs + hy * sn, uz * cs + hz * sn, 1.0)

    # Exact trace coordinates at each segment's ends and midpoint, then the
    # piecewise-quadratic fit of every step: ``tau`` and the segment of
    # each step come from the host, as the JAX package's static loop.
    starts = list(range(0, N, seg))
    ends = [min(k0 + seg, N) for k0 in starts]
    knots = [kf for k0, k1 in zip(starts, ends) for kf in (k0, 0.5 * (k0 + k1 - 1), k1 - 1)]
    gx_k, gy_k = ground_raster(sigma_of(f32(knots, dev))[:, None])
    seg_of = np.repeat(np.arange(len(starts)), [k1 - k0 for k0, k1 in zip(starts, ends)])
    tau_np = np.concatenate([
        (np.arange(k0, k1, dtype=np.float32) - np.float32(k0)) / np.float32(max(k1 - 1 - k0, 1))
        for k0, k1 in zip(starts, ends)
    ])
    tau = f32(tau_np[:, None], dev)
    seg_idx = to_device(torch.from_numpy(seg_of), dev)

    def fit(g):
        a, m, b_ = g.view(len(starts), 3, W).unbind(1)
        cq = 2.0 * a - 4.0 * m + 2.0 * b_
        bq = -3.0 * a + 4.0 * m - b_
        return a[seg_idx] + tau * (bq[seg_idx] + tau * cq[seg_idx])

    gx, gy = fit(gx_k), fit(gy_k)  # [N, W]
    sig = sigma_of(torch.arange(N, dtype=torch.float32, device=dev))[:, None]
    cs, sn = torch.cos(sig), torch.sin(sig)
    sh2 = 2.0 * R0 * torch.sin(0.5 * sig) ** 2

    def ratio(h, rows=slice(None)):
        ok = h > 0.5 * INVALID_HEIGHT
        y = h * cs[rows] - a0 - sh2[rows]
        x = (R0 + h) * sn[rows]
        return torch.where(ok, y / x, NEG_RATIO)

    e_prof = ratio(_cell_h(mosaic, gx, gy))  # [N, W], tan-space
    e_bound = None
    if conservative and mosaic.mip_shapes:
        levels, src = _prepass_bound_plan(spec, mosaic, seg, bound_stride)
        samples = []
        for lv, rows in levels.items():
            r = to_device(torch.tensor(rows), dev)
            samples.append(ratio(_sample_hmax(mosaic, lv, gx[r], gy[r]), r))
        samples.append(torch.full((1, W), NEG_RATIO, device=dev))
        e_bound = torch.cat(samples, dim=0)[to_device(torch.from_numpy(src), dev)]

    e_lo, e_hi = spec.elevation_range()
    rows_f = (torch.arange(spec.height, dtype=torch.float32, device=dev) + 0.5) / spec.height
    e_pix = (f32(elev_offset, dev) + f32(e_hi, dev) - rows_f * f32(e_hi - e_lo, dev))[:, None]
    return a0, e_prof, e_bound, e_pix


def panorama_crossing_prepass(
    mosaic, eye, spec: PanoramaSpec, azimuth_offset=0.0, elev_offset=0.0, *, seg: int = 64,
    conservative: bool = True, k_back: int = 1 << 20, bound_stride: int = 1,
):
    """Crossing-distance brackets of the guided perspective march
    (`ops/raycast.py::march_guided_panorama`); renders no pixels.

    The triangle-exact surface is sampled along each azimuth column's ground
    trace (``n_steps`` gathers per column, shared by every elevation row),
    and each (row, column)'s first profile crossing comes from kernel K1
    (`ops/crossing.py::crossing_search`, zero payloads; the plain version
    on the CPU). The trace's raster coordinates are fitted piecewise by
    quadratics through the ends and midpoint of every ``seg`` steps, and the
    profile holds tan-elevation ratios (y/x), which the rows' tan(e)
    thresholds meet directly.

    ``conservative`` also samples the dilated max-height pyramid along the
    same traces (`_prepass_bound_plan`) and takes ``d_lo`` from that bound
    profile's first crossing (a second K1 launch), so the bracket contains
    the first crossing even where terrain narrower than the step spacing
    hides between samples. Where the bound crosses and the exact profile
    never does, the bracket ends where the ray leaves the terrain shell or
    its column's last in-mosaic sample, both without gathers.

    Returns ``{"d_lo", "d_me", "d_hi", "hit", "hit_exact"}``, ``[H, W]``:
    metric distance bounds of the crossing, FAR where sky. [d_me, d_hi] is
    the sure interval (one log step, where the exact profile crossed);
    [d_lo, d_me] the guard interval (the bound's backward drag). Bound-only
    texels have d_me == d_hi.

    The host plans (segments, levels, fit parameters) come from the spec
    and the mosaic's shapes; no device value is read.
    """
    dev = mosaic.device
    eye = f32(eye, dev)
    H, N = spec.height, spec.n_steps
    a0, e_prof, e_bound, e_pix = _prepass_profiles(
        mosaic, eye, spec, azimuth_offset, elev_offset, seg=seg, conservative=conservative,
        bound_stride=bound_stride,
    )
    sigma_of = _log_schedule(spec, dev)
    t_pix = torch.tan(e_pix)
    thresh = t_pix.reshape(H)

    def first_crossing(prof):
        z = torch.zeros_like(prof)
        return crossing_search(prof, z, z, z, thresh)[0]

    kstar = first_crossing(e_prof)
    hit_exact = kstar < N
    kstar = torch.clamp(kstar, 0.0, float(N - 1))
    if e_bound is not None:
        # Rays that skim above every exact sample but under the dilated
        # bound get a bracket instead of sky; the march decides.
        kb = first_crossing(e_bound)
        hit = hit_exact | (kb < N)
        kstar_b = torch.minimum(torch.clamp(kb, 0.0, float(N - 1)), kstar)
    else:
        hit, kstar_b = hit_exact, kstar

    # d_lo: the exact bracket extended back to the bound's crossing, at
    # most ``k_back`` log steps.
    k_lo = torch.where(hit_exact, torch.maximum(kstar_b, kstar - float(k_back)), kstar_b)
    sig_hi = sigma_of(kstar)
    sig_lo = torch.where(k_lo > 0, sigma_of(torch.clamp(k_lo - 1.0, min=0.0)), 0.0)

    def ray_dist(s):
        # Where the pixel ray meets ground angle s: the height from the
        # ray/trace geometry (no gathers), then the distance.
        cs_, sn_ = torch.cos(s), torch.sin(s)
        sh2s = torch.sin(0.5 * s) ** 2
        denom = cs_ - t_pix * sn_
        denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        h = (a0 + 2.0 * R0 * sh2s + t_pix * R0 * sn_) / denom
        y = h * cs_ - a0 - 2.0 * R0 * sh2s
        x = (R0 + h) * sn_
        return torch.sqrt(x * x + y * y)

    d_lo = torch.where(hit, ray_dist(sig_lo), FAR)
    if e_bound is not None:
        # Bound-only texels end where the ray leaves the terrain shell (per
        # row) or passes its column's last in-mosaic sample.
        hm = mosaic.hmax + 1.0
        e_norm = a0 + R0
        b_row = e_norm * torch.sin(e_pix)  # [H, 1]; sin(el) = ray . radial
        c_shell = (a0 - hm) * (e_norm + R0 + hm)
        disc = b_row * b_row - c_shell
        shell_exit = torch.where(disc > 0.0, -b_row + torch.sqrt(torch.clamp(disc, min=0.0)), FAR)
        valid_any = (e_prof > -0.9e30) | (e_bound > -0.9e30)
        kf = torch.arange(N, dtype=torch.float32, device=dev)[:, None]
        k_last = torch.where(valid_any, kf, -1.0).amax(dim=0)  # [W]
        col_exit = torch.where(
            ((k_last >= 0.0) & (k_last < N - 1))[None, :],
            ray_dist(sigma_of(torch.clamp(k_last + 1.0, max=N - 1.0))[None, :]),
            FAR,
        )
        d_hi_bound = torch.clamp(torch.minimum(shell_exit, col_exit), max=FAR)
        d_hi = torch.where(hit_exact, torch.maximum(ray_dist(sig_hi), d_lo), torch.maximum(d_hi_bound, d_lo))
    else:
        d_hi = torch.where(hit_exact, torch.maximum(ray_dist(sig_hi), d_lo), FAR)
    # The sure interval's start: the texel ray is above the exact profile at
    # sample kstar-1 and at or below it at kstar.
    sig_me = torch.where(kstar > 0, sigma_of(torch.clamp(kstar - 1.0, min=0.0)), 0.0)
    d_me = torch.where(hit_exact, torch.clamp(ray_dist(sig_me), d_lo, d_hi), d_hi)
    return {"d_lo": d_lo, "d_me": d_me, "d_hi": d_hi, "hit": hit, "hit_exact": hit_exact}


def render_batch_scan(mosaic, eyes, suns, spec: PanoramaSpec, view_mode=0, fog: str | None = None):
    """Panoramas of B viewpoints: ``eyes``, ``suns`` ``f32[B, 3]`` ->
    colours ``f32[B, H, W, 3]`` on the mosaic's device.

    The JAX package runs this as one `lax.scan` program over per-eye
    extraction and render. Here one launch of kernel K3 extracts the
    clipmap windows of up to ``EYES_PER_LAUNCH`` (256) eyes (one launch per
    such chunk), and each eye then renders from its own windows, keeping
    per-eye gather locality. Quad rows are built per eye. Where the batched
    copy does not apply (`_window_batch`), each eye extracts its own. A
    row-sharded mosaic takes
    `parallel/sharded_mosaic.py::render_batch_scan_sharded`.
    """
    if mosaic.sharded_rows:
        from topo_renderer_tpu_torch.parallel.sharded_mosaic import render_batch_scan_sharded

        return render_batch_scan_sharded(mosaic, eyes, suns, spec, view_mode=view_mode, fog=fog)
    dev = mosaic.device
    eyes = f32(eyes, dev)
    suns = f32(suns, dev)
    clip = bool(spec.lod and spec.clipmap and mosaic.mip_shapes)
    colors = torch.empty((eyes.shape[0], spec.height, spec.width, 3), dtype=torch.float32, device=dev)
    for b0 in range(0, eyes.shape[0], EYES_PER_LAUNCH):
        chunk = eyes[b0 : b0 + EYES_PER_LAUNCH]
        batch = _window_batch(mosaic, chunk, spec) if clip else None
        for i, eye in enumerate(chunk):
            if batch is not None:
                windows = batch.windows(i)
            else:
                windows = extract_clipmap_windows(mosaic, eye, spec) if clip else None
            colors[b0 + i] = render_panorama(
                mosaic, eye, spec, suns[b0 + i], view_mode=view_mode, fog=fog, windows=windows
            )["color"]
    return colors
