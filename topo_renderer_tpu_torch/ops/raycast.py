"""Perspective frames: the triangle-exact ray march and the fast warp.

Port of `topo_renderer_tpu/ops/raycast.py`. Per-pixel camera rays
(`camera_rays`) feed two renderers:

  * `render_perspective`, the triangle-exact frame: each pixel's ray is
    marched through the spherical shell that can hold terrain and its first
    crossing with the exact piecewise-linear mesh surface
    (`ops/surface.py`) is shaded as the reference's rasterizer shades it.
    The engine's default march (`march_guided_panorama`) brackets each
    pixel from a panorama-profile prepass (`ops/panorama.py::
    panorama_crossing_prepass`, two launches of kernel K1) and resolves the
    bracket on a quadratic fit of the ray's raster track with an analytic
    cell walk. `march` (uniform, or two-level over the dilated max
    pyramid), `march_guided` (strided-ray prepass) and `_window_march`
    serve strict-parity work and mosaics without a cell table.
  * `render_perspective_fast`, the interactive frame: the view's angular
    window rendered as a panorama section (`fast_view_spec`) and warped
    onto the perspective grid.

The JAX package's TPU layout devices are not copied: `_lane_shuffle` /
`_lane_unshuffle`, the prepass column shuffle and `fusion_barrier` only
permute pixels or cut XLA fusions, and every pixel is computed on its own.
"""

from __future__ import annotations

import inspect
import math

import torch

from topo_renderer_tpu_torch.models.camera import FAR, NEAR, Camera, depth_from_dist
from topo_renderer_tpu_torch.ops import mathx
from topo_renderer_tpu_torch.ops import shading as shd
from topo_renderer_tpu_torch.ops.geometry import R0, f32, radians
from topo_renderer_tpu_torch.ops.mathx import norm
from topo_renderer_tpu_torch.ops.panorama import (
    PanoramaSpec,
    _eye_frame,
    panorama_crossing_prepass,
    render_panorama,
)
from topo_renderer_tpu_torch.ops.postprocess import postprocess_soa
from topo_renderer_tpu_torch.ops.surface import (
    INVALID_HEIGHT,
    cell_rows,
    index_i32,
    raster_from_coeffs,
    raster_from_ecef,
    sample_attributes_cell,
    sample_attributes_soa,
    sample_height,
    track_coeffs,
    tri_interp,
)

DEFAULT_FOV_HINT = 0.7853981633974483  # 45°
BIG = 3.0e38
# The two-level march reads its loop condition (a host sync) once every
# this many rounds; a round after the condition turns false changes nothing.
TWO_LEVEL_ROUNDS_PER_CHECK = 4


def camera_rays(camera: Camera, width: int, height: int, device=None):
    """World-space unit ray direction planes (dx, dy, dz) ``f32[H, W]`` for
    pixel centres on ``device``, plus the forward axis ``f32[3]`` there.

    The wgpu viewport mapping: ndc_x = 2(px+0.5)/W - 1, ndc_y = 1 -
    2(py+0.5)/H, camera axes from `look_to_rh` (s, u, -f). The axes are
    computed on the camera's (host) tensors and cross to ``device`` in one
    copy.
    """
    f = camera.direction()
    up = camera.up()
    s = mathx.normalize(mathx.cross(f, up))
    u = mathx.cross(s, f)
    tan_v = torch.tan(0.5 * f32(camera.fov_y))
    tan_h = tan_v * (f32(width) / f32(height))
    f, s, u, tan = f32(torch.stack([f, s, u, torch.stack([tan_v, tan_h, tan_h])]), device).unbind(0)
    tan_v, tan_h = tan[0], tan[1]

    ndc_x = (2.0 * (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width - 1.0)[None, :]
    ndc_y = (1.0 - 2.0 * (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height)[:, None]
    dx = f[0] + ndc_x * tan_h * s[0] + ndc_y * tan_v * u[0]
    dy = f[1] + ndc_x * tan_h * s[1] + ndc_y * tan_v * u[1]
    dz = f[2] + ndc_x * tan_h * s[2] + ndc_y * tan_v * u[2]
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (dx * inv, dy * inv, dz * inv), f


# ---- march primitives ---------------------------------------------------------


def _eye_on(eye, device):
    """``(eye on device, eye on the host)``, float32 ``[3]`` each. The host
    copy feeds the per-frame scalars of `track_coeffs`; pass a CPU eye (the
    camera's) to keep the march free of host syncs."""
    eye_host = torch.as_tensor(eye, dtype=torch.float32)
    if eye_host.device.type != "cpu":
        eye_host = eye_host.cpu()
    return f32(eye_host, device), eye_host


def _split_dirs(dirs):
    if isinstance(dirs, tuple):
        return dirs
    d = torch.as_tensor(dirs, dtype=torch.float32)
    return d[..., 0], d[..., 1], d[..., 2]


def _altitude(c0, b, t):
    """(altitude, geocentric radius) at ray parameter t from the stabilized
    quadratic q(t) = |eye + t d|^2 - R0^2 = c0 + 2 t b + t^2 (|d| = 1),
    free of the cancellation of ``|p| - R0`` at ECEF magnitudes."""
    q = c0 + 2.0 * t * b + t * t
    r = torch.sqrt(torch.clamp(R0 * R0 + q, min=0.0))
    return q / (r + R0), r


def _surface_f(mosaic, eye, dirs, c0, b, t):
    """Signed clearance above the terrain surface at ray parameter t."""
    dx, dy, dz = dirs
    px = eye[0] + t * dx
    py = eye[1] + t * dy
    pz = eye[2] + t * dz
    alt, r = _altitude(c0, b, t)
    gx, gy = raster_from_ecef(mosaic, px, py, pz, r)
    return alt - sample_height(mosaic, gx, gy)


def _sample_hmax(mosaic, level: int, gx, gy):
    """Nearest fetch from the dilated max-height bound pyramid; -1e12
    outside the mosaic (never a candidate)."""
    flat = mosaic.mip_hmax_flat[level - 1]
    h_l, w_l = mosaic.mip_shapes[level - 1]
    s = float(2**level)
    off = (s - 1.0) / 2.0
    gxl = (gx - off) / s
    gyl = (gy - off) / s
    in_b = (gxl >= -1.0) & (gyl >= -1.0) & (gxl <= w_l) & (gyl <= h_l)
    ix = index_i32(torch.round(gxl), w_l - 1)
    iy = index_i32(torch.round(gyl), h_l - 1)
    return torch.where(in_b, flat[iy.long() * w_l + ix.long()], -1.0e12)


def _shell(mosaic, eye, dirs):
    """The ray's interval in the terrain shell |x| <= R0 + hmax + 1:
    ``(b, c0, t_enter, t_exit, feasible)`` with b = d . eye and c0 = |eye|^2
    - R0^2, both from the altitude difference (stable)."""
    dx, dy, dz = dirs
    e_norm = norm(eye)
    a0 = e_norm - R0
    hmax = mosaic.hmax + 1.0
    r_shell = R0 + hmax
    b = dx * eye[0] + dy * eye[1] + dz * eye[2]
    c = (a0 - hmax) * (e_norm + r_shell)
    c0 = a0 * (e_norm + R0)
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_enter = torch.where(c <= 0.0, 0.0, -b - sq)
    t_exit = -b + sq
    return b, c0, t_enter, t_exit, (disc > 0.0) & (t_exit > 0.0)


def _window_interval(mosaic, eye, dirs):
    """``(b, c0, t0, t1)``: the shell interval clipped to [0, FAR]."""
    b, c0, t_enter, t_exit, feasible = _shell(mosaic, eye, dirs)
    t0 = torch.clamp(t_enter, min=0.0)
    t1 = torch.where(feasible, torch.clamp(t_exit, max=FAR), 0.0)
    return b, c0, t0, t1


def _bisect(mosaic, eye, dirs, c0, b, lo, hi, n_refine: int):
    for _ in range(n_refine):
        tm = 0.5 * (lo + hi)
        below = _surface_f(mosaic, eye, dirs, c0, b, tm) <= 0.0
        lo, hi = torch.where(below, lo, tm), torch.where(below, tm, hi)
    return hi


def march(mosaic, eye, dirs, *, n_steps: int, n_refine: int, two_level: bool | None = None,
          n_coarse: int = 96, n_fine: int = 24):
    """First ray/surface crossing for dense ray planes.

    ``eye``: ``f32[3]`` ECEF; ``dirs``: unit-direction planes ``(dx, dy,
    dz)`` (any shape) or ``[..., 3]``. Uniform mode takes ``n_steps`` steps
    over the feasible interval and ``n_refine`` bisections; ``two_level``
    (default: the mosaic has max mips and ``n_steps >= 384``) rejects
    intervals against the dilated max-height pyramid first
    (`_march_two_level`). Returns ``(hit, t_hit)``.
    """
    dirs = _split_dirs(dirs)
    dx, dy, dz = dirs
    eye = f32(eye, dx.device)
    b, c0, t_enter, t_exit, feasible = _shell(mosaic, eye, dirs)

    # Clip to the mosaic bounding sphere.
    rx = eye[0] - mosaic.bound_center[0]
    ry = eye[1] - mosaic.bound_center[1]
    rz = eye[2] - mosaic.bound_center[2]
    bb = dx * rx + dy * ry + dz * rz
    cb = rx * rx + ry * ry + rz * rz - mosaic.bound_radius * mosaic.bound_radius
    disc_b = bb * bb - cb
    sqb = torch.sqrt(torch.clamp(disc_b, min=0.0))
    tb0 = -bb - sqb
    tb1 = -bb + sqb
    feasible = feasible & (disc_b > 0.0) & (tb1 > 0.0)

    t0 = torch.clamp(torch.maximum(t_enter, tb0), min=0.0)
    t1 = torch.where(feasible, torch.clamp(torch.minimum(t_exit, tb1), max=FAR), 0.0)
    t1 = torch.maximum(t1, t0)

    if two_level is None:
        two_level = bool(mosaic.mip_hmax_flat) and n_steps >= 384
    if two_level:
        return _march_two_level(mosaic, eye, dirs, c0, b, t0, t1, n_coarse=n_coarse, n_fine=n_fine,
                                n_refine=n_refine)

    dt = (t1 - t0) / n_steps
    f_prev = _surface_f(mosaic, eye, dirs, c0, b, t0)
    found = f_prev <= 0.0  # started at/below the surface
    t_lo, t_hi = t0, torch.where(found, t0, t1)
    for k in range(1, n_steps + 1):
        t_k = t0 + dt * k
        f_k = _surface_f(mosaic, eye, dirs, c0, b, t_k)
        crossing = (~found) & (f_prev > 0.0) & (f_k <= 0.0)
        t_lo = torch.where(crossing, t_k - dt, t_lo)
        t_hi = torch.where(crossing, t_k, t_hi)
        found, f_prev = found | crossing, f_k
    return found, _bisect(mosaic, eye, dirs, c0, b, t_lo, t_hi, n_refine)


def _march_two_level(mosaic, eye, dirs, c0, b, t0, t1, *, n_coarse, n_fine, n_refine):
    """Max-mip accelerated exact march.

    Phase A: [t0, t1] splits into ``n_coarse`` intervals; one is a
    candidate iff its minimum ray altitude (analytic, from the altitude
    quadratic) can reach the dilated max-height bound at its midpoint, at
    the tightest pyramid level whose footprint covers the interval's ground
    travel. Phase B: rounds that each fine-march the next candidate interval
    after the pixel's cursor with ``n_fine`` steps, until every pixel hit or
    ran out of candidates.

    The JAX package packs the candidate flags into u32 words and finds the
    next one by bit tricks; here they are a bool plane per interval, and
    the next candidate is the first flag after the cursor: the same
    interval. JAX's `while_loop` tests its condition before every round; a
    test on the card is a host sync, so it runs once every
    `TWO_LEVEL_ROUNDS_PER_CHECK` rounds. A round after the condition turns
    false is a no-op (no pixel is active, no cursor moves), so the result
    is the same.
    """
    dx, dy, dz = dirs
    shape = dx.shape
    dev = dx.device
    dt_c = (t1 - t0) / n_coarse

    n_levels = len(mosaic.mip_shapes)
    levels = sorted({min(1, n_levels), min(3, n_levels), min(6, n_levels)})
    texel0 = radians(mosaic.pixel_scale[1]) * R0

    cand = torch.zeros((n_coarse,) + tuple(shape), dtype=torch.bool, device=dev)
    for k in range(n_coarse):
        ta = t0 + dt_c * k
        tb = ta + dt_c
        tm = 0.5 * (ta + tb)
        px = eye[0] + tm * dx
        py = eye[1] + tm * dy
        pz = eye[2] + tm * dz
        r = torch.sqrt(px * px + py * py + pz * pz)
        gx, gy = raster_from_ecef(mosaic, px, py, pz, r)
        bound = torch.full_like(dt_c, 3.0e38)  # no valid level
        for lv in reversed(levels):  # coarsest first; finest overwrites
            valid = dt_c * 0.5 <= texel0 * (2.0**lv)
            bound = torch.where(valid, _sample_hmax(mosaic, lv, gx, gy), bound)
        # Min ray altitude over [ta, tb]: the ends and the vertex (-b).
        alt_min = torch.minimum(_altitude(c0, b, ta)[0], _altitude(c0, b, tb)[0])
        alt_min = torch.minimum(alt_min, _altitude(c0, b, torch.clamp(-b, min=ta, max=tb))[0])
        cand[k] = (alt_min <= bound + 2.0) & (dt_c > 0.0)

    big_i = n_coarse + 1
    k_of = torch.arange(n_coarse, device=dev).view((n_coarse,) + (1,) * len(shape))

    def next_candidate(cursor):
        after = cand & (k_of > cursor)
        first = torch.argmax(after.to(torch.uint8), dim=0).to(torch.int32)
        return torch.where(after.any(dim=0), first, big_i)

    f_start = _surface_f(mosaic, eye, dirs, c0, b, t0)
    found = f_start <= 0.0  # camera at/below the surface
    t_lo = torch.broadcast_to(t0, shape)
    t_hi = torch.where(found, t0, t1).broadcast_to(shape)
    cursor = torch.full(shape, -1, dtype=torch.int32, device=dev)
    dt_f = dt_c / n_fine
    for it in range(n_coarse):
        if it % TWO_LEVEL_ROUNDS_PER_CHECK == 0 and not bool(((~found) & (cursor < n_coarse)).any()):
            break
        nxt = next_candidate(cursor)
        active = (~found) & (nxt < big_i)
        ta = t0 + dt_c * nxt.to(torch.float32)
        f_prev = _surface_f(mosaic, eye, dirs, c0, b, ta)
        seg_hit = f_prev <= 0.0
        s_lo = torch.where(seg_hit, ta - dt_f, ta)
        s_hi = torch.where(seg_hit, ta, ta + dt_c)
        for j in range(1, n_fine + 1):
            t_j = ta + dt_f * j
            f_j = _surface_f(mosaic, eye, dirs, c0, b, t_j)
            crossing = (~seg_hit) & (f_prev > 0.0) & (f_j <= 0.0)
            s_lo = torch.where(crossing, t_j - dt_f, s_lo)
            s_hi = torch.where(crossing, t_j, s_hi)
            seg_hit, f_prev = seg_hit | crossing, f_j
        newly = active & seg_hit
        found = found | newly
        t_lo = torch.where(newly, s_lo, t_lo)
        t_hi = torch.where(newly, s_hi, t_hi)
        # A miss moves the cursor on; no candidate left exhausts the pixel.
        cursor = torch.where(active & (~seg_hit), nxt, cursor)
        cursor = torch.where((~found) & (nxt >= big_i), n_coarse, cursor)
    return found, _bisect(mosaic, eye, dirs, c0, b, t_lo, t_hi, n_refine)


def _pool3(a, op):
    """3x3 neighbourhood reduce with edge replication."""
    up = torch.cat([a[:1], a[:-1]], dim=0)
    dn = torch.cat([a[1:], a[-1:]], dim=0)
    a = op(op(up, a), dn)
    lf = torch.cat([a[:, :1], a[:, :-1]], dim=1)
    rt = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    return op(op(lf, a), rt)


def _cell_h(mosaic, gx, gy):
    """Triangle-exact surface height from the per-cell corner table (one row
    gather; INVALID outside the mosaic). Equals `surface.sample_height` for
    mosaics with a cell table."""
    if not mosaic.has_cell_table:
        return sample_height(mosaic, gx, gy)
    h_m, w_m = mosaic.shape
    cx = index_i32(torch.floor(gx), w_m - 2)
    cy = index_i32(torch.floor(gy), h_m - 2)
    in_b = (gx >= 0.0) & (gy >= 0.0) & (gx <= w_m - 1.0) & (gy <= h_m - 1.0)
    fx = gx - cx
    fy = gy - cy
    parity = (cx + cy) % 2
    rows = cell_rows(mosaic, cy.long() * w_m + cx.long())
    h = tri_interp(rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3], fx, fy, parity)
    return torch.where(in_b, h, INVALID_HEIGHT)


def _guarded(x):
    """``x`` with magnitudes below 1e-12 replaced by 1e-12 (a divisor)."""
    return torch.where(torch.abs(x) < 1e-12, 1e-12, x)


def _cell_walk_core(mosaic, ends, f_lo, f_hi, active, *, n_cells: int):
    """First crossing of a LINEAR track against the piecewise-linear surface.

    ``ends = (gx0, gy0, alt0, gx1, gy1, alt1)`` are the raster-space track
    endpoints of a bracket with ``f_lo > 0 >= f_hi`` (the clearance at its
    ends). Within one (cell, triangle) piece the clearance is linear along
    the track, so each crossing is one division; the walk visits at most
    ``n_cells`` cells front to back, one corner-row gather each. Pixels
    still unresolved take the secant of the last known sign change.

    Returns ``u*`` in [0, 1] along the track (1 where inactive).
    """
    gx0, gy0, alt0, gx1, gy1, alt1 = ends
    h_m, w_m = mosaic.shape
    dgx = gx1 - gx0
    dgy = gy1 - gy0
    dalt = alt1 - alt0
    eps = 1e-4

    def axis_exit(g0, dg, c):
        # First u where the linear track leaves [c, c + 1] along one axis.
        hi_b = (c + 1.0 - g0) / _guarded(dg)
        lo_b = (c.to(torch.float32) - g0) / _guarded(dg)
        ex = torch.where(dg > 0, hi_b, torch.where(dg < 0, lo_b, BIG))
        return torch.where(torch.abs(dg) < 1e-12, BIG, ex)

    u_cur = torch.zeros_like(gx0)
    found = torch.zeros_like(active)
    u_star = torch.ones_like(gx0)
    f_cur = f_lo
    for _ in range(n_cells):
        live = active & (~found) & (u_cur < 1.0)
        # The current cell at a position nudged past the entry boundary.
        un = torch.clamp(u_cur + eps, 0.0, 1.0)
        gxc = gx0 + un * dgx
        gyc = gy0 + un * dgy
        cx = index_i32(torch.floor(gxc), w_m - 2)
        cy = index_i32(torch.floor(gyc), h_m - 2)
        in_b = (gxc >= 0.0) & (gyc >= 0.0) & (gxc <= w_m - 1.0) & (gyc <= h_m - 1.0)
        parity = (cx + cy) % 2
        rows = cell_rows(mosaic, cy.long() * w_m + cx.long())

        u_exit = torch.clamp(torch.minimum(axis_exit(gx0, dgx, cx), axis_exit(gy0, dgy, cy)), max=1.0)
        u_exit = torch.maximum(u_exit, torch.clamp(u_cur + eps, max=1.0))

        # Triangle-boundary u within the cell: fx == fy (parity 0) or
        # fx + fy == 1 (parity 1), with fx(u) = gx(u) - cx, fy(u) = gy(u) - cy.
        fx0 = gx0 - cx
        fy0 = gy0 - cy
        u_d0 = (fy0 - fx0) / _guarded(dgx - dgy)
        u_d1 = (1.0 - fx0 - fy0) / _guarded(dgx + dgy)
        u_diag = torch.where(parity == 0, u_d0, u_d1)
        u_diag = torch.where((u_diag > u_cur) & (u_diag < u_exit), u_diag, u_exit)

        def clearance(u):
            fx = torch.clamp(gx0 + u * dgx - cx, 0.0, 1.0)
            fy = torch.clamp(gy0 + u * dgy - cy, 0.0, 1.0)
            h = tri_interp(rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3], fx, fy, parity)
            return (alt0 + u * dalt) - h

        # Two linear sub-intervals: [u_cur, u_diag], [u_diag, u_exit].
        f_a = clearance(u_cur)
        f_d = clearance(u_diag)
        f_e = clearance(u_exit)

        def seg_cross(fa, fb, ua, ub):
            cross = (fa > 0.0) & (fb <= 0.0) & (ub > ua)
            u = ua + (ub - ua) * fa / _guarded(fa - fb)
            return cross, torch.clamp(u, ua, ub)

        c1, u1 = seg_cross(f_a, f_d, u_cur, u_diag)
        c2, u2 = seg_cross(f_d, f_e, u_diag, u_exit)
        hit_here = live & in_b & (c1 | c2)
        found = found | hit_here
        u_star = torch.where(hit_here, torch.where(c1, u1, u2), u_star)
        u_cur = torch.where(live & (~hit_here), u_exit, u_cur)
        f_cur = torch.where(live & (~hit_here), f_e, f_cur)

    # Brackets wider than the cell budget: the secant between the walk's
    # frontier (f > 0) and the bracket's end (f <= 0).
    u_fb = u_cur + (1.0 - u_cur) * f_cur / _guarded(f_cur - f_hi)
    u_star = torch.where(found, u_star, torch.clamp(u_fb, 0.0, 1.0))
    return torch.where(active, u_star, torch.ones_like(gx0))


def _track_raster(mosaic, coeffs, c0, b, t):
    """Raster-space track point of the ray at parameter t: ``(gx, gy,
    alt)``, through the expansion in ``coeffs`` (`surface.track_coeffs`)."""
    alt, r = _altitude(c0, b, t)
    gx, gy = raster_from_coeffs(mosaic, coeffs, t, r)
    return gx, gy, alt


def _grouped_bracket_pools(d_lo, d_hi_exact):
    """3x3 bracket pooling split into two distance clusters per texel.

    Pooling one interval over a neighbourhood that spans a depth
    discontinuity runs it from the near ridge to the far valley; here the
    neighbours' brackets are clustered by their start around the midpoint
    of the start spread and each cluster pooled on its own. Coverage is the
    union of the neighbours' brackets, as with one pool.

    ``d_lo``: crossing start per texel, BIG where none. ``d_hi_exact``:
    exact crossing end, -BIG where none. Returns ``(m, m_hi, a_max, b_min,
    b_max)``: the pooled near start and max start, the near cluster's end,
    and the far cluster's start and end (sentinels where a cluster is
    empty).
    """
    def shifts(a):
        up = torch.cat([a[:1], a[:-1]], dim=0)
        dn = torch.cat([a[1:], a[-1:]], dim=0)
        out = []
        for r in (up, a, dn):
            out += [torch.cat([r[:, :1], r[:, :-1]], dim=1), r, torch.cat([r[:, 1:], r[:, -1:]], dim=1)]
        return out

    lo_n = shifts(d_lo)
    hi_n = shifts(d_hi_exact)
    m = lo_n[0]
    m_hi = torch.where(lo_n[0] < BIG, lo_n[0], -BIG)
    for p in lo_n[1:]:
        m = torch.minimum(m, p)
        m_hi = torch.maximum(m_hi, torch.where(p < BIG, p, -BIG))
    theta = 0.5 * (m + m_hi)

    a_max = torch.full_like(m, -BIG)
    b_min = torch.full_like(m, BIG)
    b_max = torch.full_like(m, -BIG)
    for lo_p, hi_p in zip(lo_n, hi_n):
        near = lo_p <= theta  # texels without a crossing carry BIG: never near
        far = (~near) & (lo_p < BIG)
        a_max = torch.maximum(a_max, torch.where(near, hi_p, -BIG))
        b_min = torch.minimum(b_min, torch.where(far, lo_p, BIG))
        b_max = torch.maximum(b_max, torch.where(far, hi_p, -BIG))
    return m, m_hi, a_max, b_min, b_max


def _quad(g0, gm, g1):
    """Quadratic in u through (0, g0), (0.5, gm), (1, g1)."""
    return g0, -3.0 * g0 + 4.0 * gm - g1, 2.0 * g0 - 4.0 * gm + 2.0 * g1


def _at(q, u):
    return q[0] + u * (q[1] + u * q[2])


def _quad_leg(mosaic, coeffs, c0, b, t0, t1, t_min, t_max, nw: int, active, *, margin_rel: float,
              margin_abs: float):
    """One bracketed leg on a quadratic fit of the ray's raster track.

    The bracket [t_min, t_max] widens by the margins and clips to the shell
    interval [t0, t1]; the exact track is evaluated at its ends and midpoint
    only, ``gx, gy, alt`` are fitted as quadratics in u, and ``nw`` uniform
    steps on the fit each take one corner-row gather (`_cell_h`). Returns
    ``(found, hit0, u_a, u_b, f_a, f_b, gx_a, gy_a, alt_a, gx_b, gy_b,
    alt_b, t_lo, span)``: the step bracket [u_a, u_b] of the first crossing
    with its clearances and track ends, as `_cell_walk_core` takes them.
    """
    t_lo = torch.clamp(t_min * (1.0 - margin_rel) - margin_abs, t0, t1)
    t_hi = torch.clamp(t_max * (1.0 + margin_rel) + margin_abs, t_lo, t1)
    span = t_hi - t_lo
    g0 = _track_raster(mosaic, coeffs, c0, b, t_lo)
    gm = _track_raster(mosaic, coeffs, c0, b, t_lo + 0.5 * span)
    g1 = _track_raster(mosaic, coeffs, c0, b, t_hi)
    qx, qy, qa = (_quad(g0[i], gm[i], g1[i]) for i in range(3))

    def f_at(u):
        return _at(qa, u) - _cell_h(mosaic, _at(qx, u), _at(qy, u))

    du = torch.where(active, 1.0 / nw, 0.0)
    f_prev = f_at(torch.zeros_like(t_lo))
    hit0 = active & (f_prev <= 0.0)
    found, u_a, u_b = hit0, torch.zeros_like(t_lo), torch.where(hit0, 0.0, 1.0)
    f_a = f_b = f_prev
    for k in range(1, nw + 1):
        u_k = du * k
        f_k = f_at(u_k)
        crossing = active & (~found) & (f_prev > 0.0) & (f_k <= 0.0)
        u_a = torch.where(crossing, u_k - du, u_a)
        u_b = torch.where(crossing, u_k, u_b)
        # The walk needs f(u_a) > 0 >= f(u_b): carry them out.
        f_a = torch.where(crossing, f_prev, f_a)
        f_b = torch.where(crossing, f_k, f_b)
        found, f_prev = found | crossing, f_k
    return (found, hit0, u_a, u_b, f_a, f_b,
            _at(qx, u_a), _at(qy, u_a), _at(qa, u_a), _at(qx, u_b), _at(qy, u_b), _at(qa, u_b),
            t_lo, span)


def _walk_leg(mosaic, leg, n_cells: int):
    """``(hit, t_hit)`` of a leg's result: the analytic cell walk inside its
    step bracket (linearized between the bracket's fitted ends)."""
    found, hit0, u_a, u_b, f_a, f_b = leg[:6]
    t_lo, span = leg[12], leg[13]
    active = found & (~hit0) & (u_b > u_a)
    v = _cell_walk_core(mosaic, leg[6:12], f_a, f_b, active, n_cells=n_cells)
    u_star = torch.where(active, u_a + v * (u_b - u_a), torch.where(hit0, 0.0, u_b))
    return found, t_lo + u_star * span


def _window_march_quad(mosaic, eye, eye_host, dirs, t_min, t_max, any_hit, *, n_window: int, n_cells: int,
                       margin_rel: float, margin_abs: float):
    """Bracketed exact march on one quadratic track fit: ``n_window``
    steps over the pixel's pooled bracket [t_min, t_max], then the cell
    walk (`raycast.py:589-702`; its TPU ``lane_shuffle`` is not ported)."""
    b, c0, t0, t1 = _window_interval(mosaic, eye, dirs)
    coeffs = track_coeffs(mosaic, eye, eye_host, dirs)
    leg = _quad_leg(mosaic, coeffs, c0, b, t0, t1, t_min, t_max, n_window, any_hit, margin_rel=margin_rel,
                    margin_abs=margin_abs)
    return _walk_leg(mosaic, leg, n_cells)


def _window_march_quad2(mosaic, eye, eye_host, dirs, legs, any_hit, *, n_window: int, n_cells: int,
                        margin_rel: float, margin_abs: float):
    """Two-interval variant of `_window_march_quad` (`raycast.py:761-871`).

    ``legs`` is ``((tA_lo, tA_hi), (tB_lo, tB_hi))``, the split pooled
    cluster brackets of `_grouped_bracket_pools` (B a phase-shifted copy of
    A where the neighbourhood has one cluster). Each leg takes its own
    track fit and ``max(n_window // 2, 2)`` steps; the leg whose bracket
    STARTS first wins (A on ties), and one cell walk refines it.
    """
    b, c0, t0, t1 = _window_interval(mosaic, eye, dirs)
    coeffs = track_coeffs(mosaic, eye, eye_host, dirs)
    nw = max(n_window // 2, 2)
    leg_a, leg_b = (_quad_leg(mosaic, coeffs, c0, b, t0, t1, lo, hi, nw, any_hit, margin_rel=margin_rel,
                              margin_abs=margin_abs) for lo, hi in legs)
    start_a = leg_a[12] + leg_a[2] * leg_a[13]  # t_lo + u_a * span
    start_b = leg_b[12] + leg_b[2] * leg_b[13]
    use_a = leg_a[0] & ((~leg_b[0]) | (start_a <= start_b))
    won = tuple(torch.where(use_a, x, y) for x, y in zip(leg_a, leg_b))
    return _walk_leg(mosaic, (leg_a[0] | leg_b[0],) + won[1:], n_cells)


def _window_march_quad3(mosaic, eye, eye_host, dirs, legs, any_hit, *, n_cells: int, margin_rel: float,
                        margin_abs: float):
    """Bracketed exact march over several legs, each on a quadratic fit of
    the ray's raster track (`_quad_leg`).

    ``legs`` is a sequence of ``(t_lo, t_hi, nw)``: per-pixel intervals with
    a static step count each (`march_guided_panorama`: the two pooled
    cluster legs and the pixel's own-texel sure leg, or one union leg and
    the own leg). The leg whose bracket ENDS first wins (the tighter
    bracket for the same crossing, the earlier one for distinct crossings),
    and one analytic cell walk refines it.
    """
    b, c0, t0, t1 = _window_interval(mosaic, eye, dirs)
    coeffs = track_coeffs(mosaic, eye, eye_host, dirs)
    cur = None
    for t_lo_leg, t_hi_leg, nw in legs:
        o = _quad_leg(mosaic, coeffs, c0, b, t0, t1, t_lo_leg, t_hi_leg, nw, any_hit, margin_rel=margin_rel,
                      margin_abs=margin_abs)
        o_end = o[12] + o[3] * o[13]  # t_lo + u_b * span
        if cur is None:
            cur, cur_end = o, o_end
            continue
        use_new = o[0] & ((~cur[0]) | (o_end < cur_end))
        cur = tuple(torch.where(use_new, n, c) for n, c in zip(o, cur))
        cur_end = torch.where(use_new, o_end, cur_end)
    return _walk_leg(mosaic, cur, n_cells)


def _window_march(mosaic, eye, dirs, t_min, t_max, any_hit, *, n_window: int, n_refine: int,
                  margin_rel: float, margin_abs: float):
    """Uniform march restricted to per-pixel brackets, then bisection: for
    mosaics without a cell table and the ray-prepass guided march."""
    b, c0, t0, t1 = _window_interval(mosaic, eye, dirs)
    t_lo = torch.clamp(t_min * (1.0 - margin_rel) - margin_abs, t0, t1)
    t_hi = torch.clamp(t_max * (1.0 + margin_rel) + margin_abs, t_lo, t1)
    dt = torch.where(any_hit, (t_hi - t_lo) / n_window, 0.0)

    f_prev = _surface_f(mosaic, eye, dirs, c0, b, t_lo)
    found = any_hit & (f_prev <= 0.0)
    lo, hi = t_lo, torch.where(found, t_lo, t_hi)
    for k in range(1, n_window + 1):
        t_k = t_lo + dt * k
        f_k = _surface_f(mosaic, eye, dirs, c0, b, t_k)
        crossing = any_hit & (~found) & (f_prev > 0.0) & (f_k <= 0.0)
        lo = torch.where(crossing, t_k - dt, lo)
        hi = torch.where(crossing, t_k, hi)
        found, f_prev = found | crossing, f_k
    return found, _bisect(mosaic, eye, dirs, c0, b, lo, hi, n_refine)


def march_guided(mosaic, eye, dirs, *, n_steps: int, n_refine: int, pre_stride: tuple = (2, 4),
                 n_window: int = 96):
    """Exact march with t-ranges from a strided low-resolution ray prepass.

    The uniform `march` on a ``(sy, sx)``-strided ray subgrid finds the
    crossings at low resolution; each pixel takes the 3x3 prepass
    neighbourhood's min/max hit distance (plus 2% + 300 m) as its bracket,
    sky where the whole neighbourhood is sky, and `_window_march` resolves
    it. Needs no field-of-view bound and serves any ray set.
    """
    dirs = _split_dirs(dirs)
    dx, dy, dz = dirs
    eye = f32(eye, dx.device)
    h, w = dx.shape
    sy, sx = pre_stride
    oy, ox = sy // 2, sx // 2
    pre = (dx[oy::sy, ox::sx], dy[oy::sy, ox::sx], dz[oy::sy, ox::sx])
    hit_p, t_p = march(mosaic, eye, pre, n_steps=n_steps, n_refine=10, two_level=False)
    t_min = _pool3(torch.where(hit_p, t_p, BIG), torch.minimum)
    t_max = _pool3(torch.where(hit_p, t_p, -BIG), torch.maximum)

    def up(a):
        a = torch.repeat_interleave(a, sy, dim=0)[:h]
        a = torch.repeat_interleave(a, sx, dim=1)[:, :w]
        # The strided grid can undershoot the full grid by one row/column.
        if a.shape[0] < h:
            a = torch.cat([a, a[-1:].expand(h - a.shape[0], -1)], dim=0)
        if a.shape[1] < w:
            a = torch.cat([a, a[:, -1:].expand(-1, w - a.shape[1])], dim=1)
        return a

    t_min, t_max = up(t_min), up(t_max)
    return _window_march(mosaic, eye, dirs, t_min, t_max, t_min < BIG, n_window=n_window,
                         n_refine=n_refine, margin_rel=0.02, margin_abs=300.0)


def guided_march_rounds(*, n_window: int = 6, n_cells: int = 2, guard_legs: bool = True, nw_guard: int = 2,
                        split_brackets: bool = True) -> int:
    """Per-pixel table-gather rounds of the guided march's window phase:
    each window evaluation and each cell-walk step is one cell-row gather."""
    nw_leg = max(n_window // 2, 2)
    if guard_legs:
        if split_brackets:
            return 2 * (nw_leg + 1) + (nw_guard + 1) + n_cells
        return (n_window + 1) + (nw_guard + 1) + n_cells  # union + own
    if split_brackets:
        return 2 * (nw_leg + 1) + n_cells
    return n_window + 1 + n_cells


def guided_prepass_spec(*, height: int, fov_hint: float, aspect: float, n_steps: int = 1024,
                        supersample: float = 1.0, elev_supersample: float = 1.0):
    """The guided march's prepass geometry: ``(spec_pre, half_win,
    az_span)``, the `PanoramaSpec` that `march_guided_panorama` hands to
    `panorama_crossing_prepass` and the angular window it comes from.

    Host arithmetic in Python floats, as the JAX package derives it: the
    window covers the frustum's diagonal half-angle plus a margin, widths
    round up to 128 and heights to 8; at most 896 prepass steps.
    """
    half_diag = min(
        math.atan(math.tan(0.5 * float(fov_hint)) * math.sqrt(1.0 + aspect * aspect)), 0.49 * math.pi
    )
    half_win = min(1.03 * half_diag + 0.01, 0.49 * math.pi)
    az_span = min(2.0 * math.pi, 2.0 * half_win / max(math.cos(half_win), 0.3))
    px_per_rad = supersample * height / float(fov_hint)
    wp = max(256, min(int(math.ceil(az_span * px_per_rad / 128.0)) * 128, 8192))
    hp_per_rad = px_per_rad * elev_supersample
    hp = max(64, min(int(math.ceil(2.0 * half_win * hp_per_rad / 8.0)) * 8, 4096))
    spec_pre = PanoramaSpec(
        width=wp, height=hp, n_steps=min(n_steps, 896), n_refine=0,
        azimuth_start=-0.5 * az_span, azimuth_span=az_span, elev_min=-half_win, elev_max=half_win,
    )
    return spec_pre, half_win, az_span


def march_guided_panorama(
    mosaic,
    eye,
    dirs,
    fwd,
    *,
    n_steps: int,
    n_refine: int,
    fov_hint: float,
    aspect: float,
    n_window: int = 6,
    supersample: float = 1.0,
    elev_supersample: float = 1.0,
    analytic_refine: bool = True,
    n_cells: int = 2,
    split_brackets: bool = True,
    guard_legs: bool = True,
    nw_guard: int = 2,
    nw_far: int | None = None,
    margin_rel: float = 0.01,
    margin_abs: float = 25.0,
    prepass_k_back: int = 1 << 20,
    bound_stride: int = 4,
):
    """Exact march with brackets from a panorama-profile prepass.

    The prepass (`panorama_crossing_prepass`: O(N) gathers per azimuth
    column, shared by every elevation row, and two launches of kernel K1)
    covers the frustum's angular window (`guided_prepass_spec`, sized from
    ``fov_hint``, an upper bound on the camera's fov) and returns per-texel
    crossing-distance brackets. Each pixel takes its nearest prepass
    texel's pooled brackets, and `_window_march_quad3` resolves the exact
    surface inside them.

    Default budget (``guard_legs``, ``split_brackets``, ``n_window=6``,
    ``nw_guard=2``, ``n_cells=2``: 13 gather rounds per pixel,
    `guided_march_rounds`): the two split pooled cluster legs of 3 steps
    and the pixel's own-texel sure leg [d_me, d_hi] of 2 steps. With
    ``split_brackets=False`` one union pooled leg of ``n_window`` steps and
    the own leg (the engine's interactive rung). ``guard_legs=False`` drops
    the own leg: the split cluster legs of ``n_window // 2`` steps each
    (`_window_march_quad2`), or with ``split_brackets=False`` one pooled
    bracket of ``n_window`` steps (`_window_march_quad`). Mosaics without a
    cell table take `_window_march` over the pooled bracket.

    ``eye`` on the host keeps the march free of host syncs (`_eye_on`).
    ``n_refine`` serves only the `_window_march` branch.
    """
    dirs = _split_dirs(dirs)
    dx, dy, dz = dirs
    dev = dx.device
    eye, eye_host = _eye_on(eye, dev)
    h, _ = dx.shape

    # Eye-local azimuth/elevation of every pixel ray (the fast warp's frame).
    _, (ux, uy, uz), (ex_, ey_), (nx0, ny0, nz0), _ = _eye_frame(eye)
    d_e = dx * ex_ + dy * ey_
    d_n = dx * nx0 + dy * ny0 + dz * nz0
    d_u = dx * ux + dy * uy + dz * uz
    az = torch.atan2(d_e, d_n)
    el = torch.asin(torch.clamp(d_u, -1.0, 1.0))
    az_c = torch.atan2(fwd[0] * ex_ + fwd[1] * ey_, fwd[0] * nx0 + fwd[1] * ny0 + fwd[2] * nz0)
    el_c = torch.asin(torch.clamp(fwd[0] * ux + fwd[1] * uy + fwd[2] * uz, -1.0, 1.0))

    spec_pre, half_win, az_span = guided_prepass_spec(
        height=h, fov_hint=fov_hint, aspect=aspect, n_steps=n_steps, supersample=supersample,
        elev_supersample=elev_supersample,
    )
    wp, hp = spec_pre.width, spec_pre.height
    pre = panorama_crossing_prepass(
        mosaic, eye, spec_pre, azimuth_offset=az_c, elev_offset=el_c, k_back=prepass_k_back,
        bound_stride=bound_stride,
    )

    d_lo = torch.where(pre["hit"], pre["d_lo"], BIG)
    # Pool the far end over exact-profile hits only: a bound-only texel
    # carries d_hi = FAR and would blow every neighbour's bracket out to
    # the far plane. A texel that is itself bound-only keeps its FAR end.
    bound_only = pre["hit"] & (pre["d_hi"] >= 0.98 * FAR)
    d_hi = torch.where(pre["hit"] & (~bound_only), pre["d_hi"], -BIG)
    use_quad = analytic_refine and mosaic.has_cell_table

    # Nearest prepass texel per pixel. Divisors are device tensors: CUDA
    # divides by a host scalar as a multiply by its reciprocal.
    span_d, half_d, win_d = f32([az_span, half_win, 2.0 * half_win], dev).unbind(0)
    rel_az = (az - az_c + math.pi) % (2.0 * math.pi) - math.pi  # floor modulo, as jnp's %
    gx = (rel_az + 0.5 * az_span) / span_d * wp - 0.5
    gy = (half_d - (el - el_c)) / win_d * hp - 0.5
    texel = (index_i32(torch.round(gy), hp - 1).long() * wp + index_i32(torch.round(gx), wp - 1).long())

    quad_kw = dict(n_cells=n_cells, margin_rel=margin_rel, margin_abs=margin_abs)
    if use_quad and (guard_legs or split_brackets):
        m, _, a_max, b_min, b_max = _grouped_bracket_pools(d_lo, d_hi)
        uni_hi = torch.maximum(a_max, b_max)
        uni_hi = torch.where(bound_only | (uni_hi <= 0.0), FAR, uni_hi)
        nw_leg = max(n_window // 2, 2)
        if split_brackets:
            b_max_eff = torch.where(bound_only, FAR, b_max)
            split = (a_max > 0.0) & (b_min < BIG) & (b_max_eff > b_min)
            t_a1 = torch.where(split, a_max, uni_hi)
            # Merged mode: leg B re-marches the union half a step out of
            # phase with leg A.
            t_b0 = torch.where(split, torch.maximum(b_min, a_max), m + (uni_hi - m) * (0.5 / nw_leg))
            t_b1 = torch.where(split, torch.maximum(b_max_eff, t_b0), uni_hi)
            cols = [m, t_a1, t_b0, t_b1]
        else:
            cols = [m, uni_hi]
        if not guard_legs:
            rows = torch.stack(cols, dim=-1).reshape(-1, 4)[texel]
            legs = ((rows[..., 0], rows[..., 1]), (rows[..., 2], rows[..., 3]))
            return _window_march_quad2(mosaic, eye, eye_host, dirs, legs, rows[..., 0] < BIG, n_window=n_window,
                                       **quad_kw)
        # The own-texel sure leg; where the own texel is sky, the pooled
        # near start (duplicate coverage, never a new hit class).
        cols += [torch.where(pre["hit"], pre["d_me"], m), torch.where(pre["hit"], pre["d_hi"], m)]
        rows = torch.stack(cols, dim=-1).reshape(-1, len(cols))[texel]
        steps = [nw_leg, nw_leg if nw_far is None else max(nw_far, 1)] if split_brackets else [n_window]
        legs = tuple((rows[..., 2 * i], rows[..., 2 * i + 1], nw) for i, nw in enumerate(steps + [nw_guard]))
        return _window_march_quad3(mosaic, eye, eye_host, dirs, legs, rows[..., 0] < BIG, **quad_kw)

    t_max_img = _pool3(d_hi, torch.maximum)
    t_max_img = torch.where(bound_only | (t_max_img <= 0.0), FAR, t_max_img)
    rows = torch.stack([_pool3(d_lo, torch.minimum), t_max_img], dim=-1).reshape(-1, 2)[texel]
    if use_quad:
        return _window_march_quad(mosaic, eye, eye_host, dirs, rows[..., 0], rows[..., 1], rows[..., 0] < BIG,
                                  n_window=n_window, **quad_kw)
    return _window_march(mosaic, eye, dirs, rows[..., 0], rows[..., 1], rows[..., 0] < BIG, n_window=n_window,
                         n_refine=n_refine, margin_rel=margin_rel, margin_abs=margin_abs)


def guided_march_defaults() -> dict:
    """The guided march's default knob values, read off
    `march_guided_panorama`'s signature."""
    sig = inspect.signature(march_guided_panorama)
    return {k: v.default for k, v in sig.parameters.items() if v.default is not inspect.Parameter.empty}


def render_perspective(
    mosaic,
    camera: Camera,
    *,
    width: int,
    height: int,
    n_steps: int = 1024,
    n_refine: int = 24,
    pixelize_n=None,
    quantize_rt: bool = True,
    apply_postprocess: bool = True,
    guided: bool = False,
    fov_hint: float | None = None,
    guided_kw: tuple = (),
):
    """One triangle-exact perspective frame on the mosaic's device: the
    terrain pass (the march, the hit's attributes and shading, the sky
    clear colour, 0..1 depth) and the postprocess pass, as the reference's
    two render passes (`terrain_renderer.rs:373-450`).

    ``guided`` with ``fov_hint`` (a static upper bound on the camera's fov)
    takes `march_guided_panorama` (with ``guided_kw`` and at most 18
    bisections), ``guided`` alone `march_guided`, else `march`.

    Returns ``{"color" f32[H, W, 3] linear, "depth" (0..1 reference
    convention), "distance", "hit"}``.
    """
    dev = mosaic.device
    (dx, dy, dz), fwd = camera_rays(camera, width, height, device=dev)
    eye, eye_host = _eye_on(camera.eye, dev)

    if guided and fov_hint is not None:
        hit, t_hit = march_guided_panorama(
            mosaic, eye_host, (dx, dy, dz), fwd, n_steps=n_steps, n_refine=min(n_refine, 18),
            fov_hint=fov_hint, aspect=width / height, **dict(guided_kw),
        )
    elif guided:
        hit, t_hit = march_guided(mosaic, eye, (dx, dy, dz), n_steps=n_steps, n_refine=n_refine)
    else:
        hit, t_hit = march(mosaic, eye, (dx, dy, dz), n_steps=n_steps, n_refine=n_refine)

    # Near/far plane clipping along the view axis (`camera.rs:7-8`).
    cosf = dx * fwd[0] + dy * fwd[1] + dz * fwd[2]
    z_view = t_hit * cosf
    hit = hit & (z_view >= NEAR) & (z_view <= FAR)

    pos_x = eye[0] + t_hit * dx
    pos_y = eye[1] + t_hit * dy
    pos_z = eye[2] + t_hit * dz

    # Depth in the reference's convention: ndc z from the view-projection.
    vp = f32(camera.build_view_proj_matrix(float(width), float(height)), dev)
    clip_z = vp[2, 0] * pos_x + vp[2, 1] * pos_y + vp[2, 2] * pos_z + vp[2, 3]
    clip_w = vp[3, 0] * pos_x + vp[3, 1] * pos_y + vp[3, 2] * pos_z + vp[3, 3]
    depth = torch.where(hit, clip_z / clip_w, 1.0)

    # Attributes and shading at the hit point: one 32 B cell-row gather
    # where the cell rows carry the normals, four attribute rows otherwise.
    r = torch.sqrt(pos_x * pos_x + pos_y * pos_y + pos_z * pos_z)
    gx, gy = raster_from_ecef(mosaic, pos_x, pos_y, pos_z, r)
    if mosaic.has_cell_table and mosaic.cell_width == 8:
        _, n_x, n_y, n_z, _ = sample_attributes_cell(mosaic, gx, gy)
    else:
        _, n_x, n_y, n_z, _ = sample_attributes_soa(mosaic, gx, gy)

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    seed_x = px + eye[0] - pos_x
    seed_y = py + eye[1] - pos_y

    sun = f32(camera.sun_angle.to_vec3(), dev)
    channels = shd.shade_soa(n_x, n_y, n_z, sun, int(camera.view_mode), seed_x, seed_y)
    channels = tuple(torch.where(hit, c, sc) for c, sc in zip(channels, shd.SKY_COLOR))
    if quantize_rt:
        channels = tuple(shd.quantize_srgb8(c) for c in channels)
    if apply_postprocess:
        channels = postprocess_soa(channels, depth, pixelize_n=pixelize_n)
    return {
        "color": torch.stack(channels, dim=-1),
        "depth": depth,
        "distance": torch.where(hit, t_hit, FAR),
        "hit": hit,
    }


def fast_view_spec(
    *,
    width: int,
    height: int,
    fov_hint: float = DEFAULT_FOV_HINT,
    supersample: float = 1.25,
    n_steps: int = 384,
    clipmap_threshold: int | None = None,
):
    """The panorama spec that `render_perspective_fast` renders, with the
    window's half height and azimuth span: ``(spec, half_win, az_span)``.

    Host arithmetic in Python floats, as the JAX package derives it, so the
    window's static shapes are the same: the window covers the frustum's
    diagonal half-angle plus a margin, at ``supersample`` x the pixel
    density; widths round up to 256, heights to 8. ``clipmap_threshold``
    overrides `PanoramaSpec.fast`'s (the sharded fast frame windows every
    sharded level, `parallel/sharded_mosaic.py`).
    """
    half_diag = min(
        math.atan(math.tan(0.5 * float(fov_hint)) * math.sqrt(1.0 + (width / height) ** 2)),
        0.49 * math.pi,
    )
    half_win = min(1.03 * half_diag + 0.01, 0.49 * math.pi)
    az_span = min(2.0 * math.pi, 2.0 * half_win / max(math.cos(half_win), 0.3))
    px_per_rad = supersample * height / float(fov_hint)
    wp = max(256, min(int(math.ceil(az_span * px_per_rad / 256.0)) * 256, 8192))
    hp = max(64, min(int(math.ceil(2.0 * half_win * px_per_rad / 8.0)) * 8, 4096))
    kw = {} if clipmap_threshold is None else {"clipmap_threshold": clipmap_threshold}
    spec = PanoramaSpec.fast(
        width=wp, height=hp, n_steps=n_steps,
        azimuth_start=-0.5 * az_span, azimuth_span=az_span,
        elev_min=-half_win, elev_max=half_win, **kw,
    )
    return spec, half_win, az_span


def _unpack_rgb(bits):
    return tuple(((bits >> s) & 0x3FF).to(torch.float32) / 1023.0 for s in (0, 10, 20))


def render_perspective_fast(
    mosaic,
    camera: Camera,
    *,
    width: int,
    height: int,
    supersample: float = 1.25,
    n_steps: int = 384,
    pixelize_n=None,
    fov_hint: float = DEFAULT_FOV_HINT,
    windows=None,
    clipmap_threshold: int | None = None,
):
    """Interactive perspective frame on the mosaic's device.

    Renders the frustum's azimuth/elevation window (`fast_view_spec`,
    sized from ``fov_hint``, an upper bound on the camera's fov) with the
    LOD panorama engine, centred on the view direction, then warps it onto
    the perspective grid: each pixel takes the bilinear blend of the four
    window texels around its ray's azimuth and elevation, gathered as one
    8-word row (colour as a 10/10/10 code, distance) per pixel. The rows are
    int32 words: a packed colour whose blue code is below 8 is a denormal
    as a float.

    ``windows``: the clipmap windows of `fast_view_spec`'s spec (with
    ``clipmap_threshold``), extracted beforehand, as the sharded fast frame
    does (`parallel/sharded_mosaic.py::render_perspective_fast_sharded`);
    extracted here when None.

    Returns ``{"color" f32[H, W, 3], "depth" (0..1 reference convention),
    "distance", "hit"}``.
    """
    dev = mosaic.device
    (dx, dy, dz), fwd = camera_rays(camera, width, height, device=dev)
    eye = f32(camera.eye, dev)

    # Eye-local azimuth/elevation of every pixel ray.
    _, (ux, uy, uz), (ex_, ey_), (nx0, ny0, nz0), _ = _eye_frame(eye)
    d_e = dx * ex_ + dy * ey_
    d_n = dx * nx0 + dy * ny0 + dz * nz0
    d_u = dx * ux + dy * uy + dz * uz
    az = torch.atan2(d_e, d_n)  # [H, W], 0 = north
    el = torch.asin(torch.clamp(d_u, -1.0, 1.0))

    spec, half_win, az_span = fast_view_spec(
        width=width, height=height, fov_hint=fov_hint, supersample=supersample,
        n_steps=n_steps, clipmap_threshold=clipmap_threshold,
    )
    wp, hp = spec.width, spec.height

    # The window's centre: the view direction's azimuth/elevation.
    az_c = torch.atan2(fwd[0] * ex_ + fwd[1] * ey_, fwd[0] * nx0 + fwd[1] * ny0 + fwd[2] * nz0)
    el_c = torch.asin(torch.clamp(fwd[0] * ux + fwd[1] * uy + fwd[2] * uz, -1.0, 1.0))
    pano = render_panorama(
        mosaic, eye, spec, camera.sun_angle.to_vec3(), view_mode=int(camera.view_mode),
        quantize_rt=False, apply_postprocess=False,
        azimuth_offset=az_c, elev_offset=el_c, windows=windows,
    )

    enc = torch.round(torch.clamp(pano["color"], 0.0, 1.0) * 1023.0).to(torch.int32)
    packed_rgb = enc[..., 0] | (enc[..., 1] << 10) | (enc[..., 2] << 20)
    dist_p = pano["distance"].view(torch.int32)
    cosf = dx * fwd[0] + dy * fwd[1] + dz * fwd[2]

    # Divisors are device tensors: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which moves a last bit.
    span_d, half_d, win_d = f32([az_span, half_win, 2.0 * half_win], dev).unbind(0)
    rel_az = (az - az_c + math.pi) % (2.0 * math.pi) - math.pi  # floor modulo, as jnp's %
    gx = (rel_az + 0.5 * az_span) / span_d * wp - 0.5
    gy = (half_d - (el - el_c)) / win_d * hp - 0.5

    def shift_x(a):
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)

    def shift_y(a):
        return torch.cat([a[1:], a[-1:]], dim=0)

    p01, d01 = shift_x(packed_rgb), shift_x(dist_p)
    quad = torch.stack(
        [packed_rgb, dist_p, p01, d01, shift_y(packed_rgb), shift_y(dist_p), shift_y(p01), shift_y(d01)],
        dim=-1,
    ).reshape(-1, 8)

    x0 = torch.clamp(torch.floor(gx).to(torch.int32), 0, wp - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int32), 0, hp - 2)
    fx = torch.clamp(gx - x0, 0.0, 1.0)
    fy = torch.clamp(gy - y0, 0.0, 1.0)
    rows8 = quad[(y0 * wp + x0).long()]

    c00, c01 = _unpack_rgb(rows8[..., 0]), _unpack_rgb(rows8[..., 2])
    c10, c11 = _unpack_rgb(rows8[..., 4]), _unpack_rgb(rows8[..., 6])
    chans = tuple(
        (c00[i] * (1 - fx) + c01[i] * fx) * (1 - fy) + (c10[i] * (1 - fx) + c11[i] * fx) * fy
        for i in range(3)
    )
    d = rows8[..., 1::2].view(torch.float32)
    dist = (d[..., 0] * (1 - fx) + d[..., 1] * fx) * (1 - fy) + (d[..., 2] * (1 - fx) + d[..., 3] * fx) * fy
    hit = dist < 0.98 * FAR  # sky carries FAR distance

    # Reference-convention depth for the label pass: ray distance to view-axis
    # distance, then to ndc depth.
    depth = torch.where(hit, depth_from_dist(torch.clamp(dist * cosf, NEAR, FAR)), 1.0)

    chans = tuple(shd.quantize_srgb8(c) for c in chans)
    chans = postprocess_soa(chans, depth, pixelize_n=pixelize_n)
    return {
        "color": torch.stack(chans, dim=-1),
        "depth": depth,
        "distance": torch.where(hit, dist, FAR),
        "hit": hit,
    }
