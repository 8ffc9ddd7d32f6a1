"""The exact frame's building blocks: the port vs the JAX package.

The scene is the goldens' (`tests/helpers.py::small_scene(n=49,
span_deg=0.04, height_above=500)`); the JAX mosaic is carried across
(`jax_mosaic_to_port`), so both sides read the same tables. Tolerances:

- Dekker/Knuth pairs: head + tail equals the exact sum or product (rational
  arithmetic), and the pairs equal JAX's bit for bit on the same inputs.
- `track_coeffs` + `raster_from_coeffs`: within 4 float32 ulps of JAX
  evaluated primitive by primitive; within 4 ulps of the coordinates'
  largest magnitude of the jitted evaluation (XLA-CPU contracts the
  latitude polynomial into fused multiply-adds, which moves near-zero
  ``gy`` by many of its own ulps); against float64 truth no farther than
  1.15x the nearer of JAX's two evaluations, at p50 and max.
- `sample_attributes_cell`, `_cell_walk_core`, `_grouped_bracket_pools`:
  equal to JAX under `jax.disable_jit()` (the pools also to jitted JAX).
- `panorama_crossing_prepass`: ``hit`` and ``hit_exact`` equal on >= 99.9%
  of texels to JAX under `jax.disable_jit()`; ``d_lo``, ``d_me``, ``d_hi``
  within rtol 1e-5 on >= 99.5% of texels where both sides hit (the rest
  are a profile step off where an ulp of XLA's exp/cos moves a sample
  across a row's threshold).
"""

import dataclasses
import fractions
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import east_at, make_tile, small_scene, yaw_towards
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.ops import panorama as jpano
from topo_renderer_tpu.ops import raycast as jray
from topo_renderer_tpu.ops import surface as jsurf
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.models.scene import TerrainTile, build_mosaic
from topo_renderer_tpu_torch.ops import panorama as ppano
from topo_renderer_tpu_torch.ops import raycast as pray
from topo_renderer_tpu_torch.ops import surface as psurf
from topo_renderer_tpu_torch.ops.crossing import crossing_search, crossing_search_plain


def T(a):  # noqa: N802 - a numpy array as a CPU tensor of its own
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    """(JAX mosaic, port mosaic, JAX camera looking east, 96x64 ray planes
    as numpy, forward axis)."""
    mosaic, cam, _ = small_scene(n=49, span_deg=0.04, height_above=500.0)
    cam = dataclasses.replace(cam, yaw=yaw_towards(cam, east_at(cam)), pitch=-0.06)
    (dx, dy, dz), fwd = jray.camera_rays(cam, 96, 64)
    return mosaic, jax_mosaic_to_port(mosaic), cam, tuple(map(_np, (dx, dy, dz))), _np(fwd)


def _exact(x):
    return fractions.Fraction(float(x))


def test_dekker_pairs_exact_and_equal_to_jax():
    rng = np.random.default_rng(0)
    mags = [1.0, 6.4e6, 1e-3, 3.7e13]
    a = np.concatenate([rng.normal(0, m, 64) for m in mags]).astype(np.float32)
    b = np.concatenate([rng.normal(0, m, 64) for m in mags[::-1]]).astype(np.float32)
    hs, ts = psurf._two_sum(T(a), T(b))
    hp, tp = psurf._two_prod(T(a), T(b))
    for i in range(a.size):
        assert _exact(hs[i]) + _exact(ts[i]) == _exact(a[i]) + _exact(b[i])
        assert _exact(hp[i]) + _exact(tp[i]) == _exact(a[i]) * _exact(b[i])
    x = psurf._two_sum(T(a), T(b * np.float32(1e-9)))
    y = psurf._two_prod(T(b), T(a[::-1].copy()))
    x_np = tuple(v.numpy() for v in x)
    y_np = tuple(v.numpy() for v in y)
    for evaluation in ("jit", "eager"):
        def jax_eval(fn, *args):
            if evaluation == "jit":
                return jax.jit(fn)(*args)
            with jax.disable_jit():
                return fn(*jax.tree.map(jnp.asarray, args))

        want = {
            "two_sum": jax_eval(jsurf._two_sum, a, b),
            "two_prod": jax_eval(jsurf._two_prod, a, b),
            "df_add": jax_eval(jsurf._df_add, x_np, y_np),
        }
        got = {"two_sum": (hs, ts), "two_prod": (hp, tp), "df_add": psurf._df_add(x, y)}
        if evaluation == "eager":
            # mul22's cross terms are inexact products: a fused evaluation
            # rounds them differently, so it is held to the eager one.
            want["df_mul"] = jax_eval(jsurf._df_mul, x_np, y_np)
            got["df_mul"] = psurf._df_mul(x, y)
        for name in want:
            for g, w in zip(got[name], want[name]):
                np.testing.assert_array_equal(g.numpy().view(np.int32), _np(w).view(np.int32),
                                              err_msg=f"{name} vs {evaluation}")


def test_track_frame_terms_equal_jax(scene):
    mosaic, pm, cam, dirs, _ = scene
    eye = np.asarray(cam.eye, np.float32)
    with jax.disable_jit():
        k = jsurf.track_coeffs(mosaic, jnp.asarray(eye), tuple(map(jnp.asarray, dirs)))
    want = [k["u0"][0], k["u0"][1], k["v0"], k["A"][0], k["A"][1], k["rho0"][0], k["rho0"][1], k["c1"], k["s1"]]
    got = psurf.track_frame_terms(pm, T(eye)).numpy()[[0, 1, 2, 3, 4, 5, 6, 9, 10]]
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(want, np.float32).view(np.int32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_track_raster_matches_jax_and_float64(scene):
    mosaic, pm, cam, dirs, _ = scene
    eye = np.asarray(cam.eye, np.float32)
    rng = np.random.default_rng(1)
    t = rng.uniform(50.0, 30_000.0, dirs[0].shape).astype(np.float32)
    p = [eye[i].astype(np.float64) + t.astype(np.float64) * dirs[i].astype(np.float64) for i in range(3)]
    r = np.sqrt(p[0] ** 2 + p[1] ** 2 + p[2] ** 2).astype(np.float32)

    def jax_track(e, d, t_, r_):
        return jsurf.raster_from_coeffs(mosaic, jsurf.track_coeffs(mosaic, e, d), t_, r_)

    args = (jnp.asarray(eye), tuple(map(jnp.asarray, dirs)), jnp.asarray(t), jnp.asarray(r))
    jit = [_np(g) for g in jax.jit(jax_track)(*args)]
    with jax.disable_jit():
        eager = [_np(g) for g in jax_track(*args)]
    k = psurf.track_coeffs(pm, T(eye), T(eye), tuple(map(T, dirs)))
    port = [g.numpy() for g in psurf.raster_from_coeffs(pm, k, T(t), T(r))]

    # Float64 truth with the float32 rotation constants (their rounding is
    # a rigid shift shared by every evaluation).
    c0, s0, c1, s1 = psurf.track_frame_terms(pm, T(eye)).numpy()[7:11].astype(np.float64)
    ps = pm.host.pixel_scale.astype(np.float64)
    gx_t = np.degrees(np.arctan2(p[1] * c0 - p[0] * s0, p[0] * c0 + p[1] * s0)) / ps[0]
    rho = np.hypot(p[0], p[1])
    gy_t = -np.degrees(np.arcsin((p[2] * c1 - rho * s1) / np.sqrt(rho**2 + p[2] ** 2))) / ps[1]
    for i, truth in enumerate((gx_t, gy_t)):
        assert _ulps(port[i], eager[i]).max() <= 4
        assert np.abs(port[i] - jit[i]).max() <= 4 * np.spacing(np.abs(jit[i]).max())
        errs = {name: np.abs(v[i] - truth) for name, v in (("port", port), ("jit", jit), ("eager", eager))}
        for stat in (np.median, np.max):
            nearest = min(stat(errs["jit"]), stat(errs["eager"]))
            assert stat(errs["port"]) <= 1.15 * nearest, (i, stat.__name__, stat(errs["port"]), nearest)


def test_sample_attributes_cell_equals_jax(scene):
    mosaic, pm, *_ = scene
    rng = np.random.default_rng(2)
    gx = rng.uniform(-2, 50, (64, 64)).astype(np.float32)
    gy = rng.uniform(-2, 50, (64, 64)).astype(np.float32)
    gx[0, :4] = [np.nan, np.inf, -np.inf, 3e9]
    with jax.disable_jit():
        want = jsurf.sample_attributes_cell(mosaic, jnp.asarray(gx), jnp.asarray(gy))
    got = psurf.sample_attributes_cell(pm, T(gx), T(gy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    for g, s in zip(got, psurf.sample_attributes_soa(pm, T(gx), T(gy))):
        np.testing.assert_array_equal(g.numpy(), s.numpy())


def test_cell_walk_core_equals_jax(scene):
    """Brackets from random tracks across one to three cells, with the
    clearance signs the march hands the walk; inactive pixels, and NaN and
    infinite ends (XLA's float->int32 conversion)."""
    mosaic, pm, *_ = scene
    rng = np.random.default_rng(3)
    n = (48, 64)
    gx0 = rng.uniform(1, 46, n).astype(np.float32)
    gy0 = rng.uniform(1, 46, n).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    length = rng.uniform(0.2, 3.0, n)
    gx1 = (gx0 + length * np.cos(ang)).astype(np.float32)
    gy1 = (gy0 + length * np.sin(ang)).astype(np.float32)
    h0 = _np(jray._cell_h(mosaic, jnp.asarray(gx0), jnp.asarray(gy0)))
    h1 = _np(jray._cell_h(mosaic, jnp.asarray(gx1), jnp.asarray(gy1)))
    alt0 = (h0 + rng.uniform(0.1, 40, n)).astype(np.float32)
    alt1 = (h1 - rng.uniform(0.0, 40, n)).astype(np.float32)
    f_lo, f_hi = (alt0 - h0).astype(np.float32), (alt1 - h1).astype(np.float32)
    active = rng.random(n) < 0.9
    gx1[0, :3] = [np.nan, np.inf, -np.inf]
    gy0[1, :2] = [np.inf, np.nan]
    ends = (gx0, gy0, alt0, gx1, gy1, alt1)
    with jax.disable_jit():
        want = jray._cell_walk_core(mosaic, tuple(map(jnp.asarray, ends)), jnp.asarray(f_lo), jnp.asarray(f_hi),
                                    jnp.asarray(active), n_cells=2)
    got = pray._cell_walk_core(pm, tuple(map(T, ends)), T(f_lo), T(f_hi), T(active), n_cells=2)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert 0.2 < float((got.numpy() < 1.0).mean()) < 0.95


def test_grouped_bracket_pools_equal_jax():
    rng = np.random.default_rng(4)
    d_lo = rng.uniform(100, 20_000, (37, 53)).astype(np.float32)
    d_lo[5:9, 10:20] *= 8.0  # a far cluster beside near texels
    d_hi = (d_lo * rng.uniform(1.0, 1.3, d_lo.shape)).astype(np.float32)
    sky = rng.random(d_lo.shape) < 0.3
    d_lo[sky] = 3.0e38
    d_hi[sky | (rng.random(d_lo.shape) < 0.1)] = -3.0e38
    got = pray._grouped_bracket_pools(T(d_lo), T(d_hi))
    want_jit = jax.jit(jray._grouped_bracket_pools)(d_lo, d_hi)
    with jax.disable_jit():
        want_eager = jray._grouped_bracket_pools(jnp.asarray(d_lo), jnp.asarray(d_hi))
    for g, wj, we in zip(got, want_jit, want_eager):
        np.testing.assert_array_equal(g.numpy(), _np(wj))
        np.testing.assert_array_equal(g.numpy(), _np(we))


def _prepass_inputs(scene, elev_c):
    """The guided march's prepass spec at 96x64 and a view ``elev_c`` rad
    above the horizon along the camera's azimuth."""
    mosaic, pm, cam, dirs, fwd = scene
    spec, half_win, _ = pray.guided_prepass_spec(height=64, fov_hint=math.radians(45.0), aspect=1.5, n_steps=384)
    jspec, *_ = jray.guided_prepass_spec(height=64, fov_hint=math.radians(45.0), aspect=1.5, n_steps=384)
    eye = np.asarray(cam.eye, np.float32)
    e = eye.astype(np.float64)
    lon, lat = np.arctan2(e[1], e[0]), np.arcsin(e[2] / np.linalg.norm(e))
    north = np.array([-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)])
    east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    az_c = np.float32(np.arctan2(fwd @ east, fwd @ north))
    return mosaic, pm, eye, spec, jspec, az_c, np.float32(elev_c), half_win


@pytest.mark.parametrize("elev_c", [0.0, -1.1], ids=["level", "1.1_rad_down"])
def test_crossing_plain_equals_cummax_count(scene, elev_c):
    """On the prepass's own profiles (exact and bound), K1's plain version
    gives JAX's CPU crossing, the count of running-max samples at or below
    each row's threshold; the view 1.1 rad down puts rows past -pi/2."""
    _, pm, eye, spec, _, az_c, el_c, half_win = _prepass_inputs(scene, elev_c)
    _, e_prof, e_bound, e_pix = ppano._prepass_profiles(pm, T(eye), spec, float(az_c), float(el_c), seg=64,
                                                         conservative=True, bound_stride=4)
    assert e_bound is not None and (e_pix.numpy() < -math.pi / 2).any() == (elev_c < 0)
    t_pix = torch.tan(e_pix)
    for prof in (e_prof, e_bound):
        z = torch.zeros_like(prof)
        kstar = crossing_search_plain(prof, z, z, z, t_pix.reshape(-1))[0]
        np.testing.assert_array_equal(kstar.numpy(), crossing_search(prof, z, z, z, t_pix.reshape(-1))[0].numpy())
        m_prof = jax.lax.cummax(jnp.asarray(prof.numpy()), axis=0)
        count = jnp.sum(m_prof[:, None, :] <= jnp.asarray(t_pix.numpy())[None, :, :], axis=0)
        np.testing.assert_array_equal(kstar.numpy(), _np(count).astype(np.float32))
        hits = float((kstar < prof.shape[0]).float().mean())
        assert 0.0 < hits and (hits < 1.0 or elev_c < 0)


def test_prepass_matches_jax(scene):
    mosaic, pm, eye, spec, jspec, az_c, el_c, _ = _prepass_inputs(scene, -0.06)
    kw = dict(k_back=1 << 20, bound_stride=4)
    got = ppano.panorama_crossing_prepass(pm, T(eye), spec, azimuth_offset=float(az_c), elev_offset=float(el_c), **kw)
    with jax.disable_jit():
        want = jpano.panorama_crossing_prepass(mosaic, jnp.asarray(eye), jspec, azimuth_offset=az_c,
                                               elev_offset=el_c, **kw)
    for key in ("hit", "hit_exact"):
        agree = float((got[key].numpy() == _np(want[key])).mean())
        assert agree >= 0.999, (key, agree)
    both = got["hit"].numpy() & _np(want["hit"])
    assert 0.1 < both.mean() < 0.99
    for key in ("d_lo", "d_me", "d_hi"):
        g, w = got[key].numpy()[both], _np(want[key])[both]
        close = float((np.abs(g - w) <= 1e-5 * np.abs(w)).mean())
        assert close >= 0.995, (key, close)


def _port_tile(tile):
    t = tile.transform
    return TerrainTile(tile.location, tile.heights, CoordinateTransform(t.raster_point, t.model_point, t.pixel_scale))


def test_prepass_brackets_contain_uniform_crossings():
    """The port alone (`tests/test_render.py:318`'s invariant): rays cast at
    the prepass texel centres cross the surface, by the uniform exact
    march, inside the prepass's [d_lo, d_hi] up to one step's slack, and
    the prepass flags every hit."""
    tile = make_tile(49, 20, n=129, span_deg=0.1)
    pm = build_mosaic([_port_tile(tile)], device="cpu")
    lat, lon = 49.05, 20.012
    gy = int(round((tile.transform.model_point[1] - lat) / tile.transform.pixel_scale[1]))
    gx = int(round((lon - tile.transform.model_point[0]) / tile.transform.pixel_scale[0]))
    la, lo = np.radians(lat), np.radians(lon)
    rr = 6_371_000.0 + float(tile.heights[gy, gx]) + 500.0
    e = np.array([rr * np.cos(la) * np.cos(lo), rr * np.cos(la) * np.sin(lo), rr * np.sin(la)])
    eye = e.astype(np.float32)
    w, h, half = 256, 64, 0.22
    spec = ppano.PanoramaSpec(width=w, height=h, n_steps=512, n_refine=0, azimuth_start=-half,
                              azimuth_span=2 * half, elev_min=-half / 2, elev_max=half / 2)
    pre = ppano.panorama_crossing_prepass(pm, T(eye), spec)

    e = eye.astype(np.float64)
    u = e / np.linalg.norm(e)
    lon0, lat0 = np.arctan2(e[1], e[0]), np.arcsin(u[2])
    east = np.array([-np.sin(lon0), np.cos(lon0), 0.0])
    north = np.array([-np.sin(lat0) * np.cos(lon0), -np.sin(lat0) * np.sin(lon0), np.cos(lat0)])
    az = spec.azimuth_start + spec.azimuth_span * ((np.arange(w) + 0.5) / w)
    el = spec.elev_max - (spec.elev_max - spec.elev_min) * ((np.arange(h) + 0.5) / h)
    azg, elg = np.meshgrid(az, el)
    horiz = np.cos(azg)[..., None] * north + np.sin(azg)[..., None] * east
    dirs = (np.cos(elg)[..., None] * horiz + np.sin(elg)[..., None] * u).astype(np.float32)
    hit_u, t_u = pray.march(pm, T(eye), tuple(T(dirs[..., i].copy()) for i in range(3)), n_steps=1024,
                            n_refine=20, two_level=False)
    hu, tu = hit_u.numpy(), t_u.numpy()
    d_lo, d_hi, ph = pre["d_lo"].numpy(), pre["d_hi"].numpy(), pre["hit"].numpy()
    assert hu.mean() > 0.2
    assert (hu & ~ph).mean() < 0.002
    both = hu & ph
    assert ((tu < d_lo * 0.985 - 30.0) & both).mean() < 0.002
    assert ((tu > d_hi * 1.015 + 30.0) & both).mean() < 0.01


def test_guided_plans_equal_jax():
    for height, fov, aspect, n_steps in ((450, math.radians(45.0), 800 / 450, 1024), (64, math.radians(45.0), 1.5, 384),
                                         (100, math.radians(60.0), 1.6, 256)):
        got = pray.guided_prepass_spec(height=height, fov_hint=fov, aspect=aspect, n_steps=n_steps)
        want = jray.guided_prepass_spec(height=height, fov_hint=fov, aspect=aspect, n_steps=n_steps)
        assert got[1:] == want[1:]
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    spec, *_ = pray.guided_prepass_spec(height=450, fov_hint=math.radians(45.0), aspect=800 / 450, n_steps=1024)
    assert (spec.n_steps, spec.width, spec.height) == (896, 1152, 840)  # K1's prepass shape at config 1
    want = jray.guided_march_defaults()
    assert want.pop("fusion_barrier") is False  # an XLA fusion hint, not ported
    assert pray.guided_march_defaults() == want
    for kw in ({}, {"n_window": 3, "split_brackets": False}, {"guard_legs": False}, {"n_window": 4}):
        assert pray.guided_march_rounds(**kw) == jray.guided_march_rounds(**kw)
    assert pray.guided_march_rounds() == 13


def test_bound_plan_matches_jax_segments(scene):
    """The bound profile's static plan: near segments NEG, each far segment
    at JAX's level, each step repeating its stride group's first sample."""
    _, pm, *_ = scene
    spec, *_ = pray.guided_prepass_spec(height=450, fov_hint=math.radians(45.0), aspect=800 / 450, n_steps=1024)
    levels, src = ppano._prepass_bound_plan(spec, pm, 64, 4)
    n_samples = sum(len(r) for r in levels.values())
    assert src.shape == (spec.n_steps,) and (src <= n_samples).all()
    order = [k for rows in levels.values() for k in rows]
    sampled = np.array([order[i] if i < n_samples else -1 for i in src])
    k = np.arange(spec.n_steps)
    far = sampled >= 0
    assert (sampled[far] == k[far] - (k[far] % 64) % 4).all()
    first = int(np.argmax(far))  # near segments skip the bound, then every segment has it
    assert first > 0 and first % 64 == 0 and far[first:].all()


def test_unported_quad_marches_raise(scene, monkeypatch):
    """The two unguarded branches (once stubs that raised): the split legs
    (`_window_march_quad2`) and the single pooled bracket
    (`_window_march_quad`) run, resolve hits, and take per pixel exactly
    `guided_march_rounds(guard_legs=False)` corner-row gathers, besides
    the prepass's one."""
    mosaic, pm, cam, dirs, fwd = scene
    gathers = []

    def counted(m, idx):
        gathers.append(tuple(idx.shape))
        return psurf.cell_rows(m, idx)

    monkeypatch.setattr(pray, "cell_rows", counted)
    for split in (True, False):
        gathers.clear()
        kw = dict(guard_legs=False, split_brackets=split)
        hit, t_hit = pray.march_guided_panorama(pm, T(np.asarray(cam.eye, np.float32)), tuple(map(T, dirs)), T(fwd),
                                                n_steps=384, n_refine=4, fov_hint=math.radians(45.0), aspect=1.5,
                                                **kw)
        per_pixel = [g for g in gathers if g == dirs[0].shape]
        assert len(gathers) - len(per_pixel) == 1  # the prepass's exact profile
        assert len(per_pixel) == pray.guided_march_rounds(**kw) == jray.guided_march_rounds(**kw)
        assert bool(hit.any()) and bool(torch.isfinite(t_hit[hit]).all())
