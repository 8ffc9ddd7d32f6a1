"""The batch path: K3, batched windows, `render_batch_scan`, the engine's
`render_batch`, and what its non-clipmap fallback needs (the surface
samplers and the reduction crossing), against the JAX package on the CPU.

Tolerances: window copies, origins, samplers and crossings are exact (bit
for bit through int32 views where words carry packed normals). Frames are
held at the golden tolerance (<= 2/255 per channel on >= 99% of pixels) to
the JAX reference evaluated primitive by primitive, and to the jitted
reference as closely as that evaluation comes, within 1% (see
`test_torch_panorama.py` for why).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import make_tile
from tests.test_engine import build_engine as jax_build_engine
from tests.test_torch_panorama import frac_bad
from tests.test_torch_window_slice import _bits, _table, jax_mosaic_to_port
from topo_renderer_tpu.geo import GeoCoord as JaxCoord
from topo_renderer_tpu.models.camera import Camera as JaxCamera
from topo_renderer_tpu.models.scene import build_mosaic as jax_build_mosaic
from topo_renderer_tpu.ops import surface as jsurf
from topo_renderer_tpu.ops.panorama import (
    PanoramaSpec as JaxSpec,
    extract_clipmap_windows as jax_extract,
    extract_clipmap_windows_batched as jax_extract_batched,
    render_batch_scan as jax_render_batch_scan,
    render_panorama as jax_render,
)
from topo_renderer_tpu.ops.shading import to_srgb8_image as jax_srgb8
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.ops import crossing, surface as psurf, window_slice
from topo_renderer_tpu_torch.ops.panorama import (
    PanoramaSpec,
    extract_clipmap_windows,
    extract_clipmap_windows_batched,
    render_batch_scan,
    render_panorama,
)
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.render.engine import RenderEngine


def u8(color):
    """f32 colour planes (numpy or torch, [..., 3]) -> the u8 image."""
    return np.asarray(jax_srgb8(jnp.asarray(np.asarray(color))))


def device_scene(n, span_deg, height_above=800.0):
    """`tests.helpers.small_scene`'s tile and camera, with the mosaic from
    the JAX package's device build (the host build takes seconds more)."""
    tile = make_tile(49, 20, n=n, span_deg=span_deg)
    mosaic = jax_build_mosaic([tile], on_device=True)
    lat, lon = 49.0 + span_deg * 0.5, 20.0 + span_deg * 0.12
    gy = (tile.transform.model_point[1] - lat) / tile.transform.pixel_scale[1]
    gx = (lon - tile.transform.model_point[0]) / tile.transform.pixel_scale[0]
    ground = float(tile.heights[int(round(gy)), int(round(gx))])
    return mosaic, JaxCamera().reset(JaxCoord(lat, lon), ground + height_above)


def check_frame(port, eager, jit):
    assert frac_bad(port, eager) < 0.01, frac_bad(port, eager)
    assert frac_bad(port, jit) <= frac_bad(eager, jit) + 0.01, (frac_bad(port, jit), frac_bad(eager, jit))


# ---- (a) K3's plain version ------------------------------------------------

def test_window_slice_multi_batched_plain_is_dynamic_slice_bits():
    rng = np.random.default_rng(1)
    shapes = [(301, 517), (150, 258), (75, 129)]
    tables = [_table(rng, h, w) for h, w in shapes]
    wsy, wsx = 48, 128
    B = 4
    origins = np.stack([
        rng.integers(-20, [h - wsy + 30 for h, _ in shapes]),
        rng.integers(-20, [w - wsx + 30 for _, w in shapes]),
    ], axis=-1).astype(np.int32)[None].repeat(B, 0)
    origins[:, :, 0] += rng.integers(0, 8, (B, len(shapes))).astype(np.int32)
    origins[1, 0] = (301 - wsy + 9, 517 - wsx + 100)  # past the far edge: clamped
    origins[2, 2] = (-7, -300)  # before the origin: clamped to 0 as XLA's HLO does
    got = window_slice.window_slice_multi_batched(
        [torch.from_numpy(t) for t in tables], torch.from_numpy(origins), wsy=wsy, wsx=wsx
    )
    assert [tuple(g.shape) for g in got] == [(B, 2, wsy, wsx)] * len(shapes)
    for b in range(B):
        for level, t in enumerate(tables):
            sy, sx = (int(v) for v in np.clip(origins[b, level], 0, None))
            want = jax.lax.dynamic_slice(jnp.asarray(t), (0, sy, sx), (2, wsy, wsx))
            np.testing.assert_array_equal(_bits(got[level][b].numpy()), _bits(want), err_msg=f"{b} {level}")
    assert window_slice.window_slice_multi_batched.launches == 0


def test_window_slice_multi_batched_rejects_bad_inputs():
    t = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match=r"\[B, 1, 2\]"):
        window_slice.window_slice_multi_batched([t], torch.zeros((1, 2), dtype=torch.int32), wsy=8, wsx=8)
    with pytest.raises(ValueError, match="viewpoints"):
        window_slice.window_slice_multi_batched(
            [t], torch.zeros((0, 1, 2), dtype=torch.int32), wsy=8, wsx=8
        )


# ---- (b) batched extraction ------------------------------------------------

EXTRACT_KW = dict(width=64, height=32, elev_min=-0.3, elev_max=0.1, s_near=5.0, s_far=40_000.0,
                  n_steps=128)


@pytest.fixture(scope="module")
def tile608():
    return make_tile(49, 20, n=608, span_deg=0.05)


def _eyes_over(jm, n=3):
    c = np.asarray(jm.bound_center, np.float64)
    up = c / np.linalg.norm(c)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    eyes = [c + (500.0 + 40.0 * i) * up + 900.0 * (i - 1) * east + 300.0 * i * north for i in range(n)]
    return np.asarray(eyes, np.float32)


def _assert_windows_equal(pw, jw):
    assert len(pw) == len(jw)
    for level, (p, j) in enumerate(zip(pw, jw)):
        for name, pv, jv in zip(("tbl_h", "tbl_a", "tbl_q", "sx", "sy"), p, j):
            assert (pv is None) == (jv is None), (level, name)
            if pv is not None:
                np.testing.assert_array_equal(_bits(pv.contiguous().numpy()), _bits(np.asarray(jv)),
                                              err_msg=f"level {level} {name}")


@pytest.mark.parametrize("case", ["window_tables", "no_profile_attrs", "no_window_tables"])
def test_extract_clipmap_windows_batched_bit_equal(tile608, case):
    jm = jax_build_mosaic([tile608], window_table_min=10**9 if case == "no_window_tables" else 0,
                          on_device=True)
    pm = jax_mosaic_to_port(jm)
    eyes = _eyes_over(jm)
    attrs = case != "no_profile_attrs"
    js, ps = (dataclasses.replace(S.fast(**EXTRACT_KW, attrs_from_profile=attrs), clipmap_threshold=0)
              for S in (JaxSpec, PanoramaSpec))
    pw = extract_clipmap_windows_batched(pm, torch.from_numpy(eyes), ps)
    assert any(level[0] is not None or level[1] is not None for level in pw), "no level windowed"
    if case == "window_tables":
        _assert_windows_equal(pw, jax_extract_batched(jm, jnp.asarray(eyes), js))
        assert pw[0][2] is not None, "level 0 has no quad rows"
    else:
        for b, eye in enumerate(eyes):
            jw = jax_extract(jm, jnp.asarray(eye), js, force_xla=True)
            _assert_windows_equal(tuple(tuple(None if v is None else v[b] for v in lv) for lv in pw), jw)
    # Each eye's slice of the batch is its single-eye extraction.
    for b, eye in enumerate(eyes):
        single = extract_clipmap_windows(pm, torch.from_numpy(eye), ps)
        for level, (bt, st) in enumerate(zip(pw, single)):
            for bv, sv in zip(bt, st):
                assert (bv is None) == (sv is None)
                if bv is not None:
                    assert torch.equal(bv[b].view(torch.int32) if bv.is_floating_point() else bv[b],
                                       sv.view(torch.int32) if sv.is_floating_point() else sv), level


# ---- (c) render_batch_scan ---------------------------------------------------

def test_render_batch_scan_matches_reference():
    mosaic, cam = device_scene(n=560, span_deg=0.05, height_above=500.0)
    kw = dict(width=128, height=64, elev_min=-0.3, elev_max=0.1, s_near=5.0, s_far=40_000.0, n_steps=256)
    js = dataclasses.replace(JaxSpec.fast(**kw), clipmap_threshold=0)
    ps = dataclasses.replace(PanoramaSpec.fast(**kw), clipmap_threshold=0)
    eye = np.asarray(cam.eye, np.float32)
    up = eye / np.linalg.norm(eye)
    eyes = np.stack([eye, eye + 40.0 * up, eye + 90.0 * up]).astype(np.float32)
    suns = np.stack([np.asarray(cam.sun_angle.to_vec3(), np.float32)] * 3)

    pm = jax_mosaic_to_port(mosaic)
    got = render_batch_scan(pm, torch.from_numpy(eyes), torch.from_numpy(suns), ps, fog="atmosphere")
    assert got.shape == (3, 64, 128, 3) and bool(torch.isfinite(got).all())
    jit = np.asarray(jax_render_batch_scan(mosaic, eyes, suns, js, fog="atmosphere"))
    for b in range(3):
        with jax.disable_jit():
            eager = jax_render(mosaic, eyes[b], js, suns[b], fog="atmosphere")["color"]
        check_frame(u8(got[b]), u8(eager), u8(jit[b]))
        # The batch is the per-eye render, bit for bit.
        single = render_panorama(pm, torch.from_numpy(eyes[b]), ps, torch.from_numpy(suns[b]),
                                 fog="atmosphere")["color"]
        assert torch.equal(got[b], single), b


# ---- (d) the engine's render_batch -------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """`test_engine.py`'s hill scene in both engines: (port engine, port
    camera, JAX engine, JAX camera)."""
    je, jcam, tile = jax_build_engine()
    pe = RenderEngine(device="cpu")
    t = tile.transform
    loc = GeoLocation.from_coord(49, 20)
    pe.add_terrain(loc, tile.heights, CoordinateTransform(t.raster_point, t.model_point, t.pixel_scale))
    pe.add_peaks(loc, [PeakInstance(position=np.asarray(p.position, np.float32), name=p.name)
                       for p in je._peaks[tile.location]])
    pcam = Camera().reset(GeoCoord(49.0 + 0.025, 20.0 + 0.005), 1400.0)
    pcam = dataclasses.replace(pcam, yaw=float(jcam.yaw), pitch=float(jcam.pitch))
    np.testing.assert_allclose(pcam.eye.numpy(), np.asarray(jcam.eye), rtol=1e-6)
    return pe, pcam, je, jcam


def test_engine_render_batch_fallback(engines):
    """Non-clipmap specs (`test_engine.py:83-96`): the labelled panorama and
    the batch through the reduction crossing, K1 never launched."""
    pe, pcam, je, jcam = engines
    spec, jspec = (S(width=128, height=48, n_steps=256, n_refine=2) for S in (PanoramaSpec, JaxSpec))
    res = pe.render_panorama(pcam, spec)
    assert res.color.shape == (48, 128, 3)
    assert res.hit.mean() > 0.05
    assert pe._peaks[GeoLocation.from_coord(49, 20)][0].visible
    jres = je.render_panorama(jcam, jspec)
    assert (res.hit == jres.hit).mean() >= 0.99

    eyes = np.stack([np.asarray(jcam.eye, np.float32)] * 3)
    suns = np.stack([np.asarray(jcam.sun_angle.to_vec3(), np.float32)] * 3)
    crossing.crossing_search.launches = 0
    batch = pe.render_batch(eyes, spec, suns)
    assert isinstance(batch, torch.Tensor) and batch.shape == (3, 48, 128, 3)
    assert torch.equal(batch[0], batch[2])
    jit = np.asarray(je.render_batch(eyes, jspec, suns))
    with jax.disable_jit():
        eager = np.asarray(je.render_batch(eyes, jspec, suns))
    check_frame(u8(batch[0]), u8(eager[0]), u8(jit[0]))


def test_engine_render_batch_clipmap(engines):
    """Clipmap specs go through `render_batch_scan` (`test_engine.py:194-226`)."""
    pe, _, je, jcam = engines
    kw = dict(width=128, height=48, n_steps=128, s_near=5.0, s_far=40_000.0)
    spec = dataclasses.replace(PanoramaSpec.fast(**kw), clipmap_threshold=0)
    jspec = dataclasses.replace(JaxSpec.fast(**kw), clipmap_threshold=0)
    eyes = np.stack([np.asarray(jcam.eye, np.float32)] * 2)
    suns = np.stack([np.asarray(jcam.sun_angle.to_vec3(), np.float32)] * 2)
    batch = pe.render_batch(eyes, spec, suns)
    assert batch.shape == (2, 48, 128, 3) and bool(torch.isfinite(batch).all())
    assert torch.equal(batch[0], batch[1])
    single = render_panorama(pe.mosaic, torch.from_numpy(eyes[0]), spec, torch.from_numpy(suns[0]))["color"]
    assert torch.equal(batch[0], single)
    jit = np.asarray(je.render_batch(eyes, jspec, suns))
    with jax.disable_jit():
        eager = np.asarray(je.render_batch(eyes, jspec, suns))
    check_frame(u8(batch[0]), u8(eager[0]), u8(jit[0]))


# ---- (e) surface samplers ----------------------------------------------------

@pytest.fixture(scope="module")
def sampler_mosaics():
    mosaic, _ = device_scene(n=65, span_deg=0.05)
    return mosaic, jax_mosaic_to_port(mosaic)


def _coords(shape, n=4000, seed=3):
    """Raster coordinates over the mosaic and up to 6 texels beyond it,
    with exact texel centres, cell edges and the far corner planted."""
    h, w = shape
    rng = np.random.default_rng(seed)
    gx = rng.uniform(-6.0, w + 5.0, n).astype(np.float32)
    gy = rng.uniform(-6.0, h + 5.0, n).astype(np.float32)
    gx[:50] = rng.integers(0, w, 50)
    gy[50:100] = rng.integers(0, h, 50)
    gx[100], gy[100] = w - 1.0, h - 1.0
    return gx.reshape(40, -1), gy.reshape(40, -1)


SAMPLERS = {
    "sample_height": lambda m, s, gx, gy: (m.sample_height(s, gx, gy),),
    "sample_height_no_cell_table": lambda m, s, gx, gy: (
        m.sample_height(dataclasses.replace(s, has_cell_table=False), gx, gy),),
    "level0_nearest": lambda m, s, gx, gy: (m.sample_height_level(s, 0, gx, gy, nearest=True),),
    "level1_bilinear": lambda m, s, gx, gy: (m.sample_height_level(s, 1, gx, gy),),
    "level2_nearest": lambda m, s, gx, gy: (m.sample_height_level(s, 2, gx, gy, nearest=True),),
    "level3_bilinear": lambda m, s, gx, gy: (m.sample_height_level(s, 3, gx, gy),),
    "attributes_nearest": lambda m, s, gx, gy: m.sample_attributes_nearest(s, gx, gy),
    "attributes_soa": lambda m, s, gx, gy: m.sample_attributes_soa(s, gx, gy),
    "geo_from_raster": lambda m, s, gx, gy: m.geo_from_raster(s, gx, gy),
    "cell_setup": lambda m, s, gx, gy: (lambda r: (r[0], r[2], r[3], r[4], r[5]))(m._cell_setup(s, gx, gy)),
    "cell_rows": lambda m, s, gx, gy: (m.cell_rows(s, m._cell_setup(s, gx, gy)[0]),),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_bit_equal(sampler_mosaics, name):
    """Bit-equal to the JAX package's samplers evaluated op by op."""
    jm, pm = sampler_mosaics
    gx, gy = _coords(jm.shape)
    with jax.disable_jit():
        want = SAMPLERS[name](jsurf, jm, jnp.asarray(gx), jnp.asarray(gy))
    got = SAMPLERS[name](psurf, pm, torch.from_numpy(gx), torch.from_numpy(gy))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"output {i}")


def test_tri_interp_bit_equal():
    rng = np.random.default_rng(5)
    v = [rng.uniform(-100.0, 3000.0, 500).astype(np.float32) for _ in range(4)]
    fx, fy = (rng.random(500).astype(np.float32) for _ in range(2))
    fx[:20], fy[:20] = fy[:20], fy[:20]  # on the NW-SE diagonal
    fy[20:40] = 1.0 - fx[20:40]  # on the SW-NE diagonal
    parity = rng.integers(0, 2, 500).astype(np.int32)
    want = np.asarray(jsurf.tri_interp(*map(jnp.asarray, (*v, fx, fy, parity))))
    got = psurf.tri_interp(*map(torch.from_numpy, (*v, fx, fy, parity))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---- (f) the reduction crossing ---------------------------------------------

def _profile(n=96, w=40, h=24, seed=11):
    rng = np.random.default_rng(seed)
    e = np.cumsum(rng.normal(0, 0.02, (n, w)), axis=0) - 0.1
    e += (rng.random((n, w)) < 0.05) * rng.uniform(0.05, 0.4, (n, w))
    e[rng.random((n, w)) < 0.05] = -1.0e30  # samples outside the mosaic
    e[:, 3] = -1.0e30  # a column that never crosses
    a = [rng.integers(0, 1024, (n, w)).astype(np.float32) for _ in range(3)]
    t = np.sort(rng.uniform(-0.3, 0.5, h).astype(np.float32))[::-1].copy()
    return [torch.from_numpy(x.astype(np.float32)) for x in (e, *a)] + [torch.from_numpy(t)]


@pytest.mark.parametrize("with_payloads", [False, True])
def test_crossing_reductions_chunked_exact(monkeypatch, with_payloads):
    e, a0, a1, a2, t = _profile()
    m = torch.cummax(e, dim=0).values
    pay = (a0, a1, a2) if with_payloads else None
    whole = crossing.crossing_reductions(m, t, pay)
    monkeypatch.setattr(crossing, "REDUCE_CHUNK_ELEMS", m.numel() * 5)  # chunks of 5 rows
    chunked = crossing.crossing_reductions(m, t, pay)
    for a, b in zip(whole[:3], chunked[:3]):
        assert torch.equal(a, b)
    if with_payloads:
        for a, b in zip(whole[3], chunked[3]):
            assert torch.equal(a, b)
    else:
        assert whole[3] is None and chunked[3] is None

    kstar, theta, mlo, *codes = crossing.crossing_search_plain(e, a0, a1, a2, t)
    hit = kstar < e.shape[0]
    assert 0.05 < hit.float().mean() < 0.95
    assert torch.equal(chunked[0] < e.shape[0], hit)
    assert torch.equal(chunked[0][hit], kstar[hit])
    assert torch.equal(chunked[1][hit], theta[hit])
    assert torch.equal(chunked[2][hit], mlo[hit])
    if with_payloads:
        for got, want in zip(chunked[3], codes):
            assert torch.equal(got, want)  # 0 on sky rows in both
    else:
        assert torch.equal(chunked[0], kstar)  # the count is N on sky rows
