"""The port's array-of-structs helpers and uniform records against the JAX
package's, on the CPU (`tests/test_ops.py:132-231`,
`tests/test_camera.py:176-188`, mirrored).

The same numpy-seeded inputs go through both. JAX's helpers are not jitted:
each runs primitive by primitive (and under `jax.disable_jit()` here), one
rounding per operation, as PyTorch's do. So the hashes, the dither, the
shading, the postprocess, the samplers and the attribute sampler must
agree exactly. Where a transcendental of XLA's meets one of torch's (the
fog's and the atmosphere's exp, `geo_from_ecef`'s asin and atan2,
`local_frame`'s sin and cos) the values are held to a few float32 ulps
(rtol 1e-6 / atol 2e-7). The uniforms carry
the camera's matrices, held as `tests/test_torch_camera.py` holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_tile
from tests.test_torch_exact_frame import port_camera
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.data.coordinate_transform import CoordinateTransform as JaxTransform
from topo_renderer_tpu.geo import GeoCoord as JaxGeoCoord
from topo_renderer_tpu.models import uniforms as juni
from topo_renderer_tpu.models.camera import Camera as JaxCamera, depth_from_dist as jax_depth_from_dist
from topo_renderer_tpu.models.scene import build_mosaic as jax_build_mosaic
from topo_renderer_tpu.ops import geometry as jgeo, postprocess as jpost, sampling as jsamp, shading as jshade
from topo_renderer_tpu.ops import surface as jsurf
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.models import uniforms as puni
from topo_renderer_tpu_torch.ops import geometry as pgeo, postprocess as ppost, sampling as psamp, shading as pshade
from topo_renderer_tpu_torch.ops import surface as psurf


def T(a):  # noqa: N802 - a numpy array as a CPU tensor of its own
    return torch.from_numpy(np.array(a))


def eq(port, ref):
    """Exact equality of a port tensor and a JAX/numpy array, NaNs included."""
    np.testing.assert_array_equal(port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port),
                                  np.asarray(ref))


RNG = np.random.default_rng(1)
SEEDS = RNG.uniform(-2000, 2000, size=(128, 2)).astype(np.float32)
NORMALS = RNG.normal(size=(6, 20, 3)).astype(np.float32)
SUN = (RNG.normal(size=3) / 3.0).astype(np.float32)


# ---- shading ---------------------------------------------------------------

def test_hash_and_dither_equal_jax():
    with jax.disable_jit():
        eq(pshade.hash12n(T(SEEDS)), jshade.hash12n(SEEDS))
        eq(pshade.hash42n(T(SEEDS)), jshade.hash42n(SEEDS))
        color = RNG.uniform(0, 1, (128, 3)).astype(np.float32)
        eq(pshade.dither_rgb(T(color), T(SEEDS)), jshade.dither_rgb(color, SEEDS))
    h = pshade.hash12n(T(SEEDS)).numpy()
    assert np.all((h >= 0) & (h < 1))  # `tests/test_ops.py` range
    dithered = pshade.dither_rgb(torch.full((128, 3), 0.5), T(SEEDS)).numpy()
    assert np.max(np.abs(dithered - 0.5)) <= 1.0 / 255.0 + 1e-6


@pytest.mark.parametrize("view_mode", [0, 1, 2])
def test_shade_equals_jax(view_mode):
    seeds = RNG.uniform(-500, 500, NORMALS.shape[:-1] + (2,)).astype(np.float32)
    with jax.disable_jit():
        want = jshade.shade(NORMALS, SUN, view_mode, seeds)
    got = pshade.shade(T(NORMALS), T(SUN), view_mode, T(seeds))
    assert got.shape == NORMALS.shape and got.dtype == torch.float32
    eq(got, want)


def test_shade_modes():
    """`tests/test_ops.py::test_shade_modes` on the port."""
    sun = torch.tensor([0.0, 0.0, 1.0])
    n = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    seed = torch.zeros((2, 2))
    lin = pshade.shade(n, sun, 1, seed).numpy()
    np.testing.assert_allclose(lin[0], 0.71, atol=1e-6)
    np.testing.assert_allclose(lin[1], 0.01, atol=1e-6)
    np.testing.assert_allclose(pshade.shade(n, sun, 2, seed).numpy()[0], [0.5, 0.5, 1.0], atol=1e-6)
    assert np.max(np.abs(pshade.shade(n, sun, 0, seed).numpy() - lin)) <= 1.0 / 255.0 + 1e-6


# ---- postprocess -----------------------------------------------------------

def _depth_planes():
    depth = np.full((16, 16), 1.0, np.float32)
    depth[:, :8] = float(jax_depth_from_dist(1000.0))
    depth[3:6, 10:13] = float(jax_depth_from_dist(30_000.0))
    return depth


@pytest.mark.parametrize("pixelize_n", [None, 100.0, 8.0, 5.0])
def test_postprocess_equals_jax(pixelize_n):
    color = RNG.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    depth = _depth_planes()
    with jax.disable_jit():
        want = jpost.postprocess(color, depth, pixelize_n=pixelize_n)
    got = ppost.postprocess(T(color), T(depth), pixelize_n=pixelize_n)
    assert got.shape == (16, 16, 3)
    eq(got, want)


def test_postprocess_contour_and_pixelize():
    """`tests/test_ops.py`'s contour and pixelize cases on the port."""
    color = torch.full((16, 16, 3), 0.8)
    out = ppost.postprocess(color, T(_depth_planes())).numpy()
    assert np.all(out[:, 8] < 0.05)
    np.testing.assert_allclose(out[:, 2], 0.8, atol=1e-6)
    rnd = T(RNG.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    flat = torch.full((32, 32), 0.5)
    block = ppost.postprocess(rnd, flat, pixelize_n=8.0).numpy()[0:4, 0:4]
    assert np.allclose(block, block[0, 0], atol=1e-6)
    np.testing.assert_allclose(ppost.postprocess(rnd, flat, pixelize_n=100.0).numpy(), rnd.numpy(), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_fog_and_atmosphere_equal_jax(masked):
    color = RNG.uniform(0, 1, (6, 7, 3)).astype(np.float32)
    dist = RNG.uniform(0, 3e5, (6, 7)).astype(np.float32)
    dist[0, 0] = 1e9
    sky = dist > 2e5 if masked else None
    with jax.disable_jit():
        fog = jpost.distance_fog(color, dist, (0.0, 0.71, 0.885), sky_mask=sky)
        atm = jpost.atmospheric_shading(color, dist, (0.0, 0.71, 0.885), sky_mask=sky)
    psky = None if sky is None else T(sky)
    for got, want in ((ppost.distance_fog(T(color), T(dist), (0.0, 0.71, 0.885), sky_mask=psky), fog),
                      (ppost.atmospheric_shading(T(color), T(dist), (0.0, 0.71, 0.885), sky_mask=psky), atm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=2e-7)
        if masked:  # sky pixels keep their colour exactly
            eq(got[T(sky)], color[sky])
    if not masked:  # `tests/test_ops.py::test_fog_and_atmosphere`: far pixels take the sky's colour
        np.testing.assert_allclose(np.asarray(fog)[0, 0], [0.0, 0.71, 0.885], atol=1e-4)


# ---- sampling --------------------------------------------------------------

def test_samplers_equal_jax():
    img = RNG.normal(size=(2, 12, 10)).astype(np.float32)
    imgc = RNG.normal(size=(12, 10, 3)).astype(np.float32)
    x = RNG.uniform(-3, 13, (5, 4)).astype(np.float32)
    y = RNG.uniform(-3, 15, (5, 4)).astype(np.float32)
    with jax.disable_jit():
        eq(psamp.bilinear_sample_hw(T(img), T(x), T(y)), jsamp.bilinear_sample_hw(img, x, y))
        eq(psamp.bilinear_sample_hwc(T(imgc), T(x), T(y)), jsamp.bilinear_sample_hwc(imgc, x, y))
        eq(psamp.bilinear_sample(T(imgc), T(x), T(y)), jsamp.bilinear_sample(imgc, x, y))  # channels by heuristic
        eq(psamp.bilinear_sample(T(img), T(x), T(y)), jsamp.bilinear_sample(img, x, y))
        eq(psamp._bilinear(T(img), T(x), T(y), False), jsamp._bilinear(img, x, y, False))
        eq(psamp.nearest_sample_hw(T(img), T(x), T(y)), jsamp.nearest_sample_hw(img, x, y))


def test_bilinear_sampler():
    """`tests/test_ops.py::test_bilinear_sampler` on the port."""
    img = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
    f = torch.tensor
    assert float(psamp.bilinear_sample_hw(img, f(0.0), f(0.0))) == 0.0
    assert float(psamp.bilinear_sample_hw(img, f(1.0), f(1.0))) == 3.0
    assert float(psamp.bilinear_sample_hw(img, f(0.5), f(0.5))) == 1.5
    assert float(psamp.bilinear_sample_hw(img, f(-5.0), f(0.0))) == 0.0
    out = psamp.bilinear_sample_hwc(torch.stack([img, img * 10], dim=-1), f(0.5), f(0.5))
    np.testing.assert_allclose(out.numpy(), [1.5, 15.0])


# ---- geometry --------------------------------------------------------------

def test_geo_from_ecef_and_local_frame_equal_jax():
    lon = RNG.uniform(-180, 180, 64).astype(np.float32)
    lat = RNG.uniform(-89, 89, 64).astype(np.float32)
    h = RNG.uniform(-400, 9000, 64).astype(np.float32)
    p = np.asarray(jgeo.ecef_from_geo(h, lon, lat))
    with jax.disable_jit():
        want = jgeo.geo_from_ecef(p)
        frames = jgeo.local_frame(lon, lat)
    got = pgeo.geo_from_ecef(T(p))
    for g, w, atol in zip(got, want, (2e-3, 0.0, 0.0)):  # height: ulps of a 6.4e6 m radius
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=atol)
    np.testing.assert_allclose(got[2].numpy(), lat, atol=1e-4)  # the round trip, `tests/test_camera.py`
    for g, w in zip(pgeo.local_frame(T(lon), T(lat)), frames):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=2e-7)
    east, north, up = (t.numpy() for t in pgeo.local_frame(20.0, 50.0))
    np.testing.assert_allclose([east @ north, east @ up, north @ up], 0.0, atol=1e-6)


# ---- the attribute sampler -------------------------------------------------

@pytest.fixture(scope="module")
def mosaics():
    tile = make_tile(49, 20, n=33, span_deg=0.03)
    jm = jax_build_mosaic([tile], on_device=True)
    return jm, jax_mosaic_to_port(jm)


def test_sample_attributes_equals_jax(mosaics):
    jm, pm = mosaics
    gx = RNG.uniform(-2, 35, (9, 11)).astype(np.float32)
    gy = RNG.uniform(-2, 35, (9, 11)).astype(np.float32)
    with jax.disable_jit():
        want = jsurf.sample_attributes(jm, gx, gy)
    got = psurf.sample_attributes(pm, T(gx), T(gy))
    assert got[1].shape == (9, 11, 3)
    for g, w in zip(got, want):
        eq(g, w)
    assert got[2].any() and not got[2].all()  # in and out of the tile


# ---- uniforms --------------------------------------------------------------

def _cameras():
    jcam = dataclasses.replace(JaxCamera().reset(JaxGeoCoord(49.35135, 20.21139), 2000.0), pitch=0.1, yaw=0.7)
    return port_camera(jcam), jcam


def test_uniforms_equal_jax():
    pcam, jcam = _cameras()
    got, want = puni.Uniforms.new(pcam, 800.0, 450.0), juni.Uniforms.new(jcam, 800.0, 450.0)
    np.testing.assert_allclose(got.camera_proj.numpy(), np.asarray(want.camera_proj), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.normal_proj.numpy(), np.asarray(want.normal_proj), rtol=1e-5, atol=1e-5)
    eq(got.camera_pos, want.camera_pos)
    np.testing.assert_allclose(got.sun_direction.numpy(), np.asarray(want.sun_direction), rtol=1e-6, atol=1e-7)
    assert got.view_mode.dtype == torch.int32 and int(got.view_mode) == int(want.view_mode) == 0


def test_uniforms_build():
    """`tests/test_camera.py::test_uniforms_build` on the port."""
    cam, _ = _cameras()
    u = puni.Uniforms.new(cam, 800.0, 450.0)
    assert tuple(u.camera_proj.shape) == (4, 4) and tuple(u.normal_proj.shape) == (4, 4)
    np.testing.assert_allclose(u.camera_pos.numpy()[:3], cam.eye.numpy())
    v = cam.get_view().numpy().astype(np.float64)
    np.testing.assert_allclose(u.normal_proj.numpy(), np.linalg.inv(v).T, rtol=1e-4, atol=1e-4)


def test_postprocessing_and_terrain_uniforms_equal_jax():
    got = puni.PostprocessingUniforms.new(800, 450, pixelize_n=12.5)
    want = juni.PostprocessingUniforms.new(800, 450, pixelize_n=12.5)
    eq(got.viewport, want.viewport)
    eq(got.pixelize_n, want.pixelize_n)
    assert float(puni.PostprocessingUniforms(viewport=got.viewport).pixelize_n) == 100.0
    args = ((0.0, 0.0), (20.0, 50.0), (1.0 / 1200, 1.0 / 1200))
    got = puni.TerrainUniforms.new(CoordinateTransform(*args), 1201, 1201)
    want = juni.TerrainUniforms.new(JaxTransform(*args), 1201, 1201)
    for name in ("raster_point", "model_point", "pixel_scale", "size"):
        eq(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(got.normal_to_world_rot.numpy(), np.asarray(want.normal_to_world_rot), atol=1e-6)
    assert jnp.asarray(want.size).dtype == jnp.float32 and got.size.dtype == torch.float32
