"""The triangle-exact frame: the port's marches and `render_perspective` vs
the JAX package, its goldens and the independent WGSL rasterizer oracle.

Scenes are the JAX tests' own (`tests/helpers.py::small_scene`, the
goldens' and `tests/test_parity_independent.py`'s); the JAX mosaic is
carried across (`jax_mosaic_to_port`). Tolerances:

- Marches against jitted JAX on one pose with terrain and sky (22% sky):
  hit masks equal on >= 99.9% of pixels (measured 99.95-99.98%: grazing
  silhouette rays); relative ``t_hit`` difference where both hit below 1e-6
  at p50 and 5e-2 at max, and on at most 2% of pixels above 1e-3 (measured
  0.4-0.9%); at p99 below 2e-3 for the uniform, two-level and ray-guided
  marches (bisection of a clearance whose transcendentals differ from
  XLA's by ulps; measured 8.3-8.7e-4) and below 1e-4 for the
  panorama-guided march (the cell walk; measured 1.1-3.5e-6).
- Frames (the slice-1 rule): <= 2/255 per channel on >= 99% of pixels
  against JAX evaluated primitive by primitive (`jax.disable_jit()`), and
  against the golden no worse than that evaluation is + 1%; hit masks equal
  on >= 99.9% of pixels, depth within rtol 1e-5 on >= 99% of common hits
  and 5e-3 on all (measured: 99.9% and 1.3e-3).
- The WGSL oracle (`tests/raster_oracle2.py`, numpy only), at the JAX
  test's gate (`test_parity_independent.py:289-330`): < 0.05% of pixels
  beyond 2/255, median error < 1/1020, guided and unguided.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import east_at, small_scene, yaw_towards
from tests.raster_oracle2 import rasterize2
from tests.test_parity_independent import _scene_and_vp
from tests.test_torch_panorama import frac_bad
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.ops import raycast as jray
from topo_renderer_tpu.ops.shading import to_srgb8_image as jax_srgb8
from topo_renderer_tpu_torch.models.camera import Camera, LightAngle, ViewMode
from topo_renderer_tpu_torch.ops import raycast as pray
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image

W, H = 96, 64
FOV = math.radians(45.0)


def T(a):  # noqa: N802 - a numpy array as a CPU tensor of its own
    return torch.from_numpy(np.array(a))


def port_camera(jcam):
    """The port's camera at the JAX camera's pose."""
    return Camera(
        eye=T(np.asarray(jcam.eye, np.float32)), pitch=float(jcam.pitch), yaw=float(jcam.yaw),
        fov_y=float(jcam.fov_y), view_mode=ViewMode(int(jcam.view_mode)),
        sun_angle=LightAngle(theta=float(jcam.sun_angle.theta), phi=float(jcam.sun_angle.phi)),
    )


@pytest.fixture(scope="module")
def golden_scene():
    """The goldens' mosaic (JAX and port) and camera, looking east."""
    mosaic, cam, _ = small_scene(n=49, span_deg=0.04, height_above=500.0)
    return mosaic, jax_mosaic_to_port(mosaic), cam


MARCHES = {
    "uniform": dict(fn="march", kw=dict(n_steps=256, n_refine=16, two_level=False)),
    "two_level": dict(fn="march", kw=dict(n_steps=384, n_refine=16)),
    "guided_rays": dict(fn="march_guided", kw=dict(n_steps=256, n_refine=16)),
    "guided_panorama": dict(fn="march_guided_panorama",
                            kw=dict(n_steps=384, n_refine=16, fov_hint=FOV, aspect=W / H)),
    "guided_panorama_interactive": dict(fn="march_guided_panorama",
                                        kw=dict(n_steps=384, n_refine=16, fov_hint=FOV, aspect=W / H,
                                                n_window=3, split_brackets=False)),
    "guided_panorama_unguarded": dict(fn="march_guided_panorama",
                                      kw=dict(n_steps=384, n_refine=16, fov_hint=FOV, aspect=W / H,
                                              guard_legs=False)),
    "guided_panorama_unguarded_single": dict(fn="march_guided_panorama",
                                             kw=dict(n_steps=384, n_refine=16, fov_hint=FOV, aspect=W / H,
                                                     guard_legs=False, split_brackets=False)),
}


@pytest.mark.parametrize("name", list(MARCHES))
def test_march_matches_jitted_jax(golden_scene, name):
    mosaic, pm, cam = golden_scene
    cam = dataclasses.replace(cam, yaw=yaw_towards(cam, east_at(cam)), pitch=-0.4)  # skyline in view
    (dx, dy, dz), fwd = jray.camera_rays(cam, W, H)
    dirs = tuple(np.asarray(a) for a in (dx, dy, dz))
    eye, fwd = np.asarray(cam.eye, np.float32), np.asarray(fwd)
    spec = MARCHES[name]
    guided_pano = spec["fn"] == "march_guided_panorama"
    jfn, pfn = getattr(jray, spec["fn"]), getattr(pray, spec["fn"])

    def jax_march(e, d, f):
        return jfn(mosaic, e, d, f, **spec["kw"]) if guided_pano else jfn(mosaic, e, d, **spec["kw"])

    jh, jt = (np.asarray(a) for a in jax.jit(jax_march)(jnp.asarray(eye), tuple(map(jnp.asarray, dirs)),
                                                          jnp.asarray(fwd)))
    pargs = (pm, T(eye), tuple(map(T, dirs))) + ((T(fwd),) if guided_pano else ())
    ph, pt = (a.numpy() for a in pfn(*pargs, **spec["kw"]))
    assert 0.05 < ph.mean() < 0.95
    assert (ph == jh).mean() >= 0.999
    both = ph & jh
    rel = np.abs(pt - jt)[both] / jt[both]
    assert np.median(rel) < 1e-6 and rel.max() < 5e-2 and (rel > 1e-3).mean() < 0.02
    assert np.quantile(rel, 0.99) < (1e-4 if guided_pano else 2e-3)


GOLDEN_FRAMES = {
    "perspective_96x64": dict(n_steps=384, n_refine=16),
    "guided_exact_96x64": dict(n_steps=384, n_refine=16, guided=True, fov_hint=FOV),
}


@pytest.mark.parametrize("name", list(GOLDEN_FRAMES))
def test_render_perspective_golden(golden_scene, name):
    mosaic, pm, cam = golden_scene
    cam = dataclasses.replace(cam, yaw=yaw_towards(cam, east_at(cam)), pitch=-0.06)
    kw = dict(width=W, height=H, **GOLDEN_FRAMES[name])
    out = pray.render_perspective(pm, port_camera(cam), **kw)
    with jax.disable_jit():
        eager = jray.render_perspective(mosaic, cam, **kw)
    port = to_srgb8_image(out["color"]).numpy()
    eager_u8 = np.asarray(jax_srgb8(eager["color"]))
    golden = np.load(f"tests/golden/{name}.npy")
    assert port.shape == golden.shape
    assert frac_bad(port, eager_u8) < 0.01, frac_bad(port, eager_u8)
    assert frac_bad(port, golden) <= frac_bad(eager_u8, golden) + 0.01
    hit, eager_hit = out["hit"].numpy(), np.asarray(eager["hit"])
    assert (hit == eager_hit).mean() >= 0.999
    both = hit & eager_hit
    rel = np.abs(out["depth"].numpy() - np.asarray(eager["depth"]))[both] / np.asarray(eager["depth"])[both]
    assert (rel <= 1e-5).mean() >= 0.99 and rel.max() <= 5e-3


def test_renderer_matches_wgsl_oracle():
    """`test_parity_independent.py::test_renderer_matches_oracle2` on the
    port: the strict-parity unguided march and the guided march."""
    w, h = 160, 100
    mosaic, cam, vp = _scene_and_vp(w, h)
    c2, _ = rasterize2(
        np.asarray(mosaic.heights), np.asarray(mosaic.normals), (0.0, 0.0), np.asarray(mosaic.model_point),
        np.asarray(mosaic.pixel_scale), vp, np.asarray(cam.eye, np.float64),
        np.asarray(cam.sun_angle.to_vec3(), np.float64), w, h, view_mode=1,
    )
    pm, pcam = jax_mosaic_to_port(mosaic), port_camera(cam)
    for guided in (False, True):
        out = pray.render_perspective(
            pm, pcam, width=w, height=h, n_steps=768, n_refine=26, quantize_rt=False, apply_postprocess=False,
            guided=guided, fov_hint=FOV if guided else None,
        )
        err = np.abs(out["color"].numpy() - c2).max(axis=-1)
        assert (err > 2.0 / 255.0).mean() < 0.0005, (guided, (err > 2.0 / 255.0).mean())
        assert np.median(err) < 1.0 / 1020.0
