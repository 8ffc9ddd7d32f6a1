"""The interactive fast frame: the port vs the JAX package.

The scene is `test_torch_engine.py`'s: four tiles sharing their seams and
16 peaks. `render_perspective_fast` renders from the JAX mosaic carried
across (`jax_mosaic_to_port`), so both sides read the same tables; the
engine tests build a mosaic on each side.

Tolerances: colours at the golden tolerance (<= 2/255 on >= 99% of pixels)
against JAX evaluated primitive by primitive (`jax.disable_jit()`), and
against the jitted frame no worse than that evaluation is + 1% (XLA-CPU
contracts multiply-adds; see `test_torch_panorama.py`). Hit masks agree on
>= 99% of pixels. Label visibility, label pixels, the visible label sets
and the wire's label tail are exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import CAM, scene, terrain
from tests.test_torch_panorama import frac_bad
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.data.coordinate_transform import CoordinateTransform as JaxTransform
from topo_renderer_tpu.geo import GeoCoord as JaxCoord, GeoLocation as JaxLocation
from topo_renderer_tpu.models.camera import Camera as JaxCamera
from topo_renderer_tpu.models.uniforms import PeakInstance as JaxPeak
from topo_renderer_tpu.ops.labels import peak_visibility as jax_peak_visibility
from topo_renderer_tpu.ops.raycast import (
    fast_view_spec as jax_fast_view_spec,
    render_perspective_fast as jax_fast,
)
from topo_renderer_tpu.ops.shading import to_srgb8_image as jax_srgb8
from topo_renderer_tpu.render import transport as jax_transport
from topo_renderer_tpu.render.engine import RenderEngine as JaxEngine
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo
from topo_renderer_tpu_torch.ops.labels import peak_visibility, to_int32_saturating
from topo_renderer_tpu_torch.ops.raycast import fast_view_spec, render_perspective_fast
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.render import transport
from topo_renderer_tpu_torch.render.engine import RenderEngine

W, H = 96, 64


def _yaw_south(jcam):
    """Yaw that points the camera due south (azimuth ±π): the window then
    straddles the azimuth seam."""
    from tests.helpers import yaw_towards

    eye = np.asarray(jcam.eye, np.float64)
    lon, lat = np.arctan2(eye[1], eye[0]), np.arcsin(eye[2] / np.linalg.norm(eye))
    north = np.array([-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)])
    return yaw_towards(jcam, -north)


def _cameras():
    lat, lon, above = CAM
    ground = float(terrain(np.array(lat), np.array(lon)))
    p = Camera().reset(GeoCoord(lat, lon), ground + above)
    j = JaxCamera().reset(JaxCoord(lat, lon), ground + above)
    return p, j


# The camera's pitch is measured in the canonical frame, whose up is
# (0, -1, 0): a positive pitch looks down. One step count for every frame,
# so that JAX's primitive-by-primitive evaluation compiles each op once.
N_STEPS = 192
POSES = {
    "level": dict(yaw=0.3, pitch=-0.15),  # slightly up: peaks on the skyline
    "steep": dict(yaw=1.9, pitch=1.12),  # 1.12 rad down: the window's rows pass -pi/2
    "seam": dict(yaw=None, pitch=0.05),  # 0.2 rad off due south: the window crosses azimuth ±pi
}


@pytest.fixture(scope="module")
def scene_engines():
    return build_engines()


def build_engines():
    tiles, peaks = scene()
    pe = RenderEngine(device="cpu")
    je = JaxEngine()
    for (la, lo), h, mp, ps in tiles:
        pe.add_terrain(GeoLocation.from_coord(la, lo), h, CoordinateTransform((0.0, 0.0), mp, (ps, ps)))
        je.add_terrain(JaxLocation.from_coord(la, lo), h, JaxTransform((0.0, 0.0), mp, (ps, ps)))
    for (la, lo), lst in peaks.items():
        pos = [ecef_from_geo(h + 10.0, plo, pla).numpy() for pla, plo, h in lst]
        pe.add_peaks(GeoLocation.from_coord(la, lo),
                     [PeakInstance(position=p, name=f"Peak {i}") for i, p in enumerate(pos)])
        je.add_peaks(JaxLocation.from_coord(la, lo),
                     [JaxPeak(position=np.asarray(p), name=f"Peak {i}") for i, p in enumerate(pos)])
    je.mosaic  # build outside disable_jit
    return pe, je


def _posed(name):
    p, j = _cameras()
    pose = dict(POSES[name])
    if pose["yaw"] is None:
        pose["yaw"] = _yaw_south(j) + 0.2
    return dataclasses.replace(p, **pose), dataclasses.replace(j, **pose)


def test_fast_view_spec_matches():
    for w, h, fov in ((800, 450, math.radians(45)), (96, 64, math.radians(45)), (1920, 1080, math.radians(90))):
        ps, pw, pa = fast_view_spec(width=w, height=h, fov_hint=fov, n_steps=512)
        js, jw, ja = jax_fast_view_spec(width=w, height=h, fov_hint=fov, n_steps=512)
        assert (pw, pa) == (jw, ja)
        assert dataclasses.asdict(ps) == dataclasses.asdict(js)
    spec, _, _ = fast_view_spec(width=800, height=450, fov_hint=math.radians(45), n_steps=512)
    assert (spec.width, spec.height, spec.profile_stride) == (1536, 1056, 2)


@pytest.mark.parametrize("pose", list(POSES))
def test_render_perspective_fast(scene_engines, pose):
    _, je = scene_engines
    pcam, jcam = _posed(pose)
    if pose == "seam":
        fwd = np.asarray(jcam.direction(), np.float64)
        eye = np.asarray(jcam.eye, np.float64)
        lon = np.arctan2(eye[1], eye[0])
        east = np.array([-np.sin(lon), np.cos(lon), 0.0])
        assert abs(np.arctan2(fwd @ east, fwd @ np.cross(eye / np.linalg.norm(eye), east))) > 2.5
    kw = dict(width=W, height=H, n_steps=N_STEPS)
    po = render_perspective_fast(jax_mosaic_to_port(je.mosaic), pcam, **kw)
    jo = jax_fast(je.mosaic, jcam, **kw)
    with jax.disable_jit():
        eo = jax_fast(je.mosaic, jcam, **kw)
    port = to_srgb8_image(po["color"]).numpy()
    jit, eager = (np.asarray(jax_srgb8(o["color"])) for o in (jo, eo))
    assert port.shape == (H, W, 3)
    assert frac_bad(port, eager) < 0.01, frac_bad(port, eager)
    assert frac_bad(port, jit) <= frac_bad(eager, jit) + 0.01, (frac_bad(port, jit), frac_bad(eager, jit))
    hit = po["hit"].numpy()
    assert (hit == np.asarray(jo["hit"])).mean() >= 0.99
    assert (hit == np.asarray(eo["hit"])).mean() >= 0.99
    assert 0.0 < hit.mean() <= 1.0
    both = hit & np.asarray(eo["hit"])
    np.testing.assert_allclose(po["depth"].numpy()[both], np.asarray(eo["depth"])[both], rtol=1e-3)


@pytest.mark.parametrize("pose", list(POSES))
def test_view_proj_equals_jax(pose):
    """The label pass's matrix, bit for bit: off-screen label pixels move by
    tens of pixels on a last bit, and they ride in the wire. XLA's sin and
    cos are not correctly rounded (cos(1.1) is an ulp off torch's), so the
    poses' angles are ones where both give the same bits; the products and
    sums must then match exactly."""
    pcam, jcam = _posed(pose)
    np.testing.assert_array_equal(pcam.build_view_proj_matrix(W, H).numpy(),
                                  np.asarray(jcam.build_view_proj_matrix(float(W), float(H))))


def test_int32_conversion_saturates_as_xla():
    x = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0**31, -(2.0**31), 2147483520.0, -2147483904.0,
                  1.7, -1.7, -0.0], np.float32)
    np.testing.assert_array_equal(to_int32_saturating(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.asarray(x).astype(jnp.int32)))


def test_peak_visibility_exact():
    """Peaks in view, off screen, behind the eye and on the eye plane (clip
    w ~ 0: ndc of ±inf or NaN, saturated pixel coordinates)."""
    _, jcam = _posed("level")
    rng = np.random.default_rng(11)
    eye = np.asarray(jcam.eye, np.float32)
    fwd, right = np.asarray(jcam.direction()), np.asarray(jcam.direction_right())
    cam_up = np.cross(right, fwd)
    d = rng.uniform(100, 20_000, 48)
    a, b = d * rng.uniform(-1.5, 1.5, (2, 48))  # a third of them off screen
    pts = list(eye + d[:, None] * fwd + a[:, None] * right + b[:, None] * cam_up)
    pts += [eye - d * fwd for d in rng.uniform(10, 5000, 6)]  # behind
    pts += [eye + a * right + b * cam_up for a, b in rng.uniform(-500, 500, (6, 2))]  # eye plane
    pts += [eye]
    pos = np.asarray(pts, np.float32)
    valid = rng.random(len(pos)) < 0.9
    depth = rng.uniform(0.99, 1.0, (H, W)).astype(np.float32)  # terrain 5-500 km away
    vp = np.array(jcam.build_view_proj_matrix(float(W), float(H)))
    got = peak_visibility(*map(torch.from_numpy, (pos, valid, vp, depth)), width=W, height=H, tolerance_rel=0.05)
    want = jax_peak_visibility(pos, valid, vp, depth, width=W, height=H, tolerance_rel=0.05)
    with jax.disable_jit():
        eager = jax_peak_visibility(pos, valid, vp, depth, width=W, height=H, tolerance_rel=0.05)
    for key in ("visible", "x", "y", "in_frustum"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(eager[key]), err_msg=key)
    x = got["x"].numpy()
    assert got["visible"].any() and not got["visible"].all()
    assert ((x == 2**31 - 1) | (x == -(2**31)) | (x == 0)).sum() >= 1, "no saturated projection"


def _labels(visible_labels):
    return {(loc.latitude.to_float(), loc.longitude.to_float()): sorted(v) for loc, v in visible_labels.items()}


@pytest.fixture(scope="module")
def engine_frames(scene_engines):
    pe, je = scene_engines
    pcam, jcam = _posed("level")
    kw = dict(n_steps=N_STEPS, fast=True, composite=False)
    out = {"port": pe.render(pcam, W, H, **kw), "jit": je.render(jcam, W, H, **kw),
           "port_wire": pe.render(pcam, W, H, wire="yuv420", host_copy=False, **kw),
           "jit_wire": je.render(jcam, W, H, wire="yuv420", **kw)}
    with jax.disable_jit():
        out["eager"] = je.render(jcam, W, H, **kw)
    return out


def test_engine_fast_frame_with_labels(engine_frames):
    out = engine_frames
    port, jit, eager = (out[k].color for k in ("port", "jit", "eager"))
    assert port.shape == (H, W, 3) and port.dtype == np.uint8
    assert frac_bad(port, eager) < 0.01, frac_bad(port, eager)
    assert frac_bad(port, jit) <= frac_bad(eager, jit) + 0.01
    assert (out["port"].hit == out["jit"].hit).mean() >= 0.99
    labels = _labels(out["port"].visible_labels)
    assert labels, "no label visible: the frame tests nothing"
    assert labels == _labels(out["jit"].visible_labels) == _labels(out["eager"].visible_labels)


def test_engine_wire_yuv420(engine_frames):
    out = engine_frames
    res, jres = out["port_wire"], out["jit_wire"]
    assert isinstance(res.color, torch.Tensor) and isinstance(res.depth, torch.Tensor)
    buf, jbuf = res.color.numpy(), np.asarray(jres.color)
    npx = transport.pixel_bytes(H, W, "yuv420")
    assert buf.shape == jbuf.shape and buf.size > npx
    np.testing.assert_array_equal(buf[npx:], jbuf[npx:])  # the label tail
    frame, visible_labels, layouts, names = res.finish(buf)
    jframe = jax_transport.decode_pixels(jbuf, H, W, mode="yuv420")
    assert frame.shape == (H, W, 3)
    assert frac_bad(frame, jframe) <= frac_bad(out["eager"].color, out["jit"].color) + 0.01
    assert _labels(visible_labels) == _labels(out["port"].visible_labels) == _labels(jres.finish(jbuf)[1])
    assert len(layouts) == len(out["port"].layouts) and names
