"""The whole slice: the port's RenderEngine vs the JAX RenderEngine.

Four tiles sharing their seams and 16 peaks go into both engines; each
builds its own mosaic and renders `PanoramaSpec.fast(256, 64,
n_steps=256)` with labels. Colours are held at the golden tolerance to the
JAX engine evaluated primitive by primitive, and to the jitted engine as
closely as that evaluation comes (see `test_torch_panorama.py` for why);
the visible label sets must be equal. The camera is held to rtol 1e-6.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from tests.test_torch_panorama import frac_bad
from topo_renderer_tpu.data.coordinate_transform import CoordinateTransform as JaxTransform
from topo_renderer_tpu.geo import GeoCoord as JaxCoord, GeoLocation as JaxLocation
from topo_renderer_tpu.models.camera import Camera as JaxCamera
from topo_renderer_tpu.models.uniforms import PeakInstance as JaxPeak
from topo_renderer_tpu.ops.panorama import PanoramaSpec as JaxSpec
from topo_renderer_tpu.render.engine import RenderEngine as JaxEngine
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec
from topo_renderer_tpu_torch.render.engine import RenderEngine

N, SPAN = 97, 0.05
LAT0, LON0 = 47.0, 11.0
CAM = (LAT0 + 0.9 * SPAN, LON0 + 0.7 * SPAN, 350.0)  # lat, lon, height above ground


def terrain(lat, lon):
    """Smooth hills as a function of position, so shared seams agree."""
    y, x = (lat - LAT0) / SPAN, (lon - LON0) / SPAN
    h = 1500.0 + 500.0 * np.sin(3.1 * x + 0.4) * np.cos(2.3 * y + 1.1)
    h += 220.0 * np.sin(7.3 * x * y + 0.9) + 90.0 * np.cos(11.0 * x - 5.0 * y)
    return h.astype(np.float32)


def scene():
    """Tiles (location, heights, model_point, ps) of a 2x2 block and peaks
    (location, [(lat, lon, height)])."""
    ps = SPAN / (N - 1)
    tiles, peaks = [], {}
    rng = np.random.default_rng(7)
    for dy in (0, 1):
        for dx in (0, 1):
            lat_top, lon0 = LAT0 + (2 - dy) * SPAN, LON0 + dx * SPAN
            lats = (lat_top - ps * np.arange(N))[:, None]
            lons = (lon0 + ps * np.arange(N))[None, :]
            loc = (int(LAT0) + 1 - dy, int(LON0) + dx)
            tiles.append((loc, terrain(lats, lons), (lon0, lat_top), ps))
            la = lat_top - SPAN * rng.uniform(0.05, 0.95, 4)
            lo = lon0 + SPAN * rng.uniform(0.05, 0.95, 4)
            hs = terrain(la, lo)
            order = np.argsort(-hs)
            peaks[loc] = [(float(la[i]), float(lo[i]), float(hs[i])) for i in order]
    return tiles, peaks


@pytest.fixture(scope="module")
def frames():
    tiles, peaks = scene()
    lat, lon, above = CAM
    ground = float(terrain(np.array(lat), np.array(lon)))

    pe = RenderEngine(device="cpu")
    je = JaxEngine()
    for (la, lo), h, mp, ps in tiles:
        pe.add_terrain(GeoLocation.from_coord(la, lo), h, CoordinateTransform((0.0, 0.0), mp, (ps, ps)))
        je.add_terrain(JaxLocation.from_coord(la, lo), h, JaxTransform((0.0, 0.0), mp, (ps, ps)))
    for (la, lo), lst in peaks.items():
        pe.add_peaks(GeoLocation.from_coord(la, lo), [
            PeakInstance(position=ecef_from_geo(h + 10.0, plo, pla).numpy(), name=f"Peak {i}")
            for i, (pla, plo, h) in enumerate(lst)
        ])
        je.add_peaks(JaxLocation.from_coord(la, lo), [
            JaxPeak(position=np.asarray(ecef_from_geo(h + 10.0, plo, pla).numpy()), name=f"Peak {i}")
            for i, (pla, plo, h) in enumerate(lst)
        ])
    pcam = Camera().reset(GeoCoord(lat, lon), ground + above)
    jcam = JaxCamera().reset(JaxCoord(lat, lon), ground + above)
    pcam = dataclasses.replace(pcam, yaw=0.3, pitch=-0.1)
    jcam = dataclasses.replace(jcam, yaw=0.3, pitch=-0.1)
    kw = dict(width=256, height=64, n_steps=256)
    out = {"port": pe.render_panorama(pcam, PanoramaSpec.fast(**kw)),
           "jit": je.render_panorama(jcam, JaxSpec.fast(**kw))}
    with jax.disable_jit():  # same engine and mosaic, frame evaluated op by op
        out["eager"] = je.render_panorama(jcam, JaxSpec.fast(**kw))
    return out, pcam, jcam


def _labels(res):
    return {
        (loc.latitude.to_float(), loc.longitude.to_float()): sorted(ids)
        for loc, ids in res.visible_labels.items()
    }


def test_colors_at_golden_tolerance(frames):
    out, _, _ = frames
    port, jit, eager = (out[k].color for k in ("port", "jit", "eager"))
    assert port.shape == (64, 256, 3)
    assert frac_bad(port, eager) < 0.01, frac_bad(port, eager)
    assert frac_bad(port, jit) <= frac_bad(eager, jit) + 0.01
    assert (out["port"].hit == out["jit"].hit).mean() >= 0.99
    assert 0.05 < out["port"].hit.mean() < 0.95


def test_visible_labels_equal(frames):
    out, _, _ = frames
    assert _labels(out["port"]), "no label visible: the scene tests nothing"
    assert _labels(out["port"]) == _labels(out["jit"]) == _labels(out["eager"])


def test_camera_matches(frames):
    _, pcam, jcam = frames
    for name in ("eye", "up", "direction"):
        p = getattr(pcam, name)
        j = getattr(jcam, name)
        p = p() if callable(p) else p
        j = j() if callable(j) else j
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        pcam.sun_angle.to_vec3().numpy(), np.asarray(jcam.sun_angle.to_vec3()), rtol=1e-6, atol=1e-6
    )


def test_engine_mosaic_on_requested_device():
    tiles, _ = scene()
    engine = RenderEngine(device="cpu")
    (la, lo), h, mp, ps = tiles[0]
    engine.add_terrain(GeoLocation.from_coord(la, lo), h, CoordinateTransform((0.0, 0.0), mp, (ps, ps)))
    assert engine.mosaic.device == torch.device("cpu")
    assert engine.mosaic.shape == (N, N)
