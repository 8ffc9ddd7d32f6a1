"""The exact frame through the engine: the port's `RenderEngine.render(...,
fast=False)` vs the JAX engine and the goldens `labeled_160x100` and
`wire_yuv420_160x100`.

Both engines load `tests/test_engine.py`'s hill tile and its two peaks and
each builds its own mosaic (the port's device build equals the JAX build's
heights bit for bit; packed normals may differ by one code). Tolerances:
colours at the slice-1 rule (<= 2/255 on >= 99% of pixels against the JAX
engine evaluated primitive by primitive, and against the golden no worse
than that evaluation + 1%); the wire's pixel bytes no further from the
golden's than the JAX evaluation's bytes + 1% of bytes; the visible label
sets, their pixels and the wire's label tail exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_engine import build_engine
from tests.test_torch_panorama import frac_bad
from topo_renderer_tpu.geo import GeoCoord as JaxCoord
from topo_renderer_tpu.render import transport as jax_transport
from topo_renderer_tpu.render.engine import RenderEngine as JaxEngine
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.render import transport
from topo_renderer_tpu_torch.render.engine import RenderEngine

W, H = 160, 100
KW = dict(n_steps=256, n_refine=8)  # the goldens' frame


def _labels(visible_labels):
    return {(loc.latitude.to_float(), loc.longitude.to_float()): sorted(v) for loc, v in visible_labels.items()}


@pytest.fixture(scope="module")
def engines():
    """(port engine, its camera, JAX engine, its camera), each engine fresh:
    its first exact frame takes the full budget, as the goldens' did."""
    je, jcam, tile = build_engine()
    pe = RenderEngine(device="cpu")
    t = tile.transform
    pe.add_terrain(GeoLocation.from_coord(49, 20), tile.heights,
                   CoordinateTransform(t.raster_point, t.model_point, t.pixel_scale))
    pe.add_peaks(GeoLocation.from_coord(49, 20),
                 [PeakInstance(position=np.array(p.position), name=p.name) for p in je._peaks[tile.location]])
    # `build_engine`'s camera: reset at (lat, lon) 1400 m (the sun follows
    # the location), then yaw toward east.
    pcam = Camera().reset(GeoCoord(49.0 + 0.05 / 2, 20.0 + 0.05 * 0.1), 1400.0)
    pcam = dataclasses.replace(pcam, yaw=float(jcam.yaw), pitch=float(jcam.pitch))
    np.testing.assert_array_equal(pcam.eye.numpy(), np.asarray(jcam.eye))
    return pe, pcam, je, jcam


@pytest.fixture(scope="module")
def frames(engines):
    pe, pcam, je, jcam = engines
    out = {"port": pe.render(pcam, W, H, **KW),
           "port_wire": pe.render(pcam, W, H, wire="yuv420", host_copy=False, **KW)}
    with jax.disable_jit():
        out["eager"] = je.render(jcam, W, H, **KW)
    return out


def test_engine_labeled_golden(frames):
    port, eager = frames["port"], frames["eager"]
    golden = np.load("tests/golden/labeled_160x100.npy")
    assert port.color.shape == golden.shape and port.color.dtype == np.uint8
    assert frac_bad(port.color, eager.color) < 0.01, frac_bad(port.color, eager.color)
    assert frac_bad(port.color, golden) <= frac_bad(eager.color, golden) + 0.01
    assert (port.hit == eager.hit).mean() >= 0.999 and 0.1 < port.hit.mean() < 1.0
    assert port.layouts, "no label laid out: the golden's frame has labels"
    assert _labels(port.visible_labels) == _labels(eager.visible_labels)


def test_engine_wire_golden(frames):
    res, eager = frames["port_wire"], frames["eager"]
    assert isinstance(res.color, torch.Tensor)
    buf = res.color.numpy()
    golden = np.load("tests/golden/wire_yuv420_160x100.npy")
    npx = transport.pixel_bytes(H, W, "yuv420")
    assert buf.shape == golden.shape
    np.testing.assert_array_equal(buf[npx:], golden[npx:])  # the label tail
    eager_px = np.asarray(jax_transport.encode_pixels_u8(jnp.asarray(eager.color_linear), mode="yuv420"))

    def off(px):
        return float((np.abs(px.astype(np.int32) - golden[:npx].astype(np.int32)) > 1).mean())

    assert off(buf[:npx]) <= off(eager_px) + 0.01, (off(buf[:npx]), off(eager_px))
    frame, visible_labels, layouts, names = res.finish(buf)
    assert frac_bad(frame, transport.decode_pixels(golden, H, W, mode="yuv420")) < 0.01
    assert _labels(visible_labels) == _labels(frames["port"].visible_labels) and layouts and names


def test_exact_quality_policy_equals_jax():
    """"auto": the full budget on the first frame, the interactive rung on
    a frame whose pose moved, the full budget again at rest; caller
    ``guided_kw`` overrides the rung's knobs; "full"/"interactive" pin."""
    pe, je = RenderEngine(device="cpu"), JaxEngine()
    pcam = Camera().reset(GeoCoord(49.02, 20.01), 1400.0)
    from topo_renderer_tpu.models.camera import Camera as JaxCamera

    jcam = JaxCamera().reset(JaxCoord(49.02, 20.01), 1400.0)
    steps = [(0.0, "auto", ()), (0.1, "auto", ()), (0.1, "auto", ()), (0.2, "auto", (("n_window", 4),)),
             (0.2, "interactive", ()), (0.3, "full", ()), (0.3, "auto", (("nw_guard", 3),))]
    got, want = [], []
    for yaw, quality, kw in steps:
        got.append(pe._resolve_exact_quality(dataclasses.replace(pcam, yaw=yaw), quality, kw))
        want.append(je._resolve_exact_quality(dataclasses.replace(jcam, yaw=yaw), quality, kw))
    assert got == want
    rung = (("n_window", 3), ("split_brackets", False))
    assert got[:3] == [(), rung, ()] and got[3] == (("n_window", 4), ("split_brackets", False))
    with pytest.raises(ValueError, match="exact_quality"):
        pe._resolve_exact_quality(pcam, "best", ())


def test_height_at_equals_jax(engines):
    pe, _, je, _ = engines
    for lat, lon in ((49.025, 20.025), (49.011, 20.0031), (49.049, 20.0499), (48.5, 20.0)):
        got = pe.height_at(GeoCoord(lat, lon))
        assert got == je.height_at(JaxCoord(lat, lon))
        assert (got is None) == (lat < 49.0)


def test_exact_frame_needs_cuda_by_default(monkeypatch, engines):
    """Without ``device`` the engine runs on CUDA and raises where CUDA is
    absent; with ``device="cpu"`` the exact frame renders there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RenderEngine().render(Camera(), 32, 24, fast=False)
    pe, pcam, *_ = engines
    res = pe.render(pcam, 32, 24, n_steps=64, n_refine=4, with_labels=False, host_copy=False)
    assert res.color.shape == (24, 32, 3) and res.hit.device.type == "cpu"


@pytest.mark.parametrize("fail_in", ["render_perspective", "_frame_labels", "encode_frame"],
                         ids=["march", "label_pass", "wire_encode"])
def test_failed_exact_frame_keeps_last_pose(monkeypatch, fail_in):
    """An exact frame whose build raises (in the march, the label pass or
    the wire encode) leaves `_last_exact_pose` at the last frame built and
    the exception reaches the caller, so the next "auto" frame back at that
    pose gets the full budget, not the interactive rung. (JAX's engine
    records the pose before the build; the port repairs that.)"""
    from tests.helpers import make_tile
    from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo
    from topo_renderer_tpu_torch.render import engine as engine_mod

    tile = make_tile(49, 20, n=33, span_deg=0.02)
    t = tile.transform
    pe = RenderEngine(device="cpu")
    loc = GeoLocation.from_coord(49, 20)
    pe.add_terrain(loc, tile.heights, CoordinateTransform(t.raster_point, t.model_point, t.pixel_scale))
    pe.add_peaks(loc, [PeakInstance(position=ecef_from_geo(2000.0, 20.015, 49.01).numpy(), name="Gipfel")])
    cam_a = Camera().reset(GeoCoord(49.01, 20.003), 1800.0)
    cam_b = dataclasses.replace(cam_a, yaw=0.4)

    budgets, failing = [], [False]
    march = engine_mod.render_perspective

    def spy(*args, **kw):
        budgets.append(kw["guided_kw"])
        if failing[0] and fail_in == "render_perspective":
            raise RuntimeError("frame build failed")
        return march(*args, **kw)

    monkeypatch.setattr(engine_mod, "render_perspective", spy)
    if fail_in != "render_perspective":
        owner = engine_mod.transport if fail_in == "encode_frame" else engine_mod
        real = getattr(owner, fail_in)

        def stage(*args, **kw):
            if failing[0]:
                raise RuntimeError("frame build failed")
            return real(*args, **kw)

        monkeypatch.setattr(owner, fail_in, stage)
    kw = dict(n_steps=64, n_refine=4, host_copy=False, wire="yuv420" if fail_in == "encode_frame" else None)

    pe.render(cam_a, 32, 24, **kw)
    pose_a = RenderEngine._camera_pose_key(cam_a)
    assert pe._last_exact_pose == pose_a
    failing[0] = True
    with pytest.raises(RuntimeError, match="frame build failed"):
        pe.render(cam_b, 32, 24, **kw)
    assert pe._last_exact_pose == pose_a
    failing[0] = False
    pe.render(cam_a, 32, 24, **kw)
    rung = tuple(sorted(RenderEngine._EXACT_RUNG_INTERACTIVE))
    assert budgets == [(), rung, ()]
    assert pe._last_exact_pose == pose_a
