"""The port's camera matrices and camera moves vs the JAX package.

Same numpy-seeded inputs through `topo_renderer_tpu.ops.mathx` /
`models.camera` and their ports, held at rtol 1e-6. Entries that cancel
(the view matrix's translations, ~|eye| * 2^-24 of rounding around 0) get
an absolute tolerance of that size beside the relative one.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_renderer_tpu.geo import GeoCoord as JaxCoord
from topo_renderer_tpu.models.camera import Camera as JaxCamera, ViewMode as JaxViewMode
from topo_renderer_tpu.ops import mathx as jmathx
from topo_renderer_tpu_torch.geo import GeoCoord
from topo_renderer_tpu_torch.models.camera import Camera, ViewMode
from topo_renderer_tpu_torch.ops import mathx

RTOL = 1e-6
EYE_ATOL = 6.4e6 * 2.0**-23  # one ulp of an ECEF coordinate


def _close(p, j, atol=1e-6, **kw):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=RTOL, atol=atol, **kw)


def cameras(seed=0, n=6):
    """(port, JAX) camera pairs at numpy-drawn places and poses."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lat, lon = float(rng.uniform(-70, 70)), float(rng.uniform(-179, 179))
        h = float(rng.uniform(200, 9000))
        pose = dict(pitch=float(rng.uniform(-1.2, 1.2)), yaw=float(rng.uniform(-math.pi, math.pi)),
                    fov_y=float(rng.uniform(0.3, 2.0)))
        p = dataclasses.replace(Camera().reset(GeoCoord(lat, lon), h), **pose)
        j = dataclasses.replace(JaxCamera().reset(JaxCoord(lat, lon), h), **pose)
        out.append((p, j))
    return out


CAMS = cameras()


@pytest.mark.parametrize("k", range(len(CAMS)))
def test_camera_axes_and_matrices(k):
    p, j = CAMS[k]
    for name in ("up", "direction", "direction_right", "direction_down", "position"):
        _close(getattr(p, name)(), getattr(j, name)(), err_msg=name)
    _close(p.get_view(), j.get_view(), atol=EYE_ATOL)
    for w, h in ((800, 450), (96, 64)):
        _close(p.build_view_proj_matrix(w, h), j.build_view_proj_matrix(float(w), float(h)), atol=EYE_ATOL,
               err_msg=f"{w}x{h}")
    _close(p.build_view_normal_matrix(), j.build_view_normal_matrix(), atol=1e-5)


def test_mathx_matrices():
    rng = np.random.default_rng(1)
    eye = rng.normal(size=3).astype(np.float32) * 4e6
    d = rng.normal(size=3).astype(np.float32)
    up = (eye / np.linalg.norm(eye)).astype(np.float32)
    _close(mathx.look_to_rh(*map(torch.from_numpy, (eye, d, up))), jmathx.look_to_rh(eye, d, up), atol=EYE_ATOL)
    args = [np.float32(v) for v in (0.9, 16 / 9, 50.0, 500_000.0)]
    proj = mathx.perspective_rh(*map(torch.tensor, args))
    _close(proj, jmathx.perspective_rh(*args))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    pts = (rng.normal(size=(64, 3)) * 1e4).astype(np.float32)
    got = mathx.project_point3(torch.from_numpy(m), torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmathx.project_point3(m, pts)))
    got = mathx.transform_vector3(torch.from_numpy(m), torch.from_numpy(pts))
    _close(got, jmathx.transform_vector3(m, pts), atol=1e-2)


def test_camera_moves():
    p, j = CAMS[0]
    for fov in (0.05, 1.0, 3.0):
        _close(p.with_fovy(fov).fov_y, j.with_fovy(fov).fov_y)
    _close(p.rotate_yaw(0.25).yaw, j.rotate_yaw(0.25).yaw)
    p0, j0 = dataclasses.replace(p, pitch=1.5), dataclasses.replace(j, pitch=1.5)
    for step in (0.05, 0.2, -0.4):  # 1.55 stays, 1.7 is past +90° and is skipped
        _close(p0.rotate_pitch(step).pitch, j0.rotate_pitch(step).pitch, err_msg=str(step))
    assert float(p0.rotate_pitch(0.2).pitch) == np.float32(1.5)
    mode_p, mode_j = p, j
    for _ in range(4):
        mode_p, mode_j = mode_p.toggle_view_mode(), mode_j.toggle_view_mode()
        assert int(mode_p.view_mode) == int(mode_j.view_mode)
    assert [int(ViewMode(m).toggle()) for m in range(3)] == [int(JaxViewMode(m).toggle()) for m in range(3)]


def test_view_proj_product_order():
    """The 4x4 product equals XLA's bit for bit on the same two matrices."""
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(4, 4)).astype(np.float32) * s for s in (1.0, 3e6))
    got = mathx.mat4_mul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(a) @ jnp.asarray(b)))


NORM_N = 64


@pytest.mark.parametrize("layout", ["3xN", "Nx3"])
@pytest.mark.parametrize("eps", [0.0, 1e-30])
@pytest.mark.parametrize("axis", [-1, 0])
def test_normalize_along_either_axis(axis, eps, layout):
    """`normalize(v, axis, eps)` against ``jax.jit`` of JAX's on the same
    float32 ``[3, N]`` or ``[N, 3]`` input (one zero vector among them, so
    that ``eps`` acts). Reduced over an axis of 3, bit for bit: XLA-CPU's
    chain of fused multiply-adds and its correctly rounded square root.
    Reduced over the axis of N = 64, XLA vectorises the sum in an order of
    its own that the port does not copy (measured at most 5 ulps on 300
    seeds); held within 8 ulps."""
    shape = (3, NORM_N) if layout == "3xN" else (NORM_N, 3)
    v = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    np.moveaxis(v, axis, -1)[1] = 0.0  # a zero vector along the reduced axis
    got = mathx.normalize(torch.from_numpy(v), axis=axis, eps=eps).numpy()
    want = np.asarray(jax.jit(jmathx.normalize, static_argnames=("axis", "eps"))(jnp.asarray(v), axis=axis, eps=eps))
    assert got.shape == want.shape == v.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    ulps = np.abs(got[ok].view(np.int32).astype(np.int64) - want[ok].view(np.int32))
    if v.shape[axis] == 3:
        assert ulps.max() == 0, (int(ulps.max()), float((ulps > 0).mean()))
    else:
        assert ulps.max() <= 8, int(ulps.max())
