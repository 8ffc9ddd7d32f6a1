"""The exact frame's interactive rung: its frame against JAX's, and how much
the rung's budget magnifies a last-bit difference against the full budget.

The scene is the goldens' (`tests/helpers.py::small_scene(n=49, ...)`,
carried across with `jax_mosaic_to_port`), 96x64, guided, looking east at
the golden pose (pitch -0.06), at the rung the engine renders a moving
camera with (`RenderEngine._EXACT_RUNG_INTERACTIVE`: ``n_window=3``,
``split_brackets=False``) and at the full budget (the defaults).

- The rung frame is held to JAX evaluated primitive by primitive
  (`jax.disable_jit()`) by the frame rule of `test_torch_exact_frame.py`:
  <= 2/255 per channel on >= 99% of pixels, hit masks equal on >= 99.9%,
  depth within 1e-5 relative on >= 99% of common hits; on all, 1e-2 where
  the full budget's rule says 5e-3. Measured 5.3e-3 on one pixel of 6144
  (the full budget: 1.3e-3): at a silhouette a last bit flips whether the
  cell walk finds the crossing (the port: 292.62 m, between its
  neighbours) or the leg keeps its bracket's end (JAX: 299.23 m, the pixel
  above's), and the rung's union bracket puts that end farther out.
- Sensitivity: the share of pixels beyond 2/255 between a frame and the
  same frame with a last-bit difference, at both budgets: the eye moved
  one float32 ulp in each coordinate (measured 12.2% full, 5.6% rung: the
  postprocess's depth-contour outline turns every pixel's new depth into
  these flips), and JAX's eager evaluation of the same frame (0.049% full,
  0.065% rung). The rung over the full budget is held below 1.5 and 2.5
  (measured 0.46 and 1.33): the rung does not magnify last bits. On the
  card, `topo_renderer_tpu_torch/scripts/rung_stages.py` read the card
  against the CPU at both budgets on the benchmark's own poses: the
  `exact800` check's 0.28% at the rung (against 0.011% at the full budget)
  is its pose's, 240 of the free-fly path, where the full budget reads
  0.32% (`PERF.md` §6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.helpers import east_at, small_scene, yaw_towards
from tests.test_torch_exact_frame import FOV, H, W, port_camera
from tests.test_torch_panorama import frac_bad
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.ops import raycast as jray
from topo_renderer_tpu.ops.shading import to_srgb8_image as jax_srgb8
from topo_renderer_tpu_torch.ops import raycast as pray
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.render.engine import RenderEngine

BUDGETS = {"full": (), "rung": RenderEngine._EXACT_RUNG_INTERACTIVE}
RATIO_MAX = {"eye_ulp": 1.5, "eager_jax": 2.5}  # rung over full; measured 0.46 and 1.33
KW = dict(width=W, height=H, n_steps=384, n_refine=16, guided=True, fov_hint=FOV)


@pytest.fixture(scope="module")
def scene():
    """(the port's mosaic, the JAX camera, eager(budget): JAX's frame
    evaluated primitive by primitive, each budget rendered once)."""
    mosaic, cam, _ = small_scene(n=49, span_deg=0.04, height_above=500.0)
    cam = dataclasses.replace(cam, yaw=yaw_towards(cam, east_at(cam)), pitch=-0.06)
    frames = {}

    def eager(budget):
        if budget not in frames:
            with jax.disable_jit():
                frames[budget] = jray.render_perspective(mosaic, cam, guided_kw=BUDGETS[budget], **KW)
        return frames[budget]

    return jax_mosaic_to_port(mosaic), cam, eager


def port_frame(pm, cam, budget, eye=None):
    pcam = port_camera(cam)
    if eye is not None:
        pcam = dataclasses.replace(pcam, eye=torch.from_numpy(eye))
    return pray.render_perspective(pm, pcam, guided_kw=BUDGETS[budget], **KW)


def test_rung_frame_matches_eager_jax(scene):
    pm, cam, eager_frame = scene
    out, eager = port_frame(pm, cam, "rung"), eager_frame("rung")
    port, eager_u8 = to_srgb8_image(out["color"]).numpy(), np.asarray(jax_srgb8(eager["color"]))
    assert port.shape == eager_u8.shape == (H, W, 3)
    assert frac_bad(port, eager_u8) < 0.01, frac_bad(port, eager_u8)
    hit, eager_hit = out["hit"].numpy(), np.asarray(eager["hit"])
    assert hit.mean() > 0.05
    assert (hit == eager_hit).mean() >= 0.999
    both = hit & eager_hit
    rel = np.abs(out["depth"].numpy() - np.asarray(eager["depth"]))[both] / np.asarray(eager["depth"])[both]
    assert (rel <= 1e-5).mean() >= 0.99 and rel.max() <= 1e-2, rel.max()


@pytest.mark.parametrize("probe", list(RATIO_MAX))
def test_rung_does_not_magnify_last_bits(scene, probe):
    pm, cam, eager_frame = scene
    eye_up = np.nextafter(np.asarray(cam.eye, np.float32), np.float32(np.inf)).astype(np.float32)
    shares = {}
    for budget in BUDGETS:
        base = to_srgb8_image(port_frame(pm, cam, budget)["color"]).numpy()
        if probe == "eye_ulp":
            other = to_srgb8_image(port_frame(pm, cam, budget, eye_up)["color"]).numpy()
        else:
            other = np.asarray(jax_srgb8(eager_frame(budget)["color"]))
        shares[budget] = frac_bad(base, other)
    print(f"{probe}: pixels beyond 2/255", shares)
    assert shares["full"] > 0.0 and shares["rung"] > 0.0, shares
    assert shares["rung"] / shares["full"] < RATIO_MAX[probe], shares
