"""Render the two demo images on the synthetic alpine scene.

Port of the repository's ``scripts/make_demos.py``: on
`perf_probe.synthetic_mosaic_device`'s ridged 2401^2 scene, from 3400 m
above 51N 19E, (1) the 2048x512 atmospheric panorama under a
late-afternoon sun with five labelled peaks on local maxima of the relief
(``demo_panorama.png``), and (2) the same view with distance fog at a dusk
sun (``demo_fog.png``). The PNGs go to the directory given, by default
``demos/`` in the package's build directory (`build_dir`).

    python -m topo_renderer_tpu_torch.scripts.make_demos [out_dir]            # CUDA
    python -m topo_renderer_tpu_torch.scripts.make_demos /tmp/d --device cpu
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from topo_renderer_tpu_torch import build_dir, resolve_device
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models.uniforms import PeakInstance
from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo, local_frame, to_device
from topo_renderer_tpu_torch.ops.labels import peak_visibility_panorama
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, render_panorama
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.render import text as text_mod
from topo_renderer_tpu_torch.render.overlay import composite_labels
from topo_renderer_tpu_torch.scripts.perf_probe import eye_at, synthetic_mosaic_device
from topo_renderer_tpu_torch.utils.imageio import save_image

NAMES = ["Grosse Sinuspitze", "Cos Horn", "Mittelgipfel", "Wellenkamm", "Sudkamm"]


def demo_peaks(heights: np.ndarray):
    """One fabricated peak per name, each 10 m above the highest texel of
    its own window of the relief (the height a float32 sum, as numpy gives
    the JAX script)."""
    peaks = []
    hh, ww = heights.shape
    step = hh // 6
    for i, name in enumerate(NAMES):
        r0, c0 = step * (i + 1) - step // 2, (step * (2 * i + 3)) % (ww - step)
        win = heights[r0 : r0 + step, c0 : c0 + step]
        r, c = np.unravel_index(np.argmax(win), win.shape)
        lat = 52.0 - (r0 + r) / 1200.0
        lon = 18.0 + (c0 + c) / 1200.0
        position = ecef_from_geo(torch.tensor(win[r, c] + np.float32(10.0)), lon, lat).numpy()
        peaks.append(PeakInstance(position=position, name=name))
    return peaks


def main(argv=None) -> dict:
    """Writes both PNGs; returns ``{"panorama": path, "fog": path,
    "labels": count}``."""
    p = argparse.ArgumentParser(description="Render the demo images.")
    p.add_argument("out_dir", nargs="?", default=None, help="where the PNGs go (default: <build dir>/demos)")
    p.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = pathlib.Path(args.out_dir) if args.out_dir else build_dir() / "demos"
    out_dir.mkdir(parents=True, exist_ok=True)

    mosaic = synthetic_mosaic_device(n=2401, rugged=True, device=device)
    eye = eye_at(51.0, 19.0, 3400.0)
    # Late-afternoon sun: low over the local horizon for relief contrast.
    east, north, up = (v.numpy() for v in local_frame(19.0, 51.0))
    sun_v = 0.55 * east + 0.25 * north + 0.45 * up
    sun = torch.tensor(sun_v / np.linalg.norm(sun_v), dtype=torch.float32)
    spec = PanoramaSpec.fast(width=2048, height=512, n_steps=512)

    # 1. Wide atmospheric panorama with labels.
    out = render_panorama(mosaic, eye, spec, sun, fog="atmosphere")
    img = to_srgb8_image(out["color"]).cpu().numpy()
    peaks = demo_peaks(mosaic.heights.cpu().numpy())
    pos = to_device(torch.from_numpy(np.stack([pk.position for pk in peaks]).astype(np.float32)), device)
    valid = to_device(torch.ones((len(peaks),), dtype=torch.bool), device)
    vis = peak_visibility_panorama(pos, valid, to_device(eye, device), spec, out["depth"], tolerance_rel=0.05)
    visible_np, xs, ys = (vis[k].cpu().numpy() for k in ("visible", "x", "y"))
    loc = GeoLocation.from_coord(51, 18)
    visible = {loc: [(i, (int(xs[i]), int(ys[i]))) for i in range(len(peaks)) if bool(visible_np[i])]}
    layouts = text_mod.layout_labels(visible, lambda _l, i: text_mod.measure_text(peaks[i].name))
    named = {(loc, i): peaks[i].name for i in range(len(peaks))}
    img = composite_labels(img, layouts, named)
    pano_path = out_dir / "demo_panorama.png"
    save_image(pano_path, img)
    print(f"wrote {pano_path}, {len(layouts)} labels", flush=True)

    # 2. Distance-fog panorama at a dusk sun.
    sun2 = torch.tensor(np.array([0.7, 0.1, 0.3]) / np.linalg.norm([0.7, 0.1, 0.3]), dtype=torch.float32)
    out2 = render_panorama(mosaic, eye, spec, sun2, fog="distance", fog_density=1.0 / 40_000.0)
    fog_path = out_dir / "demo_fog.png"
    save_image(fog_path, to_srgb8_image(out2["color"]).cpu().numpy())
    print(f"wrote {fog_path}", flush=True)
    return {"panorama": pano_path, "fog": fog_path, "labels": len(layouts)}


if __name__ == "__main__":
    main()
