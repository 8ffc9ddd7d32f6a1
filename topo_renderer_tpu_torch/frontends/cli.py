"""Command-line frontend: render vistas/panoramas to image files.

The desktop-frontend equivalent (`topo-renderer-desktop/src/main.rs:7-66`) —
headless by design: the renderer produces frames server-side. Copy of
`topo_renderer_tpu/frontends/cli.py` for the PyTorch port, with the same
subcommands and flags plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch versions, as the tests do).

Examples:
  topo-render-torch render --lat 49.35135 --lon 20.21139 -o vista.png
  topo-render-torch panorama --lat 45.95 --lon 7.7 --width 4096 --height 1024 \\
      --fog atmosphere -o matterhorn.png
  topo-backend-torch            # serve DEM tiles + peaks (Settings.toml)
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def _add_common(p):
    p.add_argument("--lat", type=float, required=True, help="viewpoint latitude (deg)")
    p.add_argument("--lon", type=float, required=True, help="viewpoint longitude (deg)")
    p.add_argument("--height-above", type=float, default=50.0,
                   help="camera height above terrain (m), reference default 50")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--settings", default=None, help="path to Settings.toml")
    p.add_argument("--no-labels", action="store_true")
    p.add_argument("--pixelize", type=float, default=None, help="pixelization N")
    p.add_argument("--sun-theta", type=float, default=None)
    p.add_argument("--sun-phi", type=float, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the mosaic lives and frames render (cuda raises without CUDA)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="topo-render-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="perspective frame")
    _add_common(p_render)
    p_render.add_argument("--width", type=int, default=800)
    p_render.add_argument("--height", type=int, default=600)
    p_render.add_argument("--yaw", type=float, default=0.0)
    p_render.add_argument("--pitch", type=float, default=0.0)
    p_render.add_argument("--fov", type=float, default=45.0)
    p_render.add_argument("--steps", type=int, default=1024)
    p_render.add_argument("--fast", action="store_true",
                          help="interactive LOD path (panorama-warp)")
    p_render.add_argument("--strict-parity", action="store_true",
                          help="uniform exact march (no guided prepass)")

    p_pano = sub.add_parser("panorama", help="360-degree cylindrical panorama")
    _add_common(p_pano)
    p_pano.add_argument("--width", type=int, default=2048)
    p_pano.add_argument("--height", type=int, default=512)
    p_pano.add_argument("--fog", choices=["distance", "atmosphere"], default=None)
    p_pano.add_argument("--fast", action="store_true", help="LOD fast path")
    p_pano.add_argument("--steps", type=int, default=1024)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    import dataclasses

    from topo_renderer_tpu_torch.app.application import Application
    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.geo import GeoCoord
    from topo_renderer_tpu_torch.models.camera import LightAngle
    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec
    from topo_renderer_tpu_torch.utils.imageio import save_image

    settings = Settings.load(path=args.settings)
    app = Application(settings, device=None if args.device == "cuda" else args.device)
    location = GeoCoord(args.lat, args.lon)

    logging.info("requesting tiles around %.5f, %.5f ...", args.lat, args.lon)
    app.start(location)
    app.wait_for_terrain()
    # Let remaining nearby tiles stream in briefly.
    t0 = time.time()
    while time.time() - t0 < 2.0:
        app.pump_events()
        time.sleep(0.05)
    app.pump_events()

    cam = app.data.camera
    if args.height_above != 50.0:
        terrain_h = app.engine.height_at(location) or 0.0
        cam = cam.reset(location, terrain_h + float(args.height_above))
    if args.sun_theta is not None or args.sun_phi is not None:
        cam = dataclasses.replace(
            cam,
            sun_angle=LightAngle(
                theta=args.sun_theta if args.sun_theta is not None else cam.sun_angle.theta,
                phi=args.sun_phi if args.sun_phi is not None else cam.sun_angle.phi,
            ),
        )

    pixelize = args.pixelize

    if args.command == "render":
        import math

        cam = dataclasses.replace(
            cam, yaw=math.radians(args.yaw), pitch=math.radians(args.pitch)
        ).with_fovy(math.radians(args.fov))
        logging.info("rendering %dx%d ...", args.width, args.height)
        res = app.engine.render(
            cam, args.width, args.height, n_steps=args.steps,
            pixelize_n=pixelize, with_labels=not args.no_labels,
            fast=args.fast, guided=not args.strict_parity,
        )
    else:
        spec = (
            PanoramaSpec.fast(width=args.width, height=args.height, n_steps=args.steps)
            if args.fast
            else PanoramaSpec(width=args.width, height=args.height, n_steps=args.steps)
        )
        logging.info("rendering %dx%d panorama ...", args.width, args.height)
        res = app.engine.render_panorama(
            cam, spec, fog=args.fog, pixelize_n=pixelize,
            with_labels=not args.no_labels,
        )

    save_image(args.output, res.color)
    n_labels = len(res.layouts)
    logging.info("wrote %s (%d peak labels)", args.output, n_labels)
    app.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
