"""Stage-level cost breakdown of the fast panorama path (not a test).

Port of the repository's ``scripts/stage_probe.py``. At bench config 4's
spec (4096x1024, 512 steps, on `perf_probe.synthetic_mosaic_device`'s
12001^2 scene, or ``PROBE_N`` texels a side) it times, host clock over 20
calls dispatched back to back after a warm-up:

  1. the clipmap window extraction (kernel K2);
  2. the profile alone (`_build_lod_profile`: e_prof and the attribute
     planes), the gather stage;
  3. the profile and the crossing search through
     `ops/crossing.py::crossing_search`, kernel K1, as `render_panorama`
     runs it. (The JAX script writes the crossing as the running max and
     its reductions inline, which is K1's plain version.)
  4. the full render, extraction included.

Stage deltas say where the time goes.

    python -m topo_renderer_tpu_torch.scripts.stage_probe             # CUDA
    PROBE_N=801 python -m topo_renderer_tpu_torch.scripts.stage_probe --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.ops import panorama as pano
from topo_renderer_tpu_torch.ops.crossing import crossing_search
from topo_renderer_tpu_torch.ops.geometry import f32
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, extract_clipmap_windows, render_panorama
from topo_renderer_tpu_torch.scripts.perf_probe import eye_at, synthetic_mosaic_device
from topo_renderer_tpu_torch.utils.profiling import _wait_for

SPEC = PanoramaSpec.fast(width=4096, height=1024, n_steps=512)  # bench config 4


def bench(label, fn, *args, reps=20):
    """Host-clock ms per call of ``fn(*args)``: ``reps`` calls dispatched
    back to back after a warm-up, then waited for."""
    _wait_for(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(reps)]
    _wait_for(outs)
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"{label:<42s} {ms:8.2f} ms", flush=True)
    return ms


def setup_ctx(mosaic, eye, spec):
    """The per-call values `render_panorama` computes before the profile:
    ``(a0, up, h_prof_b, sigma)`` for the spec's profile columns."""
    dev = mosaic.device
    eye = f32(eye, dev)
    a0, up, (ex, ey), (nx0, ny0, nz0), _ = pano._eye_frame(eye)
    ws = spec.width // max(1, int(spec.profile_stride))
    phi_sub = f32(spec.azimuth_start, dev) + spec.azimuth_span * (
        (torch.arange(ws, dtype=torch.float32, device=dev) + 0.5) / ws
    )
    cps, sps = torch.cos(phi_sub), torch.sin(phi_sub)
    h_prof_b = tuple(c[None, :] for c in (nx0 * cps + ex * sps, ny0 * cps + ey * sps, nz0 * cps))
    sigma = pano._log_schedule(spec, dev)(torch.arange(spec.n_steps, dtype=torch.float32, device=dev)[:, None])
    return a0, up, h_prof_b, sigma


def profile_only(mosaic, eye, spec, windows):
    a0, up, h_prof_b, sigma = setup_ctx(mosaic, eye, spec)
    e_prof, attr_prof = pano._build_lod_profile(mosaic, spec, windows, a0, up, h_prof_b, sigma)
    return (e_prof,) + tuple(attr_prof)


def through_crossing(mosaic, eye, spec, windows):
    e_prof, *attr_prof = profile_only(mosaic, eye, spec, windows)
    dev = mosaic.device
    e_lo, e_hi = spec.elevation_range()
    rows = (torch.arange(spec.height, dtype=torch.float32, device=dev) + 0.5) / spec.height
    thresh = torch.tan(f32(e_hi, dev) - rows * f32(e_hi - e_lo, dev))
    return crossing_search(e_prof, *attr_prof, thresh)


def main(argv=None) -> dict:
    """Prints each stage's ms and the deltas; returns them by name."""
    p = argparse.ArgumentParser(description="Stage breakdown of the fast panorama path.")
    p.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    n = int(os.environ.get("PROBE_N", "12001"))
    mosaic = synthetic_mosaic_device(n=n, device=device)
    _wait_for(mosaic.heights_flat)
    eye = eye_at(47.0, 23.0, 2800.0)
    sun = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float32)

    win = extract_clipmap_windows(mosaic, eye, SPEC)
    _wait_for(win)
    ms = {"extract": bench("1. extract_clipmap_windows", extract_clipmap_windows, mosaic, eye, SPEC)}
    ms["profile"] = bench("2. profile sampling (e_prof + attrs)", lambda: profile_only(mosaic, eye, SPEC, win))
    ms["crossing"] = bench("3. sampling + crossing search (K1)", lambda: through_crossing(mosaic, eye, SPEC, win))

    def full():
        w = extract_clipmap_windows(mosaic, eye, SPEC)
        return render_panorama(mosaic, eye, SPEC, sun, fog="atmosphere", windows=w)["color"]

    ms["full"] = bench("4. full render (incl. extraction)", full)
    print(f"\n   crossing stage delta: {ms['crossing'] - ms['profile']:.2f} ms")
    print(f"   tail (shade/post/etc): {ms['full'] - ms['crossing']:.2f} ms", flush=True)
    return ms


if __name__ == "__main__":
    main()
