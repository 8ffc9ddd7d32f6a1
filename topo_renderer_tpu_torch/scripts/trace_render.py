"""Capture and summarize a device trace of the non-LOD panorama render.

Port of the repository's ``scripts/trace_render.py``: a 4096x1024
panorama of 1024 steps with two refinements on
`perf_probe.synthetic_mosaic_device`'s ``n``-texel scene (default 1201),
timed once after a warm-up, then rendered once more under
`utils/profiling.trace` (torch.profiler, a Chrome trace) and summarized by
`summarize_trace`: the 22 operations with the most device time.

    python -m topo_renderer_tpu_torch.scripts.trace_render [n]           # CUDA
    python -m topo_renderer_tpu_torch.scripts.trace_render 257 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, render_panorama
from topo_renderer_tpu_torch.scripts.perf_probe import eye_at, synthetic_mosaic_device
from topo_renderer_tpu_torch.utils.profiling import _wait_for, summarize_trace, trace

TOP = 22
SPEC = PanoramaSpec(width=4096, height=1024, n_steps=1024, n_refine=2)


def main(argv=None) -> list:
    """Prints the render's ms and the trace's top operations; returns them
    as ``[(ms, name), ...]`` (empty on the CPU, whose trace has no device
    operation)."""
    p = argparse.ArgumentParser(description="Device trace of the non-LOD panorama render.")
    p.add_argument("n", nargs="?", type=int, default=1201, help="texels per side of the synthetic scene")
    p.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    p.add_argument("--trace-dir", default=None, help="where the Chrome trace goes (default: trace's own)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n
    mosaic = synthetic_mosaic_device(n=n, device=device)
    _wait_for(mosaic.heights_flat)
    print("mosaic ready", flush=True)
    eye = eye_at(52.0 - (n / 1200.0) / 2, 18.0 + (n / 1200.0) / 2, 2800.0)
    sun = torch.tensor([0.3, 0.5, 0.8])

    def run():
        return render_panorama(mosaic, eye, SPEC, sun, fog="atmosphere")["color"]

    _wait_for(run())
    t0 = time.perf_counter()
    _wait_for(run())
    print(f"render: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    with trace(args.trace_dir) as log_dir:
        _wait_for(run())
    top = summarize_trace(log_dir, top=TOP)
    print(f"== {device}")
    for ms, name in top:
        print(f"{ms:9.2f} ms  {name[:140]}", flush=True)
    if not top:
        print("(the trace holds no device operation)", flush=True)
    return top


if __name__ == "__main__":
    main()
