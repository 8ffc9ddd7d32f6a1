"""Benchmark of the port: one JSON line over the renderer's six configs.

Port of the repository's ``bench.py``, with its configs, shapes, knobs and
keys, run on one CUDA device:

    python -m topo_renderer_tpu_torch.bench                       # CUDA
    BENCH_SMOKE=1 python -m topo_renderer_tpu_torch.bench --device cpu

The headline (the top-level keys) is config 4, the 4096x1024 atmospheric
LOD panorama. ``configs`` carries every config, in ms per call except
config 5 (panoramas/s):

  1. the triangle-exact 800x450 perspective frame, engine-default guided
     march (``stages``: prepass and march, gather rounds, the interactive
     rung);
  2. the 2048x512 panorama with distance fog;
  3. the 800x450 fast frame with the label pass, its visibility bytes in
     the frame's wire vector (``stages``: overhead over config 6);
  4. the headline panorama (``stages``: window extraction and the rest);
  5. 256 viewpoints of 1024x256 panoramas (`render_batch_scan`);
  6. the 800x450 fast frame through the yuv420 wire, its pull to the host
     one frame behind the render (``stages``: device, transport, rgb888).

Configs 6 and 3 compose the frame from the functions the engine's
``render`` calls (`render_perspective_fast`, the label pass,
`transport.encode_frame`). The JAX package's targets were set for its TPU,
so ``target`` and ``vs_baseline`` are null throughout.

Terrain is generated on the device (`scripts/perf_probe.py`'s
`synthetic_mosaic_device`, 12001^2 texels centred at 47N 23E, ~6 GB of
tables), so nothing is read or copied from the host. ``BENCH_SMOKE=1`` takes
tiny shapes (n = 801; the eye is then off the scene's edge): a code-path
check, not a measurement.

When a config raises, the line carries the configs that completed and an
``error`` key, and the program exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.frontends.web.server import _start_pull
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.ops.geometry import to_device
from topo_renderer_tpu_torch.ops.panorama import (
    PanoramaSpec,
    extract_clipmap_windows,
    panorama_crossing_prepass,
    render_batch_scan,
    render_panorama,
)
from topo_renderer_tpu_torch.ops.raycast import (
    guided_march_defaults,
    guided_march_rounds,
    guided_prepass_spec,
    render_perspective,
    render_perspective_fast,
)
from topo_renderer_tpu_torch.render import text as text_mod
from topo_renderer_tpu_torch.render import transport
from topo_renderer_tpu_torch.render.engine import RenderEngine, _frame_labels
from topo_renderer_tpu_torch.scripts.perf_probe import eye_at, synthetic_mosaic_device
from topo_renderer_tpu_torch.utils.profiling import _wait_for

HEADLINE = "ms per 4096x1024 panorama (atmospheric shading, 1 chip)"

SMOKE = bool(int(os.environ.get("BENCH_SMOKE", "0")))

# Calls per timed loop, each after one warm-up call: the sustained loops
# (configs 4, 2, 6's device-only loop), config 1's three loops, config 5's
# batches, and the wire loops (frames per chunk, chunks).
REPS = {"sustained": 20, "exact": 12, "batch": 3, "wire": (5, 4)}


def _summary(samples, reps):
    """Mean, min and stddev of the chunks' ms per call."""
    mean = sum(samples) / len(samples)
    var = sum((s - mean) ** 2 for s in samples) / len(samples)
    return {"mean": mean, "min": min(samples), "stddev": var**0.5, "reps": reps}


def _sustained_stats(run, reps=20, chunks=4):
    """Sustained pipelined wall-clock with dispersion: ``reps // chunks``
    calls dispatched back to back per chunk (as a server dispatches), each
    chunk's mean per call; mean, min and stddev over the chunks."""
    _wait_for(run())  # warm-up: allocator, kernel builds
    per = max(1, reps // chunks)
    samples = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        outs = [run() for _ in range(per)]
        _wait_for(outs)
        samples.append((time.perf_counter() - t0) / per * 1e3)
    return _summary(samples, per * chunks)


def _stats_field(st):
    return {"min": round(st["min"], 2), "stddev": round(st["stddev"], 2), "reps": st["reps"]}


def _sustained_ms(run, reps=20, chunks=4):
    return _sustained_stats(run, reps=reps, chunks=chunks)["mean"]


def _emit(configs, error=None):
    """One JSON line, also when a config raised: the headline keys come
    from config 4 where it completed, and every config that finished is
    kept."""
    configs = sorted(configs, key=lambda c: c["config"])
    c4 = next((c for c in configs if c["config"] == 4), None)
    out = {
        "metric": HEADLINE,
        "value": c4["value"] if c4 else None,
        "unit": "ms",
        "vs_baseline": c4["vs_baseline"] if c4 else None,
        "configs": configs,
    }
    if error is not None:
        out["error"] = error
    print(json.dumps(out), flush=True)


# ---- the calls each config times ------------------------------------------------


def panorama_call(mosaic, eye, spec, sun, fog):
    """Configs 4 and 2: window extraction, then the render from those
    windows (the engine's two steps)."""
    win = extract_clipmap_windows(mosaic, eye, spec)
    return render_panorama(mosaic, eye, spec, sun, fog=fog, windows=win)


def exact_frame(mosaic, cam, width, height, fov, guided_kw=()):
    """Config 1: the guided triangle-exact frame with the engine's default
    steps and refinements."""
    return render_perspective(
        mosaic, cam, width=width, height=height, n_steps=1024, n_refine=24, guided=True, fov_hint=fov,
        guided_kw=guided_kw,
    )


def wire_frame(mosaic, cam, width, height, fov, mode="yuv420", labels=None):
    """Configs 6 and 3: the 512-step fast frame encoded into its wire
    vector, with ``labels=(positions, valid)`` the label pass's packed
    visibility appended (tolerance 5% of the LOD depth, as the engine's
    fast frame)."""
    out = render_perspective_fast(
        mosaic, cam, width=width, height=height, n_steps=512, pixelize_n=None, fov_hint=fov
    )
    packed = None
    if labels is not None:
        packed = _frame_labels(cam, out, *labels, width=width, height=height, tolerance_rel=0.05)
    return transport.encode_frame(out["color"], packed, mode=mode)


def _finish_pull(pull):
    """The host copy of a pull that `_start_pull` (the web server's pinned
    copy) queued, once its event has fired."""
    host, ready = pull
    if ready is not None:
        ready.synchronize()
    return host.numpy()


def wire_loop(frame_fn, consume, reps=5, chunks=4):
    """The web frame loop, pipelined one deep: each frame's pull is queued
    after its render, and the previous frame is decoded on the host while
    the device renders. Mean, min and stddev of the chunks' ms per frame."""
    _wait_for(frame_fn())  # warm-up
    samples = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        prev = None
        for _ in range(reps):
            cur = _start_pull(frame_fn())
            if prev is not None:
                consume(_finish_pull(prev))
            prev = cur
        consume(_finish_pull(prev))
        samples.append((time.perf_counter() - t0) / reps * 1e3)
    return _summary(samples, reps * chunks)


def bench_fixtures(device):
    """The scene and the inputs every config reads: ``(mosaic, eye, sun,
    peaks, eyes)`` with bench.py's seeds (512 peaks and config 5's
    viewpoints from ``default_rng(7)``, in that order). The eye stays on the
    host; peaks and viewpoints are on ``device``."""
    mosaic = synthetic_mosaic_device(n=801 if SMOKE else 12001, device=device)
    _wait_for(mosaic.heights_flat)
    eye = eye_at(47.0, 23.0, 2800.0)  # the scene's centre
    sun = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float32)

    rng = np.random.default_rng(7)
    P = 512
    lat = 47.0 + rng.uniform(-0.9, 0.9, P)
    lon = 23.0 + rng.uniform(-0.9, 0.9, P)
    alt = rng.uniform(800.0, 3200.0, P)
    peaks = torch.stack([eye_at(a, o, h) for a, o, h in zip(lat, lon, alt)])
    B = 4 if SMOKE else 256
    eyes = torch.stack([
        eye_at(47.0 + float(a), 23.0 + float(o), 2500.0)
        for a, o in zip(rng.uniform(-0.8, 0.8, B), rng.uniform(-0.8, 0.8, B))
    ])
    valid = torch.ones((P,), dtype=torch.bool)
    return mosaic, eye, sun, (to_device(peaks, device), to_device(valid, device)), to_device(eyes, device)


def main(configs, device=None, *, one_rep=False, mark=None, fixtures=None):
    """Run bench.py's configs in its order (4, 2, 5, 1, 6, 3), appending
    each finished config's record to ``configs``. ``device`` defaults to
    CUDA, which must be present. ``one_rep`` makes every timed loop one call
    after its warm-up (a code-path check on the CPU). ``mark(n)`` is called
    just before config ``n`` starts and ``mark(None)`` after the last.
    ``fixtures``: `bench_fixtures`'s result, built here when None."""
    device = resolve_device(device)
    mark = mark or (lambda n: None)

    def loop(reps):
        """(calls, chunks) of one timed loop."""
        return (1, 1) if one_rep else (reps, 4)

    def wire_stats(frame_fn, consume):
        reps, chunks = (1, 1) if one_rep else REPS["wire"]
        return wire_loop(frame_fn, consume, reps=reps, chunks=chunks)

    mosaic, eye, sun, (pos, valid), eyes = fixtures or bench_fixtures(device)

    # ---- config 4 (headline): 4096x1024 atmospheric panorama, LOD fast ----
    mark(4)
    spec4 = (
        PanoramaSpec.fast(width=512, height=128, n_steps=128)
        if SMOKE
        else PanoramaSpec.fast(width=4096, height=1024, n_steps=512)
    )
    st4 = _sustained_stats(lambda: panorama_call(mosaic, eye, spec4, sun, "atmosphere")["color"],
                           *loop(REPS["sustained"]))
    ms4 = st4["mean"]
    # Stage split: extraction alone; the render is the rest.
    ms4_extract = _sustained_ms(lambda: extract_clipmap_windows(mosaic, eye, spec4), *loop(REPS["sustained"]))
    configs.append({
        "config": 4,
        "metric": HEADLINE,
        "value": round(ms4, 2),
        "unit": "ms",
        "target": None,
        "vs_baseline": None,
        "stats": _stats_field(st4),
        "stages": {"extract_ms": round(ms4_extract, 2), "render_ms": round(ms4 - ms4_extract, 2)},
    })

    # ---- config 2: 2048x512 panorama, distance fog ----
    mark(2)
    spec2 = (
        PanoramaSpec.fast(width=256, height=64, n_steps=128)
        if SMOKE
        else PanoramaSpec.fast(width=2048, height=512, n_steps=512)
    )
    st2 = _sustained_stats(lambda: panorama_call(mosaic, eye, spec2, sun, "distance")["color"],
                           *loop(REPS["sustained"]))
    configs.append({
        "config": 2,
        "metric": "ms per 2048x512 panorama (distance fog)",
        "value": round(st2["mean"], 2),
        "unit": "ms",
        "target": None,
        "vs_baseline": None,
        "stats": _stats_field(st2),
    })

    # ---- peak fixtures (configs 3, 5) ----
    P = int(pos.shape[0])
    names = [f"Peak {i}" for i in range(P)]
    loc = GeoLocation.from_coord(47, 23)
    layout_memo = {}

    def layout_from_packed(packed_np):
        key = packed_np.tobytes()
        if key not in layout_memo:
            visible, xs, ys = packed_np[0].astype(bool), packed_np[1], packed_np[2]
            labels = {loc: [(i, (int(xs[i]), int(ys[i]))) for i in range(P) if visible[i]]}
            layout_memo[key] = text_mod.layout_labels(labels, lambda _loc, i: text_mod.measure_text(names[i]))
        return layout_memo[key]

    # ---- config 5: batched throughput, 256 viewpoints at 1024x256 ----
    mark(5)
    spec5 = (
        PanoramaSpec.fast(width=256, height=64, n_steps=128)
        if SMOKE
        else PanoramaSpec.fast(width=1024, height=256, n_steps=512)
    )
    B = int(eyes.shape[0])
    suns5 = sun.to(device).expand(B, 3)

    def run5():
        return render_batch_scan(mosaic, eyes, suns5, spec5, fog="atmosphere")

    _wait_for(run5())  # warm-up
    samples5 = []
    for _ in range(1 if one_rep else REPS["batch"]):
        t0 = time.perf_counter()
        _wait_for(run5())
        samples5.append(B / (time.perf_counter() - t0))
    panos_per_s = sum(samples5) / len(samples5)
    var5 = sum((s - panos_per_s) ** 2 for s in samples5) / len(samples5)
    configs.append({
        "config": 5,
        "metric": "1024x256 panoramas/sec (256 viewpoints, 1 chip)",
        "value": round(panos_per_s, 1),
        "unit": "panoramas/s",
        "target": None,
        "vs_baseline": None,
        "stats": {"min": round(min(samples5), 1), "stddev": round(var5**0.5, 1), "reps": len(samples5) * B},
    })

    # ---- config 1: exact perspective frame, 800x450, engine-default knobs ----
    mark(1)
    cam = Camera(eye=eye, pitch=-0.05, yaw=0.8)
    fov = math.radians(45.0)
    W1, H1 = (160, 90) if SMOKE else (800, 450)
    st1 = _sustained_stats(lambda: exact_frame(mosaic, cam, W1, H1, fov)["color"], *loop(REPS["exact"]))
    ms1 = st1["mean"]

    # Stage split: the prepass (profile gathers and K1) against the march
    # (the rest), the prepass spec taken from the march's own knobs.
    gmd = guided_march_defaults()
    spec_pre, _, _ = guided_prepass_spec(
        height=H1, fov_hint=fov, aspect=W1 / H1, n_steps=1024, supersample=gmd["supersample"],
        elev_supersample=gmd.get("elev_supersample", 1.0),
    )
    ms1_pre = _sustained_ms(
        lambda: panorama_crossing_prepass(mosaic, eye, spec_pre, bound_stride=gmd["bound_stride"])["d_lo"],
        *loop(REPS["exact"]),
    )
    rounds1 = guided_march_rounds(
        n_window=gmd["n_window"], n_cells=gmd["n_cells"], guard_legs=gmd["guard_legs"],
        nw_guard=gmd["nw_guard"], split_brackets=gmd["split_brackets"],
    )
    # The interactive rung that exact_quality="auto" serves on motion frames.
    rung_kw = RenderEngine._EXACT_RUNG_INTERACTIVE
    st1r = _sustained_stats(lambda: exact_frame(mosaic, cam, W1, H1, fov, guided_kw=rung_kw)["color"],
                            *loop(REPS["exact"]))
    rkw = dict(rung_kw)
    rounds1_rung = guided_march_rounds(**{
        k: rkw.get(k, gmd[k]) for k in ("n_window", "n_cells", "guard_legs", "nw_guard", "split_brackets")
    })
    configs.append({
        "config": 1,
        "metric": "ms per exact 800x450 perspective frame (engine-default guided march)",
        "value": round(ms1, 1),
        "unit": "ms",
        "target": None,
        "vs_baseline": None,
        "stats": _stats_field(st1),
        "stages": {
            "prepass_ms": round(ms1_pre, 2),
            "march_ms": round(ms1 - ms1_pre, 2),
            "gather_rounds": rounds1,
            "ms_per_round": round(max(ms1 - ms1_pre, 0.0) / rounds1, 2),
            "interactive_rung_ms": round(st1r["mean"], 1),
            "rung_rounds": rounds1_rung,
            "rung_ms_per_round": round(max(st1r["mean"] - ms1_pre, 0.0) / rounds1_rung, 2),
        },
    })

    # ---- config 6: interactive fast frame, pipelined wire pull ----
    mark(6)
    W6, H6 = (160, 90) if SMOKE else (800, 450)

    def frame6(mode="yuv420"):
        return wire_frame(mosaic, cam, W6, H6, fov, mode=mode)

    st6 = wire_stats(frame6, lambda b: transport.decode_pixels(b, H6, W6, mode="yuv420"))
    ms6 = st6["mean"]
    st6_raw = wire_stats(lambda: frame6("rgb888"), lambda b: transport.decode_pixels(b, H6, W6, mode="rgb888"))
    # Device-side sustained cost without the pull: the gap to ms6 is the
    # transfer and the host decode.
    ms6_dev = _sustained_ms(frame6, *loop(REPS["sustained"]))
    configs.append({
        "config": 6,
        "metric": "interactive 800x450 fast frame incl. one-transfer host pull (yuv420 wire, 1-deep pipeline)",
        "value": round(ms6, 2),
        "unit": "ms",
        "target": None,
        "vs_baseline": None,
        "fps": round(1000.0 / ms6, 1),
        "stats": _stats_field(st6),
        "stages": {
            "device_ms": round(ms6_dev, 2),
            "transport_ms": round(max(ms6 - ms6_dev, 0.0), 2),
            "wire_bytes": transport.pixel_bytes(H6, W6, "yuv420"),
            "rgb888_ms": round(st6_raw["mean"], 2),
            "rgb888_bytes": transport.pixel_bytes(H6, W6, "rgb888"),
        },
    })

    # ---- config 3: the label pass riding the frame's wire vector ----
    mark(3)
    n_laid = 0

    def consume3(buf):
        nonlocal n_laid
        _img, lab = transport.decode_frame(buf, H6, W6, P, mode="yuv420")
        n_laid = len(layout_from_packed(lab))

    st3 = wire_stats(lambda: wire_frame(mosaic, cam, W6, H6, fov, labels=(pos, valid)), consume3)
    configs.append({
        "config": 3,
        "metric": (
            f"ms per fused 800x450 frame+label pass (512 peaks -> {n_laid} laid out, labels ride the frame pull)"
        ),
        "value": round(st3["mean"], 2),
        "unit": "ms",
        "target": None,
        "vs_baseline": None,
        "stats": _stats_field(st3),
        # Min against min: the chunk minima are the stall-free samples of
        # the same pipelined loops.
        "stages": {"label_overhead_ms": round(max(st3["min"] - st6["min"], 0.0), 2)},
    })
    mark(None)


def run(argv=None) -> int:
    """The program: one JSON line; exit status 1 when a config raised."""
    p = argparse.ArgumentParser(description="The renderer's six benchmark configs, one JSON line.")
    p.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = p.parse_args(argv)
    completed = []
    try:
        main(completed, device=args.device)
    except Exception as e:  # publish what finished, then fail
        _emit(completed, error=f"{type(e).__name__}: {e}"[:500])
        return 1
    _emit(completed)
    return 0


if __name__ == "__main__":
    sys.exit(run())
