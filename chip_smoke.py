#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1, 2, 3 and 5's kernel times

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the port from ``topo_renderer_tpu_torch/csrc``
     (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the panoramas and the perspective frames give it: K1 (crossing
     search), K2/K4 (window copies) and K3 (the batched window copy, 256
     viewpoints) must agree exactly, bit for bit. K1 also at config 2's
     shape (N 512, W 1024, H 512), at the fast
     frame's shape (N 512, W 768, H 1056; level and with rows past -pi/2),
     at the exact frame's prepass shape (N 896, W 1152, H 840, zero
     payloads; exact and bound profiles, level and 1.1 rad down), on ties,
     N = 509 (not a multiple of its chunk), crossings and NaNs at chunk
     edges, shuffled rows at the batch shape and an unaligned profile; K2
     also on two table sets in turn. Each kernel's device time is read by
     CUDA events, one pair per launch with the host queued ahead, cold (a
     256 MB scratch buffer written between launches, outside the pair) and
     warm, beside an empty kernel's (the card's floor), its bytes bound
     and, for K2 and K4, the `copy_` calls that compute the same windows
     from host-int origins (K2: one per level). A cold reading faster than
     105% of 3.35 TB/s for the bytes counted fails the run. K3 is read at
     phase 3's random origins and at config 5's own (after the scene's
     build, before phase 4a), bytes counted by ``batched_bytes``;
  4. drive the engine on 100 COP-90-shaped tiles (10 x 10 tiles of 1201^2
     texels at 3", a 12001^2 mosaic) and ~256 peaks. First K3 at the
     origins `_window_batch` gives it for config 5's 256 eyes, on the
     scene's ``win_attr_2d`` tables, bit for bit against its plain version
     and timed as in phase 3, then phase 5; then:
     a0. the mosaic's accessors on the card: `heights`, `normals_packed`
        and `normals` equal the attribute table's words and their CPU
        decode bit for bit (`mosaic_accessors`), no kernel launched;
     a. three 4096 x 1024 atmospheric LOD panoramas of 512 steps with
        labels; every frame must launch K1 and K2 once, hit terrain and
        sky, and carry labels;
     a2. config 2 as bench.py runs it: `extract_clipmap_windows` then the
        functional `render_panorama` at 2048 x 512, 512 steps, with
        distance fog, on phase 4a's camera; every call launches K1 and K2
        once (K2's launch arguments found in the cache), hits terrain and
        sky and has > 200 colours; the host-clock median of 5 calls, the
        host syncs inside a call and the device-only ms by CUDA-graph
        replay; K1 and K2 held bit for bit against their plain versions on
        the inputs one call gives them; the phase's own seconds;
     b. config 5: `render_batch` of 256 viewpoints at 1024 x 256, 512
        steps, atmosphere; one call launches K3 once, K2 never and K1 256
        times, sampled eyes equal their single-eye render bit for bit, and
        the call's panoramas/s is printed;
     c. the non-clipmap fallback: `render_batch` of 4 viewpoints with
        ``PanoramaSpec(1024, 256, n_steps=512, n_refine=2)``; K1 never
        launches and each eye equals its single-eye render;
     d. config 6: the interactive 800 x 450 fast frame (`render(...,
        fast=True, wire="yuv420")`, 512 steps) for 20 frames, each with one
        host pull and the host decode; every frame launches K1 and K2 once
        and K3 never, hits terrain and sky and has > 200 colours. Then
        frames 1.1 rad below and above the horizon and one whose window
        crosses azimuth ±pi; ms per frame on the host clock, the host syncs
        inside a frame, the device-only ms by CUDA events (the frame
        captured into a CUDA graph and replayed), and the profiled frame's
        device busy share;
     e. config 3: the same frame with the label pass, its bytes in the same
        wire vector; at least one label is visible and ``finish``'s labels
        equal those of the frame rendered without the wire;
     f. config 1: the triangle-exact 800 x 450 frame (`render(...,
        n_steps=1024, n_refine=24, fast=False)`, the guided march), 10
        settle frames (``exact_quality="full"``) and 10 motion frames
        ("interactive"), each with the u8 pull, then one labelled frame
        through the yuv420 wire; every frame launches K1 twice (the
        prepass's profiles) and K2/K3 never, hits terrain and sky and has >
        200 colours. Per rung the host syncs inside a frame (must be 0) and
        the device-only ms by CUDA-graph replay; the settle frame's device
        busy share. Then one frame of each march without the own-texel leg
        (``guided_kw`` with ``guard_legs=False``, split legs and one pooled
        bracket): K1 twice, 0 host syncs, device-only ms;
     g. streaming: `RenderEngine(streaming=True)` on 3 x 3 tiles at 44-46N,
        11-13E (a 6144^2 canvas); one degree east unloads the 11E column and
        adds the 14E column, six slot updates that must be queued, not
        rebuilt (no kernel launch; host-clock ms, host syncs); the tables
        equal a fresh `build_mosaic` of the same tiles on the same canvas bit
        for bit (its ms is printed), and a fast frame (K1 1, K2 1) and an
        exact frame (K1 2) after the updates equal the fresh build's frames
        bit for bit with 0 host syncs; then the 15E column leaves the canvas
        and must rebuild in full (ms), and the phase's peak device memory;
     h. the host runtime: the streaming scene's 9 tiles written as GeoTIFFs
        with ~300 peaks each, served by the port's `BackendServer` on
        127.0.0.1; per tile the fetch, the native and the Python decode (each
        bit-equal to the array written) and `fetch_terrain`; then the CLI
        (`frontends/cli.py::main`, ``--device cuda``): a 4096 x 1024 fast
        atmospheric panorama (K1 1, K2 1) and the 800 x 450 exact frame (K1
        2, K2 0), each with its stages on the host clock (`Application()`,
        time to first terrain, the fixed 2 s pump, the mosaic build, the
        frame, `save_image`), the app engine's tables equal to a fresh build
        in its slot order and the PNG equal to a fresh engine's render of
        the same arrays, peaks and camera (labels too); then
        `Application.run` from cold with W held (fast frames from the first
        tile on): steps, full builds and slot updates until all 9 tiles are
        in, ms per step, K1/K2 per step (1/1), and the peak device memory
        of the CLI calls and of the app run;
     i. the frontends: phase 4h's 9 GeoTIFFs served by a local
        `BackendServer`; the web frontend (`frontends/web/server.py`) on
        CUDA in a thread answers `/location` at 45.5N 12.5E and `/session`,
        then 20 forced 800 x 450 fast frames with labels through the
        yuv420 wire, W held (ms per request, request to JPEG bytes, on the
        host clock; K1/K2 1/1 each; the server's stages timed with
        `utils/profiling.FrameTimer`), 10 exact frames on the interactive
        rung (K1 2, K2 0), one yuv420_half frame and one frame traced with
        `utils/profiling.trace`, whose `summarize_trace` must name K1's and
        K2's kernels; every served image, taken before its JPEG encode,
        equals the engine's render of the session's camera bit for bit.
        Then `/render`'s default 1024 x 384 panorama (K1 1, K2 1; the PNG
        equal to the engine's panorama) and again from its cache, and
        frames/s with one and with two requests in flight on one session.
        Then `DesktopFrontend`'s headless core at 800 x 600 (the Tk shell
        needs a display): 20 `render_frame` calls with W held (ms per
        frame, K1/K2 1/1, each equal to the engine's render);
     j. the host mosaic build: `RenderEngine(streaming=True,
        device_mosaic_build=False)` on the streaming scene's 9 tiles (a
        6144^2 canvas): `build_mosaic(on_device=False)` timed, with its
        numpy tables apart, against a device build of the same canvas
        (height tables bit for bit, packed normals within one code on
        under 2% of texels); one slot update, then a fast (K1 1, K2 1) and
        an exact frame (K1 2), each with 0 host syncs inside the frame;
     k. multi-device rendering, every band and shard on cuda:0, so that it
        runs on one card (transfers between cards are not exercised):
        `RenderEngine(geo_mesh=Mesh(["cuda:0"] * 4, ("geo",)))` with the
        100 tiles and their peaks (each band's resident bytes, the
        replicated bytes, the peak memory; its `heights`, `normals_packed`
        and `normals` equal the unsharded mosaic's, padded rows poisoned
        or zero); its config 6 fast frame (K1 1,
        K2 4: one per band), config 1 exact frame at both budgets (K1 2),
        config 4 panorama (K1 1, K2 4) and config 5 batch of 256 eyes (K1
        256, K3 4; each K3 launch also held bit for bit against its plain
        version at its band's origins) must equal the replicated engine's
        bit for bit, with
        host-clock and device-only ms and 0 host syncs in the frames;
        streaming under a 2-band geo mesh on phase 4g's tiles (six slot
        updates; the bands equal `shard_mosaic` of a replicated engine's
        updated tables and the frames after them its frames, bit for
        bit); `render_batch_sharded` over dp x az = 2 x 2, 8 eyes at
        1024 x 256 (K1/K2 16/16), against the single-device panorama with
        the ring-wrapped contour and its label visibility;
        `Application(geo_shard=2)` must raise RuntimeError on one card;
     l. the port's measurement programs (`topo_renderer_tpu_torch/bench.py`
        and `topo_renderer_tpu_torch/scripts/`): the bench's scene,
        `perf_probe.synthetic_mosaic_device(12001)`, built on the card (seconds, GB of tables, the build's peak); then
        `bench.main` in this process, every config in bench.py's order
        with the launch counts reset before each and checked after (K1/K2
        1/1 per config 4, 2, 6 and 3 call and one more K2 per config-4
        extraction, K1 256 and K3 1 per config-5 call of 256 eyes, K1 2 per
        config-1 frame, prepass and rung frame), its JSON line printed on a
        line of its own and held to bench.py's keys; one counted call of
        each form; K1 and K2 bit for bit against their plain versions on one
        config-4 call's inputs, and K3 on config 5's 256 eyes; then
        `stage_probe` (the launches of each stage per call), the
        `perf_probe` sweep at n = 2401, `trace_render` (its top operations
        from the device trace) and `make_demos` into the build directory (2048 x
        512 PNGs with > 200 colours, the label count); and the synthetic
        build on the card against the CPU's at n = 801 under the tests'
        tolerances; the phase's seconds.
     Small scenes rendered on the card and on the CPU (plain versions) must
     agree, for the fast preset (atmospheric, distance fog and no fog; its
     colours at the golden tolerance, at most 1% of pixels beyond 2/255),
     the fallback's spec, the fast frame
     (level, 1.1 rad down and across azimuth ±pi) and the exact frame at
     320 x 180 (guided, unguided and both marches without the own-texel
     leg; the unguided two-level frame's host syncs are printed);
  5. each kernel's own device time with torch.profiler, cold and warm as
     in phase 3, beside the event readings, before any path runs (see
     `device_times`); the ``kernels`` JSON line comes last (``ms``: the
     cold event reading; ``call_ms``: back-to-back calls, host included).

``--kernels-only`` runs phases 1 to 3, builds the 100-tile scene for K3's
config 5 origins, and the device times, and prints the
kernels line without launch counts and without the final result line; run
from a copy of this script placed beside another checkout's package, it
times that checkout's kernels the same way.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without
the package beside it, the script exits non-zero and prints no result.
Terrain and peaks are synthetic, made from a fixed seed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 1234
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_syncs(fn):
    """The operations inside one call of ``fn`` that make the host wait for
    the device (torch's sync debug mode), each as the innermost line of
    this repository on its stack and the innermost line of all."""
    import traceback
    import warnings

    import torch

    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1] if not f.filename.endswith("warnings.py")]
            ours = [f for f in stack if "topo_renderer_tpu_torch" in f.filename or "chip_smoke" in f.filename]
            found.append(" in ".join(f"{'/'.join(f.filename.rsplit('/', 2)[-2:])}:{f.lineno} {f.name}"
                                     for f in (stack[-1], *ours[-1:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found


def graph_ms(fn, replays: int = 20):
    """Device-only ms of one call of ``fn`` by CUDA events: ``fn`` captured
    once into a CUDA graph and replayed back to back, so that no host work
    runs between its kernels. Returns (ms, None), or (None, the reason)
    where ``fn`` cannot be captured (a host sync inside it, for one); the
    run goes on either way."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
    except Exception as exc:  # noqa: BLE001 - a measurement that cannot be made is reported
        torch.cuda.synchronize()
        return None, f"{type(exc).__name__}: {str(exc).strip().splitlines()[0][:160]}"
    ms = cuda_ms(graph.replay, iters=replays)
    del graph
    return ms, None


FLUSH_BYTES = 256 << 20  # written between cold launches: five times the H100's 50 MB L2
SPIN_CYCLES = 100_000_000  # ~50 ms of a spin kernel: the host queues a timed run behind it
_flush = []


def flush_l2():
    """Write FLUSH_BYTES of scratch on the device, so that the L2 holds
    none of the next launch's inputs."""
    import torch

    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda"))
    _flush[0].fill_(1)


def event_ms(fn, iters: int, cold: bool) -> float:
    """Device time per call of ``fn`` by CUDA events: one event pair around
    each call, ``iters`` calls, queued behind a spin kernel so that the host
    is ahead of the device and no host time falls inside a pair. With
    ``cold`` the L2 is flushed before each call, outside its pair."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in pairs:
        if cold:
            flush_l2()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def noop_floor(iters: int = 200) -> dict:
    """The card's floor: an empty kernel's device time (torch's spin kernel
    for 0 cycles), cold and warm, by `event_ms`."""
    import torch

    return {"cold": event_ms(lambda: torch.cuda._sleep(0), iters, cold=True),
            "warm": event_ms(lambda: torch.cuda._sleep(0), iters, cold=False)}


def launch_readings(what: str, fn, nbytes: int, iters: int) -> dict:
    """A kernel's cold and warm device time by `event_ms` against the bound
    of ``nbytes`` at 3.35 TB/s. A cold reading faster than 105% of that
    rate is impossible, so the measurement is wrong: it fails the run."""
    cold = event_ms(fn, iters, cold=True)
    rate = nbytes / (cold * 1e-3)
    if rate > 1.05 * HBM_BYTES_PER_S:
        raise AssertionError(f"{what}: a cold reading of {cold:.5f} ms for {nbytes / 1e6:.2f} MB is "
                             f"{rate / 1e12:.2f} TB/s, above 105% of the card's {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
                             "the measurement or the bytes counted are wrong")
    return dict(ms=cold, warm_ms=event_ms(fn, iters, cold=False), bytes=nbytes,
                bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


def device_ms(fn, iters: int, cold: bool) -> float:
    """Device time per call of ``fn`` by torch.profiler: the self device
    time of every kernel but the L2 flush's, over ``iters``; with ``cold``
    the L2 is flushed before each call as `event_ms` flushes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                flush_l2()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "FillFunctor" not in e.key]
    us = sum(e.self_device_time_total for e in events)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / iters


def device_times(kernels) -> None:
    """Phase 5: each kernel's device time by torch.profiler on its phase-3
    inputs, into ``device_ms`` (cold L2) and ``device_warm_ms`` of the
    kernel or of its shape's or origin set's entry, beside the event
    readings ``ms`` and ``warm_ms``. It runs before the paths: after them
    (their profiles, graph captures and traces) the profiler read K3 up to
    40% below the events, faster than the card's memory allows, while
    before them it agrees with the events within 1%."""
    for k in kernels:
        readings = []
        for where, fn, iters in k.pop("device_fns"):
            entry = k[where] if where else k
            entry["device_ms"] = device_ms(fn, iters, cold=True)
            entry["device_warm_ms"] = device_ms(fn, iters, cold=False)
            readings.append(f"{where or 'main'} {entry['device_ms']:.4f} ms cold (events "
                            f"{100 * (entry['device_ms'] / entry['ms'] - 1.0):+.1f}%), {entry['device_warm_ms']:.4f} "
                            f"warm (events {100 * (entry['device_warm_ms'] / entry['warm_ms'] - 1.0):+.1f}%)")
        log(f"{k['name']}: device time per launch by the profiler: " + "; ".join(readings))


# ---- synthetic scene ------------------------------------------------------

LAT0, LON0, TILES, TEXELS = 40, 7, 10, 1201  # tiles 40N..49N x 7E..16E


def terrain(lat, lon):
    """Smooth ridges and valleys as a function of (lat, lon) in degrees, so
    adjacent tiles agree on their shared seam texels."""
    rng = np.random.default_rng(SEED)
    h = np.full(np.broadcast(lat, lon).shape, 1400.0)
    for k in range(1, 6):
        fy, fx = rng.uniform(2.0, 9.0, 2) * k
        py, px = rng.uniform(0, 2 * np.pi, 2)
        h = h + (900.0 / k) * np.sin(fy * lat + py) * np.cos(fx * lon + px)
    return h.astype(np.float32)


def make_tile(lat, lon, n=TEXELS):
    """The COP-90-shaped tile whose SW corner is (lat, lon): (location,
    heights, transform), as `RenderEngine.add_terrain` takes them."""
    from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
    from topo_renderer_tpu_torch.geo import GeoLocation

    ps = 1.0 / (n - 1)
    lats = (lat + 1.0 - ps * np.arange(n))[:, None]
    lons = (lon + ps * np.arange(n))[None, :]
    return (
        GeoLocation.from_coord(lat, lon),
        terrain(lats, lons),
        CoordinateTransform(raster_point=(0.0, 0.0), model_point=(float(lon), float(lat + 1)), pixel_scale=(ps, ps)),
    )


def make_tiles(lat0=LAT0, lon0=LON0, tiles=TILES, n=TEXELS):
    return [make_tile(lat0 + ty, lon0 + tx, n) for ty in range(tiles) for tx in range(tiles)]


def make_peaks(center_lat, center_lon, count, radius_deg, lat0, lon0, tiles):
    """Peaks on the terrain around the camera, grouped by tile, Latin names."""
    from topo_renderer_tpu_torch.geo import GeoLocation
    from topo_renderer_tpu_torch.models.uniforms import PeakInstance
    from topo_renderer_tpu_torch.ops.geometry import ecef_from_geo

    rng = np.random.default_rng(SEED + 1)
    lats = np.clip(center_lat + rng.uniform(-radius_deg, radius_deg, count), lat0 + 1e-3, lat0 + tiles - 1e-3)
    lons = np.clip(center_lon + rng.uniform(-radius_deg, radius_deg, count), lon0 + 1e-3, lon0 + tiles - 1e-3)
    heights = terrain(lats, lons)
    by_tile: dict = {}
    order = np.argsort(-heights)  # elevation-sorted, as the fetch pipeline delivers
    for j, i in enumerate(order):
        loc = GeoLocation.from_coord(int(np.floor(lats[i])), int(np.floor(lons[i])))
        pos = ecef_from_geo(float(heights[i]) + 10.0, float(lons[i]), float(lats[i])).numpy()
        by_tile.setdefault(loc, []).append(PeakInstance(position=pos, name=f"Peak {j}"))
    return by_tile


def camera_at(lat, lon, height_above):
    from topo_renderer_tpu_torch.geo import GeoCoord
    from topo_renderer_tpu_torch.models.camera import Camera

    ground = float(terrain(np.array(lat), np.array(lon)))
    return Camera().reset(GeoCoord(lat, lon), ground + height_above)


def build_engine(device, tiles, peaks):
    from topo_renderer_tpu_torch.render.engine import RenderEngine

    engine = RenderEngine(device=device)
    for loc, heights, transform in tiles:
        engine.add_terrain(loc, heights, transform)
    for loc, lst in peaks.items():
        engine.add_peaks(loc, lst)
    return engine


# ---- phase 3: kernels against their plain versions -------------------------

def row_thresholds(h, half, centre=0.0):
    """tan(elevation) of ``h`` pixel rows from ``centre + half`` down to
    ``centre - half``; rows past -pi/2 flip the sign of their tangent."""
    rows = (np.arange(h, dtype=np.float32) + 0.5) / h
    return np.tan(np.float32(centre + half) - rows * np.float32(2 * half)).astype(np.float32)


def crossing_inputs(n=512, ws=2048, h=1024, half=None, centre=0.0):
    """A profile like the panorama's: tan-elevation random walks with
    spikes, normal codes as payloads, rows' tan(elevation) thresholds from
    ``centre + half`` down to ``centre - half`` (default: a full circle's
    square pixels at profile stride 2)."""
    import torch

    rng = np.random.default_rng(SEED + 2)
    e = np.cumsum(rng.normal(0, 0.01, (n, ws)), axis=0) - 0.2
    e += (rng.random((n, ws)) < 0.03) * rng.uniform(0.05, 0.4, (n, ws))
    e[rng.random((n, ws)) < 0.01] = -1.0e30  # samples outside the mosaic
    a = [rng.integers(0, 1024, (n, ws)).astype(np.float32) for _ in range(3)]
    t = row_thresholds(h, 0.5 * 2 * np.pi * h / (2 * ws) if half is None else half, centre)
    dev = torch.device("cuda")
    return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (e, *a)] + [torch.from_numpy(t).to(dev)]


def crossing_bytes(e, kstar):
    """Bytes the crossing search needs for this data: each column's profile
    up to its last crossing (all of it where a row stays sky), the three
    payloads at steps where some row crossed, and the six outputs."""
    import torch

    n, w = e.shape
    h = kstar.shape[0]
    sky = (kstar >= n).any(dim=0)
    last = torch.where(sky, n, kstar.amax(dim=0).to(torch.int64) + 1)
    crossed = torch.zeros((n + 1, w), dtype=torch.bool, device=e.device)
    crossed.scatter_(0, kstar.to(torch.int64), True)
    payload_cells = int(crossed[:n].sum())
    return 4 * (int(last.sum()) + 3 * payload_cells + h) + 6 * 4 * h * w


def check_crossing():
    import torch

    from topo_renderer_tpu_torch.ops import crossing as K

    e, a0, a1, a2, t = crossing_inputs()
    got = K.crossing_search(e, a0, a1, a2, t)
    torch.cuda.synchronize()
    want = K.crossing_search_plain(e, a0, a1, a2, t)
    err = 0.0
    for g, w, name in zip(got, want, ("kstar", "theta", "m_lo", "n0", "n1", "n2")):
        if not torch.equal(g, w):
            raise AssertionError(f"K1 {name}: {(g != w).sum().item()} elements differ from the plain version")
        err = max(err, (g - w).abs().max().item())
    perm = torch.randperm(t.shape[0], generator=torch.Generator().manual_seed(SEED)).to(t.device)
    got_p = K.crossing_search(e, a0, a1, a2, t[perm].contiguous())
    for g, w in zip(got_p, want):
        if not torch.equal(g, w[perm]):
            raise AssertionError("K1 with shuffled row order differs from the plain version")
    # Off the main path: odd shapes, NaN in the profile, NaN and -inf rows.
    odd = [x[:50, :200].contiguous() for x in (e, a0, a1, a2)]
    odd[0][7, 3:9] = float("nan")
    t_odd = t[::27].contiguous()
    t_odd[[2, 20]] = torch.tensor([float("nan"), float("-inf")], device=t.device)
    for g, w in zip(K.crossing_search(*odd, t_odd), K.crossing_search_plain(*odd, t_odd)):
        if not torch.equal(g, w):
            raise AssertionError("K1 differs from the plain version on odd shapes / NaN inputs")
    config4 = k1_readings("config 4's shape", e, t, lambda: K.crossing_search(e, a0, a1, a2, t),
                          lambda: K.crossing_search_plain(e, a0, a1, a2, t), crossing_bytes(e, want[0]), iters=50)
    # The batch path's shape: 1024x256 panoramas with profile stride 2.
    eb, b0, b1, b2, tb = crossing_inputs(n=512, ws=512, h=256)
    want_b = K.crossing_search_plain(eb, b0, b1, b2, tb)
    if not all(torch.equal(g, w) for g, w in zip(K.crossing_search(eb, b0, b1, b2, tb), want_b)):
        raise AssertionError("K1 differs from the plain version at the batch path's shape")
    # Config 2's shape: 2048x512 panoramas of 512 steps with profile stride 2.
    e2, c0, c1, c2, t2 = crossing_inputs(n=512, ws=1024, h=512)
    if not all(torch.equal(g, w) for g, w in zip(K.crossing_search(e2, c0, c1, c2, t2),
                                                 K.crossing_search_plain(e2, c0, c1, c2, t2))):
        raise AssertionError("K1 differs from the plain version at config 2's shape")
    del e2, c0, c1, c2, t2
    batch_shape = k1_readings("the batch path's shape", eb, tb, lambda: K.crossing_search(eb, b0, b1, b2, tb),
                              lambda: K.crossing_search_plain(eb, b0, b1, b2, tb), crossing_bytes(eb, want_b[0]))
    ef, f0, f1, f2, tf, steep = fast_frame_crossing_inputs()
    want_f = K.crossing_search_plain(ef, f0, f1, f2, tf)
    for name, rows in (("level", tf), ("1.1 rad down", steep)):
        want_rows = want_f if rows is tf else K.crossing_search_plain(ef, f0, f1, f2, rows)
        if not all(torch.equal(g, w) for g, w in zip(K.crossing_search(ef, f0, f1, f2, rows), want_rows)):
            raise AssertionError(f"K1 differs from the plain version at the fast frame's shape ({name})")
    fast_shape = k1_readings("the 800x450 fast frame's shape, level rows", ef, tf,
                             lambda: K.crossing_search(ef, f0, f1, f2, tf),
                             lambda: K.crossing_search_plain(ef, f0, f1, f2, tf), crossing_bytes(ef, want_f[0]))
    profiles, z, rows = prepass_crossing_inputs()
    for (pname, prof), (rname, thr) in ((p, r) for p in profiles.items() for r in rows.items()):
        if not all(torch.equal(g, w) for g, w in zip(K.crossing_search(prof, z, z, z, thr),
                                                     K.crossing_search_plain(prof, z, z, z, thr))):
            raise AssertionError(f"K1 differs from the plain version at the prepass shape ({pname}, {rname})")
    ep, tp = profiles["exact profile"], rows["level"]
    kstar_p = K.crossing_search_plain(ep, z, z, z, tp)[0]
    sky = (kstar_p >= ep.shape[0]).any(dim=0)
    last = torch.where(sky, ep.shape[0], kstar_p.amax(dim=0).to(torch.int64) + 1).double()
    full_bytes = 4 * (4 * ep.numel() + tp.numel()) + 6 * 4 * tp.shape[0] * ep.shape[1]
    prepass_shape = k1_readings("the 800x450 exact frame's prepass shape (the exact profile, level rows, zero "
                                "payloads)", ep, tp, lambda: K.crossing_search(ep, z, z, z, tp),
                                lambda: K.crossing_search_plain(ep, z, z, z, tp), crossing_bytes(ep, kstar_p))
    prepass_shape.update(profile="exact profile, level rows", bound_all_read_ms=1e3 * full_bytes / HBM_BYTES_PER_S,
                         sky_columns=float(sky.double().mean()), mean_last_step=float(last.mean()))
    log(f"K1 at the prepass shape timed on: crossing_inputs(n={ep.shape[0]}, ws={ep.shape[1]}, h={tp.shape[0]}) "
        f"(seed {SEED + 2}), the exact profile and the level view's rows; columns with a sky row "
        f"{100 * prepass_shape['sky_columns']:.1f}%, mean last step read {prepass_shape['mean_last_step']:.1f} of "
        f"{ep.shape[0]}; bound {prepass_shape['bound_all_read_ms']:.5f} ms reading every input")
    return dict(
        name="crossing_search", route="cuda", source="topo_renderer_tpu_torch/csrc/crossing.cu",
        replaces="topo_renderer_tpu/ops/pallas_crossing.py:124", max_abs_err=err, bound_by="bytes",
        library_ms=None, **config4, batch_shape=batch_shape, fast_shape=fast_shape, prepass_shape=prepass_shape,
        device_fns=[(None, lambda: K.crossing_search(e, a0, a1, a2, t), 50),
                    ("batch_shape", lambda: K.crossing_search(eb, b0, b1, b2, tb), 200),
                    ("fast_shape", lambda: K.crossing_search(ef, f0, f1, f2, tf), 200),
                    ("prepass_shape", lambda: K.crossing_search(ep, z, z, z, tp), 200)],
    )


def k1_readings(where, e, t, fn, plain_fn, nbytes, iters=200):
    """K1's readings at the shape of profile ``e`` and rows ``t``:
    back-to-back calls (CUDA events, host included), cold and warm device
    time (`launch_readings`), the plain version's calls."""
    r = dict(shape=[*e.shape, t.shape[0]], call_ms=cuda_ms(fn, iters=iters, warmup=3),
             **launch_readings(f"K1 at {where}", fn, nbytes, iters), plain_ms=cuda_ms(plain_fn, iters=3))
    log(f"K1 crossing_search at {where}: exact; device {r['ms']:.4f} ms cold, {r['warm_ms']:.4f} warm (CUDA "
        f"events per launch), {r['call_ms']:.4f} ms per call back to back; bound {r['bound_ms']:.5f} ms "
        f"({nbytes / 1e6:.2f} MB this data needs), plain {r['plain_ms']:.3f} ms")
    return r


def prepass_crossing_inputs():
    """K1's inputs at the 800 x 450 exact frame's prepass shape
    (`guided_prepass_spec` at the 45 degree fov bucket: N 896, W 1152, H
    840) with zero payloads, as `panorama_crossing_prepass` calls it: an
    exact profile, and a bound profile above it with NEG rows where the near
    segments skip the bound (the plan of the 12001^2 mosaic's pyramid) and
    columns that leave the mosaic (all NEG); the rows' tan(elevation) of a
    level view and of a view 1.1 rad down, whose lowest rows pass -pi/2."""
    import math
    import types

    import torch

    from topo_renderer_tpu_torch.models.scene import _mip_shapes
    from topo_renderer_tpu_torch.ops.panorama import NEG_RATIO, _prepass_bound_plan
    from topo_renderer_tpu_torch.ops.raycast import guided_prepass_spec

    spec, half_win, _ = guided_prepass_spec(height=FAST_H, fov_hint=math.radians(45.0), aspect=FAST_W / FAST_H,
                                            n_steps=1024)
    e, _, _, _, t = crossing_inputs(n=spec.n_steps, ws=spec.width, h=spec.height, half=half_win)
    mosaic = types.SimpleNamespace(mip_shapes=_mip_shapes(12001, 12001), texel_m=92.6)
    levels, src = _prepass_bound_plan(spec, mosaic, 64, 4)
    near = torch.from_numpy(src == sum(len(r) for r in levels.values())).to(e.device)
    rng = np.random.default_rng(SEED + 8)
    bound = e + torch.from_numpy(rng.uniform(0.0, 0.05, e.shape).astype(np.float32)).to(e.device)
    bound[near] = NEG_RATIO
    bound[:, torch.from_numpy(rng.random(e.shape[1]) < 0.05).to(e.device)] = NEG_RATIO
    steep = torch.from_numpy(row_thresholds(spec.height, half_win, centre=-1.1)).to(t.device)
    return {"exact profile": e, "bound profile": bound}, torch.zeros_like(e), {"level": t, "1.1 rad down": steep}


def fast_frame_crossing_inputs():
    """K1's inputs at the 800 x 450 fast frame's shape (`fast_view_spec` at
    the 45 degree fov bucket: a 1536 x 1056 window at profile stride 2, so N
    512, W 768, H 1056), with the window's row thresholds for a level view
    and for a view 1.1 rad down, whose lowest rows pass -pi/2."""
    import math

    import torch

    from topo_renderer_tpu_torch.ops.raycast import fast_view_spec

    spec, half_win, _ = fast_view_spec(width=800, height=450, fov_hint=math.radians(45.0), n_steps=512)
    ws = spec.width // spec.profile_stride
    e, a0, a1, a2, t = crossing_inputs(n=spec.n_steps, ws=ws, h=spec.height, half=half_win)
    steep = torch.from_numpy(row_thresholds(spec.height, half_win, centre=-1.1)).to(t.device)
    return e, a0, a1, a2, t, steep


def check_crossing_edges():
    """K1 against its plain version where the kernel's chunks show: ties,
    N not a multiple of the chunk, crossings on a chunk's first step, NaNs
    on either side of a chunk edge, shuffled rows at the batch shape, a
    width that is not a multiple of 4 and a profile that is not 16-byte
    aligned (both take the 4-byte loads; phase 3's 50 x 200 case takes the
    16-byte loads on a ragged column tile)."""
    import torch

    from topo_renderer_tpu_torch.ops import crossing as K

    def same(name, e, a0, a1, a2, t):
        got = K.crossing_search(e, a0, a1, a2, t)
        torch.cuda.synchronize()
        for g, w, field in zip(got, K.crossing_search_plain(e, a0, a1, a2, t), ("kstar", "theta", "m_lo", "n0",
                                                                                "n1", "n2")):
            if not torch.equal(g, w):
                raise AssertionError(f"K1 {name} {field}: {(g != w).sum().item()} elements differ "
                                     "from the plain version")

    chunk = K.CHUNK
    gen = torch.Generator().manual_seed(SEED + 6)
    e, a0, a1, a2, t = crossing_inputs(n=509, ws=301, h=77)
    same("N=509 W=301", e, a0, a1, a2, t)
    m = torch.cummax(e, dim=0).values.flatten()
    pick = torch.randint(0, m.numel(), (77,), generator=gen).to(e.device)
    ties = torch.cat([m[pick[:50]], e.flatten()[pick[50:]]]).contiguous()
    same("ties", e, a0, a1, a2, ties)
    edges = e.clone()
    top = float(e.max())
    steps = [k for k in (chunk, 2 * chunk, 4 * chunk) if k < e.shape[0]]
    for j, k in enumerate(steps):
        edges[k, 40 * j : 40 * j + 60] = top + 1.0 + j
    t_edge = t.clone()
    t_edge[: 3 * len(steps)] = torch.tensor([top + 0.5 + j + d for j in range(len(steps)) for d in (0.0, 0.25, 0.4)],
                                            device=t.device)
    same("crossings on a chunk's first step", edges, a0, a1, a2, t_edge)
    nans = edges.clone()
    nans[chunk - 1, 0:30] = float("nan")
    nans[chunk, 100:130] = float("nan")
    nans[2 * chunk - 1, 200:230] = float("nan")
    same("NaN at chunk edges", nans, a0, a1, a2, t_edge)
    eb, b0, b1, b2, tb = crossing_inputs(n=512, ws=512, h=256)
    same("W=512 H=256 shuffled rows", eb, b0, b1, b2, tb[torch.randperm(256, generator=gen).to(tb.device)])
    flat = torch.empty(eb.numel() + 1, device=eb.device)
    flat[1:] = eb.flatten()
    same("unaligned profile at W=512", flat[1:].view(eb.shape), b0, b1, b2, tb)
    log(f"K1 crossing_search: exact on ties, N=509 W=301, crossings on chunk-first steps {steps}, NaN at "
        f"chunk edges, an unaligned profile and shuffled rows at W=512 H=256 (chunk {chunk})")


def window_tables(seed=SEED):
    """The four windowed levels of the 12001^2 mosaic, with random heights
    and packed-normal words, a fifth of them denormal patterns."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    tables = []
    for h in (12001, 6000, 3000, 1500):
        words = torch.randint(0, 1 << 30, (2, h, h), generator=g, device="cuda", dtype=torch.int32)
        mask = torch.rand((h, h), generator=g, device="cuda") < 0.2
        words[1] = torch.where(mask, words[1] & 0x7FFFFF, words[1])
        words[0] = torch.rand((h, h), generator=g, device="cuda").mul_(3000.0).view(torch.int32)
        tables.append(words.view(torch.float32))
    return tables


def check_window_slice():
    import torch

    from topo_renderer_tpu_torch.ops import window_slice as K

    tables = window_tables()
    wsy, wsx = 272, 512
    rng = np.random.default_rng(SEED + 3)
    origins = np.array(
        [[rng.integers(0, (t.shape[1] - wsy) // 8) * 8, rng.integers(0, (t.shape[2] - wsx) // 128) * 128]
         for t in tables], np.int32,
    )
    origins[-1] = (tables[-1].shape[1] - wsy + 5, 7)  # clamped start, unaligned column
    org = torch.from_numpy(origins).cuda()
    got = K.window_slice_multi(tables, org, wsy=wsy, wsx=wsx)
    want = K.window_slice_multi_plain(tables, org, wsy=wsy, wsx=wsx)
    for level, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"K2 level {level}: window bits differ from the plain version")
    one = K.window_slice(tables[0], org[0], wsy=wsy, wsx=wsx)
    if not torch.equal(one.view(torch.int32), want[0].view(torch.int32)):
        raise AssertionError("K4: window bits differ from the plain version")
    # Two table sets of the same shapes in turn: each call must copy its own.
    others = window_tables(SEED + 7)
    for round_ in range(2):
        for tabs in (others, tables):
            got = K.window_slice_multi(tabs, org, wsy=wsy, wsx=wsx)
            for level, (g, w) in enumerate(zip(got, K.window_slice_multi_plain(tabs, org, wsy=wsy, wsx=wsx))):
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"K2 level {level}, table sets in turn (round {round_}): window bits "
                                         "differ from the plain version")
    del others
    # A set whose windows differ in shape (a 2-D table among 3-D ones).
    mixed = [tables[0], tables[2][1], tables[3]]
    got = K.window_slice_multi(mixed, org[[0, 2, 3]], wsy=wsy, wsx=wsx)
    for level, (g, w) in enumerate(zip(got, K.window_slice_multi_plain(mixed, org[[0, 2, 3]], wsy=wsy, wsx=wsx))):
        if g.shape != w.shape or not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"K2 level {level} of a mixed 2-D/3-D table set: window bits differ")
    # The library yardstick: one `copy_` per level with the origin as host
    # ints (K4: one call; K2: L calls).
    starts = [(min(max(sy, 0), t.shape[1] - wsy), min(max(sx, 0), t.shape[2] - wsx))
              for t, (sy, sx) in zip(tables, origins.tolist())]
    outs = [torch.empty_like(w) for w in want]

    def library(n):
        for out, t, (sy, sx) in zip(outs[:n], tables, starts[:n]):
            out.copy_(t[:, sy : sy + wsy, sx : sx + wsx])

    library(len(tables))
    if not all(torch.equal(o.view(torch.int32), w.view(torch.int32)) for o, w in zip(outs, want)):
        raise AssertionError("K2's library yardstick (copy_ of each window) differs from the plain version")
    win_bytes = 2 * wsy * wsx * 4
    rows = []
    for name, replaces, n, fn in (
        ("window_slice_multi", "topo_renderer_tpu/ops/pallas_dma.py:68", len(tables),
         lambda: K.window_slice_multi(tables, org, wsy=wsy, wsx=wsx)),
        ("window_slice", "topo_renderer_tpu/ops/pallas_dma.py:30", 1,
         lambda: K.window_slice(tables[0], org[0], wsy=wsy, wsx=wsx)),
    ):
        r = launch_readings(name, fn, 2 * n * win_bytes, iters=200)
        r.update(call_ms=cuda_ms(fn, iters=200, warmup=5),
                 plain_ms=cuda_ms(lambda n=n: K.window_slice_multi_plain(tables[:n], org[:n], wsy=wsy, wsx=wsx),
                                  iters=20),
                 library_ms=event_ms(lambda n=n: library(n), 200, cold=True),
                 library_warm_ms=event_ms(lambda n=n: library(n), 200, cold=False), library_calls=n)
        log(f"{name}: bit-exact; device {r['ms']:.4f} ms cold, {r['warm_ms']:.4f} warm (CUDA events per launch), "
            f"{r['call_ms']:.4f} ms per call back to back; bound {r['bound_ms']:.5f} ms ({r['bytes'] / 1e6:.2f} MB), "
            f"{n} copy_ call(s) {r['library_ms']:.4f} ms cold, {r['library_warm_ms']:.4f} warm; plain "
            f"{r['plain_ms']:.3f} ms")
        rows.append(dict(name=name, route="cuda", source="topo_renderer_tpu_torch/csrc/window_slice.cu",
                         replaces=replaces, max_abs_err=0.0, bound_by="bytes", **r, device_fns=[(None, fn, 200)]))
    log("K2 window_slice_multi: bit-exact on 4 levels, on two table sets in turn and on a mixed 2-D/3-D set; "
        "K4 window_slice: bit-exact")
    return rows


def batched_origins(tables, batch, wsy, wsx):
    """Random (8, 128)-aligned origins for every viewpoint and level, with
    some clamped (past either edge) and some unaligned ones planted."""
    import torch

    rng = np.random.default_rng(SEED + 4)
    origins = np.stack([
        np.stack([rng.integers(0, (t.shape[1] - wsy) // 8, batch) * 8,
                  rng.integers(0, (t.shape[2] - wsx) // 128, batch) * 128], axis=-1)
        for t in tables
    ], axis=1).astype(np.int32)  # [B, L, 2]
    h0, w0 = tables[0].shape[1:]
    origins[5, 0] = (h0 - wsy + 13, w0 - wsx + 300)  # past the far edge
    origins[9, 2] = (-5, -700)  # before the origin
    origins[17, 1] = (1001, 333)  # unaligned
    origins[-1, :, 1] += 7  # unaligned columns on every level
    return torch.from_numpy(origins).cuda()


def batched_bytes(tables, org, wsy, wsx):
    """Bytes the batched copy must move for these origins: each table texel
    that some window covers read once (the viewpoints' windows overlap on
    the smaller levels), every window written once."""
    import torch

    total = 0
    for lv, t in enumerate(tables):
        h, w = t.shape[-2:]
        cover = torch.zeros((h, w), dtype=torch.bool, device=t.device)
        for y, x in org[:, lv].tolist():
            y, x = min(max(y, 0), h - wsy), min(max(x, 0), w - wsx)  # clamped as the copy clamps
            cover[y : y + wsy, x : x + wsx] = True
        planes = t.shape[0] if t.dim() == 3 else 1
        total += 4 * planes * (int(cover.sum()) + org.shape[0] * wsy * wsx)
    return total


def k3_readings(what, tables, org, wsy, wsx):
    """K3 against its plain version at origins ``org`` ``i32[B, L, 2]``
    (bit for bit), then its readings there: cold and warm device time
    against the bytes these origins need (`batched_bytes`), back-to-back
    calls and the plain version's calls. Returns (readings, the call)."""
    import torch

    from topo_renderer_tpu_torch.ops import window_slice as K

    def fn():
        return K.window_slice_multi_batched(tables, org, wsy=wsy, wsx=wsx)

    got = fn()
    torch.cuda.synchronize()
    want = K.window_slice_multi_batched_plain(tables, org, wsy=wsy, wsx=wsx)
    for level, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"K3 at {what}, level {level}: window bits differ from the plain version")
    del got, want
    batch = org.shape[0]
    r = dict(origins=what, **launch_readings(f"K3 at {what}", fn, batched_bytes(tables, org, wsy, wsx), iters=20))
    out_words = sum((t.shape[0] if t.dim() == 3 else 1) * batch * wsy * wsx for t in tables)
    every = 2 * 4 * out_words
    # The write floor: the windows' bytes written alone, by one zero_.
    writes = torch.empty(out_words, dtype=torch.int32, device=org.device)
    r.update(call_ms=cuda_ms(fn, iters=20, warmup=2), bound_every_window_ms=1e3 * every / HBM_BYTES_PER_S,
             writes_only_ms=event_ms(writes.zero_, 20, cold=True),
             plain_ms=cuda_ms(lambda: K.window_slice_multi_batched_plain(tables, org, wsy=wsy, wsx=wsx), iters=2))
    del writes
    log(f"K3 window_slice_multi_batched at {what}: bit-exact on B={batch} x {len(tables)} levels; device "
        f"{r['ms']:.4f} ms cold, {r['warm_ms']:.4f} warm (CUDA events per launch), {r['call_ms']:.4f} ms per call "
        f"back to back; bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e9:.3f} GB: the covered table texels once, "
        f"the windows written once), {r['bound_every_window_ms']:.4f} ms reading every window "
        f"({every / 1e9:.3f} GB); the windows' bytes written alone (one zero_) {r['writes_only_ms']:.4f} ms cold; "
        f"plain {r['plain_ms']:.3f} ms")
    return r, fn


def check_window_slice_batched(batch=256):
    """K3 at phase 3's random origins. The row's main readings come from
    config 5's own origins (`config5_window_readings`); no single PyTorch
    call takes per-eye origins that live on the device, so it has no
    library time."""
    from topo_renderer_tpu_torch.ops import window_slice as K

    tables = window_tables()
    wsy, wsx = 272, 512
    org = batched_origins(tables, batch, wsy, wsx)
    r, fn = k3_readings("phase 3's random (8, 128)-aligned origins", tables, org, wsy, wsx)
    k2_loop = cuda_ms(lambda: [K.window_slice_multi(tables, org[b], wsy=wsy, wsx=wsx) for b in range(batch)],
                      iters=3)
    log(f"K3 at the random origins: {batch} x K2 {k2_loop:.3f} ms")
    return dict(
        name="window_slice_multi_batched", route="cuda", source="topo_renderer_tpu_torch/csrc/window_slice.cu",
        replaces="topo_renderer_tpu/ops/pallas_dma.py:113", max_abs_err=0.0, bound_by="bytes", library_ms=None,
        random_origins=dict(r, k2_loop_ms=k2_loop), device_fns=[("random_origins", fn, 20)],
    )


def config5_window_readings(k3, engine, centre, batch=256):
    """K3 at config 5's own origins: the ``i32[256, L, 2]`` that
    `ops/panorama.py::_window_batch` computes for `batch_eyes` and hands to
    K3, on the 100-tile scene's ``win_attr_2d`` tables at the path's window
    shape. Its readings become K3's main ones."""
    import torch

    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, _window_batch

    spec = PanoramaSpec.fast(1024, 256, n_steps=512)
    wb = _window_batch(engine.mosaic, batch_eyes(centre, batch), spec)
    levels = sorted(wb.wins)
    tables = [engine.mosaic.win_attr_2d[lv] for lv in levels]
    org = torch.stack([torch.stack([wb.sy[lv], wb.sx[lv]], dim=-1) for lv in levels], dim=1).contiguous()
    wsy, wsx = wb.wins[levels[0]].shape[-2:]
    del wb
    r, fn = k3_readings(f"config 5's own origins (levels {levels})", tables, org, wsy, wsx)
    k3.update(r)
    k3["device_fns"].insert(0, (None, fn, 20))


# ---- phase 4: the engine's panoramas ------------------------------------------

def _counted():
    from topo_renderer_tpu_torch.ops import crossing, window_slice

    return {
        "crossing_search": crossing.crossing_search,
        "window_slice_multi": window_slice.window_slice_multi,
        "window_slice_multi_batched": window_slice.window_slice_multi_batched,
        "window_slice": window_slice.window_slice,
    }


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def expect_counts(what, counts, want):
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{what}: {name} launched {counts[name]} times, not {n}")


def frame_profile(render, top=12, host_top=0):
    """Device time of one frame by kernel (torch.profiler), and the share of
    the frame's host-clock time the device was busy; with ``host_top`` also
    the host operations that took the most host time. Returns (host ms,
    device busy ms), or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        log("profile: the profiler saw no device time")
        return None
    log(f"profile: frame {wall_us / 1e3:.2f} ms host clock, device busy {device_us / 1e3:.2f} ms "
        f"({100 * device_us / wall_us:.1f}%), {sum(e.count for e in events)} device ops")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:host_top]:
        log(f"  host {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:85]}")
    return wall_us / 1e3, device_us / 1e3


def build_scene():
    import torch

    t0 = time.perf_counter()
    tiles = make_tiles()
    c_lat, c_lon = LAT0 + TILES / 2 + 0.13, LON0 + TILES / 2 + 0.21
    peaks = make_peaks(c_lat, c_lon, 256, 0.3, LAT0, LON0, TILES)
    engine = build_engine(None, tiles, peaks)
    del tiles
    log(f"scene: 100 tiles, {sum(len(v) for v in peaks.values())} peaks, made in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mosaic = engine.mosaic
    torch.cuda.synchronize()
    log(f"mosaic {mosaic.shape} built on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    if mosaic.shape != (12001, 12001):
        raise AssertionError(f"mosaic shape {mosaic.shape} != (12001, 12001)")
    return engine, (c_lat, c_lon)


def mosaic_accessors(engine):
    """Phase 4a0: the 12001^2 mosaic's accessors on the card. `heights`,
    `normals_packed` (uint32) and `normals` (f32 [H, W, 3]) must be card
    tensors of the mosaic's shape; the packed words equal the attribute
    table's bits and the decoded normals the CPU decode (`unpack_normals`)
    of those words pulled to the host, bit for bit; `valid`, `cell_tile` and
    `tile_rot` are the build's host arrays. No kernel launches."""
    import torch

    from topo_renderer_tpu_torch.models.scene import unpack_normals

    m = engine.mosaic
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heights, packed, normals = m.heights, m.normals_packed, m.normals
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    expect_counts("mosaic accessors", read_counts(), {name: 0 for name in _counted()})
    if not (heights.is_cuda and packed.is_cuda and normals.is_cuda) or packed.dtype != torch.uint32:
        raise AssertionError(f"mosaic accessors: {heights.device}, {packed.device} {packed.dtype}, {normals.device}")
    if heights.shape != m.shape or packed.shape != m.shape or normals.shape != (*m.shape, 3):
        raise AssertionError(f"mosaic accessors: shapes {heights.shape}, {packed.shape}, {normals.shape}")
    t0 = time.perf_counter()
    words = m.attr_packed_flat[:, 1].cpu().view(torch.int32).reshape(m.shape)
    want = torch.stack(unpack_normals(words), dim=-1)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(packed.cpu().view(torch.int32), words):
        raise AssertionError("mosaic accessors: normals_packed differs from the attribute table's words")
    if not torch.equal(normals.cpu().view(torch.int32), want.view(torch.int32)):
        differ = (normals.cpu().view(torch.int32) != want.view(torch.int32)).any(dim=-1).float().mean().item()
        raise AssertionError(f"mosaic accessors: normals differ from the CPU decode on {100 * differ:.4f}% of texels")
    if not torch.equal(heights.view(-1), m.heights_flat):
        raise AssertionError("mosaic accessors: heights differ from heights_flat")
    valid, cell_tile, tile_rot = (np.asarray(getattr(m, name)) for name in ("valid", "cell_tile", "tile_rot"))
    if valid.shape != m.shape or cell_tile.shape != m.shape or tile_rot.shape != (len(engine._tiles), 3, 3):
        raise AssertionError(f"mosaic accessors: host arrays {valid.shape}, {cell_tile.shape}, {tile_rot.shape}")
    unit = torch.linalg.vector_norm(normals[1:-1, 1:-1].double(), dim=-1)
    log(f"mosaic accessors (phase 4a0): heights, normals_packed (uint32) and normals {tuple(normals.shape)} on the "
        f"card in {card_ms:.0f} ms host clock, no kernel launched; the packed words equal the attribute table's and "
        f"the normals the CPU decode of those words pulled to the host ({cpu_ms:.0f} ms), bit for bit, on "
        f"{packed.numel()} texels; |n| of the inner texels {unit.min().item():.5f}-{unit.max().item():.5f}; valid "
        f"{valid.mean():.4f} of texels, cell_tile {cell_tile.shape}, tile_rot {tile_rot.shape}")
    del heights, packed, normals, words, want, unit
    torch.cuda.empty_cache()


def panorama_path(engine, centre, frames=3):
    """Phase 4a: the labelled 4096 x 1024 panorama. Returns the launch
    counts of one frame and the frame's time by CUDA events."""
    import torch

    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec

    cam = camera_at(*centre, 300.0)
    spec = PanoramaSpec.fast(4096, 1024, n_steps=512)
    engine.render_panorama(cam, spec, fog="atmosphere")  # first frame: allocator warm-up
    torch.cuda.synchronize()
    per_frame = None
    for i in range(frames):
        reset_counts()
        t0 = time.perf_counter()
        res = engine.render_panorama(cam, spec, fog="atmosphere")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        per_frame = read_counts()
        expect_counts(f"frame {i}", per_frame, {"crossing_search": 1, "window_slice_multi": 1,
                                                "window_slice_multi_batched": 0})
        hit = float(res.hit.mean())
        colors = len(np.unique(res.color.reshape(-1, 3), axis=0))
        n_labels = sum(len(v) for v in res.visible_labels.values())
        if res.color.shape != (1024, 4096, 3) or not np.isfinite(res.color_linear).all():
            raise AssertionError(f"frame {i}: bad color output")
        if not 0.0 < hit < 1.0 or colors <= 200 or n_labels < 1:
            raise AssertionError(f"frame {i}: hit {hit:.3f}, {colors} colours, {n_labels} labels")
        log(f"frame {i}: {ms:.1f} ms host clock, hit {hit:.3f}, {colors} colours, {n_labels} labels")
    frame_ms = cuda_ms(lambda: engine.render_panorama(cam, spec, fog="atmosphere"), iters=5)
    log(f"frame (CUDA events, 5 frames): {frame_ms:.2f} ms")
    frame_profile(lambda: engine.render_panorama(cam, spec, fog="atmosphere"))
    return per_frame, frame_ms


def config2_path(engine, centre, calls=5):
    """Phase 4a2, bench.py's config 2: the 2048 x 512 panorama of 512 steps
    with distance fog, in bench.py's form (`extract_clipmap_windows`, then
    the functional `render_panorama` with those windows and bench.py's sun;
    no labels) on phase 4a's camera. Every call must launch K1 and K2 once,
    take K2's launch arguments from the entry phase 4a's frames left in the
    cache (the engine's tables, the same window shape), hit terrain and sky
    and have > 200 colours. Returns the launch counts of one call and its
    readings: the host-clock median of ``calls`` calls after a warm-up, the
    host syncs inside a call and, where there are none, the device-only ms
    by CUDA-graph replay."""
    import torch

    from topo_renderer_tpu_torch.ops import window_slice
    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, extract_clipmap_windows, render_panorama
    from topo_renderer_tpu_torch.ops.shading import to_srgb8_image

    eye = camera_at(*centre, 300.0).eye
    sun = torch.tensor([0.3, 0.5, 0.8])  # bench.py's
    spec = PanoramaSpec.fast(width=2048, height=512, n_steps=512)

    def call():
        win = extract_clipmap_windows(engine.mosaic, eye, spec)
        return render_panorama(engine.mosaic, eye, spec, sun, fog="distance", windows=win)

    t_phase = time.perf_counter()
    cached = set(window_slice._args_cache)
    call()  # warm-up
    torch.cuda.synchronize()
    host_ms, counts = [], None
    for i in range(calls):
        reset_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        counts = read_counts()
        expect_counts(f"config 2 call {i}", counts, {"crossing_search": 1, "window_slice_multi": 1,
                                                     "window_slice_multi_batched": 0, "window_slice": 0})
    if set(window_slice._args_cache) != cached:
        raise AssertionError("config 2: K2's launch arguments were built anew, not found in the cache")
    color = to_srgb8_image(out["color"]).cpu().numpy()
    hit = float(out["hit"].float().mean())
    colors = len(np.unique(color.reshape(-1, 3), axis=0))
    if color.shape != (512, 2048, 3) or not bool(torch.isfinite(out["color"]).all()):
        raise AssertionError(f"config 2: bad colour output {color.shape}")
    if not 0.0 < hit < 1.0 or colors <= 200:
        raise AssertionError(f"config 2: hit {hit:.3f}, {colors} colours")
    syncs = host_syncs(call)
    dev_ms, why = graph_ms(call) if not syncs else (None, f"{len(syncs)} host syncs inside a call")
    check_config2_kernels(call)
    log(f"config 2: 2048x512 panorama, 512 steps, distance fog (bench.py's extract_clipmap_windows + "
        f"render_panorama): median {np.median(host_ms):.2f} ms host clock of {calls} calls "
        f"({', '.join(f'{ms:.2f}' for ms in host_ms)}), {len(syncs)} host syncs inside a call, device only "
        f"{'not measured (' + why + ')' if dev_ms is None else f'{dev_ms:.3f} ms'} (CUDA graph replay); "
        f"K1 {counts['crossing_search']}, K2 {counts['window_slice_multi']} per call, K2's launch arguments from "
        f"the cache; hit {hit:.3f}, {colors} colours")
    for where in syncs:
        log(f"  config 2 host sync: {where}")
    phase_s = time.perf_counter() - t_phase
    log(f"config 2 phase: {phase_s:.1f} s in all (warm-up, timed calls, sync count, graph replay, kernel checks)")
    return counts, {"host_ms": host_ms, "host_syncs": len(syncs), "graph_ms": dev_ms, "phase_s": phase_s}


def caught_kernel_inputs(call, names):
    """Run ``call()`` with the kernel wrappers ``names`` wrapped at the
    names `ops/panorama.py` calls them by; returns each one's last inputs,
    ``{name: (args, kw)}``."""
    from topo_renderer_tpu_torch.ops import panorama

    seen = {}

    def catch(name, fn):
        def wrapper(*args, **kw):
            seen[name] = (args, kw)
            return fn(*args, **kw)
        return wrapper

    real = {name: getattr(panorama, name) for name in names}
    for name, fn in real.items():
        setattr(panorama, name, catch(name, fn))
    try:
        call()
    finally:
        for name, fn in real.items():
            setattr(panorama, name, fn)
    if set(seen) != set(real):
        raise AssertionError(f"caught {sorted(seen)} of {sorted(real)}'s inputs")
    return seen


def hold_to_plain(what, seen):
    """Each caught kernel input run through the kernel and its plain
    version: equal bit for bit (window words as int32). Returns a line that
    names the shapes."""
    import torch

    from topo_renderer_tpu_torch.ops import crossing, window_slice

    done = []
    if "crossing_search" in seen:
        args, kw = seen["crossing_search"]
        got, want = crossing.crossing_search(*args, **kw), crossing.crossing_search_plain(*args, **kw)
        for g, w, name in zip(got, want, ("kstar", "theta", "m_lo", "n0", "n1", "n2")):
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: K1 {name} differs from the plain version in "
                                     f"{(g != w).sum().item()} elements")
        done.append(f"K1 at N {args[0].shape[0]}, W {args[0].shape[1]}, H {args[4].shape[0]}")
    for name, k, plain in (("window_slice_multi", "K2", window_slice.window_slice_multi_plain),
                           ("window_slice_multi_batched", "K3", window_slice.window_slice_multi_batched_plain)):
        if name not in seen:
            continue
        args, kw = seen[name]
        got, want = getattr(window_slice, name)(*args, **kw), plain(*args, **kw)
        for level, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{what}: {k} window {level} differs from the plain version")
        eyes = f"{got[0].shape[0]} eyes x " if k == "K3" else ""
        done.append(f"{k} at {eyes}{len(got)} windows of {kw['wsy']} x {kw['wsx']} words")
    return " and ".join(done)


def check_config2_kernels(call):
    """Hold K1 and K2 against their plain versions bit for bit on the very
    inputs one config-2 call gives them."""
    shapes = hold_to_plain("config 2", caught_kernel_inputs(call, ("crossing_search", "window_slice_multi")))
    log(f"config 2's own kernel inputs: {shapes} equal their plain versions bit for bit")


def batch_eyes(centre, count, alt=2500.0):
    """``count`` viewpoints spread +-0.8 deg around ``centre`` at ``alt``
    metres above the sphere, as bench.py's config 5 places them
    (`scripts/perf_probe.py::eye_at`). Draws over terrain higher than
    ``alt - 300`` are skipped, so no eye sits inside a ridge."""
    import torch

    rng = np.random.default_rng(SEED + 5)
    eyes = []
    while len(eyes) < count:
        lat, lon = centre[0] + rng.uniform(-0.8, 0.8), centre[1] + rng.uniform(-0.8, 0.8)
        if float(terrain(np.array(lat), np.array(lon))) > alt - 300.0:
            continue
        lam, phi = np.radians(lon), np.radians(lat)
        r = 6_371_000.0 + alt
        eyes.append((r * np.cos(phi) * np.cos(lam), r * np.cos(phi) * np.sin(lam), r * np.sin(phi)))
    return torch.tensor(np.asarray(eyes, np.float32), device="cuda")


def batch_path(engine, centre, batch=256):
    """Phase 4b, config 5: ``render_batch`` of ``batch`` viewpoints. Returns
    the launch counts of one call, the call's time by CUDA events and
    panoramas/s."""
    import torch

    from topo_renderer_tpu_torch.ops.panorama import EYES_PER_LAUNCH, PanoramaSpec, render_panorama

    spec = PanoramaSpec.fast(1024, 256, n_steps=512)
    eyes = batch_eyes(centre, batch)
    suns = torch.tensor([[0.3, 0.5, 0.8]], device="cuda").expand(batch, 3).contiguous()
    engine.render_batch(eyes[:8], spec, suns[:8], fog="atmosphere")  # allocator warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    colors = engine.render_batch(eyes, spec, suns, fog="atmosphere")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    launches_k3 = -(-batch // EYES_PER_LAUNCH)
    expect_counts("batch", counts, {"window_slice_multi_batched": launches_k3, "window_slice_multi": 0,
                                    "crossing_search": batch})
    if colors.shape != (batch, 256, 1024, 3) or not bool(torch.isfinite(colors).all()):
        raise AssertionError(f"batch: bad colour output {tuple(colors.shape)}")
    sky_rgb = None
    for b in (0, batch // 2 - 1, batch - 1):
        one = render_panorama(engine.mosaic, eyes[b], spec, suns[b], fog="atmosphere")
        if not torch.equal(colors[b], one["color"]):
            raise AssertionError(f"batch eye {b} differs from its single-eye render")
        if sky_rgb is None:
            sky = one["color"][~one["hit"]]
            sky_rgb = torch.unique(sky, dim=0, return_counts=True)
            sky_rgb = sky_rgb[0][sky_rgb[1].argmax()]
    sky_share = (colors == sky_rgb).all(dim=-1).float().mean(dim=(1, 2))
    if not bool(((sky_share > 0.0) & (sky_share < 1.0)).all()):
        raise AssertionError(f"batch: an eye without terrain or sky (sky share {sky_share.min():.3f}"
                             f"..{sky_share.max():.3f})")
    del colors
    batch_ms = cuda_ms(lambda: engine.render_batch(eyes, spec, suns, fog="atmosphere"), iters=1, warmup=0)
    log(f"batch (config 5): {batch} eyes, first call {first_s:.2f} s host clock, timed call "
        f"{batch_ms / 1e3:.3f} s (CUDA events) = {batch / (batch_ms * 1e-3):.1f} panoramas/s; "
        f"eyes 0/{batch // 2 - 1}/{batch - 1} equal their single-eye renders; sky share "
        f"{float(sky_share.min()):.3f}..{float(sky_share.max()):.3f}")
    frame_profile(lambda: engine.render_batch(eyes[:16], spec, suns[:16], fog="atmosphere"))
    return counts, batch_ms, batch / (batch_ms * 1e-3)


def fallback_path(engine, centre, batch=4):
    """Phase 4c: ``render_batch`` with a spec that is not clipmapped."""
    import dataclasses

    import torch

    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, render_panorama

    spec = PanoramaSpec(width=1024, height=256, n_steps=512, n_refine=2)
    eyes = batch_eyes(centre, batch)
    suns = torch.tensor([[0.3, 0.5, 0.8]], device="cuda").expand(batch, 3).contiguous()
    reset_counts()
    t0 = time.perf_counter()
    colors = engine.render_batch(eyes, spec, suns, fog="atmosphere")
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("fallback", counts, {"crossing_search": 0, "window_slice_multi": 0,
                                       "window_slice_multi_batched": 0})
    if colors.shape != (batch, 256, 1024, 3) or not bool(torch.isfinite(colors).all()):
        raise AssertionError("fallback: bad colour output")
    vspec = dataclasses.replace(spec, use_pallas=False)
    for b in range(batch):
        if not torch.equal(colors[b], render_panorama(engine.mosaic, eyes[b], vspec, suns[b],
                                                       fog="atmosphere")["color"]):
            raise AssertionError(f"fallback eye {b} differs from its single-eye render")
    log(f"fallback: {batch} eyes at 1024x256, 512 steps, n_refine=2 in {call_s:.2f} s host clock; "
        f"K1 not launched; every eye equals its single-eye render")
    return counts


# ---- phase 4d/4e: the interactive fast frame (configs 6 and 3) ----------------

FAST_W, FAST_H = 800, 450


def local_axes(cam):
    """Float64 (north, east) at the camera's eye."""
    eye = cam.eye.double().numpy()
    lon, lat = np.arctan2(eye[1], eye[0]), np.arcsin(eye[2] / np.linalg.norm(eye))
    north = np.array([-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)])
    return north, np.array([-np.sin(lon), np.cos(lon), 0.0])


def yaw_toward(cam, azimuth):
    """Yaw that points ``cam`` at ``azimuth`` (radians from north, eastward).
    Yaw turns the canonical frame's x axis toward its z axis, and the
    canonical frame is carried onto the eye's by the shortest arc from
    (0, -1, 0) to up (`camera.rs:99-111`)."""
    import torch

    from topo_renderer_tpu_torch.ops import mathx

    north, east = local_axes(cam)
    target = np.cos(azimuth) * north + np.sin(azimuth) * east
    q = mathx.quat_from_rotation_arc(torch.tensor([0.0, -1.0, 0.0]), cam.up())
    x_w, z_w = (mathx.quat_rotate(q, torch.tensor(v)).double().numpy() for v in ([1.0, 0, 0], [0, 0, 1.0]))
    return float(np.arctan2(target @ z_w, target @ x_w))


def view_azimuth(cam):
    north, east = local_axes(cam)
    d = cam.direction().double().numpy()
    return float(np.arctan2(d @ east, d @ north))


def fast_camera(engine, centre):
    """The fast frames' camera: 300 m above the scene's centre, aimed at a
    peak that a 2048 x 512 panorama from there shows, so the label pass has
    a visible peak to report."""
    import dataclasses

    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec

    cam = camera_at(*centre, 300.0)
    spec = PanoramaSpec.fast(2048, 512, n_steps=512)
    pano = engine.render_panorama(cam, spec, composite=False, host_copy=False)
    seen = sorted(xy for lst in pano.visible_labels.values() for _, xy in lst)
    if not seen:
        raise AssertionError("fast frame: the panorama from the camera shows no peak to aim at")
    x, y = seen[len(seen) // 2]
    e_lo, e_hi = spec.elevation_range()
    azimuth = spec.azimuth_start + (x + 0.5) / spec.width * spec.azimuth_span
    elevation = e_hi - (y + 0.5) / spec.height * (e_hi - e_lo)
    # A positive pitch looks down: the canonical frame's up is (0, -1, 0).
    return dataclasses.replace(cam, yaw=yaw_toward(cam, azimuth), pitch=-elevation)


def wire_frame(engine, cam, with_labels):
    """One interactive frame as the web server runs it: render with the
    yuv420 wire on the card, one host pull, decode and label pass on the
    host. Returns the result and ``finish``'s (frame, labels, layouts,
    names)."""
    res = engine.render(cam, FAST_W, FAST_H, n_steps=512, fast=True, with_labels=with_labels,
                        wire="yuv420", host_copy=False)
    return res, res.finish(res.color.cpu().numpy())


def timed_wire_frames(engine, cam, with_labels, frames, what):
    """``frames`` wire frames, each with its launch counts checked (K1 and
    K2 once, K3 never). Returns the per-frame host-clock ms (render, pull,
    decode), the last frame's counts and its result."""
    import torch

    from topo_renderer_tpu_torch.render import transport

    wire_frame(engine, cam, with_labels)  # allocator warm-up
    torch.cuda.synchronize()
    host_ms = []
    for i in range(frames):
        reset_counts()
        t0 = time.perf_counter()
        res, out = wire_frame(engine, cam, with_labels)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        counts = read_counts()
        expect_counts(f"{what} {i}", counts, {"crossing_search": 1, "window_slice_multi": 1,
                                              "window_slice_multi_batched": 0})
    img = out[0]
    n_pix = transport.pixel_bytes(FAST_H, FAST_W, "yuv420")
    hit = float(res.hit.float().mean())
    colours = len(np.unique(img.reshape(-1, 3), axis=0))
    finite = bool(torch.isfinite(res.color_linear).all())
    if img.shape != (FAST_H, FAST_W, 3) or res.color.shape[0] < n_pix or not finite:
        raise AssertionError(f"{what}: bad output")
    if not 0.0 < hit < 1.0 or colours <= 200:
        raise AssertionError(f"{what}: hit {hit:.3f}, {colours} colours")
    return host_ms, counts, res, out


def ms_stats(host_ms):
    return f"mean {np.mean(host_ms):.2f}, median {np.median(host_ms):.2f}, min {np.min(host_ms):.2f} ms"


def fast_frame_path(engine, cam, frames=20):
    """Phase 4d, config 6: the 800 x 450 fast frame without labels through
    the yuv420 wire, one host pull per frame; then frames 1.1 rad below and
    above the horizon and one whose window crosses azimuth ±pi. Returns the
    launch counts of one frame, the per-frame host-clock ms, the no-pull ms
    by CUDA events and the profiled frame's (host ms, device busy ms)."""
    import dataclasses
    import math

    import torch

    host_ms, counts, res, (img, labels, _, _) = timed_wire_frames(engine, cam, False, frames, "fast frame")
    if labels:
        raise AssertionError("fast frame without labels reported labels")
    log(f"fast frame (config 6): {FAST_W}x{FAST_H}, 512 steps, yuv420 wire ({res.color.shape[0]} bytes), "
        f"{frames} frames, host clock incl. pull and decode: {ms_stats(host_ms)}; hit "
        f"{float(res.hit.float().mean()):.3f}, {len(np.unique(img.reshape(-1, 3), axis=0))} colours; "
        f"view azimuth {view_azimuth(cam):.3f} rad")
    seam_cam = dataclasses.replace(cam, yaw=yaw_toward(cam, math.pi - 0.2))
    for name, c in (("1.1 rad down", dataclasses.replace(cam, pitch=1.1)),
                    ("1.1 rad up", dataclasses.replace(cam, pitch=-1.1)),
                    ("window across azimuth ±pi", seam_cam)):
        reset_counts()
        res, (img, _, _, _) = wire_frame(engine, c, False)
        torch.cuda.synchronize()
        expect_counts(f"fast frame {name}", read_counts(), {"crossing_search": 1, "window_slice_multi": 1,
                                                            "window_slice_multi_batched": 0})
        if img.shape != (FAST_H, FAST_W, 3) or not bool(torch.isfinite(res.color_linear).all()):
            raise AssertionError(f"fast frame {name}: bad output")
        hit = float(res.hit.float().mean())
        if name == "1.1 rad down" and not hit > 0.5:
            raise AssertionError(f"fast frame {name}: hit {hit:.3f}, the terrain below is missing")
        log(f"fast frame {name}: view azimuth {view_azimuth(c):.3f} rad, hit {hit:.3f}")
    if abs(view_azimuth(seam_cam)) < math.pi - 0.3:
        raise AssertionError("fast frame: the seam frame does not look across azimuth ±pi")
    # The profile first: releasing the CUDA graph's memory pool makes the
    # next frame allocate anew.
    profiled = frame_profile(lambda: wire_frame(engine, cam, False))
    dev_ms = frame_device_ms(engine, cam, False, "fast frame")
    return counts, host_ms, dev_ms, profiled


def frame_device_ms(engine, cam, with_labels, what):
    """The wire frame's device-only ms (`graph_ms`: render and encode,
    without the pull) and the host syncs inside it (`host_syncs`), logged."""
    def frame():
        engine.render(cam, FAST_W, FAST_H, n_steps=512, fast=True, with_labels=with_labels,
                      wire="yuv420", host_copy=False)

    syncs = host_syncs(frame)
    ms, why = graph_ms(frame)
    log(f"{what}: host syncs inside a frame: {len(syncs)}{' at ' + ', '.join(syncs[:8]) if syncs else ''}; "
        f"device only (CUDA graph of the frame, 20 replays back to back, CUDA events): "
        f"{f'{ms:.3f} ms' if why is None else 'not measured (' + why + ')'}")
    return ms


def labelled_fast_frame_path(engine, cam, frames=20, pairs=10):
    """Phase 4e, config 3: the same frame with the label pass, whose bytes
    ride in the same wire vector. At least one label must be visible, and
    ``finish``'s labels must equal those of the frame rendered without the
    wire. Returns the launch counts of one frame, the per-frame host-clock
    ms and the label pass's ms per frame."""
    host_ms, counts, res, (_, labels, layouts, _) = timed_wire_frames(engine, cam, True, frames,
                                                                       "labelled fast frame")
    n_labels = sum(len(v) for v in labels.values())
    plain = engine.render(cam, FAST_W, FAST_H, n_steps=512, fast=True, composite=False, host_copy=False)
    if n_labels < 1 or labels != plain.visible_labels:
        raise AssertionError(f"labelled fast frame: {n_labels} labels, equal to the plain frame's: "
                             f"{labels == plain.visible_labels}")
    log(f"labelled fast frame (config 3): {frames} frames, host clock incl. pull, decode and label pass: "
        f"{ms_stats(host_ms)}; {n_labels} labels visible ({len(layouts)} laid out), equal to the "
        f"frame without the wire")
    # Frames with and without labels in turn, so that both see the same
    # host: the label pass's cost is the median of the pairs' differences.
    diffs = []
    for _ in range(pairs):
        t = []
        for with_labels in (False, True):
            t0 = time.perf_counter()
            wire_frame(engine, cam, with_labels)
            t.append(1e3 * (time.perf_counter() - t0))
        diffs.append(t[1] - t[0])
    overhead = float(np.median(diffs))
    log(f"label overhead: {overhead:.2f} ms per frame (median of {pairs} pairs of frames without and with "
        f"labels in turn)")
    label_pass_steps(engine, cam)
    frame_profile(lambda: wire_frame(engine, cam, True), host_top=8)
    frame_device_ms(engine, cam, True, "labelled fast frame")
    return counts, host_ms, overhead


def label_pass_steps(engine, cam, reps=20):
    """Host ms of each step that the label pass adds to a wire frame, each
    timed alone between synchronizations (median of ``reps``): the padded
    peak arrays, the view-projection built on the host, the visibility pass
    and the label bytes queued on the card (host time to queue them), and
    ``finish`` with labels against ``finish`` without."""
    import torch

    from topo_renderer_tpu_torch.render import engine as engine_mod
    from topo_renderer_tpu_torch.render import transport

    def host_ms(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return float(np.median(times))

    res, _ = wire_frame(engine, cam, True)
    bare, _ = wire_frame(engine, cam, False)
    _, pos, valid = engine._padded_peaks()
    packed = engine_mod._frame_labels(cam, {"depth": res.depth}, pos, valid, width=FAST_W, height=FAST_H,
                                      tolerance_rel=0.05)
    buf, bare_buf = res.color.cpu().numpy(), bare.color.cpu().numpy()
    steps = {
        "padded peak arrays": engine._padded_peaks,
        "view-projection on the host": lambda: cam.build_view_proj_matrix(float(FAST_W), float(FAST_H)),
        "visibility pass, queued": lambda: engine_mod._frame_labels(
            cam, {"depth": res.depth}, pos, valid, width=FAST_W, height=FAST_H, tolerance_rel=0.05),
        "label bytes, queued": lambda: transport.encode_labels_u8(packed),
        "finish with labels": lambda: res.finish(buf),
        "finish without labels": lambda: bare.finish(bare_buf),
    }
    log("label pass steps (host ms, median of %d): %s" % (
        reps, ", ".join(f"{name} {host_ms(fn):.3f}" for name, fn in steps.items())))


# ---- phase 4f: the triangle-exact frame (config 1) ----------------------------

EXACT_KW = dict(n_steps=1024, n_refine=24, fast=False)


def exact_frame(engine, cam, quality, **kw):
    """One 800 x 450 exact frame (config 1) on the engine's default guided
    march at ``quality`` ("full": the settle budget, "interactive": the
    motion rung), without labels unless ``kw`` asks for them."""
    kw = {"with_labels": False, "host_copy": False, **kw}
    return engine.render(cam, FAST_W, FAST_H, exact_quality=quality, **EXACT_KW, **kw)


def exact_frame_path(engine, cam, frames=10):
    """Phase 4f, config 1: ``frames`` settle and ``frames`` motion frames,
    each with the u8 frame pulled to the host, then one labelled frame
    through the yuv420 wire. Every frame launches K1 twice (the prepass's
    exact and bound profiles) and K2/K3 never, hits terrain and sky and has
    > 200 colours. Then, per rung, the host syncs inside a frame (0), the
    device-only ms by CUDA-graph replay, and the settle frame's device busy
    share. Returns the launch counts of one frame per rung, the per-frame
    host-clock ms per rung, the device-only ms per rung and the profile."""
    import torch

    counts, host_ms, last = {}, {"full": [], "interactive": []}, {}
    for quality in host_ms:
        exact_frame(engine, cam, quality)  # allocator warm-up
    torch.cuda.synchronize()
    # The rungs in turns, so that both see the same host.
    for i in range(frames):
        for quality in host_ms:
            reset_counts()
            t0 = time.perf_counter()
            last[quality] = exact_frame(engine, cam, quality)
            host_ms[quality].append(1e3 * (time.perf_counter() - t0))
            counts[quality] = read_counts()
            expect_counts(f"exact frame ({quality}) {i}", counts[quality], {
                "crossing_search": 2, "window_slice_multi": 0, "window_slice_multi_batched": 0, "window_slice": 0})
    for quality, res in last.items():
        hit = float(res.hit.float().mean())
        colours = len(np.unique(res.color.reshape(-1, 3), axis=0))
        if res.color.shape != (FAST_H, FAST_W, 3) or not bool(torch.isfinite(res.color_linear).all()):
            raise AssertionError(f"exact frame ({quality}): bad output")
        if not 0.0 < hit < 1.0 or colours <= 200:
            raise AssertionError(f"exact frame ({quality}): hit {hit:.3f}, {colours} colours")
        log(f"exact frame (config 1, {quality}): {FAST_W}x{FAST_H}, 1024 steps (prepass 896), n_refine 24, "
            f"{frames} frames with the u8 pull, host clock: {ms_stats(host_ms[quality])}; hit {hit:.3f}, "
            f"{colours} colours")

    reset_counts()
    res = exact_frame(engine, cam, "full", with_labels=True, wire="yuv420")
    _, labels, layouts, _ = res.finish(res.color.cpu().numpy())
    expect_counts("labelled exact frame", read_counts(), {"crossing_search": 2, "window_slice_multi": 0,
                                                          "window_slice_multi_batched": 0})
    plain = exact_frame(engine, cam, "full", with_labels=True, composite=False)
    if labels != plain.visible_labels:
        raise AssertionError("labelled exact frame: the wire's labels differ from the frame's without the wire")
    log(f"labelled exact frame (yuv420 wire): {sum(len(v) for v in labels.values())} labels visible "
        f"({len(layouts)} laid out), equal to the frame without the wire")

    dev_ms = {}
    profiled = frame_profile(lambda: exact_frame(engine, cam, "full", u8_host=False))
    for quality in ("full", "interactive"):
        def frame():
            exact_frame(engine, cam, quality, u8_host=False)

        syncs = host_syncs(frame)
        if syncs:
            raise AssertionError(f"exact frame ({quality}): {len(syncs)} host syncs inside a frame at {syncs[:8]}")
        dev_ms[quality], why = graph_ms(frame)
        if why is not None:
            raise AssertionError(f"exact frame ({quality}): no CUDA graph capture ({why})")
        log(f"exact frame ({quality}): host syncs inside a frame: 0; device only (CUDA graph of the frame "
            f"without the pull, 20 replays back to back, CUDA events): {dev_ms[quality]:.3f} ms")
    return counts, host_ms, dev_ms, profiled


UNGUARDED = {"exact_frame_unguarded": (("guard_legs", False),),
             "exact_frame_unguarded_single": (("guard_legs", False), ("split_brackets", False))}


def unguarded_exact_frames(engine, cam):
    """Phase 4f, the two marches without the own-texel leg: one 800 x 450
    exact frame each (``guard_legs=False``, split cluster legs and one
    pooled bracket), K1 twice and K2/K3 never, hit, sky and > 200 colours,
    0 host syncs inside a frame, the device-only ms by CUDA-graph replay.
    Returns the launch counts of each frame by path name."""
    import torch

    counts = {}
    for name, kw in UNGUARDED.items():
        exact_frame(engine, cam, "full", guided_kw=kw)  # allocator warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = exact_frame(engine, cam, "full", guided_kw=kw)
        ms = 1e3 * (time.perf_counter() - t0)
        counts[name] = read_counts()
        expect_counts(name, counts[name], {"crossing_search": 2, "window_slice_multi": 0,
                                           "window_slice_multi_batched": 0, "window_slice": 0})
        hit = float(res.hit.float().mean())
        colours = len(np.unique(res.color.reshape(-1, 3), axis=0))
        if res.color.shape != (FAST_H, FAST_W, 3) or not bool(torch.isfinite(res.color_linear).all()):
            raise AssertionError(f"{name}: bad output")
        if not 0.0 < hit < 1.0 or colours <= 200:
            raise AssertionError(f"{name}: hit {hit:.3f}, {colours} colours")

        def frame():
            exact_frame(engine, cam, "full", guided_kw=kw, u8_host=False)

        syncs = host_syncs(frame)
        if syncs:
            raise AssertionError(f"{name}: {len(syncs)} host syncs inside a frame at {syncs[:8]}")
        dev_ms, why = graph_ms(frame)
        if why is not None:
            raise AssertionError(f"{name}: no CUDA graph capture ({why})")
        log(f"{name} (guided_kw {dict(kw)}): {FAST_W}x{FAST_H}, 1024 steps, one frame with the u8 pull "
            f"{ms:.2f} ms host clock; hit {hit:.3f}, {colours} colours; host syncs inside a frame 0; device only "
            f"(CUDA graph, 20 replays) {dev_ms:.3f} ms; K1 2 launches")
    return counts


# ---- phase 4g: streaming tile updates ---------------------------------------

STREAM_LAT, STREAM_LON = 44, 11  # the 3 x 3 working set at 44-46N, 11-13E


def mosaic_tables(m):
    """name -> device tensor (int32 words) of every table and scalar of a
    mosaic, each band of a row-sharded table under its own name, for a
    bit-for-bit comparison."""
    import torch

    out = {}

    def put(key, t):
        if isinstance(t, tuple):
            out.update({f"{key}/{b}": band for b, band in enumerate(t)})
        elif t is not None:
            out[key] = t

    for name in ("heights_flat", "attr_packed_flat", "cell_heights_flat", "hmax", "bound_center",
                 "bound_radius"):
        put(name, getattr(m, name))
    for name in ("mip_heights_flat", "mip_attr_flat", "mip_hmax_flat", "mip_hmax_raw_flat", "win_attr_2d"):
        for lv, t in enumerate(getattr(m, name)):
            put(f"{name}[{lv}]", t)
    return {k: v.contiguous().view(torch.int32) for k, v in out.items()}


def slot_order_build(engine):
    """A fresh build of the engine's tiles on its canvas, listed in its slot
    order: the first tile listed, the lowest occupied slot's, lends its
    rotation to valid texels without an owning cell, in the build as in the
    engine's updated tables."""
    from topo_renderer_tpu_torch.models.scene import build_mosaic

    order = sorted(engine._slots, key=lambda loc: engine._slots[loc][0])
    return build_mosaic([engine._tiles[loc] for loc in order], canvas=engine._canvas[:4], keep_hmax_raw=True,
                        window_table_min=engine._window_table_min, device=engine.device)


def check_tables(engine, fresh, what):
    """The engine's tables equal those of `fresh` bit for bit; returns how
    many there are."""
    import torch

    got, want = mosaic_tables(engine.mosaic), mosaic_tables(fresh)
    differ = [k for k in want if got[k].shape != want[k].shape or not torch.equal(got[k], want[k])]
    if got.keys() != want.keys() or differ or not np.array_equal(engine.mosaic.host.valid, fresh.host.valid):
        raise AssertionError(f"{what}: the engine's tables differ from a fresh build in slot order: {differ}")
    return len(want)


def update_breakdown(engine, lat, lon):
    """Where one unload and one re-add of the tile at (lat, lon) spend
    their host time: the region assembly (numpy), the queued device work
    of `apply_slot_update`, and the rest of `_apply_pending` (owner
    windows, pinned copies, the `hmax` read); then the pair under
    torch.profiler."""
    import torch

    from topo_renderer_tpu_torch.geo import GeoLocation
    from topo_renderer_tpu_torch.render import engine as engine_mod

    location = GeoLocation.from_coord(lat, lon)
    spent = {"region assembly": 0.0, "apply_slot_update, queued": 0.0}

    def timed(fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += 1e3 * (time.perf_counter() - t0)
        return call

    tile = engine._tiles[location]
    args = (location, tile.heights, tile.transform)
    assemble, apply = engine._assemble_region, engine_mod.apply_slot_update
    engine._assemble_region = timed(assemble, "region assembly")
    engine_mod.apply_slot_update = timed(apply, "apply_slot_update, queued")
    try:
        engine.unload_terrain(location)
        engine.add_terrain(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.mosaic
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        engine._assemble_region, engine_mod.apply_slot_update = assemble, apply
    log(f"streaming: one unload and one add of the {lat}N {lon}E tile: {total:.1f} ms host clock; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in spent.items())
        + f", the rest of _apply_pending {total - sum(spent.values()):.1f} ms")
    engine.unload_terrain(location)
    engine.add_terrain(*args)
    log("streaming: the same pair under torch.profiler:")
    frame_profile(lambda: engine.mosaic, host_top=8)
    if engine._pending or engine._dirty:
        raise AssertionError("streaming: profiled updates left pending")


def streaming_frames(engine, fresh, cam, prefix):
    """The streaming engine's fast and exact 800 x 450 frames at ``cam``
    after its updates: launch counts reset and checked, each frame equal
    bit for bit to the one rendered from ``fresh``, no host sync inside a
    frame. Returns the launch counts by path name."""
    import torch

    from topo_renderer_tpu_torch.ops.raycast import render_perspective, render_perspective_fast

    counts = {}
    fov_hint = engine._fov_bucket_rad(cam)
    frames = {
        f"{prefix}_fast_frame": (
            dict(n_steps=512, fast=True), {"crossing_search": 1, "window_slice_multi": 1},
            lambda m: render_perspective_fast(m, cam, width=FAST_W, height=FAST_H, n_steps=512,
                                              fov_hint=fov_hint)),
        f"{prefix}_exact_frame": (
            dict(EXACT_KW, exact_quality="full"), {"crossing_search": 2, "window_slice_multi": 0},
            lambda m: render_perspective(m, cam, width=FAST_W, height=FAST_H, n_steps=EXACT_KW["n_steps"],
                                         n_refine=EXACT_KW["n_refine"], guided=True, fov_hint=fov_hint)),
    }
    for name, (kw, want_counts, plain) in frames.items():
        def frame():
            return engine.render(cam, FAST_W, FAST_H, with_labels=False, host_copy=False, u8_host=False, **kw)

        frame()
        torch.cuda.synchronize()
        reset_counts()
        res = frame()
        torch.cuda.synchronize()
        counts[name] = read_counts()
        expect_counts(name, counts[name], dict(want_counts, window_slice_multi_batched=0))
        ref = plain(fresh)
        for key, a, b in (("color", res.color_linear, ref["color"]), ("depth", res.depth, ref["depth"]),
                          ("hit", res.hit, ref["hit"])):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: {key} differs from the fresh build's frame")
        syncs = host_syncs(frame)
        if syncs:
            raise AssertionError(f"{name}: {len(syncs)} host syncs inside a frame at {syncs[:8]}")
        hit = float(res.hit.float().mean())
        if not 0.0 < hit:
            raise AssertionError(f"{name}: no terrain in view")
        log(f"{name}: {FAST_W}x{FAST_H} after the updates, equal bit for bit to the fresh build's frame; hit "
            f"{hit:.3f}; host syncs inside a frame 0; launches {counts[name]}")
    return counts


def streaming_move_north(engine):
    """After the move east (the set at 44-46N, 12-14E), one degree north:
    unload the 44N row and add the 47N row, six queued slot updates. The
    lowest occupied slot passes from 44N 14E to 47N 12E, so the valid
    texels with no owning cell (the set's south row and east column) take a
    new rotation: the engine re-packs them after the updates. The tables
    must equal a fresh build in slot order bit for bit, and the fast and
    exact frames the fresh build's. Returns the launch counts by path."""
    import dataclasses

    import torch

    from topo_renderer_tpu_torch.geo import GeoLocation
    from topo_renderer_tpu_torch.models import mosaic_update
    from topo_renderer_tpu_torch.render import engine as engine_mod

    lons = range(STREAM_LON + 1, STREAM_LON + 4)
    for lon in lons:
        engine.unload_terrain(GeoLocation.from_coord(STREAM_LAT, lon))
    for lon in lons:
        engine.add_terrain(*make_tile(STREAM_LAT + 3, lon))
    if engine._dirty or [op for op, *_ in engine._pending] != ["remove"] * 3 + ["add"] * 3:
        raise AssertionError(f"streaming: the move north was not queued as six slot updates ({engine._pending})")
    calls = {"slot updates": 0, "rebuilds": 0}
    repack_ms = []

    def counted(fn, key):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return repack(*args)
        finally:
            repack_ms.append(1e3 * (time.perf_counter() - t0))

    update, rebuild, repack = engine_mod.apply_slot_update, engine._full_streaming_rebuild, engine._repack_unowned
    engine_mod.apply_slot_update = counted(update, "slot updates")
    engine._full_streaming_rebuild = counted(rebuild, "rebuilds")
    engine._repack_unowned = timed
    strips = mosaic_update.repack_unowned.calls
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        engine.mosaic
        torch.cuda.synchronize()
        north_ms = 1e3 * (time.perf_counter() - t0)
        counts = {"streaming_north_update": read_counts()}
    finally:
        engine_mod.apply_slot_update = update
        del engine._full_streaming_rebuild, engine._repack_unowned
    strips = mosaic_update.repack_unowned.calls - strips
    expect_counts("streaming, the move north", counts["streaming_north_update"],
                  dict.fromkeys(counts["streaming_north_update"], 0))
    if calls != {"slot updates": 6, "rebuilds": 0} or engine._pending or engine._dirty:
        raise AssertionError(f"streaming: the move north ran {calls}, not six slot updates and no rebuild")
    if len(repack_ms) != 1 or not strips:
        raise AssertionError(f"streaming: the move north re-packed {strips} strips in {len(repack_ms)} calls, "
                             "though the lowest occupied slot's rotation changed")
    fresh = slot_order_build(engine)
    n_tables = check_tables(engine, fresh, "streaming, the move north")
    log(f"streaming: one degree north (44N row out, 47N row in) = 6 slot updates and a re-pack of {strips} "
        f"strips (the texels with no owning cell) in {north_ms:.1f} ms host clock, synchronized; the re-pack "
        f"{repack_ms[0]:.1f} ms host clock, queued; {n_tables} tables equal bit for bit to a fresh build in "
        f"slot order")
    cam = camera_at(STREAM_LAT + 2.4, STREAM_LON + 2.3, 300.0)
    counts.update(streaming_frames(engine, fresh, dataclasses.replace(cam, yaw=yaw_toward(cam, 1.2), pitch=0.05),
                                   "streaming_north"))
    return counts


def streaming_path():
    """Phase 4g: `RenderEngine(streaming=True)` on the 3 x 3 COP-90-shaped
    tiles at 44-46N, 11-13E (a 6144^2 canvas), one degree east (unload the
    11E column, add the 14E column: six slot updates, queued, not rebuilt),
    the tables against a fresh `build_mosaic` of the same tiles on the same
    canvas bit for bit, one fast and one exact frame from each mosaic bit
    for bit, then one degree north (`streaming_move_north`: six slot updates
    and the re-pack of the texels with no owning cell, checked the same
    way), then a tile that leaves the canvas (15E) and its full rebuild.
    Returns the launch counts by path name."""
    import dataclasses

    import torch

    from topo_renderer_tpu_torch.geo import GeoLocation
    from topo_renderer_tpu_torch.models.mosaic_update import streaming_canvas_dim
    from topo_renderer_tpu_torch.render.engine import RenderEngine

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    engine = RenderEngine(streaming=True)
    for lat in range(STREAM_LAT, STREAM_LAT + 3):
        for lon in range(STREAM_LON, STREAM_LON + 3):
            engine.add_terrain(*make_tile(lat, lon))
    t0 = time.perf_counter()
    engine.mosaic
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    memory = {"first build": (torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated())}
    side = streaming_canvas_dim(5 * (TEXELS - 1) + 1)  # the tiles' box and a tile each side: 6144 at 1201
    if engine._canvas[2:4] != (side, side):
        raise AssertionError(f"streaming canvas {engine._canvas[2:4]}, not {side} x {side}")

    counts = {}
    for lat in range(STREAM_LAT, STREAM_LAT + 3):
        engine.unload_terrain(GeoLocation.from_coord(lat, STREAM_LON))
    for lat in range(STREAM_LAT, STREAM_LAT + 3):
        engine.add_terrain(*make_tile(lat, STREAM_LON + 3))
    if engine._dirty or [op for op, *_ in engine._pending] != ["remove"] * 3 + ["add"] * 3:
        raise AssertionError(f"streaming: the move east was not queued as six slot updates ({engine._pending})")
    reset_counts()
    t0 = time.perf_counter()
    update_syncs = host_syncs(lambda: engine.mosaic)
    update_ms = 1e3 * (time.perf_counter() - t0)
    counts["streaming_update"] = read_counts()
    expect_counts("streaming update", counts["streaming_update"], dict.fromkeys(counts["streaming_update"], 0))
    if engine._pending or engine._dirty:
        raise AssertionError("streaming: updates left pending")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fresh = slot_order_build(engine)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    memory["fresh build beside the engine's"] = (torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated())
    n_tables = check_tables(engine, fresh, "streaming")
    log(f"streaming (phase 4g): 3x3 tiles of {TEXELS}^2 at {STREAM_LAT}-{STREAM_LAT + 2}N, "
        f"{STREAM_LON}-{STREAM_LON + 2}E on a {engine._canvas[2]}x{engine._canvas[3]} canvas; first build "
        f"{first_s * 1e3:.1f} ms host clock; one degree east = 6 slot updates in {update_ms:.1f} ms "
        f"({update_ms / 6:.1f} ms per update; host syncs in the updates: {len(update_syncs)}"
        f"{' at ' + ', '.join(update_syncs[:4]) if update_syncs else ''}); a fresh build of the same canvas "
        f"{fresh_s * 1e3:.1f} ms; {n_tables} tables equal bit for bit")

    cam = camera_at(STREAM_LAT + 1.4, STREAM_LON + 2.3, 300.0)
    counts.update(streaming_frames(engine, fresh, dataclasses.replace(cam, yaw=yaw_toward(cam, 1.2), pitch=0.05),
                                   "streaming"))
    del fresh
    update_breakdown(engine, STREAM_LAT, STREAM_LON + 3)
    counts.update(streaming_move_north(engine))

    for lat in range(STREAM_LAT, STREAM_LAT + 3):
        engine.add_terrain(*make_tile(lat, STREAM_LON + 4))
    if not engine._dirty or engine._pending:
        raise AssertionError("streaming: a tile off the canvas did not ask for a full rebuild")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = engine.mosaic
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    memory["rebuild"] = (torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated())
    log(f"streaming: the 15E column leaves the canvas: full rebuild of {len(engine.loaded_locations)} tiles on "
        f"a {m.shape[0]}x{m.shape[1]} canvas in {rebuild_s * 1e3:.1f} ms host clock; device memory above the "
        f"phase's start (torch.cuda.max_memory_allocated / memory_allocated after): "
        + ", ".join(f"{k} {(peak - base) / 1e9:.2f} / {(now - base) / 1e9:.2f} GB" for k, (peak, now) in memory.items()))
    del engine, m
    torch.cuda.empty_cache()
    return counts


# ---- phase 4h: the host runtime, backend to CLI image ----------------------

PEAKS_PER_TILE = 300
CLI_PANORAMA = (4096, 1024, 512)  # width, height, steps of `topo-render-torch panorama --fast`
CLI_FRAME = (FAST_W, FAST_H, 1024)  # of `topo-render-torch render` (the exact frame)
# W held at the reference's speed 1.0 moves 0.1 m per microsecond of frame
# time, ~5 km per 50 ms step; 0.01 keeps the flight inside the tile set.
APP_CAMERA_SPEED = 0.01
APP_STEPS_AFTER = 10  # steps timed once every tile is in
APP_TIMEOUT_S = 120.0


class StageClock:
    """Host-clock spans of the methods and functions it wraps, by key, and
    the last value each returned; `restore` puts the originals back."""

    def __init__(self):
        self.spans, self.last, self._saved = {}, {}, []

    def wrap(self, owner, name, key, sync=False):
        import functools

        fn = getattr(owner, name)

        @functools.wraps(fn)
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                out = self.last[key] = fn(*args, **kw)
                if sync:
                    import torch

                    torch.cuda.synchronize()
                return out
            finally:
                self.spans.setdefault(key, []).append((t0, time.perf_counter()))

        setattr(owner, name, timed)
        self._saved.append((owner, name, fn))

    def ms(self, key):
        return sum(1e3 * (b - a) for a, b in self.spans.get(key, ()))

    def restore(self):
        while self._saved:
            setattr(*self._saved.pop())


def write_backend_data(root, lat0, lon0):
    """The 3 x 3 COP-90-shaped tiles from (lat0, lon0) as GeoTIFFs written
    by the port's `write_geotiff`, and a peaks CSV per tile with peaks on
    the terrain, laid out as the backend serves them. Returns the written
    heights by (lat, lon)."""
    from topo_renderer_tpu_torch.backend.server import dem_file_name, peaks_file_name
    from topo_renderer_tpu_torch.data.tiff import write_geotiff

    rng = np.random.default_rng(SEED + 7)
    written = {}
    for lat in range(lat0, lat0 + 3):
        for lon in range(lon0, lon0 + 3):
            loc, heights, transform = make_tile(lat, lon)
            ps = transform.pixel_scale[0]
            path = root / dem_file_name(loc)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(write_geotiff(heights, (ps, ps, 0.0), (0.0, 0.0, 0.0, float(lon), float(lat + 1), 0.0)))
            plat = lat + rng.uniform(0.002, 0.998, PEAKS_PER_TILE)
            plon = lon + rng.uniform(0.002, 0.998, PEAKS_PER_TILE)
            elev = terrain(plat, plon)
            rows = [f"{a:.6f},{o:.6f},Peak {lat}-{lon}-{i},{e:.1f}" for i, (a, o, e) in enumerate(zip(plat, plon, elev))]
            path = root / peaks_file_name(loc)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text("latitude,longitude,name,elevation\n" + "\n".join(rows) + "\n")
            written[(lat, lon)] = heights
    return written


def tile_fetch_and_decode(url, written):
    """Per tile: the HTTP fetch of its GeoTIFF, its decode on the native
    decoder and on the Python decoder (both must equal the array written),
    and `fetch_terrain` whole (fetch, decode, peaks CSV and positions); then
    the 8-worker runner on all tiles at once, with `fetch_terrain`, its
    decode and its peak positions (torch CPU ops) timed inside each worker.
    Returns medians in ms."""
    import torch

    from topo_renderer_tpu_torch import native
    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.data import background, tiff
    from topo_renderer_tpu_torch.data.fetch import get_tiff_from_http
    from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation

    if not native.available():
        raise AssertionError("host runtime: the native GeoTIFF decoder did not build (g++ and zlib)")
    times = {"fetch": [], "native decode": [], "Python decode": [], "fetch_terrain": []}
    settings = Settings(backend_url=url)
    try_native = tiff._try_native
    serial = StageClock()
    serial.wrap(background, "ecef_from_geo", "positions")
    for (lat, lon), heights in written.items():
        loc = GeoLocation.from_coord(lat, lon)
        t0 = time.perf_counter()
        blob = get_tiff_from_http(url, loc)
        times["fetch"].append(1e3 * (time.perf_counter() - t0))
        for key, patch in (("native decode", try_native), ("Python decode", lambda data: None)):
            tiff._try_native = patch
            try:
                t0 = time.perf_counter()
                decoded, info = tiff.read_geotiff(blob)
                times[key].append(1e3 * (time.perf_counter() - t0))
            finally:
                tiff._try_native = try_native
            if decoded.dtype != np.float32 or not np.array_equal(decoded, heights):
                raise AssertionError(f"host runtime: the {key} of tile {lat}N {lon}E differs from the array written")
        t0 = time.perf_counter()
        peaks, _ = background.fetch_terrain(loc, settings)
        times["fetch_terrain"].append(1e3 * (time.perf_counter() - t0))
        if not 0 < len(peaks) <= PEAKS_PER_TILE:
            raise AssertionError(f"host runtime: tile {lat}N {lon}E gave {len(peaks)} peaks")
    serial.restore()
    events = []
    runner = background.BackgroundRunner(settings, lambda kind, payload: events.append(kind))
    inside = StageClock()
    for name, key in (("fetch_terrain", "fetch_terrain"), ("read_geotiff", "decode"), ("ecef_from_geo", "positions")):
        inside.wrap(background, name, key)
    runner.spawn()
    t0 = time.perf_counter()
    try:
        for lat, lon in written:
            runner.send(background.DataRequested(GeoLocation.from_coord(lat, lon), GeoCoord(lat + 0.5, lon + 0.5)))
        runner.drain(timeout=120)
    finally:
        runner.shutdown()
        inside.restore()
    parallel_ms = 1e3 * (time.perf_counter() - t0)
    if events.count("terrain_ready") != len(written):
        raise AssertionError(f"host runtime: the runner delivered {events.count('terrain_ready')} tiles")
    times["positions"] = [1e3 * (b - a) for a, b in serial.spans["positions"]]
    med = {k: float(np.median(v)) for k, v in times.items()}
    in_runner = {k: float(np.median([1e3 * (b - a) for a, b in inside.spans[k]]))
                 for k in ("fetch_terrain", "decode", "positions")}
    log(f"host runtime: per tile of {TEXELS}^2 (median of {len(written)}): fetch {med['fetch']:.2f} ms, native "
        f"decode {med['native decode']:.2f} ms, Python decode {med['Python decode']:.2f} ms (both bit-equal to the "
        f"arrays written), fetch_terrain whole {med['fetch_terrain']:.2f} ms with {PEAKS_PER_TILE} peaks, of which "
        f"the peak positions {med['positions']:.3f} ms; the 8-worker runner on all {len(written)} tiles "
        f"{parallel_ms:.1f} ms, per tile inside a worker (median): fetch_terrain {in_runner['fetch_terrain']:.2f} ms, "
        f"its decode {in_runner['decode']:.2f} ms, its peak positions {in_runner['positions']:.3f} ms; torch "
        f"intra-op threads {torch.get_num_threads()}; the default decoder is the native one")
    return dict(med, runner_ms=parallel_ms, **{f"runner {k}": v for k, v in in_runner.items()})


def run_cli(argv, clock):
    """One CLI call with its stages timed (the mosaic build and slot
    updates up to a device sync); returns (whole ms, the application it
    made, the launch counts)."""
    from topo_renderer_tpu_torch.app.application import Application
    from topo_renderer_tpu_torch.frontends import cli
    from topo_renderer_tpu_torch.render.engine import RenderEngine
    from topo_renderer_tpu_torch.utils import imageio

    made = []
    init = Application.__init__

    def keep(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    Application.__init__ = keep
    clock.wrap(Application, "__init__", "construct")
    clock.wrap(Application, "start", "start")
    clock.wrap(Application, "wait_for_terrain", "wait_for_terrain")
    clock.wrap(RenderEngine, "height_at", "height_at")
    clock.wrap(RenderEngine, "_full_streaming_rebuild", "mosaic build", sync=True)
    clock.wrap(RenderEngine, "_apply_pending", "slot updates", sync=True)
    clock.wrap(RenderEngine, "render_panorama", "frame")
    clock.wrap(RenderEngine, "render", "frame")
    clock.wrap(imageio, "save_image", "save_image")
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        whole = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        clock.restore()
        Application.__init__ = init
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"cli {argv[0]}: exit code {rc}")
    return whole, made[0], counts


def cli_stage_line(what, whole, clock):
    """Log one CLI call's stages: `Application()`, time to first terrain
    (`start` to the end of `wait_for_terrain`), the CLI's fixed 2 s pump,
    `height_at` (the first mosaic build happens in it), the frame and
    `save_image`; the rest is argument parsing and shutdown."""
    wait_end = clock.spans["wait_for_terrain"][0][1]
    stages = {"Application()": clock.ms("construct"),
              "time to first terrain": 1e3 * (wait_end - clock.spans["start"][0][0]),
              "the fixed 2 s pump": 1e3 * (clock.spans["height_at"][0][0] - wait_end),
              "height_at": clock.ms("height_at"), "frame": clock.ms("frame"), "save_image": clock.ms("save_image")}
    rest = whole - sum(stages.values())
    stages.update({"mosaic build (in height_at)": clock.ms("mosaic build"), "slot updates": clock.ms("slot updates")})
    log(f"{what}: {whole:.1f} ms host clock for the whole call; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()) + f", the rest {rest:.1f} ms")


def reference_engine(app):
    """A fresh streaming engine with the app's decoded tiles and peaks; it
    builds its canvas from the sorted tiles, as the app's first build does
    when every tile has landed before it."""
    from topo_renderer_tpu_torch.render.engine import RenderEngine

    order = sorted(app.engine._slots, key=lambda loc: app.engine._slots[loc][0])
    if order != sorted(app.engine._tiles):
        raise AssertionError(f"host runtime: the CLI built before every tile landed (slots {order})")
    ref = RenderEngine(streaming=True)
    for loc, tile in app.engine._tiles.items():
        ref.add_terrain(loc, tile.heights, tile.transform)
    for loc, peaks in app.engine._peaks.items():
        ref.add_peaks(loc, peaks)
    return ref


def app_cold_run(url, size, lat, lon):
    """`Application.run` from cold with W held and ``fast=True``: frames
    start as soon as the first tile lands; later tiles become slot updates
    (inside the canvas) or rebuilds. Returns per-step records."""
    from topo_renderer_tpu_torch.app.application import Application
    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.control.events import Key, KeyInput
    from topo_renderer_tpu_torch.control.ui_controller import get_locations_range
    from topo_renderer_tpu_torch.geo import GeoCoord
    from topo_renderer_tpu_torch.render import engine as engine_mod

    clock = StageClock()
    app = Application(Settings(backend_url=url), camera_speed=APP_CAMERA_SPEED)
    n_tiles = len(get_locations_range(GeoCoord(lat, lon)))
    records = []
    try:
        app.viewport = size
        clock.wrap(app.engine, "_full_streaming_rebuild", "build")
        clock.wrap(engine_mod, "apply_slot_update", "update")
        step = app.step
        t_start = time.perf_counter()
        state = {"done_at": None}

        def timed_step(**kw):
            reset_counts()
            builds, updates = len(clock.spans.get("build", ())), len(clock.spans.get("update", ()))
            t0 = time.perf_counter()
            res = step(**kw)
            ms = 1e3 * (time.perf_counter() - t0)
            loaded = len(app.engine.loaded_locations)
            records.append(dict(ms=ms, rendered=res is not None, loaded=loaded, counts=read_counts(),
                                builds=len(clock.spans.get("build", ())) - builds,
                                updates=len(clock.spans.get("update", ())) - updates,
                                t=1e3 * (time.perf_counter() - t_start)))
            all_in = loaded == n_tiles and not app.engine._pending and app.background.idle()
            if all_in and state["done_at"] is None:
                state["done_at"] = len(records)
            if (state["done_at"] is not None and len(records) >= state["done_at"] + APP_STEPS_AFTER) or \
                    time.perf_counter() - t_start > APP_TIMEOUT_S:
                app._running = False
            return res

        app.step = timed_step
        app.start(GeoCoord(lat, lon))
        app.process_input(KeyInput(Key.W, True))
        app.run(target_fps=1e6, fast=True, n_steps=512)
        if state["done_at"] is None:
            raise AssertionError(f"app run: {len(app.engine.loaded_locations)} of {n_tiles} tiles after {APP_TIMEOUT_S} s")
        n_tables = check_tables(app.engine, slot_order_build(app.engine), "app run")
    finally:
        clock.restore()
        app.shutdown()
    return records, state["done_at"], n_tiles, n_tables


def host_runtime_path():
    """Phase 4h: the port's host runtime from a local `BackendServer` to the
    CLI's image, on the streaming scene's 3 x 3 tiles (44-46N, 11-13E):
    per-tile fetch and decode; `topo-render-torch panorama` and `render`
    (`frontends/cli.py::main`) with their stages timed, the launch counts
    of each call, the app engine's tables against a fresh build in slot
    order, and each PNG against a fresh engine's render of the same arrays,
    peaks and camera; then `Application.run` from cold with W held.
    Returns the launch counts of one call of each path by its name."""
    import dataclasses
    import gc
    import math
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from PIL import Image

    from topo_renderer_tpu_torch.backend.server import BackendServer
    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.geo import GeoCoord
    from topo_renderer_tpu_torch.models.camera import Camera
    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    root = Path(tempfile.mkdtemp(prefix="topo_backend_"))
    saved_url = os.environ.get("TOPO_BACKEND_URL")
    server = None
    counts = {}
    try:
        t0 = time.perf_counter()
        written = write_backend_data(root, STREAM_LAT, STREAM_LON)
        server = BackendServer(Settings(address="127.0.0.1", port=0, data_dir=str(root)))
        server.start()
        log(f"host runtime (phase 4h): 9 GeoTIFFs of {TEXELS}^2 and {9 * PEAKS_PER_TILE} peaks written and served at "
            f"{server.url} in {1e3 * (time.perf_counter() - t0):.0f} ms")
        tile_fetch_and_decode(server.url, written)

        os.environ["TOPO_BACKEND_URL"] = server.url
        lat, lon = STREAM_LAT + 1.5, STREAM_LON + 1.5
        where = ["--lat", str(lat), "--lon", str(lon), "--height-above", "300", "--device", "cuda"]
        pw, ph, psteps = CLI_PANORAMA
        fw, fh, fsteps = CLI_FRAME
        calls = {
            "cli_panorama": (["panorama", *where, "--width", str(pw), "--height", str(ph), "--steps", str(psteps),
                              "--fast", "--fog", "atmosphere"], {"crossing_search": 1, "window_slice_multi": 1}),
            "cli_render": (["render", *where, "--width", str(fw), "--height", str(fh), "--steps", str(fsteps)],
                           {"crossing_search": 2, "window_slice_multi": 0}),
        }
        for name, (argv, want) in calls.items():
            out = root / f"{name}.png"
            clock = StageClock()
            whole, app, counts[name] = run_cli([*argv, "-o", str(out)], clock)
            expect_counts(name, counts[name], dict(want, window_slice_multi_batched=0))
            cli_stage_line(f"{name} ({' '.join(argv[:1] + argv[7:])})", whole, clock)
            res = clock.last["frame"]
            if len(app.engine.loaded_locations) != 9 or app.background._thread.is_alive():
                raise AssertionError(f"{name}: {len(app.engine.loaded_locations)} tiles, runner alive")
            for tile in app.engine._tiles.values():
                lat0 = round(tile.transform.model_point[1]) - 1
                lon0 = round(tile.transform.model_point[0])
                if not np.array_equal(tile.heights, written[(lat0, lon0)]):
                    raise AssertionError(f"{name}: the app's tile {lat0}N {lon0}E differs from the array written")
            n_tables = check_tables(app.engine, slot_order_build(app.engine), name)
            png = np.asarray(Image.open(out))
            ref_engine = reference_engine(app)
            del app
            gc.collect()  # the application and its runner hold each other
            cam = Camera().reset(GeoCoord(lat, lon), ref_engine.height_at(GeoCoord(lat, lon)) + 300.0)
            if name == "cli_panorama":
                ref = ref_engine.render_panorama(cam, PanoramaSpec.fast(width=pw, height=ph, n_steps=psteps),
                                                 fog="atmosphere")
            else:  # the CLI's pose flags at their defaults, as it applies them
                cam = dataclasses.replace(cam, yaw=math.radians(0.0), pitch=math.radians(0.0))
                ref = ref_engine.render(cam.with_fovy(math.radians(45.0)), fw, fh, n_steps=fsteps)
            n_labels = len(res.layouts)
            if png.shape != ref.color.shape or not np.array_equal(png, ref.color) or n_labels != len(ref.layouts):
                raise AssertionError(f"{name}: the PNG differs from the engine's own render "
                                     f"({n_labels} vs {len(ref.layouts)} labels)")
            hit = float(np.asarray(ref.hit).mean())
            if not 0.0 < hit < 1.0 or (name == "cli_panorama" and n_labels < 1):
                raise AssertionError(f"{name}: hit {hit:.3f}, {n_labels} labels")
            log(f"{name}: launches {counts[name]}; {n_tables} tables equal a fresh build in slot order; the "
                f"{png.shape[1]}x{png.shape[0]} PNG equals a fresh engine's render bit for bit, hit {hit:.3f}, "
                f"{n_labels} labels in both")
            del ref_engine, ref, res
            torch.cuda.empty_cache()

        phase_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        app_base = torch.cuda.memory_allocated()
        records, done_at, n_tiles, n_tables = app_cold_run(server.url, (fw, fh), lat, lon)
        gc.collect()
        before = [r for r in records[:done_at] if r["rendered"]]
        after = [r for r in records[done_at:] if r["rendered"]]
        builds = sum(r["builds"] for r in records[:done_at])
        updates = sum(r["updates"] for r in records[:done_at])
        counts["app_step"] = after[-1]["counts"] if after else {}
        for r in after:
            expect_counts("app step", r["counts"], {"crossing_search": 1, "window_slice_multi": 1,
                                                    "window_slice_multi_batched": 0})
        first = next(r for r in records if r["rendered"])
        peak = (f"the CLI calls' {phase_peak / 1e9:.2f} GB above the phase's start, the app run's "
                f"{(torch.cuda.max_memory_allocated() - app_base) / 1e9:.2f} GB above its own")
        log(f"app run (cold, W held, fast {fw}x{fh}): {len(records)} steps, first frame at {first['t']:.0f} ms with "
            f"{first['loaded']} tiles; all {n_tiles} tiles in after {done_at} steps ({records[done_at - 1]['t']:.0f} ms): "
            f"{builds} full builds and {updates} slot updates; ms per step while tiles land "
            f"{', '.join('%.0f' % r['ms'] for r in before[:12])}; after: median "
            f"{np.median([r['ms'] for r in after]):.1f} ms over {len(after)} steps, K1/K2 per step "
            f"{counts['app_step'].get('crossing_search')}/{counts['app_step'].get('window_slice_multi')}; "
            f"{n_tables} tables equal a fresh build in slot order; peak device memory: {peak}")
        return counts
    finally:
        if server is not None:
            server.stop()
        if saved_url is None:
            os.environ.pop("TOPO_BACKEND_URL", None)
        else:
            os.environ["TOPO_BACKEND_URL"] = saved_url
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---- phase 4i: the web and desktop frontends ---------------------------------

WEB_FRAMES = 20  # forced fast frames, W held
WEB_EXACT_FRAMES = 10
WEB_PIPELINE_FRAMES = 20  # delivered frames per run of the one- and two-in-flight loops
WEB_RENDER = (1024, 384)  # `/render`'s default panorama
DESKTOP_W, DESKTOP_H = 800, 600  # the reference desktop's window (`frontends/desktop.py`)
DESKTOP_FRAMES = 20


def web_request(base, path, body=None, timeout=300):
    """One request to the web frontend (POST with a JSON body, or GET
    without one): (status, body bytes, headers)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.status, e.read(), dict(e.headers)


class K1Shapes:
    """The (N, W, H) of every K1 call while it is installed: it wraps the
    input check that `crossing_search` runs first."""

    def __enter__(self):
        from topo_renderer_tpu_torch.ops import crossing

        self.shapes, self._check = [], crossing._check_inputs

        def check(e_prof, a0, a1, a2, thresh):
            self.shapes.append((*e_prof.shape, thresh.shape[0]))
            return self._check(e_prof, a0, a1, a2, thresh)

        crossing._check_inputs = check
        return self

    def __exit__(self, *exc):
        from topo_renderer_tpu_torch.ops import crossing

        crossing._check_inputs = self._check


def web_stage_timers(fe, timer, captured):
    """Time the served frame's stages into ``timer`` (a `FrameTimer`) and keep
    each u8 image the server hands to its JPEG encoder in ``captured``.
    Returns a function that removes the wrappers."""
    import torch

    from topo_renderer_tpu_torch.frontends.web import server as web

    saved = []

    def wrap(owner, name, key, keep=None):
        fn = getattr(owner, name)

        def timed(*args, **kw):
            if keep is not None:
                keep(args)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                timer.add(key, time.perf_counter() - t0)

        saved.append((owner, name, fn, name in vars(owner)))
        setattr(owner, name, timed)

    engine = fe.app.engine
    make_finish = engine._make_finish

    def timed_finish(*args, **kw):
        finish = make_finish(*args, **kw)

        def call(buf):
            t0 = time.perf_counter()
            try:
                return finish(buf)
            finally:
                timer.add("finish: decode and label pass", time.perf_counter() - t0)

        return call

    wrap(engine, "render", "render dispatch (under the lock)")
    wrap(web, "_start_pull", "pinned copy queued (under the lock)")
    wrap(torch.cuda.Event, "synchronize", "pull wait (the frame's copy)")
    wrap(web, "composite_labels", "label compositing")
    wrap(web, "encode_jpeg", "JPEG encode", keep=lambda args: captured.append(np.array(args[0])))
    engine._make_finish = timed_finish

    def restore():
        for owner, name, fn, own in reversed(saved):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)
        del engine._make_finish

    return restore


def engine_frame(fe, cam, width, height, **kw):
    """What the web frontend serves for ``cam``, rendered by its engine
    directly: the wire frame pulled, finished and composited."""
    from topo_renderer_tpu_torch.render.overlay import composite_labels

    with fe._render_lock:
        res = fe.app.engine.render(cam, width, height, host_copy=False, **kw)
        buf = res.color.cpu().numpy()
    frame, _, layouts, names = res.finish(buf)
    return composite_labels(frame, layouts, names) if layouts else frame


def served_frames(base, sid, body, count, what, want, cams, sess):
    """``count`` forced frames of one session; each must answer 200 with a
    JPEG and launch ``want``. Returns per-request host-clock ms."""
    ms = []
    for i in range(count):
        reset_counts()
        t0 = time.perf_counter()
        status, jpg, _ = web_request(base, f"/frame?session={sid}", dict(body, force=True))
        ms.append(1e3 * (time.perf_counter() - t0))
        if status != 200 or jpg[:2] != b"\xff\xd8":
            raise AssertionError(f"{what} {i}: HTTP {status} {jpg[:200]!r}")
        expect_counts(f"{what} {i}", read_counts(), dict(want, window_slice_multi_batched=0))
        cams.append(sess.camera)
    return ms


def in_flight_run(base, sid, threads, frames):
    """``threads`` clients of one session, each sending forced frames back
    to back (after a 204, 25 ms later, as the browser's tick does) until
    ``frames`` frames are delivered in all. Returns (delivered frames/s,
    204s, wall ms)."""
    import threading

    lock = threading.Lock()
    state = {"delivered": 0, "dropped": 0, "errors": []}

    def client():
        while True:
            with lock:
                if state["delivered"] >= frames or state["errors"]:
                    return
            status, body, _ = web_request(base, f"/frame?session={sid}",
                                          {"force": True, "width": FAST_W, "height": FAST_H})
            with lock:
                if status == 200:
                    state["delivered"] += 1
                elif status == 204:
                    state["dropped"] += 1
                else:
                    state["errors"].append((status, body[:200]))
            if status == 204:
                time.sleep(0.025)

    workers = [threading.Thread(target=client) for _ in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    wall = time.perf_counter() - t0
    if state["errors"] or any(w.is_alive() for w in workers):
        raise AssertionError(f"web, {threads} in flight: {state['errors'][:2]}, alive "
                             f"{sum(w.is_alive() for w in workers)}")
    return state["delivered"] / wall, state["dropped"], 1e3 * wall


def web_frontend_run(url, lat, lon):
    """Phase 4i's web part; returns the launch counts by path name."""
    import gc
    import io
    import shutil
    import tempfile
    import threading

    import torch
    from PIL import Image

    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.frontends.web import server as web
    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec
    from topo_renderer_tpu_torch.utils.profiling import FrameTimer, summarize_trace, trace

    counts = {}
    fe = web.WebFrontend(Settings(backend_url=url), port=0)
    thread = threading.Thread(target=fe.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{fe._httpd.server_address[1]}"
    trace_dir = tempfile.mkdtemp(prefix="topo_web_trace_")
    try:
        t0 = time.perf_counter()
        status, body, _ = web_request(base, "/location", {"latitude": lat, "longitude": lon})
        location_ms = 1e3 * (time.perf_counter() - t0)
        if status != 200 or json.loads(body)["loaded"] != 9:
            raise AssertionError(f"web /location: HTTP {status} {body[:200]!r}")
        sid = json.loads(web_request(base, "/session", {})[1])["id"]
        sess = fe._sessions[sid]
        sess.controller.speed = APP_CAMERA_SPEED
        fast = {"width": FAST_W, "height": FAST_H, "labels": True}
        t0 = time.perf_counter()
        status, _, _ = web_request(base, f"/frame?session={sid}",
                                   dict(fast, force=True, events=[{"type": "key", "key": "w", "pressed": True}]))
        first_ms = 1e3 * (time.perf_counter() - t0)  # builds the streaming canvas
        if status != 200:
            raise AssertionError(f"web first frame: HTTP {status}")
        served_frames(base, sid, fast, 1, "web warm-up", {"crossing_search": 1, "window_slice_multi": 1}, [], sess)

        timer, captured, cams = FrameTimer(), [], []
        restore = web_stage_timers(fe, timer, captured)
        try:
            with K1Shapes() as k1:
                fast_ms = served_frames(base, sid, fast, WEB_FRAMES, "web fast frame",
                                        {"crossing_search": 1, "window_slice_multi": 1}, cams, sess)
            counts["web_frame"] = read_counts()
            stages = timer.report()
            exact_ms = served_frames(base, sid, dict(fast, exact=True, exact_quality="interactive"), WEB_EXACT_FRAMES,
                                     "web exact frame", {"crossing_search": 2, "window_slice_multi": 0}, cams, sess)
            counts["web_frame_exact"] = read_counts()
            half_ms = served_frames(base, sid, dict(fast, pixfmt="yuv420_half"), 1, "web yuv420_half frame",
                                    {"crossing_search": 1, "window_slice_multi": 1}, cams, sess)
            with trace(trace_dir):
                served_frames(base, sid, fast, 1, "web traced frame", {"crossing_search": 1, "window_slice_multi": 1},
                              cams, sess)
        finally:
            restore()
        kinds = ([dict(fast=True, wire="yuv420")] * WEB_FRAMES
                 + [dict(fast=False, wire="rgb888", exact_quality="interactive")] * WEB_EXACT_FRAMES
                 + [dict(fast=True, wire="yuv420_half"), dict(fast=True, wire="yuv420")])
        if not len(captured) == len(cams) == len(kinds):
            raise AssertionError(f"web: {len(captured)} images for {len(cams)} frames")
        for i, (img, cam, kw) in enumerate(zip(captured, cams, kinds)):
            want = engine_frame(fe, cam, FAST_W, FAST_H, **kw)
            if img.shape != (FAST_H, FAST_W, 3) or not np.array_equal(img, want):
                raise AssertionError(f"web frame {i} ({kw}): the served image differs from the engine's render")
        colours = len(np.unique(captured[0].reshape(-1, 3), axis=0))
        if colours <= 200:
            raise AssertionError(f"web fast frame: {colours} colours")
        ops = summarize_trace(trace_dir, top=1 << 30)
        kernels = {key: [(ms, name) for ms, name in ops if key in name]
                   for key in ("crossing_kernel", "window_slice_kernel")}
        if not all(kernels.values()):
            raise AssertionError(f"web traced frame: K1 or K2 missing from the trace's {len(ops)} device ops: "
                                 f"{[name[:60] for _, name in ops]}")

        reset_counts()
        t0 = time.perf_counter()
        status, png, _ = web_request(base, f"/render?latitude={lat}&longitude={lon}")
        render_ms = 1e3 * (time.perf_counter() - t0)
        counts["web_render"] = read_counts()
        expect_counts("web /render", counts["web_render"], {"crossing_search": 1, "window_slice_multi": 1,
                                                            "window_slice_multi_batched": 0})
        reset_counts()
        t0 = time.perf_counter()
        status2, png2, _ = web_request(base, f"/render?latitude={lat}&longitude={lon}")
        cached_ms = 1e3 * (time.perf_counter() - t0)
        expect_counts("web /render from the cache", read_counts(), dict.fromkeys(counts["web_render"], 0))
        pano = np.asarray(Image.open(io.BytesIO(png)))
        with fe._render_lock:
            ref = fe.app.engine.render_panorama(fe.app.data.camera, PanoramaSpec.fast(*WEB_RENDER)).color
        if status != 200 or status2 != 200 or png2 != png or not np.array_equal(pano, ref):
            raise AssertionError(f"web /render: HTTP {status}/{status2}, cached bytes equal {png2 == png}, the PNG "
                                 f"equal to the engine's panorama {pano.shape == ref.shape and np.array_equal(pano, ref)}")

        sid2 = json.loads(web_request(base, "/session", {})[1])["id"]
        fe._sessions[sid2].controller.speed = APP_CAMERA_SPEED
        one = in_flight_run(base, sid2, 1, WEB_PIPELINE_FRAMES)
        two = in_flight_run(base, sid2, 2, WEB_PIPELINE_FRAMES)

        log(f"web (phase 4i): /location with 9 tiles {location_ms:.1f} ms; first frame (the canvas build) "
            f"{first_ms:.1f} ms; {WEB_FRAMES} fast {FAST_W}x{FAST_H} frames with labels (yuv420 wire, W held), "
            f"request to JPEG bytes on the host clock: {ms_stats(fast_ms)}; K1/K2 per frame "
            f"{counts['web_frame']['crossing_search']}/{counts['web_frame']['window_slice_multi']}, K1 (N, W, H) "
            f"{sorted(set(k1.shapes))}; {WEB_EXACT_FRAMES} exact frames (interactive rung, rgb888): "
            f"{ms_stats(exact_ms)}, K1/K2 {counts['web_frame_exact']['crossing_search']}/"
            f"{counts['web_frame_exact']['window_slice_multi']}; yuv420_half {half_ms[0]:.1f} ms; every served "
            f"image ({len(captured)}) equals the engine's render bit for bit; fast frame {colours} colours")
        log("web fast frame stages (FrameTimer, server side; the rest of a request is HTTP, the pump and JSON):\n"
            + stages)
        log(f"web traced frame (utils.profiling.trace / summarize_trace): {len(ops)} device ops by name, "
            f"{sum(ms for ms, _ in ops):.3f} ms in all; K1 {kernels['crossing_kernel'][0][0]:.4f} ms, K2 "
            f"{kernels['window_slice_kernel'][0][0]:.4f} ms; the most: "
            + "; ".join(f"{ms:.3f} ms {name[:50]}" for ms, name in ops[:5]))
        log(f"web /render {WEB_RENDER[0]}x{WEB_RENDER[1]} panorama: {render_ms:.1f} ms, K1/K2 "
            f"{counts['web_render']['crossing_search']}/{counts['web_render']['window_slice_multi']}; from the "
            f"cache {cached_ms:.1f} ms; the PNG equals the engine's panorama bit for bit")
        log(f"web in flight, one session, forced {FAST_W}x{FAST_H} frames: one request at a time {one[0]:.2f} "
            f"frames/s ({WEB_PIPELINE_FRAMES} in {one[2]:.0f} ms, {one[1]} dropped); two in flight {two[0]:.2f} "
            f"frames/s ({two[1]} answered 204, busy renderer); ratio {two[0] / one[0]:.2f}")
        return counts
    finally:
        fe._httpd.shutdown()
        thread.join(timeout=10)
        fe.app.shutdown()
        shutil.rmtree(trace_dir, ignore_errors=True)
        del fe
        gc.collect()
        torch.cuda.empty_cache()


def desktop_run(url, lat, lon):
    """Phase 4i's desktop part: `DesktopFrontend` headless at the reference's
    800 x 600 (the Tk shell needs a display); returns the launch counts."""
    import gc

    import torch

    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.frontends.desktop import DesktopFrontend
    from topo_renderer_tpu_torch.geo import GeoCoord

    desk = DesktopFrontend(Settings(backend_url=url), width=DESKTOP_W, height=DESKTOP_H)
    try:
        desk.app.camera_controller.speed = APP_CAMERA_SPEED
        t0 = time.perf_counter()
        desk.app.start(GeoCoord(lat, lon))
        desk.app.wait_for_terrain(timeout=APP_TIMEOUT_S)
        desk.app.background.drain(timeout=APP_TIMEOUT_S)
        desk.app.pump_events()
        first = desk.render_frame()  # builds the streaming canvas
        first_ms = 1e3 * (time.perf_counter() - t0)
        desk.feed_key("w", True)
        desk.render_frame()
        frames, cams, ms = [], [], []
        with K1Shapes() as k1:
            for i in range(DESKTOP_FRAMES):
                reset_counts()
                t0 = time.perf_counter()
                frames.append(desk.render_frame())
                ms.append(1e3 * (time.perf_counter() - t0))
                counts = read_counts()
                expect_counts(f"desktop frame {i}", counts, {"crossing_search": 1, "window_slice_multi": 1,
                                                            "window_slice_multi_batched": 0})
                cams.append(desk.app.data.camera)
        status = desk.drain_notifications()
        for i, (img, cam) in enumerate(zip(frames, cams)):
            want = desk.app.engine.render(cam, DESKTOP_W, DESKTOP_H, fast=True, host_copy=False).color
            if img is None or img.shape != (DESKTOP_H, DESKTOP_W, 3) or not np.array_equal(img, want):
                raise AssertionError(f"desktop frame {i}: differs from the engine's render")
        colours = len(np.unique(frames[-1].reshape(-1, 3), axis=0))
        if first is None or colours <= 200:
            raise AssertionError(f"desktop: first frame {first is not None}, {colours} colours")
        log(f"desktop (phase 4i, headless core; the Tk shell was not run): start to first {DESKTOP_W}x{DESKTOP_H} "
            f"frame (fetch, canvas build) {first_ms:.0f} ms; {DESKTOP_FRAMES} `render_frame` calls with W held: "
            f"{ms_stats(ms)}, K1/K2 {counts['crossing_search']}/{counts['window_slice_multi']} per frame, K1 "
            f"(N, W, H) {sorted(set(k1.shapes))}; each frame equals the engine's render bit for bit; "
            f"{colours} colours; status line {status!r}")
        return {"desktop_frame": counts}
    finally:
        desk.app.shutdown()
        del desk
        gc.collect()
        torch.cuda.empty_cache()


def frontends_path():
    """Phase 4i: the port's `BackendServer` serves phase 4h's 9 GeoTIFFs on
    127.0.0.1; the web frontend on CUDA (a thread of this process) answers
    `/location`, `/session`, fast, exact and yuv420_half frames, `/render`
    and its cache, then one and two requests in flight; then the desktop
    frontend's headless core. Returns the launch counts by path name."""
    import shutil
    import tempfile
    from pathlib import Path

    from topo_renderer_tpu_torch.backend.server import BackendServer
    from topo_renderer_tpu_torch.config import Settings

    root = Path(tempfile.mkdtemp(prefix="topo_backend_"))
    server = None
    try:
        write_backend_data(root, STREAM_LAT, STREAM_LON)
        server = BackendServer(Settings(address="127.0.0.1", port=0, data_dir=str(root)))
        server.start()
        lat, lon = STREAM_LAT + 1.5, STREAM_LON + 1.5
        counts = web_frontend_run(server.url, lat, lon)
        counts.update(desktop_run(server.url, lat, lon))
        return counts
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(root, ignore_errors=True)


# ---- phase 4j: the host mosaic build -----------------------------------------

def split_tables(m):
    """(heights, packed normals): name -> int32 words on the device."""
    tables = mosaic_tables(m)
    heights, normals = {}, {}
    for name, t in tables.items():
        if name.startswith(("attr_packed_flat", "mip_attr_flat")):
            heights[name], normals[name] = t[:, 0], t[:, 1]
        elif name.startswith("cell_heights_flat"):
            heights[name], normals[name] = t[:, :4], t[:, 4:]
        elif name.startswith("win_attr_2d"):
            heights[name], normals[name] = t[0], t[1]
        else:
            heights[name] = t
    return heights, normals


def compare_builds(host, device):
    """The host build against the device build: every height table bit for
    bit; packed normals within one code per 10-bit channel. Returns (tables
    equal, the largest code difference, the share of texels off by one)."""
    import torch

    hh, hn = split_tables(host)
    dh, dn = split_tables(device)
    differ = [k for k in dh if hh[k].shape != dh[k].shape or not torch.equal(hh[k], dh[k])]
    if hh.keys() != dh.keys() or differ or not np.array_equal(host.host.valid, device.host.valid):
        raise AssertionError(f"host build: height tables differ from the device build: {differ}")
    worst, off, total = 0, 0, 0
    for k in dn:
        a, b = hn[k].long(), dn[k].long()
        d = torch.stack([((a >> s) & 0x3FF) - ((b >> s) & 0x3FF) for s in (0, 10, 20)]).abs()
        worst = max(worst, int(d.max()))
        off += int((d > 0).any(dim=0).sum())
        total += a.numel()
    share = off / total
    if worst > 1 or share >= 0.02:
        raise AssertionError(f"host build: packed normals {worst} codes apart on {share:.4%} of texels")
    return len(dh), worst, share


def host_build_path():
    """Phase 4j: `RenderEngine(streaming=True, device_mosaic_build=False)` on
    the streaming scene's 3 x 3 tiles (a 6144^2 canvas): its first build
    (`build_mosaic(on_device=False)`, timed, with its numpy tables apart),
    a device build of the same tiles on the same canvas (timed) and the two
    compared, one slot update, then a fast (K1 1, K2 1) and an exact frame
    (K1 2) with 0 host syncs inside each. Returns the launch counts."""
    import dataclasses

    import torch

    from topo_renderer_tpu_torch.models import scene
    from topo_renderer_tpu_torch.render import engine as engine_mod

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = engine_mod.RenderEngine(streaming=True, device_mosaic_build=False)
    for lat in range(STREAM_LAT, STREAM_LAT + 3):
        for lon in range(STREAM_LON, STREAM_LON + 3):
            engine.add_terrain(*make_tile(lat, lon))
    clock = StageClock()
    clock.wrap(engine_mod, "build_mosaic", "build_mosaic", sync=True)
    clock.wrap(scene, "_host_mosaic_tables", "host tables")
    clock.wrap(scene, "_device_mosaic_tables", "device tables", sync=True)
    try:
        m = engine.mosaic
        host_ms, tables_ms = clock.ms("build_mosaic"), clock.ms("host tables")
        if clock.ms("device tables") or len(clock.spans["host tables"]) != 1:
            raise AssertionError("host build: the engine did not take the host build")
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        device = slot_order_build(engine)
        torch.cuda.synchronize()
        device_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        clock.restore()
    n_tables, worst, share = compare_builds(m, device)
    del device
    torch.cuda.empty_cache()
    log(f"host build (phase 4j): {engine._canvas[2]}x{engine._canvas[3]} canvas of 9 tiles: "
        f"build_mosaic(on_device=False) {host_ms:.0f} ms host clock (numpy and CPU-tensor tables {tables_ms:.0f} ms, "
        f"the assembly and the copy to the card the rest), peak device memory {peak / 1e9:.2f} GB above the "
        f"phase's start; the device build of the same canvas {device_ms:.0f} ms; {n_tables} height tables bit-equal, "
        f"packed normals at most {worst} code apart on {share:.5%} of texels")

    counts = {}
    engine.add_terrain(*make_tile(STREAM_LAT + 1, STREAM_LON + 3))
    if engine._dirty or [op for op, *_ in engine._pending] != ["add"]:
        raise AssertionError("host build: an add inside the canvas was not queued as a slot update")
    reset_counts()
    t0 = time.perf_counter()
    syncs = host_syncs(lambda: engine.mosaic)
    update_ms = 1e3 * (time.perf_counter() - t0)
    expect_counts("host build slot update", read_counts(), dict.fromkeys(read_counts(), 0))
    cam = camera_at(STREAM_LAT + 1.4, STREAM_LON + 2.3, 300.0)
    cam = dataclasses.replace(cam, yaw=yaw_toward(cam, 1.2), pitch=0.05)
    log(f"host build: one slot update on the host-built canvas {update_ms:.1f} ms host clock, {len(syncs)} host "
        f"syncs (the bounding sphere's hmax read)")
    for name, kw, want in (("host_build_fast_frame", dict(n_steps=512, fast=True),
                            {"crossing_search": 1, "window_slice_multi": 1}),
                           ("host_build_exact_frame", dict(EXACT_KW, exact_quality="full"),
                            {"crossing_search": 2, "window_slice_multi": 0})):
        def frame():
            return engine.render(cam, FAST_W, FAST_H, with_labels=False, host_copy=False, u8_host=False, **kw)

        frame()
        torch.cuda.synchronize()
        reset_counts()
        res = frame()
        torch.cuda.synchronize()
        counts[name] = read_counts()
        expect_counts(name, counts[name], dict(want, window_slice_multi_batched=0))
        syncs = host_syncs(frame)
        hit = float(res.hit.float().mean())
        if syncs or not 0.0 < hit < 1.0 or not bool(torch.isfinite(res.color_linear).all()):
            raise AssertionError(f"{name}: {len(syncs)} host syncs at {syncs[:4]}, hit {hit:.3f}")
        log(f"{name}: {FAST_W}x{FAST_H} on the host-built, updated canvas: hit {hit:.3f}, host syncs inside a "
            f"frame 0, launches {counts[name]}")
    del engine, m, res
    torch.cuda.empty_cache()
    return counts


# ---- phase 4k: multi-device rendering -----------------------------------------

GEO_BANDS = 4  # the 100-tile scene's row bands, all on the one card
CARD = "cuda:0"  # every band and shard of phase 4k


def tensor_bytes(x):
    """Bytes of a tensor, or of every tensor in nested tuples."""
    if x is None:
        return 0
    if isinstance(x, tuple):
        return sum(tensor_bytes(t) for t in x)
    return x.numel() * x.element_size()


def resident_bytes(m):
    """(bytes held by each band, bytes replicated on the lead device) of a
    row-sharded mosaic."""
    from topo_renderer_tpu_torch.models.scene import ARRAY_FIELDS

    bands, replicated = [0] * len(m.heights_flat), 0
    for name in ARRAY_FIELDS:
        leaf = getattr(m, name)
        for t in (leaf if name.startswith(("mip", "win")) else (leaf,)):
            if isinstance(t, tuple):
                for b, band in enumerate(t):
                    bands[b] += tensor_bytes(band)
            else:
                replicated += tensor_bytes(t)
    return bands, replicated


def equal_results(what, a, b, keys=("color", "color_linear", "depth", "distance", "hit")):
    """Two RenderResults equal bit for bit (tensors as int32 words)."""
    import torch

    for key in keys:
        x, y = getattr(a, key), getattr(b, key)
        x, y = (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)) for v in (x, y))
        if x.shape != y.shape or not torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)):
            raise AssertionError(f"{what}: {key} differs from the replicated engine's")
    if a.visible_labels != b.visible_labels:
        raise AssertionError(f"{what}: labels differ from the replicated engine's")


def timed_calls(fn, calls):
    """Per-call host-clock ms of ``calls`` calls, each synchronised."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def counted(fn):
    """Launch counts of one call of ``fn`` and its result."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    res = fn()
    torch.cuda.synchronize()
    return read_counts(), res


def geo_scene_paths(engine, cam, centre, batch=256):
    """Phase 4k, the geo mesh: `RenderEngine(geo_mesh=...)` with the 100
    tiles and their peaks, its mosaic row-sharded over GEO_BANDS bands all
    on cuda:0. Its config 6 fast frame, config 1 exact frame at both
    budgets, config 4 panorama and config 5 batch must equal the
    replicated engine's bit for bit. Returns the launch counts by path."""
    import torch

    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec
    from topo_renderer_tpu_torch.parallel.mesh import Mesh
    from topo_renderer_tpu_torch.render.engine import RenderEngine

    mesh = Mesh([CARD] * GEO_BANDS, ("geo",))
    geo = RenderEngine(geo_mesh=mesh)
    for loc, tile in engine._tiles.items():
        geo.add_terrain(loc, tile.heights, tile.transform)
    for loc, peaks in engine._peaks.items():
        geo.add_peaks(loc, peaks)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m = geo.mosaic
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bands, replicated = resident_bytes(m)
    if len(bands) != GEO_BANDS or m.sharded_rows[:1] != (0,) or not m.cell_sharded:
        raise AssertionError(f"geo engine: not sharded over {GEO_BANDS} bands ({m.sharded_rows})")
    log(f"geo mesh (phase 4k): {GEO_BANDS} row bands of the {engine.mosaic.shape[0]}x{engine.mosaic.shape[1]} "
        f"mosaic on {CARD}, padded to {m.shape}, sharded levels {m.sharded_rows}; build and shard "
        f"{build_s * 1e3:.0f} ms host clock; resident per band "
        + ", ".join(f"{b / 1e9:.3f}" for b in bands)
        + f" GB, replicated {replicated / 1e9:.3f} GB; peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB "
        f"above the phase's start, {(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB after")

    geo_accessors(m, engine.mosaic)

    counts = {}
    fast_kw = dict(n_steps=512, fast=True, with_labels=False, wire="yuv420", host_copy=False)
    frames = {
        "geo_fast_frame": (fast_kw, "fast frame (config 6)"),
        "geo_exact_frame": (dict(EXACT_KW, exact_quality="full", with_labels=False, host_copy=False, u8_host=False),
                            "exact frame (config 1, full)"),
        "geo_exact_frame_interactive": (dict(EXACT_KW, exact_quality="interactive", with_labels=False,
                                             host_copy=False, u8_host=False), "exact frame (config 1, interactive)"),
    }
    for name, (kw, what) in frames.items():
        def frame(e, kw=kw):
            return e.render(cam, FAST_W, FAST_H, **kw)

        ref_counts, ref = counted(lambda: frame(engine))
        counts[name], got = counted(lambda: frame(geo))
        keys = ("color", "color_linear", "depth", "distance", "hit")
        equal_results(f"geo {what}", got, ref, keys)
        host_ms = timed_calls(lambda: frame(geo), 5)
        ref_host_ms = timed_calls(lambda: frame(engine), 5)
        syncs = host_syncs(lambda: frame(geo))
        if syncs:
            raise AssertionError(f"geo {what}: {len(syncs)} host syncs inside a frame at {syncs[:8]}")
        dev_ms, why = graph_ms(lambda: frame(geo))
        ref_dev_ms, _ = graph_ms(lambda: frame(engine))
        log(f"geo {what}: {FAST_W}x{FAST_H}, equal to the replicated engine's frame bit for bit; host clock "
            f"{ms_stats(host_ms)} (replicated: {ms_stats(ref_host_ms)}); host syncs inside a frame 0; device only "
            f"(CUDA graph, 20 replays) "
            f"{f'{dev_ms:.3f} ms' if why is None else 'not measured (' + why + ')'} against "
            f"{'not measured' if ref_dev_ms is None else f'{ref_dev_ms:.3f} ms'} replicated; launches "
            f"{counts[name]} (replicated {ref_counts})")
    expect_counts("geo fast frame", counts["geo_fast_frame"],
                  {"crossing_search": 1, "window_slice_multi": GEO_BANDS, "window_slice_multi_batched": 0})
    for name in ("geo_exact_frame", "geo_exact_frame_interactive"):
        expect_counts(name, counts[name], {"crossing_search": 2, "window_slice_multi": 0,
                                           "window_slice_multi_batched": 0})

    pano_cam = camera_at(*centre, 300.0)
    spec = PanoramaSpec.fast(4096, 1024, n_steps=512)
    ref_counts, ref = counted(lambda: engine.render_panorama(pano_cam, spec, fog="atmosphere"))
    counts["geo_panorama"], got = counted(lambda: geo.render_panorama(pano_cam, spec, fog="atmosphere"))
    equal_results("geo panorama (config 4)", got, ref)
    expect_counts("geo panorama", counts["geo_panorama"],
                  {"crossing_search": 1, "window_slice_multi": GEO_BANDS, "window_slice_multi_batched": 0})
    pano_ms = cuda_ms(lambda: geo.render_panorama(pano_cam, spec, fog="atmosphere"), iters=3)
    ref_ms = cuda_ms(lambda: engine.render_panorama(pano_cam, spec, fog="atmosphere"), iters=3)
    log(f"geo panorama (config 4): 4096x1024 with labels, equal to the replicated panorama bit for bit "
        f"({sum(len(v) for v in got.visible_labels.values())} labels); {pano_ms:.2f} ms per frame (CUDA events, "
        f"3 frames) against {ref_ms:.2f} ms replicated; launches {counts['geo_panorama']} (replicated {ref_counts})")

    bspec = PanoramaSpec.fast(1024, 256, n_steps=512)
    eyes = batch_eyes(centre, batch)
    suns = torch.tensor([[0.3, 0.5, 0.8]], device=CARD).expand(batch, 3).contiguous()
    geo.render_batch(eyes[:8], bspec, suns[:8], fog="atmosphere")  # allocator warm-up
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {}
    reset_counts()
    batch_ms = cuda_ms(lambda: out.setdefault("got", geo.render_batch(eyes, bspec, suns, fog="atmosphere")),
                       iters=1, warmup=0)
    counts["geo_batch"] = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    expect_counts("geo batch", counts["geo_batch"],
                  {"crossing_search": batch, "window_slice_multi": 0, "window_slice_multi_batched": GEO_BANDS})
    ref_ms = cuda_ms(lambda: out.setdefault("want", engine.render_batch(eyes, bspec, suns, fog="atmosphere")),
                     iters=1, warmup=0)
    if not torch.equal(out.pop("got").view(torch.int32), out.pop("want").view(torch.int32)):
        raise AssertionError("geo batch: differs from the replicated engine's batch")
    log(f"geo batch (config 5): {batch} eyes at 1024x256, equal to the replicated batch bit for bit; "
        f"{batch_ms / 1e3:.3f} s per call (CUDA events) = {batch / (batch_ms * 1e-3):.1f} panoramas/s against "
        f"{ref_ms / 1e3:.3f} s = {batch / (ref_ms * 1e-3):.1f} panoramas/s replicated; pass 1 "
        f"holds every eye's windows: peak {peak / 1e9:.2f} GB above the call's start; launches {counts['geo_batch']}")
    check_band_windows(m, eyes, bspec)
    del geo, m
    torch.cuda.empty_cache()
    return counts


def geo_accessors(geo, mosaic):
    """Phase 4k: the geo mesh's `heights`, `normals_packed` and `normals`
    join its bands in row order on the lead device; their rows equal the
    unsharded mosaic's bit for bit, and the padded rows read poisoned
    heights and zero words, as JAX's sharded arrays do. `valid`,
    `cell_tile` and `tile_rot` equal the unsharded mosaic's."""
    import torch

    from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT

    h = mosaic.shape[0]
    t0 = time.perf_counter()
    for name in ("heights", "normals_packed", "normals"):
        got, want = getattr(geo, name), getattr(mosaic, name)
        if got.device != geo.device or got.shape[0] != geo.shape[0] or got.shape[1:] != want.shape[1:]:
            raise AssertionError(f"geo {name}: {tuple(got.shape)} on {got.device}, the mosaic's {tuple(want.shape)}")
        if not torch.equal(got[:h].view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"geo {name}: the bands' rows differ from the unsharded mosaic's")
        if name == "heights" and not (got[h:] == POISON_HEIGHT).all():
            raise AssertionError("geo heights: the padded rows are not poisoned")
        if name == "normals_packed" and got[h:].view(torch.int32).any():
            raise AssertionError("geo normals_packed: the padded rows are not zero words")
        del got, want
    for name in ("valid", "cell_tile", "tile_rot"):
        if not np.array_equal(np.asarray(getattr(geo, name)), np.asarray(getattr(mosaic, name))):
            raise AssertionError(f"geo {name}: differs from the unsharded mosaic's")
    torch.cuda.synchronize()
    log(f"geo accessors (phase 4k): heights, normals_packed and normals of the {len(geo.heights_flat)}-band mesh "
        f"({geo.shape[0]} rows, {geo.shape[0] - h} padded) equal the unsharded mosaic's bit for bit, the padded rows "
        f"poisoned / zero words; valid, cell_tile, tile_rot equal; {1e3 * (time.perf_counter() - t0):.0f} ms")
    torch.cuda.empty_cache()


def check_band_windows(mosaic, eyes, spec):
    """K3 at the geo batch's band origins: pass 1's band windows
    (`parallel/sharded_mosaic.py::_sharded_windows`) cut once more for the
    same eyes, each K3 launch held bit for bit against the plain version on
    its band tables and band-clamped origins."""
    import torch

    from topo_renderer_tpu_torch.ops import window_slice as K
    from topo_renderer_tpu_torch.ops.geometry import f32
    from topo_renderer_tpu_torch.ops.panorama import _eye_raster
    from topo_renderer_tpu_torch.parallel import sharded_mosaic as S

    kernel, shapes = S.window_slice_multi_batched, []

    def checked(tables, origins, *, wsy, wsx):
        got = kernel(tables, origins, wsy=wsy, wsx=wsx)
        want = K.window_slice_multi_batched_plain(tables, origins, wsy=wsy, wsx=wsx)
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)):
            raise AssertionError(f"K3 at the geo batch's band origins (launch {len(shapes)}): window bits differ "
                                 "from the plain version")
        shapes.append(f"{tuple(origins.shape)} over tables {[tuple(t.shape) for t in tables]}")
        return got

    S.window_slice_multi_batched = checked
    try:
        S._sharded_windows(mosaic, *_eye_raster(mosaic, f32(eyes, mosaic.device)), spec, batched=True)
    finally:
        S.window_slice_multi_batched = kernel
    if len(shapes) != GEO_BANDS:
        raise AssertionError(f"geo band windows: {len(shapes)} K3 launches, not {GEO_BANDS}")
    log(f"geo batch: K3 equal to its plain version bit for bit at each band's origins ({len(shapes)} launches: "
        f"{shapes[0]})")


def geo_streaming_path():
    """Phase 4k, streaming under a geo mesh: phase 4g's 3 x 3 tiles in a
    replicated streaming engine and in one with a 2-band geo mesh on
    cuda:0, the same six slot updates of a one-degree move; every band
    equals `shard_mosaic` of the replicated engine's updated tables bit for
    bit, and the fast and exact frames after the update equal the
    replicated ones. Returns the launch counts by path."""
    import dataclasses

    import torch

    from topo_renderer_tpu_torch.geo import GeoLocation
    from topo_renderer_tpu_torch.parallel.mesh import Mesh
    from topo_renderer_tpu_torch.parallel.sharded_mosaic import shard_mosaic
    from topo_renderer_tpu_torch.render.engine import RenderEngine

    mesh = Mesh([CARD] * 2, ("geo",))
    ref, geo = RenderEngine(device=CARD, streaming=True), RenderEngine(streaming=True, geo_mesh=mesh)
    ref._canvas_multiple_override = 8 * 2 * 4  # the geo engine's canvas
    for lat in range(STREAM_LAT, STREAM_LAT + 3):
        for lon in range(STREAM_LON, STREAM_LON + 3):
            tile = make_tile(lat, lon)
            for e in (ref, geo):
                e.add_terrain(*tile)
    ref.mosaic, geo.mosaic
    if ref._canvas != geo._canvas or geo.mosaic.shape != ref.mosaic.shape:
        raise AssertionError(f"geo streaming: canvases differ ({ref._canvas} vs {geo._canvas})")
    counts = {}
    for e in (ref, geo):
        for lat in range(STREAM_LAT, STREAM_LAT + 3):
            e.unload_terrain(GeoLocation.from_coord(lat, STREAM_LON))
        for lat in range(STREAM_LAT, STREAM_LAT + 3):
            e.add_terrain(*make_tile(lat, STREAM_LON + 3))
        if e._dirty or len(e._pending) != 6:
            raise AssertionError("geo streaming: the move east was not queued as six slot updates")
    torch.cuda.synchronize()
    ms = {}
    syncs = {}
    for name, e in (("replicated", ref), ("geo", geo)):
        reset_counts()
        t0 = time.perf_counter()
        syncs[name] = host_syncs(lambda e=e: e.mosaic)
        ms[name] = 1e3 * (time.perf_counter() - t0)
    counts["geo_streaming_update"] = read_counts()
    expect_counts("geo streaming update", counts["geo_streaming_update"],
                  dict.fromkeys(counts["geo_streaming_update"], 0))
    got = mosaic_tables(geo.mosaic)
    want = mosaic_tables(shard_mosaic(ref.mosaic, mesh, keep_cell_table=True))
    differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
    if got.keys() != want.keys() or differ:
        raise AssertionError(f"geo streaming: bands differ from the resharded replicated tables: {differ[:8]}")
    log(f"geo streaming (phase 4k): 3x3 tiles on a {geo._canvas[2]}x{geo._canvas[3]} canvas in 2 bands on "
        f"{CARD}; one degree east = 6 slot updates in {ms['geo']:.1f} ms host clock ({ms['geo'] / 6:.1f} ms per "
        f"update; host syncs in the pass {len(syncs['geo'])}) against {ms['replicated']:.1f} ms replicated "
        f"({len(syncs['replicated'])} host syncs); {len(want)} band and replicated tables equal `shard_mosaic` of "
        f"the replicated engine's updated tables bit for bit")

    cam = camera_at(STREAM_LAT + 1.4, STREAM_LON + 2.3, 300.0)
    cam = dataclasses.replace(cam, yaw=yaw_toward(cam, 1.2), pitch=0.05)
    for name, kw, want_counts in (
        ("geo_streaming_fast_frame", dict(n_steps=512, fast=True), {"crossing_search": 1, "window_slice_multi": 2}),
        ("geo_streaming_exact_frame", dict(EXACT_KW, exact_quality="full"),
         {"crossing_search": 2, "window_slice_multi": 0}),
    ):
        def frame(e, kw=kw):
            return e.render(cam, FAST_W, FAST_H, with_labels=False, host_copy=False, u8_host=False, **kw)

        frame(geo)
        counts[name], res = counted(lambda: frame(geo))
        expect_counts(name, counts[name], dict(want_counts, window_slice_multi_batched=0))
        equal_results(name, res, frame(ref), ("color_linear", "depth", "distance", "hit"))
        s = host_syncs(lambda: frame(geo))
        if s:
            raise AssertionError(f"{name}: {len(s)} host syncs inside a frame at {s[:8]}")
        log(f"{name}: {FAST_W}x{FAST_H} after the updates, equal to the replicated engine's frame bit for bit; "
            f"hit {float(res.hit.float().mean()):.3f}; host syncs inside a frame 0; launches {counts[name]}")
    del ref, geo, res
    torch.cuda.empty_cache()
    return counts


def dp_az_path(engine, centre, batch=8):
    """Phase 4k, dp x az = 2 x 2 on cuda:0: `render_batch_sharded` of
    ``batch`` eyes at 1024x256, 512 steps, with the scene's peaks. Every
    column equals the single-device raw panorama times (1 - the contour of
    the ring-wrapped depth) within the CPU test's tolerance
    (`tests/test_torch_parallel.py`), and ``visible`` equals the label
    visibility of the single-device depth. Returns the launch counts."""
    import torch

    from topo_renderer_tpu_torch.ops.labels import peak_visibility_panorama
    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, render_panorama
    from topo_renderer_tpu_torch.ops.postprocess import _contour_mix
    from topo_renderer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4, dp=2, az=2, devices=[CARD] * 4)
    spec = PanoramaSpec.fast(1024, 256, n_steps=512)
    eyes = batch_eyes(centre, batch)
    suns = torch.tensor([[0.3, 0.5, 0.8]], device=CARD).expand(batch, 3).contiguous()
    engine.render_batch_sharded(eyes[:4], spec, suns[:4], mesh)  # allocator warm-up
    counts, (color, depth, visible) = counted(lambda: engine.render_batch_sharded(eyes, spec, suns, mesh))
    expect_counts("dp x az batch", counts, {"crossing_search": 2 * batch, "window_slice_multi": 2 * batch,
                                            "window_slice_multi_batched": 0})
    _, pos, valid = engine._padded_peaks()
    share_c = share_d = 1.0
    worst_c = worst_d = 0.0
    n_visible = 0
    for b in range(batch):
        raw = render_panorama(engine.mosaic, eyes[b], spec, suns[b], apply_postprocess=False)
        d = raw["depth"]
        want_c = raw["color"] * (1.0 - _contour_mix(torch.cat([d[:, -1:], d, d[:, :1]], dim=1))[:, 1:-1, None])
        dd, dc = (depth[b] - d).abs(), (color[b] - want_c).abs().amax(-1)
        share_d, share_c = min(share_d, float((dd <= 1e-6).float().mean())), min(share_c, float((dc <= 1e-4).float().mean()))
        worst_d, worst_c = max(worst_d, float(dd.max())), max(worst_c, float(dc.max()))
        want_v = peak_visibility_panorama(pos, valid, eyes[b], spec, d)["visible"]
        if not torch.equal(visible[b], want_v):
            raise AssertionError(f"dp x az eye {b}: visible differs from the single-device label visibility")
        n_visible += int(visible[b].sum())
    if share_d < 0.999 or share_c < 0.999:
        raise AssertionError(f"dp x az: depth within 1e-6 on {share_d:.5f}, colours within 1e-4 on {share_c:.5f} "
                             f"of an eye's pixels (CPU test: >= 0.999 each)")
    call_ms = cuda_ms(lambda: engine.render_batch_sharded(eyes, spec, suns, mesh), iters=1, warmup=0)
    log(f"dp x az (phase 4k): 2 x 2 on {CARD}, {batch} eyes at 1024x256, 512 steps: {call_ms:.1f} ms per call "
        f"(CUDA events); against the single-device panorama with the ring-wrapped contour: depth within 1e-6 on "
        f">= {100 * share_d:.3f}% and colours within 1e-4 on >= {100 * share_c:.3f}% of each eye's pixels (max "
        f"{worst_d:.2e} and {worst_c:.2e}); visible equal to the label visibility of the single-device depth "
        f"({n_visible} visible in all); launches {counts}")
    return counts


def geo_application_check():
    """Phase 4k: `Application` with ``geo_shard=2``. With fewer than two
    cards it must raise RuntimeError naming the device count before any
    worker starts; with two or more it streams phase 4h's tiles from a
    local backend and renders 3 steps."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from topo_renderer_tpu_torch.app.application import Application
    from topo_renderer_tpu_torch.backend.server import BackendServer
    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.geo import GeoCoord

    count = torch.cuda.device_count()
    if count < 2:
        try:
            Application(Settings(backend_url="http://127.0.0.1:9", geo_shard=2))
        except RuntimeError as exc:
            if f"only {count} devices" not in str(exc):
                raise
            log(f"geo application: geo_shard=2 with {count} card raises RuntimeError: {exc}")
            return
        raise AssertionError("geo application: geo_shard=2 with one card did not raise")
    root = Path(tempfile.mkdtemp(prefix="topo_geo_backend_"))
    server = app = None
    try:
        write_backend_data(root, STREAM_LAT, STREAM_LON)
        server = BackendServer(Settings(address="127.0.0.1", port=0, data_dir=str(root)))
        server.start()
        app = Application(Settings(backend_url=server.url, geo_shard=2))
        app.viewport = (FAST_W, FAST_H)
        app.start(GeoCoord(STREAM_LAT + 1.5, STREAM_LON + 1.5))
        app.wait_for_terrain(timeout=APP_TIMEOUT_S)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = app.step(n_steps=512, fast=True)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if res is None or not res.hit.any():
                raise AssertionError("geo application: a step rendered no terrain")
        log(f"geo application: geo_shard=2 over {count} cards, {len(app.engine.loaded_locations)} tiles in, "
            f"3 fast steps at {FAST_W}x{FAST_H}: " + ", ".join(f"{t:.1f}" for t in ms) + " ms")
    finally:
        if app is not None:
            app.shutdown()
        if server is not None:
            server.stop()
        shutil.rmtree(root, ignore_errors=True)


def multi_device_path(engine, cam, centre):
    """Phase 4k: multi-device rendering on one card. Returns the launch
    counts by path name."""
    import torch

    t0 = time.perf_counter()
    counts = geo_scene_paths(engine, cam, centre)
    counts["dp_az_batch"] = dp_az_path(engine, centre)
    counts.update(geo_streaming_path())
    geo_application_check()
    log(f"multi-device (phase 4k): {time.perf_counter() - t0:.1f} s; every band and shard ran on {CARD} "
        f"({torch.cuda.device_count()} card(s) present), so transfers between cards and the capacity gain are not "
        f"measured")
    return counts


# ---- phase 4l: the measurement programs ------------------------------------------

K1, K2, K3, K4 = "crossing_search", "window_slice_multi", "window_slice_multi_batched", "window_slice"
BENCH_N = 12001
PERF_PROBE_N = 2401  # perf_probe's own default
SYNTH_CHECK_N = 801  # bench's smoke size: the card's build against the CPU's
HEIGHT_ATOL = 0.05  # metres (tests/test_torch_bench.py)
CODE_MAX, CODE_SHARE = 4, 0.005  # packed normal codes (tests/test_torch_bench.py)


def launches(k1=0, k2=0, k3=0, k4=0):
    return {K1: k1, K2: k2, K3: k3, K4: k4}


def bench_calls():
    """Calls of each loop of `bench.main` (each loop adds one warm-up call):
    the sustained loops, config 1's loops, config 5's batches and the wire
    loops."""
    from topo_renderer_tpu_torch import bench

    reps, chunks = bench.REPS["wire"]
    return {"sustained": 1 + max(1, bench.REPS["sustained"] // 4) * 4,
            "exact": 1 + max(1, bench.REPS["exact"] // 4) * 4,
            "batch": 1 + bench.REPS["batch"], "wire": 1 + reps * chunks}


def bench_launch_totals(eyes):
    """The launches each bench config must make in all: its calls per loop
    times each call's launches (config 4: K1 and K2 once per call, K2 once
    per extraction; config 5: K3 once per 256 eyes, K1 once per eye; config
    1: K1 twice per frame and per prepass; configs 6 and 3: K1 and K2 once
    per frame)."""
    from topo_renderer_tpu_torch.ops.panorama import EYES_PER_LAUNCH

    c = bench_calls()
    s, e, w = c["sustained"], c["exact"], c["wire"]
    return {4: launches(k1=s, k2=2 * s), 2: launches(k1=s, k2=s),
            5: launches(k1=eyes * c["batch"], k3=-(-eyes // EYES_PER_LAUNCH) * c["batch"]),
            1: launches(k1=2 * 3 * e), 6: launches(k1=2 * w + s, k2=2 * w + s), 3: launches(k1=w, k2=w)}


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "configs"}
BENCH_STAGES = {4: {"extract_ms", "render_ms"}, 2: None, 5: None, 3: {"label_overhead_ms"},
                1: {"prepass_ms", "march_ms", "gather_rounds", "ms_per_round", "interactive_rung_ms",
                    "rung_rounds", "rung_ms_per_round"},
                6: {"device_ms", "transport_ms", "wire_bytes", "rgb888_ms", "rgb888_bytes"}}


def check_bench_line(configs):
    """bench.py's keys, all six configs, finite positive values."""
    import math

    for c in configs:
        stages = BENCH_STAGES[c["config"]]
        values = [c["value"], *c["stats"].values(), *(c.get("stages") or {}).values()]
        if (stages is not None and set(c["stages"]) != stages) or not all(
                isinstance(v, (int, float)) and math.isfinite(v) for v in values) or c["value"] <= 0:
            raise AssertionError(f"bench config {c['config']}: bad record {c}")
    if sorted(c["config"] for c in configs) != [1, 2, 3, 4, 5, 6]:
        raise AssertionError(f"bench: configs {[c['config'] for c in configs]}")


def check_bench_output(name, out):
    """What one bench call gives: a frame (or the wire vector, decoded)
    with terrain and sky, finite, > 200 colours; the labelled frame's
    visible labels. Returns a short description."""
    import torch

    from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
    from topo_renderer_tpu_torch.render import transport

    if isinstance(out, tuple):  # a window extraction
        return f"{sum(w[1] is not None for w in out)} windowed levels"
    if isinstance(out, torch.Tensor):  # a wire vector
        peaks = 512 if name.endswith("config3") else 0
        img, lab = transport.decode_frame(out.cpu().numpy(), 450, 800, peaks, mode="yuv420")
        hit, n_labels = None, 0 if lab is None else int(lab[0].sum())
        if peaks and n_labels < 1:
            raise AssertionError(f"{name}: no visible label")
    elif "color" in out:
        if not bool(torch.isfinite(out["color"]).all()):
            raise AssertionError(f"{name}: colour not finite")
        img, hit, n_labels = to_srgb8_image(out["color"]).cpu().numpy(), float(out["hit"].float().mean()), 0
    else:  # the prepass's brackets
        hit = float(out["hit"].float().mean())
        if not 0.0 < hit < 1.0:
            raise AssertionError(f"{name}: prepass hit share {hit:.3f}")
        return f"hit {hit:.3f}"
    colors = len(np.unique(img.reshape(-1, 3), axis=0))
    if colors <= 200 or (hit is not None and not 0.0 < hit < 1.0):
        raise AssertionError(f"{name}: {colors} colours, hit {hit}")
    return f"{img.shape[1]}x{img.shape[0]}" + ("" if hit is None else f" hit {hit:.3f}") + f" {colors} colours" + (
        f" {n_labels} labels" if n_labels else "")


def bench_single_calls(fixtures):
    """One call of each form the bench times, with the launch counts reset
    before it: each call's own launches, and what it gives
    (`check_bench_output`). Returns the launches by path name."""
    import math

    import torch

    from topo_renderer_tpu_torch import bench
    from topo_renderer_tpu_torch.models.camera import Camera
    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, extract_clipmap_windows, panorama_crossing_prepass
    from topo_renderer_tpu_torch.ops.raycast import guided_march_defaults, guided_prepass_spec
    from topo_renderer_tpu_torch.render.engine import RenderEngine

    mosaic, eye, sun, labels, _ = fixtures
    cam = Camera(eye=eye, pitch=-0.05, yaw=0.8)
    fov = math.radians(45.0)
    spec4, spec2 = PanoramaSpec.fast(4096, 1024, n_steps=512), PanoramaSpec.fast(2048, 512, n_steps=512)
    gmd = guided_march_defaults()
    spec_pre, _, _ = guided_prepass_spec(height=450, fov_hint=fov, aspect=800 / 450, n_steps=1024,
                                         supersample=gmd["supersample"],
                                         elev_supersample=gmd.get("elev_supersample", 1.0))
    forms = {
        "bench_config4": (lambda: bench.panorama_call(mosaic, eye, spec4, sun, "atmosphere"), launches(1, 1)),
        "bench_config4_extract": (lambda: extract_clipmap_windows(mosaic, eye, spec4), launches(k2=1)),
        "bench_config2": (lambda: bench.panorama_call(mosaic, eye, spec2, sun, "distance"), launches(1, 1)),
        "bench_config1": (lambda: bench.exact_frame(mosaic, cam, 800, 450, fov), launches(k1=2)),
        "bench_config1_prepass": (lambda: panorama_crossing_prepass(mosaic, eye, spec_pre,
                                                                    bound_stride=gmd["bound_stride"]), launches(k1=2)),
        "bench_config1_rung": (lambda: bench.exact_frame(mosaic, cam, 800, 450, fov,
                                                         guided_kw=RenderEngine._EXACT_RUNG_INTERACTIVE),
                               launches(k1=2)),
        "bench_config6": (lambda: bench.wire_frame(mosaic, cam, 800, 450, fov), launches(1, 1)),
        "bench_config3": (lambda: bench.wire_frame(mosaic, cam, 800, 450, fov, labels=labels), launches(1, 1)),
    }
    counts, seen = {}, []
    for name, (fn, want) in forms.items():
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = read_counts()
        expect_counts(name, counts[name], want)
        seen.append(f"{name[6:]} {check_bench_output(name, out)}")
        del out
    log("bench (phase 4l): one call of each form: " + "; ".join(seen))
    return counts


def compare_synthetic(card, cpu):
    """The card's synthetic build against the CPU's under the tolerances
    the tests hold the port's build to against the JAX script's: (max
    height difference, share of texels whose packed normal differs, max
    code difference)."""
    import torch

    if card.shape != cpu.shape or card.mip_shapes != cpu.mip_shapes or (
            [w is None for w in card.win_attr_2d] != [w is None for w in cpu.win_attr_2d]):
        raise AssertionError("synthetic build: card and CPU tables differ in shape")
    heights = [(card.heights_flat, cpu.heights_flat), (card.cell_heights_flat, cpu.cell_heights_flat)]
    heights += list(zip(card.mip_heights_flat, cpu.mip_heights_flat)) + list(zip(card.mip_hmax_flat, cpu.mip_hmax_flat))
    h_diff = max(float((a.cpu() - b).abs().max()) for a, b in heights)
    attrs = [(card.attr_packed_flat, cpu.attr_packed_flat)] + list(zip(card.mip_attr_flat, cpu.mip_attr_flat))
    differ, texels, code_max = 0, 0, 0
    for a, b in attrs:
        wa, wb = a[:, 1].cpu().contiguous().view(torch.int32), b[:, 1].contiguous().view(torch.int32)
        d = torch.stack([((wa >> s) & 0x3FF) - ((wb >> s) & 0x3FF) for s in (0, 10, 20)]).abs()
        differ += int((d > 0).any(dim=0).sum())
        texels += d.shape[1]
        code_max = max(code_max, int(d.max()))
        h_diff = max(h_diff, float((a[:, 0].cpu() - b[:, 0]).abs().max()))
    share = differ / texels
    if h_diff > HEIGHT_ATOL or code_max > CODE_MAX or share > CODE_SHARE:
        raise AssertionError(f"synthetic build: card vs CPU heights {h_diff:.3g} m, normals {share:.4%} of "
                             f"texels up to {code_max} codes")
    return h_diff, share, code_max


def check_demo(path, what):
    from PIL import Image

    img = np.asarray(Image.open(path))
    colors = len(np.unique(img.reshape(-1, 3), axis=0))
    if img.shape != (512, 2048, 3) or colors <= 200:
        raise AssertionError(f"make_demos {what}: {img.shape}, {colors} colours")
    return colors


def bench_path():
    """Phase 4l: the port's measurement programs on the card. Returns the
    launch counts per call by path name."""
    import torch

    from topo_renderer_tpu_torch import bench, build_dir
    from topo_renderer_tpu_torch.models.scene import ARRAY_FIELDS
    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, _window_batch
    from topo_renderer_tpu_torch.scripts import make_demos, perf_probe, stage_probe, trace_render

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fixtures = bench.bench_fixtures("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mosaic = fixtures[0]
    tables = sum(tensor_bytes(getattr(mosaic, name)) for name in ARRAY_FIELDS)
    if mosaic.shape != (BENCH_N, BENCH_N) or mosaic.cell_width != 4:
        raise AssertionError(f"bench scene: {mosaic.shape}, cell width {mosaic.cell_width}")
    log(f"bench scene (phase 4l): synthetic_mosaic_device({BENCH_N}) built on the card in {build_s:.2f} s; "
        f"{tables / 1e9:.2f} GB of tables; the build's peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB "
        f"above the phase's start; 512 peaks and {fixtures[4].shape[0]} viewpoints")

    totals, current = {}, [None]

    def mark(config):
        if current[0] is not None:
            totals[current[0]] = read_counts()
        reset_counts()
        current[0] = config

    configs = []
    t0 = time.perf_counter()
    bench.main(configs, fixtures=fixtures, mark=mark)
    bench_s = time.perf_counter() - t0
    bench._emit(configs)
    check_bench_line(configs)
    want = bench_launch_totals(fixtures[4].shape[0])
    for config in (4, 2, 5, 1, 6, 3):
        expect_counts(f"bench config {config}", totals[config], want[config])
    calls = bench_calls()
    log(f"bench (phase 4l): the six configs in {bench_s:.1f} s; launches in all (K1/K2/K3/K4) by config: "
        + "; ".join(f"{c}: {'/'.join(str(totals[c][k]) for k in (K1, K2, K3, K4))}" for c in (4, 2, 5, 1, 6, 3))
        + f" (calls per loop, warm-up included: {calls})")

    counts = bench_single_calls(fixtures)
    counts["bench_config5"] = {k: v // calls["batch"] for k, v in totals[5].items()}
    log("bench (phase 4l): launches per call (K1/K2/K3/K4): "
        + "; ".join(f"{name[6:]} {'/'.join(str(c[k]) for k in (K1, K2, K3, K4))}" for name, c in counts.items()))

    spec4 = PanoramaSpec.fast(4096, 1024, n_steps=512)
    shapes = hold_to_plain("bench config 4", caught_kernel_inputs(
        lambda: bench.panorama_call(mosaic, fixtures[1], spec4, fixtures[2], "atmosphere"),
        (K1, K2)))
    log(f"bench config 4's own kernel inputs: {shapes} equal their plain versions bit for bit")
    spec5 = PanoramaSpec.fast(1024, 256, n_steps=512)
    shapes = hold_to_plain("bench config 5", caught_kernel_inputs(
        lambda: _window_batch(mosaic, fixtures[4], spec5), (K3,)))
    log(f"bench config 5's own kernel inputs: {shapes} equal their plain version bit for bit")
    del fixtures, mosaic
    torch.cuda.empty_cache()

    # stage_probe: each stage's launches per call, its bench loop counted.
    per_stage, real_bench = {}, stage_probe.bench

    def counted_bench(label, fn, *args, reps=20):
        reset_counts()
        ms = real_bench(label, fn, *args, reps=reps)
        per_stage[label] = {k: v / (reps + 1) for k, v in read_counts().items()}
        return ms

    t0 = time.perf_counter()
    stage_probe.bench = counted_bench
    try:
        stage_ms = stage_probe.main([])
    finally:
        stage_probe.bench = real_bench
    stage_want = [launches(k2=1), launches(), launches(k1=1), launches(1, 1)]
    for (label, got), want_stage in zip(per_stage.items(), stage_want):
        expect_counts(f"stage_probe {label.strip()}", got, want_stage)
    counts.update({f"stage_probe_{i}": {k: int(v) for k, v in c.items()} for i, c in enumerate(per_stage.values(), 1)})
    log(f"stage_probe (phase 4l, n {BENCH_N}): {time.perf_counter() - t0:.1f} s; stages "
        f"{', '.join(f'{k} {v:.2f} ms' for k, v in stage_ms.items())}; launches per call (K1/K2/K3/K4) "
        + ", ".join("/".join(str(int(c[k])) for k in (K1, K2, K3, K4)) for c in per_stage.values()))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_counts()
    sweep = perf_probe.main(["--n", str(PERF_PROBE_N)])
    probe_counts = read_counts()
    calls_per_spec = 6  # bench(): a warm-up and 5 timed calls
    counts["perf_probe_sweep"] = {k: v // (calls_per_spec * len(sweep)) for k, v in probe_counts.items()}
    log(f"perf_probe (phase 4l, n {PERF_PROBE_N}): the sweep in {time.perf_counter() - t0:.1f} s; best "
        + ", ".join(f"{s.width}x{s.height} N={s.n_steps} {best * 1e3:.2f} ms" for s, best in sweep)
        + f"; launches in all (K1/K2/K3/K4) {'/'.join(str(probe_counts[k]) for k in (K1, K2, K3, K4))} over "
        f"{calls_per_spec * len(sweep)} calls (the non-LOD spec crosses by reductions, not K1)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_counts()
    top = trace_render.main(["--trace-dir", str(build_dir() / "trace_render")])
    trace_counts = read_counts()
    counts["trace_render"] = {k: v // 3 for k, v in trace_counts.items()}
    if not top:
        raise AssertionError("trace_render: the trace holds no device operation")
    log(f"trace_render (phase 4l, n 1201): {time.perf_counter() - t0:.1f} s; {len(top)} top operations, the first "
        f"{top[0][1][:60]!r} {top[0][0]:.2f} ms; launches in all (K1/K2/K3/K4) "
        f"{'/'.join(str(trace_counts[k]) for k in (K1, K2, K3, K4))} over 3 renders")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_counts()
    demos = make_demos.main([])
    counts["make_demos"] = {k: v // 2 for k, v in read_counts().items()}
    expect_counts("make_demos, per panorama", counts["make_demos"], launches(1, 1))
    colors = {key: check_demo(demos[key], key) for key in ("panorama", "fog")}
    if demos["labels"] < 1:
        raise AssertionError("make_demos: no label laid out")
    log(f"make_demos (phase 4l): {time.perf_counter() - t0:.1f} s; {demos['panorama'].name} ({colors['panorama']} "
        f"colours, {demos['labels']} labels) and {demos['fog'].name} ({colors['fog']} colours), 2048x512, in "
        f"{demos['panorama'].parent}")

    t0 = time.perf_counter()
    card = perf_probe.synthetic_mosaic_device(n=SYNTH_CHECK_N)
    cpu = perf_probe.synthetic_mosaic_device(n=SYNTH_CHECK_N, device="cpu")
    h_diff, share, code_max = compare_synthetic(card, cpu)
    log(f"synthetic build (phase 4l, n {SYNTH_CHECK_N}): card vs CPU heights within {h_diff:.3g} m, packed normals "
        f"differ on {share:.4%} of texels by at most {code_max} codes ({time.perf_counter() - t0:.1f} s)")
    del card, cpu
    torch.cuda.empty_cache()
    log(f"measurement programs (phase 4l): {time.perf_counter() - t_phase:.1f} s in all")
    return counts


def small_scene_agreement():
    """One small scene on the card and on the CPU (plain versions): the
    same frame up to float rounding. Dither seeds hash world positions, so
    an ulp of difference changes a pixel's dither; the check holds hit masks
    and depth, which do not hash."""
    import dataclasses
    import math

    import torch

    from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec

    tiles = make_tiles(lat0=46, lon0=11, tiles=2, n=301)
    peaks = make_peaks(47.0, 12.0, 16, 0.1, 46, 11, 2)
    cam = camera_at(47.0, 12.0, 300.0)
    engines = {dev: build_engine(dev, tiles, peaks) for dev in ("cuda", "cpu")}
    fast = PanoramaSpec.fast(512, 128, n_steps=256)
    # The fast preset under each fog mode (bench.py's config 2 takes distance
    # fog), its colours also at the golden tolerance: distance fog's
    # `torch.exp` need not round on the card as on the CPU, and a last bit
    # flips a pixel's dither.
    panoramas = {"fast": (fast, "atmosphere"), "fast distance fog": (fast, "distance"),
                 "fast no fog": (fast, None),
                 "fallback": (PanoramaSpec(width=1024, height=256, n_steps=512, n_refine=2), "atmosphere")}
    for name, (spec, fog) in panoramas.items():
        g, c = (engines[dev].render_panorama(cam, spec, fog=fog, composite=False) for dev in ("cuda", "cpu"))
        hit_agree = float((g.hit == c.hit).mean())
        both = g.hit & c.hit
        rel = np.abs(g.depth - c.depth)[both].max() if both.any() else 0.0
        far = float((np.abs(g.color.astype(np.int16) - c.color.astype(np.int16)) > 2).any(-1).mean())
        if (hit_agree < 0.99 or rel > 1e-3 or not 0.0 < g.hit.mean() < 1.0
                or (spec is fast and far > 0.01)):
            raise AssertionError(f"small scene {name}: card vs CPU hit agreement {hit_agree:.4f}, "
                                 f"depth diff {rel:.2e}, hit {g.hit.mean():.3f}, pixels beyond 2/255 {far:.4f}")
        n_g, n_c = (sum(len(v) for v in r.visible_labels.values()) for r in (g, c))
        log(f"small scene {name}: card vs CPU hit agreement {hit_agree:.4f}, max depth diff {rel:.2e}, "
            f"pixels beyond 2/255 {far:.4f}, labels {n_g} / {n_c}")
    # The fast frame: level, 1.1 rad down (window rows past -pi/2), and a
    # window across azimuth ±pi; the exact frame, guided and unguided.
    fast_kw = dict(n_steps=256, fast=True)
    exact_kw = dict(n_steps=512, n_refine=16, fast=False, exact_quality="full")
    poses = {"fast frame": (cam, fast_kw),
             "fast frame 1.1 rad down": (dataclasses.replace(cam, pitch=1.1), fast_kw),
             "fast frame across ±pi": (dataclasses.replace(cam, yaw=yaw_toward(cam, math.pi - 0.2)), fast_kw),
             "exact frame guided": (cam, exact_kw),
             "exact frame unguided": (cam, dict(exact_kw, guided=False))}
    for name, guided_kw in UNGUARDED.items():
        poses[name.replace("_", " ")] = (cam, dict(exact_kw, guided_kw=guided_kw))
    syncs = host_syncs(lambda: engines["cuda"].render(cam, 320, 180, composite=False,
                                                      **poses["exact frame unguided"][1]))
    log(f"small scene exact frame unguided (two-level march, 512 steps) at 320x180: {len(syncs)} host syncs "
        f"inside a frame (its loop condition, read once every 4 rounds)")
    for name, (pose, kw) in poses.items():
        g, c = (engines[dev].render(pose, 320, 180, composite=False, **kw) for dev in ("cuda", "cpu"))
        # Distance, relative to itself. Where a fast-frame pixel's four window
        # texels include sky, the blend carries FAR (500 km) into its
        # distance, so a last bit of the blend weight moves that pixel by up
        # to a percent (7.8e-3 on the level frame); an exact-frame pixel at a
        # depth edge moves as far (1.5e-2). Elsewhere the readings are ~5e-5.
        # The p99 and the share above 2e-3 catch a march or warp that moves
        # distances; the max bounds the skyline's pixels.
        hit_agree = float((g.hit == c.hit).mean())
        both = g.hit & c.hit
        ddepth = float(np.abs(g.depth - c.depth)[both].max()) if both.any() else 0.0
        rel_img = np.where(both, np.abs(g.distance - c.distance) / c.distance, 0.0)
        rel = rel_img[both] if both.any() else np.zeros(1)
        sky = np.pad(~both, 2, constant_values=False)
        near_sky = np.zeros_like(both)
        for dy in range(5):
            for dx in range(5):
                near_sky |= sky[dy : dy + both.shape[0], dx : dx + both.shape[1]]
        p99, over, inland = np.quantile(rel, 0.99), float((rel > 2e-3).mean()), rel_img[~near_sky].max(initial=0.0)
        y, x = np.unravel_index(np.argmax(rel_img), rel_img.shape)
        around = c.distance[max(y - 1, 0) : y + 2, max(x - 1, 0) : x + 2]
        # Colours at the golden tolerance: a last bit flips a pixel's dither.
        near = float((np.abs(g.color.astype(np.int16) - c.color.astype(np.int16)).max(-1) <= 2).mean())
        # The marches without the own-texel leg resolve a silhouette pixel
        # from a pooled bracket alone, so a last bit can move it to the
        # bracket's other crossing: their max is the tests' march limit
        # against jitted JAX (`tests/test_torch_exact_frame.py`).
        max_rel = 5e-2 if "unguarded" in name else 2e-2
        if (hit_agree < 0.99 or ddepth > 1e-3 or p99 > 5e-4 or over > 0.01 or rel.max() > max_rel or near < 0.99
                or not g.hit.any()):
            raise AssertionError(f"small scene {name}: card vs CPU hit agreement {hit_agree:.4f}, "
                                 f"depth diff {ddepth:.2e}, relative distance diff p99 {p99:.2e} max "
                                 f"{rel.max():.2e} above 2e-3 {over:.4f}, colours within 2/255 {near:.4f}, "
                                 f"hit {g.hit.mean():.3f}")
        n_g, n_c = (sum(len(v) for v in r.visible_labels.values()) for r in (g, c))
        log(f"small scene {name}: card vs CPU hit agreement {hit_agree:.4f}, max depth diff {ddepth:.2e}, "
            f"relative distance diff p99 {p99:.2e} max {rel.max():.2e} (max {inland:.2e} beyond 2 px of sky; "
            f"at the max, distances {around.min():.0f}..{around.max():.0f} m in its 3x3 pixels), "
            f"share above 2e-3 {over:.5f}, colours within 2/255 {near:.4f}, hit {g.hit.mean():.3f}, "
            f"labels {n_g} / {n_c}")
    del engines
    torch.cuda.empty_cache()


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU", file=sys.stderr)
        return 2
    try:
        from topo_renderer_tpu_torch import cuda_build
    except ImportError:
        print("chip_smoke: run from the repository root (topo_renderer_tpu_torch not found)",
              file=sys.stderr)
        return 2

    card = card_info()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "Function properties" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    floor = noop_floor()
    log(f"floor: an empty kernel (torch.cuda._sleep(0)) {floor['cold']:.4f} ms cold, {floor['warm']:.4f} ms warm "
        f"(CUDA events per launch, as every kernel below)")
    k1 = check_crossing()
    if not kernels_only:
        check_crossing_edges()
    k2, k4 = check_window_slice()
    torch.cuda.empty_cache()
    k3 = check_window_slice_batched()
    torch.cuda.empty_cache()
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "warm_ms", "device_ms",
             "device_warm_ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "bytes", "library_ms", "library_warm_ms",
             "library_calls", "floor_ms", "floor_warm_ms", "origins", "bound_every_window_ms", "writes_only_ms",
             "launches_per_call", "batch_shape", "fast_shape", "prepass_shape", "random_origins")
    kernels = [k1, k2, k3, k4]
    for k in kernels:
        k.update(floor_ms=floor["cold"], floor_warm_ms=floor["warm"])
    if not kernels_only:
        small_scene_agreement()
    engine, centre = build_scene()
    config5_window_readings(k3, engine, centre)
    device_times(kernels)
    if kernels_only:
        print(json.dumps({"kernels": [{key: k[key] for key in order if key in k} for k in kernels]}), flush=True)
        print(card, flush=True)
        return 0
    mosaic_accessors(engine)
    per_call = {}
    per_call["panorama"], frame_ms = panorama_path(engine, centre)
    per_call["config2"], config2 = config2_path(engine, centre)
    per_call["batch"], batch_ms, panos_per_s = batch_path(engine, centre)
    per_call["fallback"] = fallback_path(engine, centre)
    cam = fast_camera(engine, centre)
    per_call["fast_frame"], fast_ms, fast_dev_ms, fast_profile = fast_frame_path(engine, cam)
    per_call["fast_frame_labels"], labelled_ms, label_ms = labelled_fast_frame_path(engine, cam)
    exact_counts, exact_ms, exact_dev_ms, exact_profile = exact_frame_path(engine, cam)
    per_call["exact_frame"], per_call["exact_frame_interactive"] = exact_counts["full"], exact_counts["interactive"]
    per_call.update(unguarded_exact_frames(engine, cam))
    per_call.update(multi_device_path(engine, cam, centre))
    del engine
    torch.cuda.empty_cache()
    per_call.update(bench_path())
    per_call.update(streaming_path())
    per_call.update(host_runtime_path())
    per_call.update(frontends_path())
    per_call.update(host_build_path())
    # ``launches``: one call of the path each kernel serves (K3 and K1: the
    # batch; K2: the single panorama); every path's count is in
    # ``launches_per_call``. ``ms``/``bound_ms`` of K1 are at config 4's
    # shape, ``batch_shape`` and ``fast_shape`` hold them at the batch
    # path's and the 800 x 450 fast frame's.
    path_of = {"crossing_search": "batch", "window_slice_multi": "panorama",
               "window_slice_multi_batched": "batch", "window_slice": "panorama"}
    for k in kernels:
        k["launches"] = per_call[path_of[k["name"]]][k["name"]]
        k["launches_per_call"] = {path: c[k["name"]] for path, c in per_call.items()}
    log(f"frame: {frame_ms:.2f} ms (CUDA events); config 5: {panos_per_s:.1f} panoramas/s "
        f"({batch_ms:.1f} ms per call of 256 viewpoints); "
        f"K3 {k3['ms']:.4f} ms cold at its origins vs 256 x K2 {k3['random_origins']['k2_loop_ms']:.3f} ms")
    c2_dev = "not measured" if config2["graph_ms"] is None else f"{config2['graph_ms']:.3f} ms"
    log(f"config 2 (2048x512, distance fog): median {np.median(config2['host_ms']):.2f} ms host clock, "
        f"{config2['host_syncs']} host syncs inside a call, device only {c2_dev} (CUDA graph replay), "
        f"the phase {config2['phase_s']:.1f} s; {card}")
    busy = (f"device busy {fast_profile[1]:.2f} of {fast_profile[0]:.2f} ms "
            f"({100 * fast_profile[1] / fast_profile[0]:.1f}%)" if fast_profile else "device busy not measured")
    log(f"fast frame (config 6): median {np.median(fast_ms):.2f} ms host clock incl. pull and decode, "
        f"device only {'not measured' if fast_dev_ms is None else f'{fast_dev_ms:.3f} ms'} (CUDA events), "
        f"{busy}; with labels (config 3): median "
        f"{np.median(labelled_ms):.2f} ms, label overhead {label_ms:.2f} ms (frames in turn)")
    exact_busy = (f"device busy {exact_profile[1]:.2f} of {exact_profile[0]:.2f} ms "
                  f"({100 * exact_profile[1] / exact_profile[0]:.1f}%)" if exact_profile else "device busy not measured")
    log(f"exact frame (config 1): median {np.median(exact_ms['full']):.2f} ms host clock incl. the u8 pull at the "
        f"full budget, {np.median(exact_ms['interactive']):.2f} ms on the interactive rung; device only "
        f"{exact_dev_ms['full']:.3f} / {exact_dev_ms['interactive']:.3f} ms (CUDA graph replay); host syncs inside "
        f"a frame 0; {exact_busy}; K1 {per_call['exact_frame']['crossing_search']} launches per frame; K1 at the "
        f"prepass shape {k1['prepass_shape']['ms']:.4f} ms cold (CUDA events), {k1['prepass_shape']['device_ms']:.4f} "
        f"ms by the profiler, bound {k1['prepass_shape']['bound_ms']:.5f} ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order if key in k} for k in kernels]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
