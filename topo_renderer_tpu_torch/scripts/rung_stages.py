"""The guided exact frame on the card against its CPU evaluation, stage by
stage, at the full budget and at the interactive rung (not a test).

Builds `perf_probe.synthetic_mosaic_device(n)` (the benchmark's bench
scene at n = 12001) on the device, copies its tables to the host, and
renders `render_perspective` (guided, 1024 steps, 24 refinements, a 45°
fov hint, the engine's two budgets) from the same camera on both: the
free-fly path's start, 2800 m above the scene's centre, pitch -0.05, at
a few yaws. Each stage's outputs are recorded on both devices, in call
order: the camera rays, the prepass profiles, K1's outputs, the prepass
brackets, the pooled brackets, each quadratic leg, the cell walk, the
walked leg, the shading inputs (normals, dither seeds) and its colours,
the postprocess's inputs and colours. For each stage it prints the share
of elements whose bits differ, the share beyond 1e-5 relative and the
largest relative difference; then the u8 frame's share of pixels beyond
2/255, with the postprocess and without it (the colours it was given),
and the hit masks' share that differs.

``--host-rays`` also renders each frame on the device from the rays the
host computes (its `camera_rays` output copied across), which holds
whatever the rays' last bits do apart from the rest. ``--path-poses``
takes the cameras of the benchmark's free-fly path instead
(`benchmarks/workload.py`, run from a checkout's root): ``exact800``
checks pose 20 at the full budget and pose 240 at the rung in a full run
(its 20 warm-up and 200 timed requests of each budget in turn), pose 42
with ``--check-only``.

    python -m topo_renderer_tpu_torch.scripts.rung_stages --host-rays --out rung_stages.json
    python -m topo_renderer_tpu_torch.scripts.rung_stages --device cpu --n 801 --size 160x90   # code path
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.models.scene import ARRAY_FIELDS
from topo_renderer_tpu_torch.ops import panorama, raycast
from topo_renderer_tpu_torch.ops import shading as shd
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.scripts.perf_probe import eye_at, synthetic_mosaic_device

FOV = math.radians(45.0)
BUDGETS = {"full": (), "rung": (("n_window", 3), ("split_brackets", False))}  # `RenderEngine`'s two
PS, LAT_NW, LON_NW = 1.0 / 1200.0, 52.0, 18.0  # the synthetic scene's texel and NW corner
REL = 1e-5

# Module attributes wrapped while a frame renders: (module, name, record the inputs too).
STAGES = (
    (raycast, "camera_rays", False),
    (panorama, "_prepass_profiles", False),
    (panorama, "crossing_search", False),
    (raycast, "panorama_crossing_prepass", False),
    (raycast, "_grouped_bracket_pools", False),
    (raycast, "_quad_leg", False),
    (raycast, "_cell_walk_core", False),
    (raycast, "_walk_leg", False),
    (shd, "shade_soa", True),
    (raycast, "postprocess_soa", True),
)


def _tensors(x, prefix=""):
    """``[(label, host tensor)]`` of every tensor in nested tuples, lists and
    dicts."""
    if isinstance(x, torch.Tensor):
        return [(prefix or "out", x.detach().cpu())]
    if isinstance(x, dict):
        return [t for k, v in x.items() for t in _tensors(v, f"{prefix}.{k}" if prefix else str(k))]
    if isinstance(x, (tuple, list)):
        return [t for i, v in enumerate(x) for t in _tensors(v, f"{prefix}[{i}]")]
    return []


class Recorder:
    """Wraps `STAGES` while it is entered; ``records``: ``[(stage, [(label,
    tensor)])]`` in call order."""

    def __init__(self, ray_device=None):
        self.records = []
        self.ray_device = ray_device
        self._saved = []

    def __enter__(self):
        for mod, name, inputs in STAGES:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn, inputs))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()

    def _wrap(self, name, fn, inputs):
        def wrapped(*args, **kw):
            if name == "camera_rays" and self.ray_device is not None:
                device = kw.pop("device", None)
                (dx, dy, dz), fwd = fn(*args, device=self.ray_device, **kw)
                out = (tuple(d.to(device) for d in (dx, dy, dz)), fwd.to(device))
            else:
                out = fn(*args, **kw)
            got = (_tensors(args, "in") if inputs else []) + _tensors(out)
            self.records.append((name, got))
            return out
        return wrapped


def render(mosaic, cam, width, height, guided_kw, ray_device=None):
    """The frame's outputs on the host and its stage records."""
    with Recorder(ray_device) as rec:
        out = raycast.render_perspective(mosaic, cam, width=width, height=height, n_steps=1024, n_refine=24,
                                         guided=True, fov_hint=FOV, guided_kw=guided_kw)
        image = to_srgb8_image(out["color"]).cpu().numpy()
    return {"image": image, "hit": out["hit"].cpu().numpy(), "distance": out["distance"].cpu().numpy()}, rec.records


def compare(a: torch.Tensor, b: torch.Tensor) -> dict:
    """``a`` against ``b``: the share of elements whose bits differ, the share
    beyond ``REL`` relative, the largest relative difference."""
    if a.shape != b.shape:
        return {"shape": [list(a.shape), list(b.shape)], "differ": 1.0, "beyond": 1.0, "max_rel": float("inf")}
    if not a.is_floating_point():
        d = (a != b).float().mean().item() if a.numel() else 0.0
        return {"differ": d, "beyond": d, "max_rel": float(d > 0)}
    a64, b64 = a.double(), b.double()
    same = (a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)) | (a64.isnan() & b64.isnan())
    rel = ((a64 - b64).abs() / b64.abs().clamp(min=1e-30)).nan_to_num(nan=float("inf"), posinf=float("inf"))
    rel = torch.where(same, 0.0, rel)
    n = max(a.numel(), 1)
    return {"differ": 1.0 - same.sum().item() / n, "beyond": (rel > REL).sum().item() / n,
            "max_rel": rel.max().item() if a.numel() else 0.0}


def compare_stages(card, host) -> list:
    """One row per recorded call: the stage, its call index, and its worst
    tensor's reading with the others that differ."""
    rows, seen = [], {}
    for (name, got), (name_h, want) in zip(card, host):
        if name != name_h or len(got) != len(want):
            rows.append({"stage": name, "error": f"the host recorded {name_h} here"})
            break
        i = seen[name] = seen.get(name, -1) + 1
        tensors = {label: compare(x, y) for (label, x), (_, y) in zip(got, want)}
        worst = max(tensors, key=lambda k: (tensors[k]["beyond"], tensors[k]["differ"]), default=None)
        rows.append({"stage": name, "call": i, "worst": worst, **(tensors[worst] if worst else {}),
                     "tensors": {k: v for k, v in tensors.items() if v["differ"] > 0}})
    return rows


def frame_reading(card, host, card_rec, host_rec) -> dict:
    """The u8 frames' share of pixels beyond 2/255, the same for the colours
    the postprocess was given (quantized as the frame is), and the hit
    masks' share that differs."""
    def bad(a, b):
        return float((np.abs(a.astype(np.int32) - b.astype(np.int32)) > 2).any(axis=-1).mean())

    def pre_post(records):
        chans = [t for name, got in records if name == "postprocess_soa" for label, t in got
                 if label.startswith("in[0]")]
        return to_srgb8_image(torch.stack(chans, dim=-1)).numpy()

    return {"beyond_2_255": bad(card["image"], host["image"]),
            "beyond_2_255_before_postprocess": bad(pre_post(card_rec), pre_post(host_rec)),
            "hit_differs": float((card["hit"] != host["hit"]).mean()),
            "distance_beyond_rel": float(((np.abs(card["distance"] - host["distance"]) /
                                           np.maximum(np.abs(host["distance"]), 1e-30)) > REL).mean())}


def to_host(mosaic):
    """The mosaic with its tables copied to the host."""
    def cpu(x):
        if isinstance(x, tuple):
            return tuple(cpu(v) for v in x)
        return x.cpu() if isinstance(x, torch.Tensor) else x

    return dataclasses.replace(mosaic, **{f: cpu(getattr(mosaic, f)) for f in ARRAY_FIELDS})


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=12001, help="texels per side of the synthetic scene")
    p.add_argument("--size", default="800x450", help="frame width x height")
    p.add_argument("--yaws", default="0.8,2.4,4.0", help="camera yaws (rad), comma-separated")
    p.add_argument("--path-poses", default=None, help="poses of the benchmark's free-fly path, comma-separated")
    p.add_argument("--seed", type=int, default=0, help="the path's seed (with --path-poses)")
    p.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    p.add_argument("--host-rays", action="store_true", help="also render on the device from the host's rays")
    p.add_argument("--out", default=None, help="write the readings as JSON here")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    width, height = (int(v) for v in args.size.split("x"))
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else device, flush=True)
    t0 = time.perf_counter()
    mosaic = synthetic_mosaic_device(n=args.n, device=device)
    host = to_host(mosaic)
    print(f"scene n {args.n} built and copied to the host in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.path_poses:
        from benchmarks.workload import Workload

        poses = [int(v) for v in args.path_poses.split(",")]
        path = Workload(args.seed, args.n).cameras(max(poses) + 1)
        cameras = {f"pose {i}": path[i] for i in poses}
    else:
        centre = (LAT_NW - PS * (args.n - 1) / 2, LON_NW + PS * (args.n - 1) / 2)
        eye = eye_at(*centre, 2800.0)
        cameras = {f"yaw {v}": Camera(eye=eye, pitch=-0.05, yaw=float(v), fov_y=FOV) for v in args.yaws.split(",")}
    variants = {"card": None}
    if args.host_rays:
        variants["card_host_rays"] = torch.device("cpu")
    result = {"n": args.n, "size": [width, height], "frames": []}
    for where, cam in cameras.items():
        for budget, kw in BUDGETS.items():
            t0 = time.perf_counter()
            want, want_rec = render(host, cam, width, height, kw)
            host_s = time.perf_counter() - t0
            for variant, ray_device in variants.items():
                got, got_rec = render(mosaic, cam, width, height, kw, ray_device)
                reading = {"camera": where, "budget": budget, "variant": variant, "host_s": host_s,
                           **frame_reading(got, want, got_rec, want_rec), "stages": compare_stages(got_rec, want_rec)}
                result["frames"].append(reading)
                print(f"{where} {budget} {variant}: beyond 2/255 {100 * reading['beyond_2_255']:.4f}% "
                      f"(before the postprocess {100 * reading['beyond_2_255_before_postprocess']:.4f}%), hits "
                      f"differ {100 * reading['hit_differs']:.4f}%, distance beyond {REL:g} relative "
                      f"{100 * reading['distance_beyond_rel']:.4f}% (host frame {host_s:.1f} s)", flush=True)
                for row in reading["stages"]:
                    if "error" in row:
                        print(f"  {row['stage']}: {row['error']}", flush=True)
                        continue
                    print(f"  {row['stage']}[{row['call']}]: worst {row['worst']}: bits differ "
                          f"{100 * row.get('differ', 0):.4f}%, beyond {REL:g} {100 * row.get('beyond', 0):.4f}%, "
                          f"max rel {row.get('max_rel', 0):.3g}; differing: "
                          + (", ".join(f"{k} {100 * v['differ']:.3f}%/{100 * v['beyond']:.4f}%"
                                       for k, v in row["tensors"].items()) or "none"), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
