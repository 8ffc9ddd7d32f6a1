"""Performance probe of the panorama renderer, and the synthetic scene that
`topo_renderer_tpu_torch.bench` measures (not a test).

Port of the repository's ``scripts/perf_probe.py``. The terrain is made on
the device from closed-form relief, so no tile is read or copied from the
host; real scenes pay that copy once per tile load.

    python -m topo_renderer_tpu_torch.scripts.perf_probe              # CUDA, n = 2401
    python -m topo_renderer_tpu_torch.scripts.perf_probe --device cpu --n 257

Every function here runs on the CUDA device unless the caller names another
(``device="cpu"``), and raises without CUDA.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from topo_renderer_tpu_torch import resolve_device
from topo_renderer_tpu_torch.models.scene import MosaicHostData, TerrainMosaic, _dilate3
from topo_renderer_tpu_torch.models.uniforms import normal_to_world_rotation
from topo_renderer_tpu_torch.ops.geometry import R0, to_device
from topo_renderer_tpu_torch.ops.normals import compute_normals
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, render_panorama
from topo_renderer_tpu_torch.utils.profiling import _wait_for

WINDOW_TABLE_MIN = 262_144  # levels above this many texels get a 2-D window table


def _grid(n: int, device) -> torch.Tensor:
    """``arange(n) / n`` in float32, each value correctly rounded: divided in
    float64 and rounded once (a CUDA float32 division by a Python scalar
    multiplies by the reciprocal and misses by an ulp)."""
    return to_device((torch.arange(n, dtype=torch.float64) / n).float(), device)


def _heights(n: int, rugged: bool, device) -> torch.Tensor:
    """The relief ``f32[n, n]``: a sum of four sinusoid products, or six
    ridged octaves. The expressions keep the JAX script's order of
    operations, so each step rounds as there."""
    g = _grid(n, device)
    ys, xs = g[:, None], g[None, :]
    h = torch.full((n, n), 1500.0, dtype=torch.float32, device=device)
    if rugged:
        # Ridged multi-octave relief for demo imagery (alpine look).
        for k in range(6):
            f = 6.0 * (2.0**k)
            amp = 900.0 / (1.6**k)
            band = torch.sin(f * xs * math.pi + 0.7 * k) * torch.cos(
                f * ys * math.pi + 1.3 * k + torch.sin(3.0 * xs + k)
            )
            h += amp * (1.0 - torch.abs(band)) - 0.5 * amp
    else:
        for k in range(1, 5):
            h += (600.0 / k) * torch.sin(12 * k * xs * math.pi + 0.3 * k) * torch.cos(
                12 * k * ys * math.pi + 1.1 * k
            )
    return h


def _packed_normals(h: torch.Tensor, level: int, rot3: torch.Tensor, lon_nw, lat_nw, ps) -> torch.Tensor:
    """World-space normals of one pyramid level packed 10/10/10 into int32
    words: `compute_normals` at the level texel's centre offset, rotated
    by the scene's one tile rotation."""
    s = float(2**level)
    off = (s - 1.0) / 2.0
    normals = compute_normals(h, (ps * s, ps * s), (0, 0), (lon_nw + ps * off, lat_nw - ps * off), quantize=True)
    world = torch.einsum("ij,hwj->hwi", rot3, normals)
    del normals
    enc = torch.round(torch.clamp(0.5 * (world + 1.0), 0.0, 1.0) * 1023.0).to(torch.int32)
    del world
    return enc[..., 0] | (enc[..., 1] << 10) | (enc[..., 2] << 20)


def _pool(cur: torch.Tensor) -> torch.Tensor:
    hh, ww = cur.shape[0] // 2, cur.shape[1] // 2
    c = cur[: 2 * hh, : 2 * ww]
    return 0.25 * (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2])


def _pool_max(cur: torch.Tensor, out_shape) -> torch.Tensor:
    hh, ww = out_shape
    c = cur[: 2 * hh, : 2 * ww]
    return torch.maximum(torch.maximum(c[0::2, 0::2], c[0::2, 1::2]), torch.maximum(c[1::2, 0::2], c[1::2, 1::2]))


def synthetic_mosaic_device(n=2401, lat_nw=52.0, lon_nw=18.0, ps=1.0 / 1200.0, rugged=False, device=None):
    """A ``n x n`` `TerrainMosaic` of closed-form relief, built on ``device``
    (default: CUDA), with the tables of the JAX script's scene: heights,
    packed (height, normal) rows, the 2x2 mean pyramid while a level is at
    least 8 texels on its short side, its packed normals, the 3x3-dilated
    max pyramid, 2-D window tables for levels above 262,144 texels and a
    4-wide cell table (corner heights only, wrapping at the east and south
    edges as ``roll`` does). Every texel is valid and owned by one tile
    whose rotation is the north-west corner's; the bounding sphere is the
    JAX script's (centre on the sphere, radius ``n * ps * 111 km``)."""
    device = resolve_device(device)
    rot3 = normal_to_world_rotation(lon_nw, lat_nw)[:3, :3].contiguous()
    rot3_dev = to_device(rot3, device)

    def pack_attr(hh, pp):
        return torch.stack([hh.reshape(-1), pp.view(torch.float32).reshape(-1)], dim=-1)

    def win2d(hh, pp):
        return torch.stack([hh, pp.view(torch.float32)], dim=0) if hh.numel() > WINDOW_TABLE_MIN else None

    h = _heights(n, rugged, device)
    packed = _packed_normals(h, 0, rot3_dev, lon_nw, lat_nw, ps)
    mips = []
    cur = h
    while min(cur.shape) >= 8:
        cur = _pool(cur)
        mips.append(cur)
    mip_packed = [_packed_normals(m, lv, rot3_dev, lon_nw, lat_nw, ps) for lv, m in enumerate(mips, 1)]
    mip_hmax = []
    cur = h
    for m in mips:
        cur = _pool_max(cur, m.shape)
        mip_hmax.append(_dilate3(cur).reshape(-1))
    e = torch.roll(h, -1, dims=1)
    s_ = torch.roll(h, -1, dims=0)
    se = torch.roll(s_, -1, dims=1)
    cell = torch.stack([h.reshape(-1), e.reshape(-1), s_.reshape(-1), se.reshape(-1)], dim=-1)
    del e, s_, se

    lat_c = lat_nw - ps * n / 2
    lon_c = lon_nw + ps * n / 2
    lam, phi = np.radians(lon_c), np.radians(lat_c)
    center = np.array(
        [R0 * np.cos(phi) * np.cos(lam), R0 * np.cos(phi) * np.sin(lam), R0 * np.sin(phi)], np.float32
    )
    radius = np.float32(n * ps * 111_000.0)
    mip_shapes = tuple(tuple(m.shape) for m in mips)
    model_point = np.array([lon_nw, lat_nw], np.float32)
    pixel_scale = np.array([ps, ps], np.float32)
    return TerrainMosaic(
        heights_flat=h.reshape(-1),
        attr_packed_flat=pack_attr(h, packed),
        cell_heights_flat=cell,
        has_cell_table=True,
        shape=(n, n),
        mip_heights_flat=tuple(m.reshape(-1) for m in mips),
        mip_attr_flat=tuple(pack_attr(m, p) for m, p in zip(mips, mip_packed)),
        mip_hmax_flat=tuple(mip_hmax),
        mip_shapes=mip_shapes,
        win_attr_2d=(win2d(h, packed),) + tuple(win2d(m, p) for m, p in zip(mips, mip_packed)),
        host=MosaicHostData(
            valid=np.ones((n, n), bool),
            cell_tile=np.zeros((n, n), np.int32),
            tile_rot=rot3.numpy()[None],
            model_point=model_point,
            pixel_scale=pixel_scale,
        ),
        model_point=to_device(torch.from_numpy(model_point), device),
        pixel_scale=to_device(torch.from_numpy(pixel_scale), device),
        hmax=h.max(),
        bound_center=to_device(torch.from_numpy(center), device),
        bound_radius=to_device(torch.tensor(radius), device),
    )


def eye_at(lat_deg, lon_deg, alt) -> torch.Tensor:
    """The ECEF point ``alt`` metres above the sphere at a latitude and
    longitude, ``f32[3]`` on the host: a camera's eye stays on the CPU, so
    that no frame reads it back from the device."""
    lam, phi = np.radians(lon_deg), np.radians(lat_deg)
    r = R0 + alt
    return torch.tensor(
        [r * np.cos(phi) * np.cos(lam), r * np.cos(phi) * np.sin(lam), r * np.sin(phi)], dtype=torch.float32
    )


def bench(fn, *args, reps=5):
    """The best of ``reps`` host-clock seconds of ``fn(*args)`` after one
    warm-up call, each call waited for on its device; and the warm-up's
    output."""
    out = fn(*args)
    _wait_for(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _wait_for(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times), out


SWEEP = ((1024, 256, 512, 4), (2048, 512, 768, 4), (4096, 1024, 1024, 4))  # width, height, steps, refinements


def main(argv=None, *, sweep=SWEEP) -> list:
    """The sweep of non-LOD atmospheric panoramas on the n x n scene around
    50.5N 20E. Prints one line per spec; returns ``[(spec, best s), ...]``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=2401, help="texels per side of the synthetic scene")
    p.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else device, flush=True)
    t0 = time.perf_counter()
    mosaic = synthetic_mosaic_device(n=args.n, device=device)
    _wait_for(mosaic.heights_flat)
    print(f"mosaic on device: {time.perf_counter() - t0:.1f}s", flush=True)
    eye = eye_at(50.5, 20.0, 2800.0)
    sun = torch.tensor([0.3, 0.5, 0.8])

    results = []
    for (w, h, n, nr) in sweep:
        spec = PanoramaSpec(width=w, height=h, n_steps=n, n_refine=nr)
        best, _ = bench(lambda: render_panorama(mosaic, eye, spec, sun, fog="atmosphere")["color"])
        print(f"{w}x{h} N={n}: best {best * 1e3:.2f} ms  ({w * h / best / 1e6:.0f} Mpix/s)", flush=True)
        results.append((spec, best))
    return results


if __name__ == "__main__":
    main()
