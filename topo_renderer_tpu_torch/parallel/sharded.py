"""Batched panoramas over a (dp, az) device mesh.

Port of `topo_renderer_tpu/parallel/sharded.py`:

  * ``dp``: the batch's viewpoints split across devices, no communication;
  * ``az``: one panorama's azimuth columns split across devices. Each shard
    renders its ``width / az`` columns (``azimuth_offset``,
    ``pixel_offset_x``) without the postprocess; the contour's 3x3 stencil
    then takes one halo column from each neighbour around the azimuth ring
    (`parallel/mesh.py::ring_halos`; the ring wraps, which for a 360°
    panorama is more correct than the single-device edge clamp);
  * peak labels: each shard tests the peaks against its own depth columns,
    and an integer sum over ``az`` merges the decisions (each peak projects
    into one shard).

The JAX package runs this as one `shard_map` program; here one process
renders each shard on its device in turn. The mosaic is replicated: each
distinct device of the mesh gets a copy of its tables, once per call
(`_replica`; none on a mesh whose devices are all the mosaic's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from topo_renderer_tpu_torch.models.scene import ARRAY_FIELDS
from topo_renderer_tpu_torch.ops.geometry import f32
from topo_renderer_tpu_torch.ops.labels import peak_visibility_panorama
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, render_panorama
from topo_renderer_tpu_torch.ops.postprocess import _contour_mix
from topo_renderer_tpu_torch.parallel.mesh import canonical, psum_int, ring_halos


def _replica(mosaic, device):
    """``mosaic`` with every table on ``device``, copied as int32 words
    (the mosaic itself where it is there already)."""
    device = canonical(device)
    if canonical(mosaic.device) == device:
        return mosaic

    def move(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(move(t) for t in x)
        return x.view(torch.int32).to(device).view(x.dtype) if x.element_size() == 4 else x.to(device)

    return dataclasses.replace(mosaic, **{name: move(getattr(mosaic, name)) for name in ARRAY_FIELDS})


def render_batch_sharded(
    mosaic,
    eyes,
    sun_directions,
    spec: PanoramaSpec,
    mesh,
    *,
    view_mode=0,
    fog: str | None = None,
    peak_positions=None,
    peak_valid=None,
):
    """Render ``eyes f32[B, 3]`` panoramas over a (dp, az) mesh.

    Returns ``(color f32[B, H, W, 3], depth f32[B, H, W], visible
    bool[B, P])`` on the mesh's lead device (``visible`` is ``[B, 0]`` when
    no peaks are given).
    """
    n_az = mesh.shape["az"]
    n_dp = mesh.shape["dp"]
    eyes = f32(eyes)
    suns = f32(sun_directions)
    B = eyes.shape[0]
    if B % n_dp:
        raise ValueError(f"batch {B} not divisible by dp={n_dp}")
    if spec.width % n_az:
        raise ValueError(f"width {spec.width} not divisible by az={n_az}")

    local_spec = dataclasses.replace(
        spec,
        width=spec.width // n_az,
        azimuth_span=spec.azimuth_span / n_az,
        elev_min=spec.elevation_range()[0],
        elev_max=spec.elevation_range()[1],
    )
    has_peaks = peak_positions is not None
    if not has_peaks:
        peak_positions = torch.zeros((8, 3), dtype=torch.float32)
        peak_valid = torch.zeros((8,), dtype=torch.bool)
    b_loc = B // n_dp
    lead = mesh.lead
    replicas = {}

    colors, depths, visible = [], [], []  # per dp row
    for i in range(n_dp):
        row = []
        for j in range(n_az):
            dev = mesh.devices[i, j]
            if dev not in replicas:
                replicas[dev] = _replica(mosaic, dev)
            m = replicas[dev]
            # The JAX shard's float32 offset (span / az) * index, one rounding.
            offset = f32(np.float32(spec.azimuth_span / n_az) * np.float32(j), dev)
            px_offset = float((spec.width // n_az) * j)
            ppos = f32(peak_positions, dev)
            pvalid = torch.as_tensor(peak_valid).to(dev)
            outs = []
            for b in range(i * b_loc, (i + 1) * b_loc):
                e = eyes[b].to(dev)
                out = render_panorama(
                    m, e, local_spec, suns[b].to(dev), view_mode=view_mode, fog=fog,
                    apply_postprocess=False, azimuth_offset=offset, pixel_offset_x=px_offset,
                )
                vis = peak_visibility_panorama(ppos, pvalid, e, local_spec, out["depth"], azimuth_offset=offset)
                outs.append((out["color"], out["depth"], vis["visible"]))
            row.append(tuple(torch.stack(x) for x in zip(*outs)))  # [b, H, Wl, 3], [b, H, Wl], [b, P]

        # Halo exchange around the azimuth ring for the contour stencil.
        halos = ring_halos([d for _, d, _ in row])
        mixed = []
        for (color, depth, _), (left, right) in zip(row, halos):
            mixf = _contour_mix(torch.cat([left, depth, right], dim=-1))[..., 1:-1]
            mixed.append((color * (1.0 - mixf[..., None])).to(lead))
        colors.append(torch.cat(mixed, dim=2))
        depths.append(torch.cat([d.to(lead) for _, d, _ in row], dim=2))
        # Label decisions merged across the azimuth shards.
        visible.append(psum_int([v.to(torch.int32) for _, _, v in row], lead) > 0)

    color = torch.cat(colors, dim=0)
    depth = torch.cat(depths, dim=0)
    vis = torch.cat(visible, dim=0)
    if not has_peaks:
        vis = vis[:, :0]
    return color, depth, vis


def jit_sharded_step(mosaic, spec, mesh, **kw):
    """The JAX package's jitted step over a fixed mosaic, spec and mesh, as
    a plain closure: ``step(eyes, suns, ppos, pvalid)`` ->
    `render_batch_sharded`'s outputs."""

    def step(eyes, suns, ppos, pvalid):
        return render_batch_sharded(mosaic, eyes, suns, spec, mesh, peak_positions=ppos, peak_valid=pvalid, **kw)

    return step
