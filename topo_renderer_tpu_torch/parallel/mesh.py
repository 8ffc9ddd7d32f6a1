"""Device meshes for multi-device rendering, and the collectives over them.

Port of `topo_renderer_tpu/parallel/mesh.py`. The JAX package drives every
device of a `jax.sharding.Mesh` from one process through `shard_map`; here a
`Mesh` is the same single-controller object over an explicit list of torch
devices, and the collectives that `shard_map` bodies call (`ppermute`,
`psum`, `pmax`, the masked sums that assemble a sharded table's rows) are
plain functions over per-shard tensors, run by the one process:

  * ``("dp", "az")`` meshes (`make_mesh`): ``dp`` data parallelism over
    viewpoints, ``az`` one panorama's columns split across devices with a
    1-column halo ring for the postprocess contour (`ring_halos`) and an
    integer sum of the label decisions (`psum_int`);
  * ``("geo",)`` meshes: the mosaic's large tables split into row bands, one
    per device (`parallel/sharded_mosaic.py`); reads gather in each band and
    select the owner's rows (`gather_rows`, `select`), the slot update's
    ``hmax`` is a `pmax`.

A device may appear more than once in a mesh when it is named explicitly
(``Mesh(["cpu"] * 8, ("geo",))`` is the tests' counterpart of XLA's eight
virtual CPU devices; ``["cuda:0"] * 4`` runs every sharded path on one
card). Nothing repeats a device or falls back to the CPU on its own.

Assembly is by selection, never by a float sum: a row-sharded table's words
include packed normals that are float32 denormals, and a sum of zeros would
turn ``-0.0`` into ``+0.0``. Every selection moves int32 words.
"""

from __future__ import annotations

import numpy as np
import torch


def canonical(device) -> torch.device:
    """``device`` as a torch.device with its CUDA index filled in, so that
    "cuda" and "cuda:0" compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Named axes over an array of torch devices (JAX's ``Mesh(devices,
    axis_names)``): ``devices`` is array-like (nested lists allowed) with
    one dimension per name; ``shape`` maps each name to its size."""

    def __init__(self, devices, axis_names):
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        flat = [canonical(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        shape = np.shape(np.asarray(devices, dtype=object))
        if len(shape) != len(names):
            raise ValueError(f"mesh of shape {shape} needs {len(shape)} axis names, got {names}")
        self.devices = arr.reshape(shape)
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The first device: replicated tables and computed-once outputs
        live here."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, dp: int | None = None, az: int | None = None, *,
              devices=None) -> Mesh:
    """A ``(dp, az)`` mesh over ``n_devices`` devices (JAX's defaults: all
    of ``dp`` unless ``az`` or ``dp`` is given).

    ``devices=None`` takes the first ``n_devices`` CUDA devices (all of them
    when ``n_devices`` is None) and raises RuntimeError when there are
    fewer; an explicit list may repeat a device. ``dp * az`` must equal
    ``n_devices`` (ValueError).
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if n < 1 or count < n:
            raise RuntimeError(
                f"make_mesh needs {n} CUDA devices and {count} are available; pass devices=[...] "
                "to name them (a named device may repeat)"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = list(devices)
        n = len(devices) if n_devices is None else n_devices
        if not 1 <= n <= len(devices):
            raise ValueError(f"make_mesh: {n} devices asked for, {len(devices)} named")
        devices = devices[:n]
    if az is None:
        az = 1 if dp is None else n // dp
    if dp is None:
        dp = n // az
    if dp * az != n:
        raise ValueError(f"dp({dp}) * az({az}) != devices({n})")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, az).tolist(), ("dp", "az"))


# ---- collectives over per-shard tensors ------------------------------------


def ring_halos(parts):
    """`ppermute` around a ring along the last axis: for each shard i, the
    last column of shard i - 1 and the first column of shard i + 1 (the
    ring wraps), on shard i's device."""
    n = len(parts)
    return [
        (parts[(i - 1) % n][..., -1:].to(parts[i].device), parts[(i + 1) % n][..., :1].to(parts[i].device))
        for i in range(n)
    ]


def psum_int(parts, device):
    """`psum` of integer tensors onto ``device`` (exact in any order)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def pmax(parts, device):
    """`pmax` of per-shard tensors onto ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device))
    return out


def select(parts, masks, device):
    """Assemble by selection: each element from the one part whose mask
    holds it, as int32 words on ``device`` (zero words where no mask does).
    Parts are 32-bit tensors of one shape; masks broadcast against them."""
    acc = None
    for part, mask in zip(parts, masks):
        words = part.view(torch.int32).to(device)
        acc = torch.where(mask.to(device), words, 0 if acc is None else acc)
    return acc.view(parts[0].dtype)


def gather_rows(table, idx):
    """``table[idx]`` of a float32 table, gathered as int32 words, for a
    tensor or for a row-sharded table: a tuple of bands of equal length,
    band b holding rows [b n, (b + 1) n). Each band gathers the indices it
    owns on its device, and the owner's rows are selected onto ``idx``'s
    device (`select`). ``idx`` is an int64 tensor of valid row indices."""
    if not isinstance(table, tuple):
        return table.view(torch.int32)[idx].view(table.dtype)
    n_loc = table[0].shape[0]
    parts, masks = [], []
    for b, band in enumerate(table):
        k = idx - b * n_loc
        ok = (k >= 0) & (k < n_loc)
        parts.append(band.view(torch.int32)[torch.clamp(k, 0, n_loc - 1).to(band.device)])
        masks.append(ok if band.dim() == 1 else ok[..., None])
    return select(parts, masks, idx.device).view(table[0].dtype)
