"""Depth snapshot identity + row-pitch helpers.

Copy of `topo_renderer_tpu/models/depth_state.py` for the PyTorch port; it imports nothing
of the JAX package.

Parity with `topo-renderer/src/data/mod.rs`:
  * ``Size`` — generic width/height pair (`mod.rs:13-26`);
  * ``pad_256`` — wgpu depth-readback rows are padded to 256 bytes
    (`mod.rs:9-11`); kept for byte-level compatibility with tooling that
    parses reference depth dumps;
  * ``DepthState`` — identity key of a depth snapshot {size, camera}
    (`mod.rs:46-50`): the reference occlusion-tests labels against a
    one-frame-old readback and uses this key to reject stale snapshots
    (`render_engine.rs:219-223,289`).

Here the depth buffer never leaves the device and the label pass runs on
the same frame's depth, so staleness cannot occur; ``DepthState`` remains the
engine's snapshot identity for interactive frontends that cache depth.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def pad_256(row_bytes: int) -> int:
    """Round a row byte count up to 256 (`data/mod.rs:9-11`)."""
    return (int(row_bytes) + 255) // 256 * 256


@dataclasses.dataclass(frozen=True)
class Size:
    width: Any
    height: Any


@dataclasses.dataclass
class DepthState:
    """Identity of a depth snapshot: reject label lookups whose viewport or
    camera no longer matches (`render_engine.rs:289`)."""

    size: Size
    camera: Any  # models.camera.Camera

    def matches(self, size: Size, camera) -> bool:
        import numpy as np

        if (self.size.width, self.size.height) != (size.width, size.height):
            return False
        try:
            return bool(
                np.allclose(np.asarray(self.camera.eye), np.asarray(camera.eye))
                and float(self.camera.pitch) == float(camera.pitch)
                and float(self.camera.yaw) == float(camera.yaw)
                and float(self.camera.fov_y) == float(camera.fov_y)
            )
        except Exception:
            return False
