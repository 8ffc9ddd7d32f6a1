"""Central application state.

Copy of `topo_renderer_tpu/app/state.py` for the PyTorch port; it imports nothing
of the JAX package.

Parity with `topo-renderer/src/data/application_data.rs:11-45`: the current
location, the loaded tile set, the camera and the postprocessing settings.
Peak lists and label buffers live in the RenderEngine (tile-keyed), as the
reference keeps them beside the renderers.
"""

from __future__ import annotations

import dataclasses

from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera


@dataclasses.dataclass
class ApplicationData:
    camera: Camera = dataclasses.field(default_factory=Camera)
    current_location: GeoCoord | None = None
    loaded_locations: set[GeoLocation] = dataclasses.field(default_factory=set)
    pixelize_n: float = 100.0  # disabled (`application_data.rs:31`)
    camera_changed: bool = True
