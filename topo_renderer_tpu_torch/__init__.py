"""topo_renderer_tpu_torch: the terrain vista renderer on PyTorch and CUDA.

A port of `topo_renderer_tpu` (JAX/XLA/Pallas) to PyTorch on an NVIDIA
Hopper GPU. Module paths mirror the JAX package's, so each module's
counterpart is found under the same name. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a CUDA kernel written by hand
(`csrc/`), built with nvcc at first use and bound with ctypes
(`cuda_build.py`). Beside every kernel its module keeps a plain PyTorch
version of the same function: the wrapper runs it for tensors on the CPU
(the tests) and launches the kernel for CUDA tensors, never falling back.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

import os
from pathlib import Path

import torch

# Rendering geometry (ECEF positions ~6.4e6 m with metre-scale features)
# needs true float32 products; the JAX package forces "highest" matmul
# precision for the same reason. TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

PACKAGE_DIR = Path(__file__).resolve().parent


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raises when CUDA is absent instead of
    running somewhere else."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "topo_renderer_tpu_torch runs on a CUDA device by default and "
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def build_dir(package_dir: Path = PACKAGE_DIR) -> Path:
    """Where the native libraries of the package (`cuda_build.py`'s kernels,
    `native/`'s host library) are built.

    In a checkout (or a `git archive` of one), where the package's parent
    holds ``pyproject.toml``, that is ``build/topo_renderer_tpu_torch/`` at
    its root. Elsewhere (an installed package, whose parent is
    site-packages) it is the per-user cache:
    ``$XDG_CACHE_HOME/topo_renderer_tpu_torch``, or
    ``~/.cache/topo_renderer_tpu_torch`` where that variable is unset or not
    an absolute path.
    """
    root = Path(package_dir).parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "topo_renderer_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME", "")
    if not os.path.isabs(cache):
        cache = os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "topo_renderer_tpu_torch"


# The public names of the JAX package's top level. Imported after
# `resolve_device` and `build_dir`, which submodules import from the package.
from topo_renderer_tpu_torch.config import Settings  # noqa: E402
from topo_renderer_tpu_torch.geo import (  # noqa: E402
    GeoCoord,
    GeoLocation,
    Latitude,
    LatitudeDirection,
    Longitude,
    LongitudeDirection,
)

__all__ = [
    "GeoCoord",
    "GeoLocation",
    "Latitude",
    "LatitudeDirection",
    "Longitude",
    "LongitudeDirection",
    "Settings",
    "__version__",
]
