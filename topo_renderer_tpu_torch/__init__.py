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

import torch

# Rendering geometry (ECEF positions ~6.4e6 m with metre-scale features)
# needs true float32 products; the JAX package forces "highest" matmul
# precision for the same reason. TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


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
