"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use by ``nvcc -shared`` into the package's build directory (`build_dir`:
``build/topo_renderer_tpu_torch/`` at the root of a checkout, else the
per-user cache), under a file name keyed by a hash of the source, then
loaded with ctypes. Nothing here runs when a module is imported: the CPU tests
import every module on machines without nvcc.

It also holds what every wrapper needs to launch a kernel on PyTorch's
current stream: `current_stream` and `on_device`.

Flags: ``sm_90a`` (Hopper), ``-O3``, and neither ``--use_fast_math`` nor
``-ftz=true``: the window copy moves packed-normal words whose bit patterns
are float32 denormals, and the crossing search must compare exactly as the
plain PyTorch version does.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from topo_renderer_tpu_torch import build_dir

SRC_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("crossing", "window_slice")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        raise RuntimeError(f"cannot create the kernel build directory {out.parent}: {exc}") from exc
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every listed source that is not built yet, one nvcc each,
    all started together."""
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, the stream
    a kernel of this package launches on: the value of
    ``torch.cuda.current_stream(device).cuda_stream``, without building a
    Stream object through several Python calls."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """The context a wrapper launches in: ``torch.cuda.device(device)``
    where ``device`` is not the current CUDA device, nothing where it is
    (the usual case, which then costs no device switch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
