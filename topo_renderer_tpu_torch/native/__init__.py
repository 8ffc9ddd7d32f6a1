"""Native (C++) host-side components, loaded via ctypes.

Copy of the JAX package's `native/` for the PyTorch port: the GeoTIFF probe
and decode and the label-overlay primitives of `src/topo_native.cc` (a copy
of the JAX package's source). The library is a host-side accelerator, never
a hard dependency: it is compiled with g++ on first use, and when the
toolchain, the build or ``TOPO_DISABLE_NATIVE`` says no, every consumer runs
its pure-Python version (`data/tiff.py`'s decoder).

The library is built beside the CUDA kernels, into the package's build
directory (`topo_renderer_tpu_torch.build_dir`: ``build/topo_renderer_tpu_torch/``
at the root of a checkout, else the per-user cache), under a file name keyed
by a hash of the source, never into the package directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from topo_renderer_tpu_torch import build_dir

_SRC = Path(__file__).resolve().parent / "src" / "topo_native.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


class TiffInfoStruct(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("has_pixel_scale", ctypes.c_int32),
        ("has_tiepoint", ctypes.c_int32),
        ("has_model_transform", ctypes.c_int32),
        ("pixel_scale", ctypes.c_double * 3),
        ("tiepoint", ctypes.c_double * 6),
    ]


def lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"libtopo_native-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile the library into ``out`` (a temporary name first, so that
    processes building at once never load a half-written file)."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
    except OSError:  # no build directory: the Python decoder runs
        return False
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lz"],
            check=True, capture_output=True, timeout=180,
        )
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load():
    """The ctypes library handle, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TOPO_DISABLE_NATIVE"):
            return None
        out = lib_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.topo_tiff_probe.restype = ctypes.c_int
        lib.topo_tiff_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(TiffInfoStruct),
        ]
        lib.topo_tiff_decode.restype = ctypes.c_int
        lib.topo_tiff_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ]
        lib.topo_last_error.restype = ctypes.c_char_p
        lib.topo_draw_line.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        ]
        lib.topo_fill_round_rect.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        ]
        lib.topo_blit_glyph.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is loaded (built here if needed); False
    when ``TOPO_DISABLE_NATIVE`` is set or it cannot be built or loaded, and
    the Python decoder runs."""
    return load() is not None


def tiff_decode(data: bytes):
    """Decode a GeoTIFF natively.

    Returns ``(heights f32[H, W], info dict)`` or None if native decoding is
    unavailable or the file is unsupported (callers fall back to Python).
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    info = TiffInfoStruct()
    if lib.topo_tiff_probe(data, len(data), ctypes.byref(info)) != 0:
        return None
    out = np.empty((info.height, info.width), np.float32)
    rc = lib.topo_tiff_decode(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size,
    )
    if rc != 0:
        return None
    return out, {
        "width": int(info.width),
        "height": int(info.height),
        "pixel_scale": list(info.pixel_scale) if info.has_pixel_scale else None,
        "tiepoint": list(info.tiepoint) if info.has_tiepoint else None,
        "has_model_transform": bool(info.has_model_transform),
    }
