"""Bounded window copies out of large tables (kernels K2, K3 and K4).

Port of `topo_renderer_tpu/ops/pallas_dma.py::window_slice_multi`,
`window_slice_multi_batched` and `window_slice`. Each copies
``table[..., sy:sy+wsy, sx:sx+wsx]`` from one or several tables, for one or
B viewpoints, reading only the windows' texels, with the origins held in an
int32 tensor on the tables' device so that no host sync is needed. An
origin that would run past the table is clamped into it, as XLA's
DynamicSlice clamps it.

The tables' plane 1 holds packed normals bitcast to float32, some of them
denormal: both versions move 32-bit words (the plain one through
``torch.int32`` views), so the copy is bit-exact.

CUDA tensors go to the hand-written kernel (`csrc/window_slice.cu`), CPU
tensors to the plain PyTorch version; neither falls back to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from collections import OrderedDict

import torch

from topo_renderer_tpu_torch import cuda_build

MAX_LEVELS = 16  # csrc/window_slice.cu's parameter-struct capacity
MAX_BATCH = 65535  # csrc/window_slice.cu's limit on viewpoints per launch


def window_slice_multi_plain(tables, origins, *, wsy: int, wsx: int):
    """Plain PyTorch version: clamp each origin into its table, then
    slice the int32 view of each table. ``origins`` ``i32[L, 2]`` rows are
    (sy, sx). Reads the origins on the host."""
    out = []
    for table, (sy, sx) in zip(tables, origins.tolist()):
        h, w = table.shape[-2], table.shape[-1]
        sy = min(max(sy, 0), h - wsy)
        sx = min(max(sx, 0), w - wsx)
        bits = table.view(torch.int32)[..., sy : sy + wsy, sx : sx + wsx]
        out.append(bits.contiguous().view(table.dtype))
    return tuple(out)


def window_slice_multi_batched_plain(tables, origins, *, wsy: int, wsx: int):
    """Plain PyTorch version of the batched copy: ``origins i32[B, L, 2]``;
    viewpoint b's windows are `window_slice_multi_plain` of ``origins[b]``,
    stacked on a leading B axis per level."""
    per_eye = [window_slice_multi_plain(tables, o, wsy=wsy, wsx=wsx) for o in origins]
    return tuple(torch.stack(wins) for wins in zip(*per_eye))


_lib = None
_ARGS_CACHE_MAX = 64  # table sets whose launch arguments are kept, least recently used out
_args_cache: OrderedDict = OrderedDict()


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = cuda_build.load("window_slice")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.window_slice_multi_batched.argtypes = [i, i, p, p, p, p, p, p, i, i, p]
        lib.window_slice_multi_batched.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_origins(origins, n, batched):
    """``origins`` is ``i32[B, L, 2]`` for the batched form, else ``i32[L, 2]``."""
    lead = origins.shape[:1] if batched else ()
    if origins.dtype != torch.int32 or tuple(origins.shape) != (*lead, n, 2):
        want = f"[B, {n}, 2]" if batched else f"[{n}, 2]"
        raise ValueError(f"origins must be int32 {want}, got {origins.dtype} {tuple(origins.shape)}")
    if batched and not 1 <= origins.shape[0] <= MAX_BATCH:
        raise ValueError(f"window_slice takes 1..{MAX_BATCH} viewpoints, got {origins.shape[0]}")


def _check_inputs(tables, origins, wsy, wsx, batched):
    n = len(tables)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"window_slice takes 1..{MAX_LEVELS} tables, got {n}")
    _check_origins(origins, n, batched)
    for t in tables:
        if t.dim() not in (2, 3) or t.element_size() != 4:
            raise ValueError("window_slice takes [H, W] or [C, H, W] tables of 32-bit words")
        if t.device != origins.device:
            raise ValueError("tables and origins must share one device")
        if t.shape[-2] < wsy or t.shape[-1] < wsx:
            raise ValueError(f"window ({wsy}, {wsx}) exceeds table {tuple(t.shape)}")


@dataclasses.dataclass(frozen=True)
class _LaunchArgs:
    """What a launch over one table set needs besides the origins and the
    output buffer: the ctypes arrays of the C entry and the buffer's shape.
    Where the levels' windows share one shape and dtype (every path of the
    panorama), the buffer is ``[L, *window]`` and unbinds into the levels;
    otherwise it is flat and ``views`` holds each level's (size, stride,
    offset, dtype)."""

    device: int
    dtype: torch.dtype
    shape: tuple
    views: tuple | None
    srcs: ctypes.Array
    planes: ctypes.Array
    hs: ctypes.Array
    ws: ctypes.Array


def _launch_args(tables, origins, wsy, wsx, batched):
    """The validated launch arguments of ``tables``, cached under every
    table's (data pointer, shape, strides, dtype, device), the window and
    the batch: a table set that differs in any of them gets its own entry,
    so no launch reads another set's pointers. The cache keeps the most
    recently used sets: a row-sharded mosaic's band sets (one per band and
    window shape) come and go without evicting the others."""
    batch = origins.shape[0] if batched else 1
    key = (wsy, wsx, batched, batch,
           *[(t.data_ptr(), t.shape, t.stride(), t.dtype, t.get_device()) for t in tables])
    args = _args_cache.get(key)
    if args is not None:
        _args_cache.move_to_end(key)
        return args
    _check_inputs(tables, origins, wsy, wsx, batched)
    if not all(t.is_contiguous() for t in tables):
        raise ValueError("window_slice's CUDA kernel takes contiguous tensors")
    views, offset = [], 0
    for t in tables:
        size = ((batch,) if batched else ()) + tuple(t.shape[:-2]) + (wsy, wsx)
        views.append((size, tuple(math.prod(size[i + 1 :]) for i in range(len(size))), offset, t.dtype))
        offset += math.prod(size)
    n = len(tables)
    uniform = all(v[0] == views[0][0] and v[3] == views[0][3] for v in views)
    ptrs, ints = ctypes.c_void_p * n, ctypes.c_int * n
    args = _LaunchArgs(
        device=tables[0].get_device(), dtype=tables[0].dtype,
        shape=(n, *views[0][0]) if uniform else (offset,), views=None if uniform else tuple(views),
        srcs=ptrs(*(t.data_ptr() for t in tables)),
        planes=ints(*(t.shape[0] if t.dim() == 3 else 1 for t in tables)),
        hs=ints(*(t.shape[-2] for t in tables)),
        ws=ints(*(t.shape[-1] for t in tables)),
    )
    if len(_args_cache) >= _ARGS_CACHE_MAX:
        _args_cache.popitem(last=False)
    _args_cache[key] = args
    return args


def _launch(tables, origins, wsy, wsx, batched):
    """One kernel launch for ``origins`` ``i32[B, L, 2]`` (batched) or
    ``i32[L, 2]``; returns per level ``[B, ..., wsy, wsx]`` or
    ``[..., wsy, wsx]``, views of one buffer."""
    _check_origins(origins, len(tables), batched)
    args = _launch_args(tables, origins, wsy, wsx, batched)
    if origins.get_device() != args.device:
        raise ValueError("tables and origins must share one device")
    if not origins.is_contiguous():
        raise ValueError("window_slice's CUDA kernel takes contiguous tensors")
    lib = _kernel_lib()
    dev = origins.device
    out = torch.empty(args.shape, dtype=args.dtype, device=dev)
    with cuda_build.on_device(dev):
        err = lib.window_slice_multi_batched(
            len(tables), origins.shape[0] if batched else 1, args.srcs, out.data_ptr(), args.planes,
            args.hs, args.ws, origins.data_ptr(), wsy, wsx, cuda_build.current_stream(dev),
        )
    if err:
        raise RuntimeError(f"window_slice launch failed: {lib.error_string(err).decode()}")
    if args.views is None:
        return out.unbind(0)
    return tuple(out.as_strided(size, stride, offset).view(dt) for size, stride, offset, dt in args.views)


def window_slice_multi(tables, origins, *, wsy: int, wsx: int):
    """Slice the same-size window out of each of L tables in one launch
    (K2). ``tables``: sequence of ``[C, H_l, W_l]`` or ``[H_l, W_l]``
    tensors of 32-bit words; ``origins``: ``i32[L, 2]`` (sy, sx) rows.
    Returns a tuple of ``[..., wsy, wsx]`` windows."""
    tables = tuple(tables)
    if origins.is_cuda:
        outs = _launch(tables, origins, wsy, wsx, batched=False)
        window_slice_multi.launches += 1
        return outs
    _check_inputs(tables, origins, wsy, wsx, batched=False)
    if origins.device.type != "cpu":
        raise ValueError(f"window_slice runs on CPU or CUDA, not {origins.device}")
    return window_slice_multi_plain(tables, origins, wsy=wsy, wsx=wsx)


def window_slice_multi_batched(tables, origins, *, wsy: int, wsx: int):
    """The windows of B viewpoints out of each of L tables in one launch
    (K3). ``origins``: ``i32[B, L, 2]`` (sy, sx) per viewpoint and level,
    1 <= B <= 65535. Returns a tuple over levels of ``[B, ..., wsy, wsx]``."""
    tables = tuple(tables)
    if origins.is_cuda:
        outs = _launch(tables, origins, wsy, wsx, batched=True)
        window_slice_multi_batched.launches += 1
        return outs
    _check_inputs(tables, origins, wsy, wsx, batched=True)
    if origins.device.type != "cpu":
        raise ValueError(f"window_slice runs on CPU or CUDA, not {origins.device}")
    return window_slice_multi_batched_plain(tables, origins, wsy=wsy, wsx=wsx)


def window_slice(table, origin, *, wsy: int, wsx: int):
    """One bounded window copy (K4): ``origin`` is ``i32[2]`` (sy, sx).
    On CUDA this is the L = 1, B = 1 launch of the window kernel."""
    origins = origin.reshape(1, 2)
    if origins.is_cuda:
        out = _launch((table,), origins, wsy, wsx, batched=False)[0]
        window_slice.launches += 1
        return out
    _check_inputs((table,), origins, wsy, wsx, batched=False)
    if origins.device.type != "cpu":
        raise ValueError(f"window_slice runs on CPU or CUDA, not {origins.device}")
    return window_slice_multi_plain((table,), origins, wsy=wsy, wsx=wsx)[0]


window_slice_multi.launches = 0  # kernel launches (CPU calls do not count)
window_slice_multi_batched.launches = 0
window_slice.launches = 0
