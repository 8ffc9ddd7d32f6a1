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

import torch

from topo_renderer_tpu_torch import cuda_build

MAX_LEVELS = 16  # csrc/window_slice.cu's parameter-struct capacity
MAX_BATCH = 65535  # csrc/window_slice.cu's grid: gridDim.z runs over viewpoints


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


def _check_inputs(tables, origins, wsy, wsx):
    """``origins`` is ``i32[B, L, 2]`` here; the single-eye forms pass B = 1."""
    n = len(tables)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"window_slice takes 1..{MAX_LEVELS} tables, got {n}")
    if origins.dtype != torch.int32 or origins.dim() != 3 or tuple(origins.shape[1:]) != (n, 2):
        raise ValueError(f"origins must be int32 [B, {n}, 2], got {origins.dtype} {tuple(origins.shape)}")
    if not 1 <= origins.shape[0] <= MAX_BATCH:
        raise ValueError(f"window_slice takes 1..{MAX_BATCH} viewpoints, got {origins.shape[0]}")
    for t in tables:
        if t.dim() not in (2, 3) or t.element_size() != 4:
            raise ValueError("window_slice takes [H, W] or [C, H, W] tables of 32-bit words")
        if t.device != origins.device:
            raise ValueError("tables and origins must share one device")
        if t.shape[-2] < wsy or t.shape[-1] < wsx:
            raise ValueError(f"window ({wsy}, {wsx}) exceeds table {tuple(t.shape)}")


def _launch(tables, origins, wsy, wsx):
    """One kernel launch for ``origins i32[B, L, 2]``; per level
    ``[B, ..., wsy, wsx]``."""
    if origins.device.type != "cuda":
        raise ValueError(f"window_slice runs on CPU or CUDA, not {origins.device}")
    for t in (*tables, origins):
        if not t.is_contiguous():
            raise ValueError("window_slice's CUDA kernel takes contiguous tensors")
    lib = _kernel_lib()
    n, batch = len(tables), origins.shape[0]
    outs = [
        torch.empty((batch,) + t.shape[:-2] + (wsy, wsx), dtype=t.dtype, device=t.device)
        for t in tables
    ]
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.window_slice_multi_batched(
            n, batch,
            ptrs(*(t.data_ptr() for t in tables)),
            ptrs(*(o.data_ptr() for o in outs)),
            ints(*(t.shape[0] if t.dim() == 3 else 1 for t in tables)),
            ints(*(t.shape[-2] for t in tables)),
            ints(*(t.shape[-1] for t in tables)),
            origins.data_ptr(), wsy, wsx, stream,
        )
    if err:
        raise RuntimeError(f"window_slice launch failed: {lib.error_string(err).decode()}")
    return tuple(outs)


def window_slice_multi(tables, origins, *, wsy: int, wsx: int):
    """Slice the same-size window out of each of L tables in one launch
    (K2). ``tables``: sequence of ``[C, H_l, W_l]`` or ``[H_l, W_l]``
    tensors of 32-bit words; ``origins``: ``i32[L, 2]`` (sy, sx) rows.
    Returns a tuple of ``[..., wsy, wsx]`` windows."""
    tables = tuple(tables)
    _check_inputs(tables, origins[None], wsy, wsx)
    if origins.device.type == "cpu":
        return window_slice_multi_plain(tables, origins, wsy=wsy, wsx=wsx)
    outs = _launch(tables, origins[None].contiguous(), wsy, wsx)
    window_slice_multi.launches += 1
    return tuple(o[0] for o in outs)


def window_slice_multi_batched(tables, origins, *, wsy: int, wsx: int):
    """The windows of B viewpoints out of each of L tables in one launch
    (K3). ``origins``: ``i32[B, L, 2]`` (sy, sx) per viewpoint and level,
    1 <= B <= 65535. Returns a tuple over levels of ``[B, ..., wsy, wsx]``."""
    tables = tuple(tables)
    _check_inputs(tables, origins, wsy, wsx)
    if origins.device.type == "cpu":
        return window_slice_multi_batched_plain(tables, origins, wsy=wsy, wsx=wsx)
    outs = _launch(tables, origins, wsy, wsx)
    window_slice_multi_batched.launches += 1
    return outs


def window_slice(table, origin, *, wsy: int, wsx: int):
    """One bounded window copy (K4): ``origin`` is ``i32[2]`` (sy, sx).
    On CUDA this is the L = 1, B = 1 launch of the window kernel."""
    origins = origin.reshape(1, 1, 2)
    _check_inputs((table,), origins, wsy, wsx)
    if origins.device.type == "cpu":
        return window_slice_multi_plain((table,), origins[0], wsy=wsy, wsx=wsx)[0]
    out = _launch((table,), origins.contiguous(), wsy, wsx)[0][0]
    window_slice.launches += 1
    return out


window_slice_multi.launches = 0  # kernel launches (CPU calls do not count)
window_slice_multi_batched.launches = 0
window_slice.launches = 0
