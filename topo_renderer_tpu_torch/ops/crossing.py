"""First-crossing search over terrain profiles (kernel K1).

Port of `topo_renderer_tpu/ops/pallas_crossing.py::crossing_search_pallas`.
Given per-column visibility profiles ``e_prof [N, W]`` (any monotone function
of elevation, not yet cummaxed) and three payload planes, find for every
pixel row the first profile step whose running max exceeds the row's
threshold, with that step's profile value (theta_hi), the previous running
max (m_lo) and the payloads there. Rows that never cross ("sky") get
``kstar = N`` and 0 elsewhere.

`crossing_search` launches the hand-written CUDA kernel
(`csrc/crossing.cu`) for CUDA tensors and runs `crossing_search_plain` for
CPU tensors; it never falls back from one to the other.

`crossing_reductions` is the JAX package's other crossing form
(`panorama.py:556-581`, ``use_pallas=False``): global reductions over the
running max, in plain PyTorch on either device.
"""

from __future__ import annotations

import ctypes

import torch

from topo_renderer_tpu_torch import cuda_build

M_INIT = -3.0e38  # running-max start value of the TPU kernel
CHUNK = 128  # csrc/crossing.cu's profile steps per streamed chunk
MAX_STEPS = 1 << 24  # the kernel writes kstar as a float32 step index: exact up to 2^24
BIG = 3.0e38  # the reductions' empty-set values (theta_hi of sky rows, -m_lo)
BIGKEY = 16777216.0  # 2^24: the packed key of a sky row (k = 16384)
# Cap on the elements of one [N, rows, W] temporary of the reductions.
REDUCE_CHUNK_ELEMS = 1 << 24


def crossing_search_plain(e_prof, a0, a1, a2, thresh):
    """Plain PyTorch version: the numpy oracle of the TPU kernel's tests
    (`tests/test_pallas_crossing.py:16-36`) step by step.

    ``thresh`` is ``f32[H]``: one threshold per row, the same for every
    column. Returns (kstar, theta_hi, m_lo, n0, n1, n2), each ``f32[H, W]``.
    """
    n, w = e_prof.shape
    h = thresh.shape[0]
    opts = dict(dtype=torch.float32, device=e_prof.device)
    kstar = torch.full((h, w), float(n), **opts)
    theta, mlo, o0, o1, o2 = (torch.zeros((h, w), **opts) for _ in range(5))
    m_prev = torch.full((w,), M_INIT, **opts)
    t = thresh[:, None]
    for k in range(n):
        m_new = torch.maximum(m_prev, e_prof[k])  # NaN-propagating
        cross = (t < m_new[None, :]) & (t >= m_prev[None, :])
        kstar = torch.where(cross, float(k), kstar)
        theta = torch.where(cross, e_prof[k][None, :], theta)
        mlo = torch.where(cross, m_prev[None, :], mlo)
        o0 = torch.where(cross, a0[k][None, :], o0)
        o1 = torch.where(cross, a1[k][None, :], o1)
        o2 = torch.where(cross, a2[k][None, :], o2)
        m_prev = m_new
    return kstar, theta, mlo, o0, o1, o2


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = cuda_build.load("crossing")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crossing_search.argtypes = [p, p, p, p, p, i, i, i, p, p]
        lib.crossing_search.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(e_prof, a0, a1, a2, thresh):
    planes = (e_prof, a0, a1, a2)
    if e_prof.dim() != 2 or thresh.dim() != 1:
        raise ValueError("crossing_search takes e_prof [N, W] and thresh [H]")
    for x in planes + (thresh,):
        if x.dtype != torch.float32:
            raise TypeError(f"crossing_search takes float32 tensors, got {x.dtype}")
        if x.device != e_prof.device:
            raise ValueError("crossing_search inputs must share one device")
    for x in planes[1:]:
        if x.shape != e_prof.shape:
            raise ValueError(f"payload shape {tuple(x.shape)} != profile {tuple(e_prof.shape)}")


def crossing_search(e_prof, a0, a1, a2, thresh):
    """First crossings of ``thresh f32[H]`` by the running max of
    ``e_prof f32[N, W]``, carrying payloads ``a0..a2 f32[N, W]``.

    Returns (kstar, theta_hi, m_lo, n0, n1, n2), each ``f32[H, W]``. Rows may
    come in any threshold order (the TPU kernel needed them non-increasing).
    """
    _check_inputs(e_prof, a0, a1, a2, thresh)
    if e_prof.device.type == "cpu":
        return crossing_search_plain(e_prof, a0, a1, a2, thresh)
    if e_prof.device.type != "cuda":
        raise ValueError(f"crossing_search runs on CPU or CUDA, not {e_prof.device}")
    for x in (e_prof, a0, a1, a2, thresh):
        if not x.is_contiguous():
            raise ValueError("crossing_search's CUDA kernel takes contiguous tensors")
    n, w = e_prof.shape
    h = thresh.shape[0]
    if n > MAX_STEPS:
        raise ValueError(f"crossing_search's CUDA kernel takes at most {MAX_STEPS} steps, got {n}")
    lib = _kernel_lib()
    out = torch.empty((6, h, w), dtype=torch.float32, device=e_prof.device)
    with cuda_build.on_device(e_prof.device):
        err = lib.crossing_search(
            e_prof.data_ptr(), a0.data_ptr(), a1.data_ptr(), a2.data_ptr(), thresh.data_ptr(),
            n, w, h, out.data_ptr(), cuda_build.current_stream(e_prof.device),
        )
    crossing_search.launches += 1
    if err:
        raise RuntimeError(f"crossing_search launch failed: {lib.error_string(err).decode()}")
    return out.unbind(0)


def crossing_reductions(m_prof, thresh, payloads=None):
    """First crossings as global reductions over the running max
    ``m_prof f32[N, W]`` (non-decreasing in k) for row thresholds
    ``thresh f32[H]`` (`panorama.py:525-581`). Because the running max is
    non-decreasing, the first k with ``M_k > t`` satisfies
      theta_hi = min{M_k : M_k > t},  m_lo = max{M_k : M_k <= t},
      k*       = #{k : M_k <= t}.
    With ``payloads`` (three ``f32[N, W]`` planes of 10-bit codes) k* and
    the payloads at k* come from packed-key minima ``k * 1024 + code`` over
    the tail {k : M_k > t}: the min lands on k* and its code rides along
    exactly (keys stay below 2^24). Sky rows get theta_hi = 3e38, kstar = N
    (16384 with payloads) and payload 0; m_lo = -3e38 where k* = 0.

    The reductions broadcast ``[N, H, W]``; XLA fuses the compare into them,
    eager PyTorch would materialise it. So rows go in chunks whose
    temporaries hold at most ``REDUCE_CHUNK_ELEMS`` (2^24) elements, 64 MB
    in float32. Min, max, a count and the key min are exact, so the chunked
    result equals the unchunked one bit for bit.

    Returns (kstar, theta_hi, m_lo, payloads at k* or None), ``f32[H, W]``.
    """
    n, w = m_prof.shape
    if payloads is not None and n > 16384:
        raise ValueError("attrs_from_profile supports n_steps <= 16384")
    rows = max(1, REDUCE_CHUNK_ELEMS // max(1, n * w))
    m3 = m_prof[:, None, :]  # [N, 1, W]
    kk = None
    if payloads is not None:
        kk = (torch.arange(n, dtype=torch.float32, device=m_prof.device) * 1024.0)[:, None, None]
    parts = []
    for r0 in range(0, thresh.shape[0], rows):
        le = m3 <= thresh[r0 : r0 + rows][None, :, None]  # [N, rows, W]
        theta_hi = torch.where(le, BIG, m3).amin(dim=0)
        m_lo = torch.where(le, m3, -BIG).amax(dim=0)
        if payloads is None:
            parts.append((le.sum(dim=0).to(torch.float32), theta_hi, m_lo))
            continue
        picks = [torch.where(le, BIGKEY, kk + comp[:, None, :]).amin(dim=0) for comp in payloads]
        kstar = torch.floor(picks[0] / 1024.0)  # exact; 16384 where sky
        codes = [p - torch.floor(p / 1024.0) * 1024.0 for p in picks]
        parts.append((kstar, theta_hi, m_lo, *codes))
    out = [torch.cat(c, dim=0) for c in zip(*parts)]
    return out[0], out[1], out[2], (tuple(out[3:]) if payloads is not None else None)


crossing_search.launches = 0  # kernel launches (CPU calls do not count)
