"""One-transfer interactive frame encoding (device -> host).

Port of `topo_renderer_tpu/render/transport.py`. An interactive frame
crosses to the host as one flat u8 vector: the pixel payload first, the
packed label visibility appended (6 bytes per peak), so one pull carries
both. Offsets are static given (H, W, P, mode); there is no header. Pixel
formats:

  * ``rgb888``: 3 B/px sRGB;
  * ``yuv420``: full-range BT.601, full-resolution luma and 2x2-mean
    chroma (1.5 B/px, the subsampling a JPEG encoder applies next anyway);
  * ``yuv420_half``: the same at half resolution (0.375 B/px), upsampled
    on the host, for motion frames.

The encoders run in torch on the frame's device; the decoders are numpy on
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from topo_renderer_tpu_torch.ops.shading import linear_to_srgb

MODES = ("rgb888", "yuv420", "yuv420_half")


def _ceil2(n: int) -> int:
    return -(-n // 2)


def pixel_bytes(height: int, width: int, mode: str) -> int:
    if mode == "rgb888":
        return height * width * 3
    if mode == "yuv420":
        return height * width + 2 * _ceil2(height) * _ceil2(width)
    if mode == "yuv420_half":
        h, w = _ceil2(height), _ceil2(width)
        return h * w + 2 * _ceil2(h) * _ceil2(w)
    raise ValueError(f"unknown transport mode {mode!r}")


def label_bytes(n_peaks: int) -> int:
    return 6 * n_peaks


# ---- device side ----------------------------------------------------------


def _halve(p):
    """2x2 box mean of a plane; an odd trailing row/column edge-replicates
    (output dims are ceil(h/2), ceil(w/2))."""
    a, b = p[0::2], p[1::2]
    if b.shape[0] < a.shape[0]:
        b = torch.cat([b, a[-1:]], dim=0)
    rows = 0.5 * (a + b)
    a, b = rows[:, 0::2], rows[:, 1::2]
    if b.shape[1] < a.shape[1]:
        b = torch.cat([b, a[:, -1:]], dim=1)
    return 0.5 * (a + b)


def _u8(p):
    return torch.round(torch.clamp(p, 0.0, 255.0)).to(torch.uint8).reshape(-1)


def encode_pixels_u8(color_linear, *, mode: str = "rgb888"):
    """Frame payload ``u8[pixel_bytes]`` on the frame's device. ``yuv420*``
    is full-range BT.601, inverted exactly by `decode_pixels`."""
    s = linear_to_srgb(torch.clamp(color_linear, 0.0, 1.0)) * 255.0
    if mode == "rgb888":
        return torch.round(s).to(torch.uint8).reshape(-1)
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    if mode == "yuv420_half":
        r, g, b = _halve(r), _halve(g), _halve(b)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 + 0.564 * (_halve(b) - _halve(y))
    cr = 128.0 + 0.713 * (_halve(r) - _halve(y))
    return torch.cat([_u8(y), _u8(cb), _u8(cr)])


def encode_labels_u8(packed):
    """``i32[3, P]`` (visible, x, y) -> ``u8[6 P]``: per peak x + 32768 and
    y + 32768 as u16 little-endian, visible as one byte, one zero byte.
    The offset keeps off-screen negatives encodable; the int32 sum wraps as
    XLA's does, and the clamp then bounds it to [0, 65535]."""
    vis, x, y = packed[0], packed[1], packed[2]
    xs = torch.clamp(x + 32768, 0, 65535)
    ys = torch.clamp(y + 32768, 0, 65535)
    cols = [xs & 0xFF, xs >> 8, ys & 0xFF, ys >> 8, torch.clamp(vis, 0, 1), torch.zeros_like(xs)]
    return torch.stack(cols, dim=-1).to(torch.uint8).reshape(-1)


def encode_frame(color_linear, packed=None, *, mode: str = "rgb888"):
    """One flat u8 wire vector: pixels, then the label bytes if ``packed``."""
    pixels = encode_pixels_u8(color_linear, mode=mode)
    if packed is None:
        return pixels
    return torch.cat([pixels, encode_labels_u8(packed)])


# ---- host side --------------------------------------------------------------


def decode_pixels(buf: np.ndarray, height: int, width: int, *, mode: str):
    """Flat u8 wire pixels -> u8 sRGB [height, width, 3] (numpy)."""
    buf = np.asarray(buf, np.uint8)
    if mode == "rgb888":
        return buf[: height * width * 3].reshape(height, width, 3)
    h, w = (_ceil2(height), _ceil2(width)) if mode == "yuv420_half" else (height, width)
    hc, wc = _ceil2(h), _ceil2(w)
    ny = h * w
    nc = hc * wc
    y = buf[:ny].reshape(h, w).astype(np.float32)
    cb = buf[ny : ny + nc].reshape(hc, wc).astype(np.float32) - 128.0
    cr = buf[ny + nc : ny + 2 * nc].reshape(hc, wc).astype(np.float32) - 128.0
    cb = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)[:h, :w]
    cr = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)[:h, :w]
    r = y + cr / 0.713
    b = y + cb / 0.564
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    img = np.stack([r, g, b], axis=-1)
    if mode == "yuv420_half":
        img = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)[:height, :width]
    return np.clip(np.round(img), 0.0, 255.0).astype(np.uint8)


def decode_labels(buf: np.ndarray, n_peaks: int, *, offset: int):
    """Label tail at ``offset`` -> i32[3, P] (visible, x, y)."""
    raw = np.asarray(buf[offset : offset + 6 * n_peaks], np.uint8).reshape(n_peaks, 6).astype(np.int32)
    x = raw[:, 0] | (raw[:, 1] << 8)
    y = raw[:, 2] | (raw[:, 3] << 8)
    return np.stack([raw[:, 4], x - 32768, y - 32768])


def decode_frame(buf: np.ndarray, height: int, width: int, n_peaks: int, *, mode: str):
    """Wire vector -> (u8 rgb [H, W, 3], i32[3, P] or None)."""
    img = decode_pixels(buf, height, width, mode=mode)
    if not n_peaks:
        return img, None
    return img, decode_labels(buf, n_peaks, offset=pixel_bytes(height, width, mode))
