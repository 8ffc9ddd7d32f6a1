"""The port's wire encoders and decoders vs `topo_renderer_tpu/render/transport.py`.

Frames are numpy-seeded smoothed noise (as `tests/test_transport.py`) on
odd and even sizes. rgb888 and the label tail must match byte for byte;
the yuv420 payloads are held to the golden wire rule
(`tests/test_golden.py:151-155`): off by more than 1 on < 0.1% of bytes,
never by more than 2 (a last-bit difference in pow or a multiply-add moves
a rounding). The host decoders must equal JAX's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_renderer_tpu.render import transport as jt
from topo_renderer_tpu_torch.render import transport as pt

SIZES = [(34, 52), (45, 51), (100, 160), (33, 2)]


def frame(h, w, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.05, 1.05, (h, w, 3)).astype(np.float32)
    p = np.pad(base, ((1, 1), (1, 1), (0, 0)), mode="edge")
    return sum(p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)) / np.float32(9.0)


@pytest.mark.parametrize("mode", pt.MODES)
@pytest.mark.parametrize("h, w", SIZES, ids=lambda v: str(v))
def test_pixels_against_jax(mode, h, w):
    img = frame(h, w)
    got = pt.encode_pixels_u8(torch.from_numpy(img), mode=mode).numpy()
    want = np.asarray(jt.encode_pixels_u8(jnp.asarray(img), mode=mode))
    assert got.dtype == np.uint8 and got.shape == want.shape == (pt.pixel_bytes(h, w, mode),)
    if mode == "rgb888":
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff > 1).mean() < 0.001 and diff.max() <= 2, ((diff > 1).mean(), diff.max())


def packed_labels(p=64, seed=5):
    """(visible, x, y) with on-screen, off-screen and saturated coordinates:
    the int32 values XLA gives for NaN (0) and ±inf / out-of-range
    projections (INT32_MAX, INT32_MIN), whose + 32768 wraps."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-40_000, 40_000, p)
    y = rng.integers(-2_000, 2_000, p)
    x[:6] = [2**31 - 1, -(2**31), 0, 2**31 - 1 - 32768, -32768, 65535 - 32768]
    y[6:10] = [2**31 - 1, -(2**31), -32769, 32768]
    vis = rng.integers(0, 2, p)
    return np.stack([vis, x, y]).astype(np.int32)


@pytest.mark.parametrize("mode", pt.MODES)
def test_label_tail_bytes_equal(mode):
    img, packed = frame(45, 51), packed_labels()
    got = pt.encode_frame(torch.from_numpy(img), torch.from_numpy(packed), mode=mode).numpy()
    want = np.asarray(jt.encode_frame(jnp.asarray(img), jnp.asarray(packed), mode=mode))
    n_pix = pt.pixel_bytes(45, 51, mode)
    assert got.shape == want.shape == (n_pix + pt.label_bytes(packed.shape[1]),)
    np.testing.assert_array_equal(got[n_pix:], want[n_pix:])
    np.testing.assert_array_equal(pt.encode_labels_u8(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jt.encode_labels_u8(jnp.asarray(packed))))


@pytest.mark.parametrize("mode", pt.MODES)
@pytest.mark.parametrize("h, w", SIZES, ids=lambda v: str(v))
def test_decoders_equal_jax(mode, h, w):
    packed = packed_labels(16)
    buf = np.asarray(jt.encode_frame(jnp.asarray(frame(h, w)), jnp.asarray(packed), mode=mode))
    img_p, lab_p = pt.decode_frame(buf, h, w, 16, mode=mode)
    img_j, lab_j = jt.decode_frame(buf, h, w, 16, mode=mode)
    np.testing.assert_array_equal(img_p, img_j)
    np.testing.assert_array_equal(lab_p, lab_j)
    assert pt.decode_frame(buf, h, w, 0, mode=mode)[1] is None
    for n in (0, 1, 7):
        assert pt.label_bytes(n) == jt.label_bytes(n)
    with pytest.raises(ValueError):
        pt.pixel_bytes(h, w, "jpeg")
