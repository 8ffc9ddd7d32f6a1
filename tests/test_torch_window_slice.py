"""Port's window copies (K2, K4) and clipmap extraction vs JAX, bit for bit.

Plane 1 of the window tables holds packed normals bitcast to float32; the
tables here plant denormal and NaN-pattern words there, and every
comparison goes through int32 views so that no float semantics can hide a
changed bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import make_tile
from topo_renderer_tpu.models.scene import build_mosaic as jax_build_mosaic
from topo_renderer_tpu.ops.panorama import (
    PanoramaSpec as JaxSpec,
    extract_clipmap_windows as jax_extract,
)
from topo_renderer_tpu_torch.models.scene import ARRAY_FIELDS, mosaic_from_arrays
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, extract_clipmap_windows
from topo_renderer_tpu_torch.ops import window_slice as ws_module
from topo_renderer_tpu_torch.ops.window_slice import window_slice, window_slice_multi


def _bits(x):
    return np.asarray(x).view(np.int32)


def _table(rng, h, w):
    """f32[2, h, w]: heights, then packed-normal words with denormal
    (z code < 8) and NaN-pattern words planted."""
    heights = rng.uniform(-50.0, 3000.0, (h, w)).astype(np.float32)
    words = rng.integers(0, 1 << 30, (h, w), dtype=np.int64).astype(np.uint32)
    words[rng.random((h, w)) < 0.2] &= (1 << 23) - 1  # denormal patterns
    words[rng.random((h, w)) < 0.05] = 0x7FC00001  # NaN pattern
    return np.stack([heights, words.view(np.float32)], axis=0)


def test_window_slice_multi_plain_is_dynamic_slice_bits():
    rng = np.random.default_rng(0)
    shapes = [(301, 517), (150, 258), (75, 129)]
    tables = [_table(rng, h, w) for h, w in shapes]
    # In range, at the far edge, and past it (clamped, as XLA clamps).
    origins = np.array([[40, 128], [150 - 48, 258 - 128], [200, 5]], np.int32)
    wsy, wsx = 48, 128
    got = window_slice_multi(
        [torch.from_numpy(t) for t in tables], torch.from_numpy(origins), wsy=wsy, wsx=wsx
    )
    for t, (sy, sx), g in zip(tables, origins, got):
        want = jax.lax.dynamic_slice(jnp.asarray(t), (0, int(sy), int(sx)), (2, wsy, wsx))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))
    one = window_slice(torch.from_numpy(tables[0]), torch.from_numpy(origins[0]), wsy=wsy, wsx=wsx)
    np.testing.assert_array_equal(_bits(one.numpy()), _bits(got[0].numpy()))
    assert window_slice_multi.launches == 0 and window_slice.launches == 0


def test_window_slice_rejects_bad_inputs():
    t = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="exceeds"):
        window_slice_multi([t], torch.zeros((1, 2), dtype=torch.int32), wsy=32, wsx=8)
    with pytest.raises(ValueError, match="int32"):
        window_slice_multi([t], torch.zeros((1, 2), dtype=torch.int64), wsy=8, wsx=8)


def test_launch_args_cached_per_table_set():
    """The CUDA path validates a table set once and caches its launch
    arguments under every table's pointer, shape, strides, dtype and
    device: another set of the same shapes gets its own pointers."""
    rng = np.random.default_rng(1)
    first = [torch.from_numpy(_table(rng, h, w)) for h, w in [(64, 96), (40, 130)]]
    second = [t.clone() for t in first]
    origins = torch.zeros((2, 2), dtype=torch.int32)
    args = ws_module._launch_args(first, origins, 16, 32, False)
    assert ws_module._launch_args(first, origins, 16, 32, False) is args
    other = ws_module._launch_args(second, origins, 16, 32, False)
    assert other is not args and list(other.srcs) == [t.data_ptr() for t in second]
    batched = ws_module._launch_args(first, torch.zeros((3, 2, 2), dtype=torch.int32), 16, 32, True)
    assert (args.shape, args.views, batched.shape) == ((2, 2, 16, 32), None, (2, 3, 2, 16, 32))
    mixed = ws_module._launch_args([first[0], first[1][0]], origins, 16, 32, False)
    assert mixed.shape == (1536,)
    assert [v[:3] for v in mixed.views] == [((2, 16, 32), (512, 32, 1), 0), ((16, 32), (32, 1), 1024)]
    with pytest.raises(ValueError, match="contiguous"):
        ws_module._launch_args([first[0][:, :, ::2], first[1]], origins, 16, 32, False)


def jax_mosaic_to_port(m, device="cpu"):
    arrays = {k: jax.tree.map(np.asarray, getattr(m, k)) for k in ARRAY_FIELDS}
    return mosaic_from_arrays(
        arrays, shape=m.shape, mip_shapes=m.mip_shapes, texel_m=m.texel_m, device=device
    )


def test_extract_clipmap_windows_bit_equal():
    tile = make_tile(49, 20, n=608, span_deg=0.05)
    jm = jax_build_mosaic([tile], window_table_min=0, on_device=True)
    pm = jax_mosaic_to_port(jm)
    eye = np.asarray(jm.bound_center) * (1.0 + 500.0 / float(np.linalg.norm(jm.bound_center)))
    eye = eye.astype(np.float32)
    kw = dict(width=64, height=32, elev_min=-0.3, elev_max=0.1, s_near=5.0,
              s_far=40_000.0, n_steps=128)
    jw = jax_extract(jm, jnp.asarray(eye), dataclasses.replace(JaxSpec.fast(**kw), clipmap_threshold=0),
                     force_xla=True)
    pw = extract_clipmap_windows(pm, torch.from_numpy(eye),
                                 dataclasses.replace(PanoramaSpec.fast(**kw), clipmap_threshold=0))
    assert any(a is not None for (_, a, _, _, _) in pw), "no level windowed"
    assert len(jw) == len(pw)
    for level, ((_, ja, jq, jx, jy), (_, pa, pq, px, py)) in enumerate(zip(jw, pw)):
        assert (ja is None) == (pa is None), level
        if ja is None:
            continue
        np.testing.assert_array_equal(_bits(pa.contiguous().numpy()), _bits(ja), err_msg=f"tbl_a {level}")
        assert (jq is None) == (pq is None), level
        if jq is not None:
            np.testing.assert_array_equal(_bits(pq.numpy()), _bits(jq), err_msg=f"tbl_q {level}")
        assert int(px) == int(jx) and int(py) == int(jy), level
