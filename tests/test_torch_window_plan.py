"""The batched window copy (K3, with K2 and K4 its B = 1 launches): the
CUDA kernel's work map and row realignment modelled in plain Python, and
the plain versions against `jax.lax.dynamic_slice` at the path's kinds of
input.

The model mirrors `csrc/window_slice.cu`: a grid of (eye, group of WARPS
output rows, level), the eye fastest; one warp per output row, which loads
the aligned 16-byte vectors holding its source row and realigns them, each
lane taking the words it lacks from the next lane's vector. Run over whole
tables, the model must give the plain version's windows bit for bit.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_renderer_tpu_torch.ops import window_slice as ws_module
from topo_renderer_tpu_torch.ops.window_slice import (
    window_slice,
    window_slice_multi,
    window_slice_multi_batched,
    window_slice_multi_batched_plain,
)

SOURCE = (Path(ws_module.__file__).parent.parent / "csrc" / "window_slice.cu").read_text()
WARPS = int(re.search(r"constexpr int WARPS = (\d+);", SOURCE).group(1))
UNROLL = int(re.search(r"constexpr int UNROLL = (\d+);", SOURCE).group(1))


def _bits(x):
    return np.asarray(x).view(np.int32)


def _table(rng, planes, h, w):
    """f32[planes, h, w] of random words, a fifth of them denormal patterns
    and some NaN patterns, as the panorama's packed-normal plane holds."""
    words = rng.integers(0, 1 << 32, (planes, h, w), dtype=np.uint64).astype(np.uint32)
    words[rng.random((planes, h, w)) < 0.2] &= (1 << 23) - 1
    words[rng.random((planes, h, w)) < 0.05] = 0x7FC00001
    return words.view(np.float32)


def _clustered(rng, shapes, batch, wsy, wsx, spread):
    """Config 5's kind of origins: eyes within ``spread`` texels of one
    point at level 0 (halved per level), each window centred on its eye and
    aligned down to (8, 128), clipped into the table, as
    `ops/panorama.py::_window_origin` places them."""
    cy, cx = shapes[0][1] / 2.0, shapes[0][2] / 2.0
    eyes = np.stack([cy + rng.uniform(-spread, spread, batch), cx + rng.uniform(-spread, spread, batch)], -1)
    origins = []
    for level, (_, h, w) in enumerate(shapes):
        p = np.round(eyes / 2.0**level).astype(np.int64) - (wsy // 2, wsx // 2)
        sy = np.clip(p[:, 0], 0, h - wsy) // 8 * 8
        sx = np.clip(p[:, 1], 0, w - wsx) // 128 * 128
        origins.append(np.stack([sy, sx], -1))
    return np.stack(origins, axis=1).astype(np.int32)  # [B, L, 2]


# ---- the model ----------------------------------------------------------------

def kernel_rows(batch, planes, wsy):
    """`window_slice_kernel`'s index map: for each block of the grid, in
    launch order (level, row group, eye; the eye fastest), and each warp of
    it, the (level, eye, plane, y) it copies and its output row in level
    l's ``[batch, planes_l, wsy]`` buffer."""
    groups = -(-max(planes) * wsy // WARPS)
    for level, n_planes in enumerate(planes):
        for group in range(groups):
            for b in range(batch):
                for warp in range(WARPS):
                    row = group * WARPS + warp
                    if row >= n_planes * wsy:
                        continue
                    plane, y = divmod(row, wsy)
                    yield level, b, plane, y, b * n_planes * wsy + row


def copy_row_model(words, start, n):
    """`copy_row_vec` for one row of ``n`` 16-byte vectors whose first word
    is ``words[start]`` (the table's first word on a 16-byte boundary):
    lane-level, 32 lanes as a numpy axis. Returns the row's 4n words."""
    m = start & 3
    base = start - m
    lanes = np.arange(32)
    padded = np.concatenate([words, np.zeros(8, words.dtype)])  # a vector's bytes past the table's last word

    def load(j, ok):
        idx = base + 4 * j[:, None] + np.arange(4)
        return np.where(ok[:, None], padded[np.minimum(idx, len(padded) - 1)], 0)

    out = np.zeros((n, 4), words.dtype)
    for i0 in range(0, n, 32 * UNROLL):
        v = [load(i0 + 32 * u + lanes, (i0 + 32 * u + lanes < n) | ((m > 0) & (i0 + 32 * u + lanes == n)))
             for u in range(UNROLL)]
        tail_j = i0 + 32 * UNROLL
        tail = load(np.array([tail_j]), np.array([m > 0 and tail_j <= n]))[0]
        for u in range(UNROLL):
            give = v[u].copy()
            give[0] = v[u + 1][0] if u + 1 < UNROLL else tail
            hi = give[(lanes + 1) % 32]  # the shuffle from lane + 1
            row = np.concatenate([v[u], hi], axis=1)[:, m : m + 4]
            j = i0 + 32 * u + lanes
            out[j[j < n]] = row[j < n]
    return out.reshape(-1)


def simulate(tables, origins, wsy, wsx):
    """The whole launch on numpy tables ``[C, H, W]``: origins ``i32[B, L,
    2]``, clamped as the kernel clamps them. Returns per level ``[B, C,
    wsy, wsx]`` words, each output row written once."""
    batch = origins.shape[0]
    planes = [t.shape[0] for t in tables]
    outs = [np.zeros((batch, c, wsy, wsx), np.uint32) for c in planes]
    written = [np.zeros((batch * c * wsy,), np.int32) for c in planes]
    for level, b, plane, y, dst_row in kernel_rows(batch, planes, wsy):
        t = tables[level]
        _, h, w = t.shape
        sy = min(max(int(origins[b, level, 0]), 0), h - wsy)
        sx = min(max(int(origins[b, level, 1]), 0), w - wsx)
        words = t.view(np.uint32).reshape(-1)
        start = (plane * h + sy + y) * w + sx
        if wsx % 4 == 0:
            row = copy_row_model(words, start, wsx // 4)
        else:
            row = words[start : start + wsx]
        outs[level].reshape(-1, wsx)[dst_row] = row
        written[level][dst_row] += 1
    assert all((n == 1).all() for n in written), "an output row written other than once"
    return outs


# ---- the work map -------------------------------------------------------------

@pytest.mark.parametrize("batch, planes, wsy", [
    (1, [2, 2, 2, 2], 24),   # K2: one eye, four levels
    (1, [2], 272),           # K4: one eye, one level
    (16, [2, 2, 2], 24),     # K3
    (7, [2, 1, 2], 13),      # a 2-D table among 3-D ones; wsy not a multiple of WARPS
])
def test_work_map_covers_each_row_once(batch, planes, wsy):
    seen = {}
    for level, b, plane, y, dst_row in kernel_rows(batch, planes, wsy):
        key = (level, b, plane, y)
        assert key not in seen, key
        seen[key] = dst_row
        # Each output lands at its eye's own position in the level's buffer.
        assert dst_row == np.ravel_multi_index((b, plane, y), (batch, planes[level], wsy))
    assert len(seen) == sum(batch * c * wsy for c in planes)


@pytest.mark.parametrize("m", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [16, 128, 129, 300])
def test_row_realignment(m, n):
    """Each of the four word offsets past a 16-byte boundary, for rows of
    one, several and a ragged number of lane chunks, up to the table's
    last word (the last vector's bytes past it are loaded, never stored)."""
    rng = np.random.default_rng(m * 1000 + n)
    words = rng.integers(0, 1 << 32, 4 * n + 64 + m, dtype=np.uint64).astype(np.uint32)
    for start in (m, 4 + m, len(words) - 4 * n):
        assert start & 3 == m
        np.testing.assert_array_equal(copy_row_model(words, start, n), words[start : start + 4 * n])


# ---- the model and the plain version against dynamic_slice ------------------------

CASES = {
    # config 5's kind: clustered eyes over four levels of an odd-width table
    "clustered": dict(shapes=[(2, 301, 517), (2, 150, 258), (2, 75, 261), (2, 40, 133)], batch=16, wsy=24,
                      wsx=128, spread=60.0),
    # the analogue of 12001: rows start at every word offset past 16 bytes
    "odd_width": dict(shapes=[(2, 97, 389)], batch=5, wsy=16, wsx=256, spread=30.0),
    "clamped": dict(shapes=[(2, 64, 300), (2, 40, 150)], batch=6, wsy=24, wsx=128, spread=200.0, planted=True),
    "b1": dict(shapes=[(2, 120, 389), (2, 60, 195), (2, 30, 131)], batch=1, wsy=24, wsx=128, spread=10.0),
    "l1": dict(shapes=[(2, 120, 389)], batch=4, wsy=24, wsx=128, spread=40.0),
    # a width that is not a multiple of 4: the word-by-word path
    "word_path": dict(shapes=[(2, 50, 97), (1, 40, 61)], batch=3, wsy=9, wsx=30, spread=10.0),
}


def _case(name):
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    tables = [_table(rng, *s) for s in c["shapes"]]
    if c["wsx"] % 128 == 0:
        origins = _clustered(rng, c["shapes"], c["batch"], c["wsy"], c["wsx"], c["spread"])
    else:
        origins = rng.integers(0, 40, (c["batch"], len(tables), 2)).astype(np.int32)
    if c.get("planted"):
        origins[0, 0] = (64 - 24 + 9, 300 - 128 + 50)  # past the far edge
        origins[1, 1] = (-7, -300)  # before the origin
        origins[2, 0] = (13, 5)  # unaligned
    return tables, origins, c["wsy"], c["wsx"]


def _dynamic_slice(table, sy, sx, wsy, wsx):
    # jax.lax.dynamic_slice clamps a start past the far edge as the copy
    # does; a negative start is clipped to 0 first (the copy clamps it,
    # XLA's HLO does too).
    return jax.lax.dynamic_slice(jnp.asarray(table), (0, max(sy, 0), max(sx, 0)), (table.shape[0], wsy, wsx))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_are_dynamic_slice(name):
    tables, origins, wsy, wsx = _case(name)
    tt = [torch.from_numpy(t) for t in tables]
    got = window_slice_multi_batched(tt, torch.from_numpy(origins), wsy=wsy, wsx=wsx)
    assert [tuple(g.shape) for g in got] == [(origins.shape[0], t.shape[0], wsy, wsx) for t in tables]
    for b in range(origins.shape[0]):
        for level, t in enumerate(tables):
            want = _dynamic_slice(t, *(int(v) for v in origins[b, level]), wsy, wsx)
            np.testing.assert_array_equal(_bits(got[level][b].numpy()), _bits(want), err_msg=f"{b} {level}")
        one = window_slice_multi(tt, torch.from_numpy(origins[b]), wsy=wsy, wsx=wsx)
        for level in range(len(tables)):
            np.testing.assert_array_equal(_bits(one[level].numpy()), _bits(got[level][b].numpy()))
    single = window_slice(tt[0], torch.from_numpy(origins[0, 0]), wsy=wsy, wsx=wsx)
    np.testing.assert_array_equal(_bits(single.numpy()), _bits(got[0][0].numpy()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_equals_plain_version(name):
    tables, origins, wsy, wsx = _case(name)
    got = simulate(tables, origins, wsy, wsx)
    want = window_slice_multi_batched_plain([torch.from_numpy(t) for t in tables], torch.from_numpy(origins),
                                            wsy=wsy, wsx=wsx)
    for level, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.view(np.int32), _bits(w.numpy()), err_msg=f"level {level}")
