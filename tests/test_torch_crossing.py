"""Port's first-crossing search (K1) vs the JAX Pallas kernel.

The port's plain PyTorch version (what the wrapper runs on CPU tensors) must
equal `crossing_search_pallas(..., interpret=True)` exactly on the TPU
kernel's own test cases, and the numpy oracle on shapes the TPU kernel
rejects. `kernel_mirror` repeats the CUDA kernel's per-block algorithm in
numpy, so that it is held to the oracle here where the kernel cannot run.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_pallas_crossing import oracle
from topo_renderer_tpu.ops.pallas_crossing import LANES, crossing_search_pallas
from topo_renderer_tpu_torch.ops.crossing import CHUNK, M_INIT, crossing_search, crossing_search_plain

NAMES = ["kstar", "theta", "mlo", "n0", "n1", "n2"]


def _inputs(seed, n, h, w):
    """The generator of `tests/test_pallas_crossing.py`: a random-walk
    profile with spikes and decreasing row thresholds spanning its range."""
    rng = np.random.default_rng(seed)
    e = np.cumsum(rng.normal(0, 0.05, (n, w)), axis=0).astype(np.float32)
    e += (rng.random((n, w)) < 0.05) * rng.uniform(0.5, 2.0, (n, w))
    e = e.astype(np.float32)
    a = [rng.integers(0, 1024, (n, w)).astype(np.float32) for _ in range(3)]
    t1d = np.sort(rng.uniform(e.min() - 0.5, e.max() + 0.5, h).astype(np.float32))[::-1].copy()
    return e, a, t1d


@pytest.mark.parametrize("seed,n,h", [(0, 96, 40), (1, 17, 8), (2, 64, 256)])
def test_plain_matches_pallas_interpret(seed, n, h):
    e, a, t1d = _inputs(seed, n, h, 2 * LANES)
    thresh = np.broadcast_to(t1d[:, None], (h, 2 * LANES)).copy()
    want = crossing_search_pallas(
        jnp.asarray(e), *[jnp.asarray(x) for x in a], jnp.asarray(thresh),
        height=h, interpret=True,
    )
    got = crossing_search(torch.from_numpy(e), *map(torch.from_numpy, a), torch.from_numpy(t1d))
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_odd_shape_matches_oracle():
    """W=200, H=37: shapes the TPU kernel refuses; the port takes any."""
    e, a, t1d = _inputs(3, 50, 37, 200)
    got = crossing_search(torch.from_numpy(e), *map(torch.from_numpy, a), torch.from_numpy(t1d))
    for g, w, name in zip(got, oracle(e, a, t1d), NAMES):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_any_row_order_and_sky_defaults():
    """Rows in shuffled threshold order give the oracle's per-row answer,
    and rows above every profile value keep the sky defaults."""
    e, a, t1d = _inputs(4, 40, 24, 64)
    t1d[:3] = e.max() + 1.0  # never crossed
    perm = np.random.default_rng(4).permutation(24)
    t_shuf = t1d[perm].copy()
    got = crossing_search_plain(
        torch.from_numpy(e), *map(torch.from_numpy, a), torch.from_numpy(t_shuf)
    )
    for g, w, name in zip(got, oracle(e, a, t_shuf), NAMES):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    kstar = got[0].numpy()
    sky_rows = np.isin(perm, [0, 1, 2])
    assert (kstar[sky_rows] == 40).all()
    assert (got[1].numpy()[sky_rows] == 0).all()


def test_nan_profile_and_extreme_rows_match_oracle():
    """NaN in the profile stops the running max (as np.maximum and
    jnp.maximum propagate it); NaN and -inf thresholds never cross."""
    e, a, t1d = _inputs(6, 30, 16, 40)
    e[5, 3:9] = np.nan
    t1d[[1, 12]] = [np.nan, -np.inf]
    got = crossing_search(torch.from_numpy(e), *map(torch.from_numpy, a), torch.from_numpy(t1d))
    want = oracle(e, a, t1d)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (got[0].numpy()[[1, 12]] == 30).all()


def test_cpu_calls_do_not_count_launches():
    before = crossing_search.launches
    e, a, t1d = _inputs(5, 8, 8, 16)
    crossing_search(torch.from_numpy(e), *map(torch.from_numpy, a), torch.from_numpy(t1d))
    assert crossing_search.launches == before


def test_rejects_mismatched_inputs():
    e = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="payload shape"):
        crossing_search(e, e, e, torch.zeros((4, 8)), torch.zeros(8))
    with pytest.raises(TypeError, match="float32"):
        crossing_search(e, e, e, e, torch.zeros(8, dtype=torch.float64))


def kernel_mirror(e, a, t, chunk, cols=32, band=16, warps=8):
    """`csrc/crossing.cu`'s algorithm, block by block, in numpy.

    A block owns ``cols`` columns and ``band`` rows and streams the profile
    in chunks of ``chunk`` steps, padded with -inf to a power of two (the
    kernel's chunk is one; its last chunk is padded so). Per chunk: the
    running max as segment scans plus the segments' prefix and the previous
    chunk's carry; pairs whose predicate ``!(M <= t)`` holds at the chunk's
    end are decided by a binary search for its first true step, where the
    serial scan's compares say whether they cross, with theta the running
    max there and m_lo from the carry at the chunk's first step; the block
    stops once no pair is open.
    Payloads are gathered where a row crossed.
    """
    n, w = e.shape
    h = t.shape[0]
    span = 1 << max(chunk - 1, 0).bit_length()
    segs = min(warps, span)
    kstar = np.full((h, w), n, np.int64)
    theta = np.zeros((h, w), np.float32)
    mlo = np.zeros((h, w), np.float32)
    for c0 in range(0, w, cols):
        cs = slice(c0, min(c0 + cols, w))
        nc = cs.stop - cs.start
        lanes = np.arange(nc)
        for r0 in range(0, h, band):
            rs = slice(r0, min(r0 + band, h))
            tb = t[rs][:, None]
            open_ = np.ones((rs.stop - rs.start, nc), bool)
            carry = np.full(nc, M_INIT, np.float32)
            for k0 in range(0, n, chunk):
                length = min(chunk, n - k0)
                blk = np.full((span, nc), -np.inf, np.float32)
                blk[:length] = e[k0 : k0 + length, cs]
                local = np.maximum.accumulate(blk.reshape(segs, span // segs, nc), axis=1)
                heads = np.concatenate([carry[None], local[:-1, -1]], axis=0)
                pre = np.maximum.accumulate(heads, axis=0)
                m = np.maximum(pre[:, None, :], local).reshape(span, nc)
                mlast = m[-1][None, :]
                decide = open_ & ~(mlast <= tb)
                idx = np.zeros(open_.shape, np.int64)
                step = span // 2
                while step:
                    idx = np.where(m[idx + step - 1, lanes] <= tb, idx + step, idx)
                    step //= 2
                mk = m[idx, lanes]
                mp = np.where(idx > 0, m[np.maximum(idx - 1, 0), lanes], carry[None, :])
                hit = decide & (tb < mk) & (tb >= mp)
                kstar[rs, cs] = np.where(hit, k0 + idx, kstar[rs, cs])
                theta[rs, cs] = np.where(hit, mk, theta[rs, cs])
                mlo[rs, cs] = np.where(hit, mp, mlo[rs, cs])
                open_ &= ~decide
                carry = m[-1]
                if not open_.any():
                    break
    hit = kstar < n
    col = np.broadcast_to(np.arange(w), (h, w))
    outs = [np.where(hit, plane[np.minimum(kstar, n - 1), col], 0).astype(np.float32) for plane in a]
    return kstar.astype(np.float32), theta, mlo, *outs


def _mirror_case(case, chunk):
    """Inputs for one mirror case; ``chunk`` places the chunk-edge events."""
    n, h, w = {"odd_n": (509, 24, 40)}.get(case, (150, 40, 70))
    e, a, t = _inputs(10 + len(case), n, h, w)
    rng = np.random.default_rng(len(case))
    if case == "ties":
        m = np.maximum.accumulate(e, axis=0)
        t = np.concatenate([rng.choice(m.ravel(), h // 2), rng.choice(e.ravel(), h - h // 2)])
        t = t.astype(np.float32)
    elif case == "nan_profile":
        e[[5, 63, 64, 127], rng.integers(0, w, 4)] = np.nan
        e[min(chunk, n - 1), 10:20] = np.nan
        e[min(chunk - 1, n - 1), 30:35] = np.nan
    elif case == "extreme_rows":
        t[:7] = [np.nan, -np.inf, np.inf, M_INIT, -3.1e38, e.max(), e.min()]
    elif case == "sky_rows":
        t[::3] = e.max() + 1.0
    elif case == "shuffled":
        t = t[rng.permutation(h)].copy()
    elif case == "chunk_edges":
        for k in (chunk - 1, chunk, 2 * chunk):  # last and first steps of chunks
            if k < n:
                e[k, k % w : k % w + 20] = e.max() + 1.0 + k
        t[: h // 2] = np.linspace(e.max() + 0.5, e.max() - 0.5, h // 2)
    return e, a, t


MIRROR_CASES = ["ties", "nan_profile", "extreme_rows", "sky_rows", "shuffled", "odd_n", "chunk_edges"]


@pytest.mark.parametrize("chunk", [1, 7, CHUNK, "n"])
@pytest.mark.parametrize("case", MIRROR_CASES)
def test_kernel_algorithm_matches_oracle(case, chunk):
    """The CUDA kernel's chunked search (numpy mirror) equals the serial
    oracle exactly, for chunks of 1, 7, the kernel's own and the whole
    profile."""
    e, a, t = _mirror_case(case, CHUNK if chunk == "n" else chunk)
    chunk = e.shape[0] if chunk == "n" else chunk
    for g, w, name in zip(kernel_mirror(e, a, t, chunk), oracle(e, a, t), NAMES):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_plain_matches_pallas_interpret_with_ties():
    """Thresholds equal to running-max and profile values: a tie does not
    cross, in the TPU kernel and in the port alike."""
    e, a, _ = _inputs(7, 48, 16, 2 * LANES)
    m = np.maximum.accumulate(e, axis=0)
    rng = np.random.default_rng(7)
    t1d = np.sort(np.concatenate([rng.choice(m.ravel(), 12), rng.choice(e.ravel(), 4)]))[::-1]
    t1d = t1d.astype(np.float32).copy()
    thresh = np.broadcast_to(t1d[:, None], (16, 2 * LANES)).copy()
    want = crossing_search_pallas(
        jnp.asarray(e), *[jnp.asarray(x) for x in a], jnp.asarray(thresh), height=16, interpret=True,
    )
    got = crossing_search(torch.from_numpy(e), *map(torch.from_numpy, a), torch.from_numpy(t1d))
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[0].numpy() < 48).any() and (got[0].numpy() == 48).any()
