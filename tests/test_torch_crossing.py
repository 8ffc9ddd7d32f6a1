"""Port's first-crossing search (K1) vs the JAX Pallas kernel.

The port's plain PyTorch version (what the wrapper runs on CPU tensors) must
equal `crossing_search_pallas(..., interpret=True)` exactly on the TPU
kernel's own test cases, and the numpy oracle on shapes the TPU kernel
rejects.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_pallas_crossing import oracle
from topo_renderer_tpu.ops.pallas_crossing import LANES, crossing_search_pallas
from topo_renderer_tpu_torch.ops.crossing import crossing_search, crossing_search_plain

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
