"""Helfand/MSD lag differences (ops/einstein.py) against host float64
oracles — the numpy Kneller form and the reference's per-lag loop — at
the shapes the former emulation-kernel suites covered."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from transport_analysis_tpu import ops
from transport_analysis_tpu.ops.einstein import (
    einstein_difference_numpy,
    einstein_difference_windowed_numpy,
)

# (N, P, d)
SHAPES = [
    (2, 1, 1), (16, 3, 3), (37, 5, 3), (129, 4, 2), (256, 8, 3),
    (1000, 16, 3), (4096, 8, 3), (32769, 2, 3), (131072, 2, 3),
    (262144, 1, 3),
]


def _walk(shape, seed, offset=100.0):
    """Random walk with a large mean offset: the small-lag cancellation
    case of the Kneller identity."""
    rng = np.random.RandomState(seed)
    a = np.cumsum(rng.normal(0, 1, shape), axis=0)
    return a + rng.uniform(offset, 2 * offset, (1,) + shape[1:])


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _tol(n):
    """FFT round-off relative to the curve's maximum: the deepest lags
    divide a sum of ~1 term by (N - lag) ~ 1, so the absolute error
    there is ~N·eps of the lag-0 scale."""
    return max(1e-12, 4e-16 * n)


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("shape", SHAPES)
def test_einstein_fft_matches_kneller_numpy(shape, mode):
    a = _walk(shape, seed=sum(shape))
    got = np.asarray(ops.einstein_difference_fft(a, mode))
    assert got.shape == shape[:2]
    assert np.all(got[0] == 0.0)
    assert _rel(got, einstein_difference_numpy(a, mode)) < _tol(shape[0])


@pytest.mark.parametrize("shape", SHAPES[:8])
def test_msd_fft_matches_kneller_numpy(shape):
    r = _walk(shape, seed=3 + sum(shape))
    got = np.asarray(ops.msd_fft(r))
    assert _rel(got, einstein_difference_numpy(r, "sum")) < _tol(shape[0])


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("shape", [(16, 3, 3), (256, 8, 3), (1000, 4, 1),
                                   (4096, 2, 3), (131072, 1, 3)])
def test_einstein_from_f32_matches_f64_route(shape, mode):
    a32 = _walk(shape, seed=5 + sum(shape), offset=10.0).astype(np.float32)
    a64 = a32.astype(np.float64)
    got = np.asarray(ops.einstein_difference_fft_from_f32(a32, mode))
    assert got.dtype == np.float64
    assert _rel(got, einstein_difference_numpy(a64, mode)) < _tol(shape[0])
    same = np.asarray(ops.einstein_difference_fft(a64, mode))
    assert _rel(got, same) < _tol(shape[0])


# (N, P, d, max_lag)
WINDOWED_CASES = [
    (8, 2, 3, None), (37, 5, 3, None), (129, 4, 2, 40),
    (256, 8, 3, 64), (1024, 16, 3, 100), (2048, 2, 1, 2048),
]


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("n,p,d,max_lag", WINDOWED_CASES)
def test_einstein_windowed_matches_reference_loop(n, p, d, max_lag, mode):
    a = _walk((n, p, d), seed=n + p, offset=5.0)
    got = np.asarray(
        ops.einstein_difference_windowed(a, mode, max_lag=max_lag))
    want = einstein_difference_windowed_numpy(a, mode, max_lag)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-12
    # the Kneller oracle agrees with the loop on the same lags
    kneller = einstein_difference_numpy(a, mode)[: want.shape[0]]
    assert _rel(kneller, want) < 1e-10


@pytest.mark.parametrize("n,p", [(1, 1), (2, 3), (127, 4), (128, 4),
                                 (129, 4), (1000, 7), (16384, 2),
                                 (16513, 3), (131072, 2), (262145, 1)])
def test_prefix_sum_matches_cumsum(n, p):
    rng = np.random.RandomState(n + p)
    x = rng.normal(2.0, 1.0, (n, p))
    got = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=0))(x))
    assert_allclose(got, np.cumsum(x, axis=0), rtol=1e-12, atol=1e-12)
