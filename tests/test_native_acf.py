"""The native spectral path (ops/acf.py) against host float64 oracles,
at the shapes the former emulation-kernel suites covered: short series, the
old engine sizes, and long series (N ≥ 2^17) with few particles."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import jax.numpy as jnp

from transport_analysis_tpu import ops
from transport_analysis_tpu.ops.acf import (
    acf_fft_numpy,
    acf_windowed_numpy,
    next_pow_2,
    raw_autocorr_sumlast,
)

# (N, P, d)
FFT_SHAPES = [
    (1, 1, 1), (2, 3, 1), (7, 2, 3), (37, 5, 3), (100, 4, 2),
    (129, 3, 3), (255, 8, 3), (256, 8, 3), (500, 64, 3), (1000, 16, 3),
    (3000, 32, 1), (4096, 8, 3), (8192, 4, 3), (16384, 2, 3),
    (32768, 2, 3), (32769, 2, 3), (65536, 1, 3), (131072, 2, 3),
    (131073, 1, 3), (262144, 1, 3),
]


def _series(shape, seed, offset=0.0):
    rng = np.random.RandomState(seed)
    return rng.normal(offset, 3.0, shape)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _tol(n):
    """FFT round-off relative to the curve's maximum: the deepest lags
    divide a sum of ~1 term by (N - lag) ~ 1, so the absolute error
    there is ~N·eps of the lag-0 scale."""
    return max(1e-12, 4e-16 * n)


@pytest.mark.parametrize("shape", FFT_SHAPES)
def test_acf_fft_matches_numpy(shape):
    x = _series(shape, seed=sum(shape))
    got = np.asarray(ops.acf_fft(x))
    assert got.shape == shape[:2]
    assert got.dtype == np.float64
    assert _rel(got, acf_fft_numpy(x)) < _tol(shape[0])


@pytest.mark.parametrize("shape", FFT_SHAPES[::2] + [(131072, 2, 3)])
def test_acf_fft_from_f32_matches_numpy(shape):
    x32 = _series(shape, seed=7 + sum(shape)).astype(np.float32)
    got = np.asarray(ops.acf_fft_from_f32(x32))
    assert got.dtype == np.float64
    assert _rel(got, acf_fft_numpy(x32.astype(np.float64))) < _tol(shape[0])
    same = np.asarray(ops.acf_fft(x32.astype(np.float64)))
    assert _rel(got, same) < _tol(shape[0])


@pytest.mark.parametrize("s", [1, 2, 5, 8, 33])
def test_raw_autocorr_sumlast_matches_correlate(s):
    rng = np.random.RandomState(s)
    n, d = 300, 3
    x = rng.normal(size=(n, s, d))
    got = np.asarray(raw_autocorr_sumlast(jnp.asarray(x)))
    want = np.stack(
        [sum(np.correlate(x[:, i, k], x[:, i, k], "full")[n - 1:]
             for k in range(d)) for i in range(s)],
        axis=1,
    )
    assert_allclose(got, want, atol=1e-11 * np.max(np.abs(want)))


# (N, P, d, max_lag)
WINDOWED_CASES = [
    (1, 1, 1, None), (16, 3, 3, None), (37, 5, 3, None),
    (100, 4, 2, 10), (256, 8, 3, 64), (512, 16, 3, 64),
    (600, 2, 1, 600), (1024, 32, 3, 128), (2048, 4, 3, 16),
    (4096, 2, 3, 8),
]


@pytest.mark.parametrize("n,p,d,max_lag", WINDOWED_CASES)
def test_acf_windowed_matches_reference_loop(n, p, d, max_lag):
    x = _series((n, p, d), seed=n + p, offset=2.0)
    got = np.asarray(ops.acf_windowed(x, max_lag=max_lag))
    want = acf_windowed_numpy(x, max_lag)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-13
    # and the FFT path agrees on the same lags
    fft = np.asarray(ops.acf_fft(x))[: want.shape[0]]
    assert _rel(fft, want) < 1e-11


def test_next_pow_2_gives_linear_padding():
    for n in (1, 2, 3, 1000, 10000, 2 ** 17, 2 ** 17 + 1):
        m = 2 * next_pow_2(n)
        assert m >= 2 * n - 1 and m & (m - 1) == 0
