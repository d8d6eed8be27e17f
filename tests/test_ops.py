"""Kernel-level tests: autocorrelation, Einstein differences,
integration, and fits — validated against independent numpy/scipy
implementations (the reference's oracle strategy, SURVEY.md §4)."""

import numpy as np
import pytest
from numpy.testing import assert_allclose
from scipy import integrate as sp_integrate

from transport_analysis_tpu import ops
from transport_analysis_tpu.ops.acf import acf_fft_numpy, next_pow_2


def brute_force_acf(x):
    """O(N²) per-lag loop, the trusted oracle."""
    x = np.asarray(x, dtype=np.float64)
    N, P, d = x.shape
    out = np.zeros((N, P))
    for lag in range(N):
        prod = np.sum(x[: N - lag] * x[lag:], axis=-1)
        out[lag] = prod.mean(axis=0)
    return out


def brute_force_einstein(a, reduce_mode="mean"):
    a = np.asarray(a, dtype=np.float64)
    N, P, d = a.shape
    out = np.zeros((N, P))
    for lag in range(1, N):
        diff = a[:-lag] - a[lag:]
        sq = np.square(diff).sum(axis=-1)
        if reduce_mode == "mean":
            sq = sq / d
        out[lag] = sq.mean(axis=0)
    return out


@pytest.fixture(scope="module")
def series():
    rng = np.random.RandomState(42)
    return rng.normal(0, 2, (37, 5, 3))


class TestNextPow2:
    def test_values(self):
        assert next_pow_2(1) == 1
        assert next_pow_2(2) == 2
        assert next_pow_2(3) == 4
        assert next_pow_2(5000) == 8192


class TestACF:
    def test_fft_vs_brute(self, series):
        assert_allclose(
            np.asarray(ops.acf_fft(series)),
            brute_force_acf(series),
            rtol=1e-10,
            atol=1e-10,
        )

    def test_windowed_vs_brute(self, series):
        assert_allclose(
            np.asarray(ops.acf_windowed(series)),
            brute_force_acf(series),
            rtol=1e-12,
        )

    def test_fft_matches_numpy_reference(self, series):
        assert_allclose(
            np.asarray(ops.acf_fft(series)),
            acf_fft_numpy(series),
            rtol=1e-12,
        )

    def test_2d_input(self):
        rng = np.random.RandomState(0)
        x = rng.normal(size=(16, 4))
        got = np.asarray(ops.acf_fft(x))
        expected = brute_force_acf(x[:, :, None])
        assert_allclose(got, expected, rtol=1e-10, atol=1e-12)

    def test_single_particle_polynomial(self):
        # v(t) = t: the reference's characteristic_poly identity
        N = 101
        v = np.arange(N, dtype=np.float64).reshape(N, 1, 1)
        v = np.repeat(v, 3, axis=2)
        expected = np.zeros(N)
        for lag in range(N):
            s = sum(x * (x + lag) for x in range(N - lag))
            expected[lag] = s * 3 / (N - lag)
        assert_allclose(
            np.asarray(ops.acf_fft(v))[:, 0], expected, rtol=1e-9,
            atol=1e-8,
        )
        assert_allclose(
            np.asarray(ops.acf_windowed(v))[:, 0], expected, rtol=1e-12
        )


class TestEinstein:
    def test_fft_vs_brute_mean(self, series):
        assert_allclose(
            np.asarray(ops.einstein_difference_fft(series, "mean")),
            brute_force_einstein(series, "mean"),
            rtol=1e-9,
            atol=1e-9,
        )

    def test_windowed_vs_brute_mean(self, series):
        assert_allclose(
            np.asarray(ops.einstein_difference_windowed(series, "mean")),
            brute_force_einstein(series, "mean"),
            rtol=1e-12,
        )

    def test_fft_vs_brute_sum(self, series):
        assert_allclose(
            np.asarray(ops.einstein_difference_fft(series, "sum")),
            brute_force_einstein(series, "sum"),
            rtol=1e-9,
            atol=1e-9,
        )

    def test_msd_linear_motion(self):
        # r(t) = v·t ⇒ MSD(lag) = |v|²·lag²
        N = 64
        v = np.array([1.0, 2.0, -0.5])
        r = np.arange(N)[:, None, None] * v[None, None, :]
        msd = np.asarray(ops.msd_fft(r))[:, 0]
        lags = np.arange(N, dtype=np.float64)
        assert_allclose(msd, np.sum(v ** 2) * lags ** 2, rtol=1e-8, atol=1e-8)


class TestIntegrate:
    @pytest.fixture(scope="class")
    def xy(self):
        rng = np.random.RandomState(7)
        x = np.sort(rng.uniform(0, 10, 51))
        y = np.sin(x) + 0.1 * rng.normal(size=51)
        return x, y

    def test_trapezoid(self, xy):
        x, y = xy
        assert_allclose(
            float(ops.trapezoid(y, x)),
            sp_integrate.trapezoid(y, x),
            rtol=1e-12,
        )

    def test_simpson_odd(self, xy):
        x, y = xy
        assert_allclose(
            float(ops.simpson(y, x)),
            sp_integrate.simpson(y=y, x=x),
            rtol=1e-12,
        )

    def test_simpson_even(self, xy):
        x, y = xy
        assert_allclose(
            float(ops.simpson(y[:-1], x[:-1])),
            sp_integrate.simpson(y=y[:-1], x=x[:-1]),
            rtol=1e-12,
        )

    def test_cumulative_trapezoid(self, xy):
        x, y = xy
        assert_allclose(
            np.asarray(ops.cumulative_trapezoid(y, x, initial=0.0)),
            sp_integrate.cumulative_trapezoid(y, x, initial=0),
            rtol=1e-12,
            atol=1e-14,
        )

    def test_polyfit_linear(self):
        rng = np.random.RandomState(3)
        x = np.arange(50, dtype=np.float64)
        y = 2.5 * x - 7.0 + rng.normal(0, 0.1, 50)
        slope, intercept = ops.polyfit_linear(x, y)
        exp_slope, exp_intercept = np.polyfit(x, y, 1)
        assert_allclose(float(slope), exp_slope, rtol=1e-10)
        assert_allclose(float(intercept), exp_intercept, rtol=1e-10)


class TestPrefixSum:
    """float64 ``jnp.cumsum`` — the Einstein assembly's prefix sum."""

    @pytest.mark.parametrize("n", [1, 7, 128, 129, 300, 1000])
    def test_matches_cumsum(self, n):
        import jax.numpy as jnp

        rng = np.random.RandomState(n)
        x = rng.normal(size=(n, 5))
        got = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
        want = np.cumsum(x, axis=0)
        assert_allclose(got, want, rtol=1e-12, atol=1e-12)


class TestEinsteinOffsetCancellation:
    """s_head + s_tail − 2·corr cancels
    catastrophically at small lags when the series carries a large
    mean offset. The kernel now centers each (particle, component)
    series first — differences are invariant under centering — so
    small-lag relative accuracy must hold for offset data in BOTH
    dtypes."""

    def _oracle(self, a):
        n = a.shape[0]
        out = np.zeros((n, a.shape[1]))
        for lag in range(1, n):
            diff = a[:-lag] - a[lag:]
            out[lag] = np.square(diff).sum(-1).mean(0)
        return out

    def test_f64_small_lag_with_large_offset(self):
        from transport_analysis_tpu import ops

        rng = np.random.RandomState(11)
        # random walk with a huge uniform offset: diffs ~1, values ~1e6
        a = np.cumsum(rng.normal(0, 1, (256, 4, 3)), axis=0)
        a += rng.uniform(1e6, 2e6, (1, 4, 3))
        got = np.asarray(
            ops.einstein_difference_fft(a, "sum")
        )
        want = self._oracle(a)
        # small lags are the cancellation hot zone — check them tightly
        assert_allclose(got[1:16], want[1:16], rtol=1e-9)
        assert_allclose(got, want, rtol=1e-8)

    def test_f32_small_lag_with_offset(self):
        from transport_analysis_tpu import ops

        rng = np.random.RandomState(12)
        a64 = np.cumsum(rng.normal(0, 1, (256, 4, 3)), axis=0)
        a64 += rng.uniform(10, 20, (1, 4, 3))  # bench-like offsets
        got = np.asarray(
            ops.einstein_difference_fft(a64.astype(np.float32), "sum")
        )
        want = self._oracle(a64)
        assert_allclose(got[1:16], want[1:16], rtol=1e-3)


class TestF32Feed:
    """The float32-sample entries upcast on the device and run the
    float64 route."""

    def test_from_f32_entries_match_f64_route(self):
        """acf_fft_from_f32 / einstein_difference_fft_from_f32 match
        the f64 route on f32-exact samples (up to backend FFT
        determinism)."""
        import jax.numpy as jnp
        from transport_analysis_tpu import ops

        rng = np.random.RandomState(9)
        x32 = rng.normal(0, 4.0, (200, 6, 3)).astype(np.float32)
        want = np.asarray(ops.acf_fft(jnp.asarray(x32, jnp.float64)))
        got = np.asarray(ops.acf_fft_from_f32(jnp.asarray(x32)))
        assert got.dtype == np.float64
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

        a32 = rng.normal(10.0, 2.0, (200, 6, 3)).astype(np.float32)
        want = np.asarray(ops.einstein_difference_fft(
            jnp.asarray(a32, jnp.float64), "mean"))
        got = np.asarray(ops.einstein_difference_fft_from_f32(
            jnp.asarray(a32), "mean"))
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()

        with pytest.raises(TypeError, match="float32"):
            ops.acf_fft_from_f32(jnp.asarray(a32, jnp.float64))
        with pytest.raises(TypeError, match="float32"):
            ops.einstein_difference_fft_from_f32(
                jnp.asarray(a32, jnp.float64))
