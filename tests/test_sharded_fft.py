"""Frame-axis-sharded four-step FFT vs the serial matmul FFT / numpy.

Runs on the suite's 8-virtual-device CPU backend
(xla_force_host_platform_device_count emulates several devices).
"""

import jax
import numpy as np
import pytest
from numpy.testing import assert_allclose
from jax.sharding import Mesh

from transport_analysis_tpu import ops
from transport_analysis_tpu.ops.acf import next_pow_2
from transport_analysis_tpu.parallel.sharded_fft import (
    sharded_acf_fft,
    sharded_fft,
    sharded_msd_fft,
    sharded_raw_autocorr,
)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("frames",))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_forward_inverse_roundtrip(n_dev):
    rng = np.random.RandomState(0)
    m, b = 1024, 6
    re = rng.normal(size=(m, b))
    im = rng.normal(size=(m, b))
    mesh = _mesh(n_dev)
    zr, zi = sharded_fft(re, im, mesh)
    xr, xi = sharded_fft(zr, zi, mesh, inverse=True)
    assert_allclose(np.asarray(xr), re, atol=1e-11)
    assert_allclose(np.asarray(xi), im, atol=1e-11)


def test_power_spectrum_matches_numpy():
    """|Z|² is layout-blind: the transposed-order power spectrum must
    be a permutation of numpy's — compare via sorted values and via
    the explicit (k1, k2) reindexing."""
    rng = np.random.RandomState(1)
    m, b = 512, 3
    x = rng.normal(size=(m, b))
    mesh = _mesh(8)
    zr, zi = sharded_fft(x, np.zeros_like(x), mesh)
    got = np.asarray(zr) + 1j * np.asarray(zi)
    want = np.fft.fft(x, axis=0)
    # transposed order: row k1·n2 + k2 holds frequency k2·n1 + k1
    n_dev = 8
    n1 = max(n_dev, min(128, m // n_dev))
    n2 = m // n1
    k1, k2 = np.divmod(np.arange(m), n2)
    freq = k2 * n1 + k1
    assert_allclose(got, want[freq], atol=1e-10 * np.max(np.abs(want)))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_raw_autocorr_matches_serial(n_dev):
    rng = np.random.RandomState(2)
    n, s = 300, 5
    x = rng.normal(size=(n, s))
    m = 2 * next_pow_2(n)
    xp = np.zeros((m, s))
    xp[:n] = x
    got = np.asarray(sharded_raw_autocorr(xp, _mesh(n_dev)))[:n]
    ref = np.stack(
        [np.correlate(x[:, i], x[:, i], "full")[n - 1:]
         for i in range(s)],
        axis=1,
    )
    assert_allclose(got, ref, atol=1e-10 * np.max(np.abs(ref)))


def test_sharded_acf_matches_acf_fft():
    rng = np.random.RandomState(3)
    x = rng.normal(size=(500, 7, 3))
    got = sharded_acf_fft(x, _mesh(8))
    want = np.asarray(ops.acf_fft(x))
    assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_sharded_msd_matches_einstein_fft():
    rng = np.random.RandomState(4)
    a = np.cumsum(rng.normal(size=(400, 5, 3)), axis=0) + 50.0
    got = sharded_msd_fft(a, _mesh(8), reduce_mode="mean")
    want = np.asarray(ops.einstein_difference_fft(a, "mean"))
    assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_bad_factorization_raises():
    with pytest.raises(ValueError, match="cannot factor"):
        sharded_raw_autocorr(np.zeros((20, 2)), _mesh(8))


def test_sharded_acf_float32_psum_scatter_branch():
    """float32 through the psum_scatter reduce (float64 is covered by
    the tests above)."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(256, 6, 3)).astype(np.float32)
    mesh = _mesh(8)
    m = 2 * next_pow_2(256)
    xp = np.zeros((m, 18), np.float32)
    xp[:256] = x.reshape(256, 18)
    got = np.asarray(sharded_raw_autocorr(xp, mesh))[:256]
    assert got.dtype == np.float32
    ref = np.stack(
        [np.correlate(x.reshape(256, 18)[:, i],
                      x.reshape(256, 18)[:, i], "full")[255:]
         for i in range(18)],
        axis=1,
    )
    scale = np.abs(ref).max()
    assert_allclose(got, ref, atol=2e-4 * scale)
