"""Matmul-decomposition FFT tests (ops/fft.py) — the local levels of the
frame-sharded transform, validated against numpy's FFT and against the
native-FFT kernels."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import jax.numpy as jnp

from transport_analysis_tpu import ops
from transport_analysis_tpu.ops.fft import matmul_fft, raw_autocorr_matmul
from transport_analysis_tpu.ops.acf import next_pow_2


@pytest.mark.parametrize("n", [8, 64, 256, 512, 2048, 8192])
def test_matmul_fft_matches_numpy(n):
    rng = np.random.RandomState(n)
    x = rng.randn(n, 3) + 1j * rng.randn(n, 3)
    fr, fi = matmul_fft(jnp.asarray(x.real), jnp.asarray(x.imag))
    ref = np.fft.fft(x, axis=0)
    scale = np.max(np.abs(ref))
    assert_allclose(np.asarray(fr), ref.real, atol=1e-12 * scale)
    assert_allclose(np.asarray(fi), ref.imag, atol=1e-12 * scale)


def test_matmul_fft_inverse_roundtrip():
    rng = np.random.RandomState(1)
    x = rng.randn(1024, 2) + 1j * rng.randn(1024, 2)
    fr, fi = matmul_fft(jnp.asarray(x.real), jnp.asarray(x.imag))
    br, bi = matmul_fft(fr, fi, inverse=True)
    assert_allclose(np.asarray(br), x.real, atol=1e-12)
    assert_allclose(np.asarray(bi), x.imag, atol=1e-12)


@pytest.mark.parametrize("s", [1, 2, 7, 8])
def test_raw_autocorr_matmul(s):
    """Pair-packing autocorrelation vs np.correlate, incl. odd column
    counts (exercises the padding column)."""
    rng = np.random.RandomState(s)
    n = 500
    x = rng.randn(n, s)
    m = 2 * next_pow_2(n)
    x_pad = np.zeros((m, s))
    x_pad[:n] = x
    got = np.asarray(raw_autocorr_matmul(jnp.asarray(x_pad), n))
    ref = np.stack(
        [np.correlate(x[:, i], x[:, i], "full")[n - 1:] for i in range(s)],
        axis=1,
    )
    assert_allclose(got, ref, atol=1e-10 * np.max(np.abs(ref)))


def test_matmul_path_matches_native_acf():
    """The full acf kernel produces identical physics through both the
    native-FFT and matmul-FFT implementations."""
    from transport_analysis_tpu.ops import acf as acf_mod

    rng = np.random.RandomState(3)
    x = rng.normal(size=(129, 4, 3))
    native = np.asarray(ops.acf_fft(x))
    n, p, d = x.shape
    m = 2 * next_pow_2(n)
    x_pad = np.zeros((m, p * d))
    x_pad[:n] = x.reshape(n, p * d)
    raw = np.asarray(
        raw_autocorr_matmul(jnp.asarray(x_pad), n)
    ).reshape(n, p, d).sum(axis=-1)
    matmul = raw / (n - np.arange(n))[:, None]
    assert_allclose(matmul, native, rtol=1e-10, atol=1e-10)
