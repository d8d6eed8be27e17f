"""GPU-vs-host float64 equivalence at real widths.

Every test here is marked ``gpu``: the conftest fixture skips it unless
JAX's devices are GPUs. ``python chip_smoke.py`` runs this file
in-process on the card (its ``gpu_tests`` phase).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from transport_analysis_tpu import ops
from transport_analysis_tpu.ops.acf import (
    acf_fft_numpy,
    acf_windowed_numpy,
    device_budget_bytes,
)
from transport_analysis_tpu.ops.einstein import (
    einstein_difference_numpy,
    einstein_difference_windowed_numpy,
)

pytestmark = pytest.mark.gpu


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_acf_fft_matches_host_f64():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(10000, 512, 3))
    got = np.asarray(ops.acf_fft(x))
    assert got.dtype == np.float64
    assert _rel(got, acf_fft_numpy(x)) < 1e-11


def test_acf_fft_from_f32_long_series():
    rng = np.random.RandomState(1)
    x32 = rng.normal(0, 5, size=(131072, 16, 3)).astype(np.float32)
    got = np.asarray(ops.acf_fft_from_f32(x32))
    assert _rel(got, acf_fft_numpy(x32.astype(np.float64))) < 1e-10


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_einstein_fft_matches_host_kneller(mode):
    rng = np.random.RandomState(2)
    a = np.cumsum(rng.normal(size=(10000, 256, 3)), axis=0) + 50.0
    got = np.asarray(ops.einstein_difference_fft(a, mode))
    assert _rel(got, einstein_difference_numpy(a, mode)) < 1e-11


def test_msd_fft_long_series():
    rng = np.random.RandomState(3)
    r = np.cumsum(rng.normal(size=(32768, 64, 3)), axis=0)
    got = np.asarray(ops.msd_fft(r))
    assert _rel(got, einstein_difference_numpy(r, "sum")) < 1e-11


def test_acf_windowed_matches_host_loop():
    rng = np.random.RandomState(4)
    x = rng.normal(1.0, 3.0, size=(4096, 64, 3))
    got = np.asarray(ops.acf_windowed(x, max_lag=256))
    assert _rel(got, acf_windowed_numpy(x, 256)) < 1e-13


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_einstein_windowed_matches_host_loop(mode):
    rng = np.random.RandomState(5)
    a = np.cumsum(rng.normal(size=(2048, 32, 3)), axis=0)
    got = np.asarray(ops.einstein_difference_windowed(a, mode, max_lag=512))
    want = einstein_difference_windowed_numpy(a, mode, 512)
    assert _rel(got, want) < 1e-12


def test_float32_fast_mode_grade():
    """float32 end to end keeps float32 accuracy (no reduced-precision
    tensor-core mode enters the transform)."""
    rng = np.random.RandomState(6)
    x = rng.normal(size=(8192, 128, 3))
    got = np.asarray(ops.acf_fft(x.astype(np.float32)))
    assert got.dtype == np.float32
    assert _rel(got.astype(np.float64), acf_fft_numpy(x)) < 1e-4


def test_matmul_fft_float32_highest_precision():
    """The matmul DFT names precision=HIGHEST, so float32 products keep
    float32 accuracy on the card (TF32 would give ~1e-3)."""
    from transport_analysis_tpu.ops.fft import matmul_fft

    rng = np.random.RandomState(7)
    x = rng.normal(size=(16384, 64)) + 1j * rng.normal(size=(16384, 64))
    fr, fi = matmul_fft(jnp.asarray(x.real, jnp.float32),
                        jnp.asarray(x.imag, jnp.float32))
    want = np.fft.fft(x, axis=0)
    got = np.asarray(fr, np.float64) + 1j * np.asarray(fi, np.float64)
    assert _rel(got, want) < 1e-5


def test_prefix_sum_matches_cumsum():
    rng = np.random.RandomState(8)
    x = rng.normal(1.0, 1.0, size=(1 << 20, 16))
    got = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=0))(x))
    want = np.cumsum(x, axis=0)
    assert np.max(np.abs(got - want) / np.abs(want).max(axis=0)) < 1e-12


def test_budget_defaults_to_device_limit(monkeypatch):
    from transport_analysis_tpu.ops.acf import BUDGET_ENV

    monkeypatch.delenv(BUDGET_ENV, raising=False)
    limit = jax.local_devices()[0].memory_stats()["bytes_limit"]
    assert device_budget_bytes() == float(limit)
