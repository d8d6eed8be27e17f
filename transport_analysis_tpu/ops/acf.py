"""Autocorrelation kernels (Wiener–Khinchin FFT + exact windowed).

The reference computes the VACF either through ``tidynamics.acf`` — an
FFT autocorrelation called *serially per particle* in a Python loop
(reference velocityautocorr.py:210-213) — or through a per-lag numpy
"windowed" loop (velocityautocorr.py:223-235). Both paths compute

    C(lag, p) = 1/(N-lag) * sum_{i<N-lag} sum_d x[i,p,d] * x[i+lag,p,d]

Here both are single fused XLA computations batched over every particle
and component at once:

* ``acf_fft``      — zero-pad to 2·next_pow2(N), batched rfft → |·|²
                     summed over components → irfft, truncate, normalize
                     by (N-lag). O(P·d·N logN) with the whole particle
                     batch in one FFT call.
* ``acf_windowed`` — direct per-lag sum, exactly the reference's
                     summation order, as a lax.fori_loop (compiles to one
                     kernel; no Python-level lag loop).

Precision: transport properties need float64-grade results (reference
velocityautocorr.py:208). Float64 input runs complex128 FFTs on every
backend (cuFFT on the GPU, ducc on the CPU).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def next_pow_2(n: int) -> int:
    """Smallest power of two >= n."""
    m = 1
    while m < n:
        m *= 2
    return m


BUDGET_ENV = "TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB"


def device_budget_bytes(hbm_budget_gb: float | None = None) -> float:
    """Device-memory budget for sizing atom chunks, in bytes.

    Resolution order: the ``hbm_budget_gb`` argument, then the
    ``TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB`` environment variable, then
    the first local device's ``memory_stats()["bytes_limit"]`` (what
    the allocator may hand out). A device that reports no limit (the
    CPU backend) has no default: the caller must name a budget.
    """
    if hbm_budget_gb is None:
        env = os.environ.get(BUDGET_ENV)
        if env is not None:
            hbm_budget_gb = float(env)
    if hbm_budget_gb is not None:
        return float(hbm_budget_gb) * 1e9
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        raise ValueError(
            "the device reports no memory limit; pass hbm_budget_gb or "
            f"set {BUDGET_ENV} to size atom chunks"
        )
    return float(limit)


def fft_peak_bytes(n_frames: int, chunk: int, d: int = 3,
                   src_itemsize: int = 8) -> float:
    """Modeled device peak of one FFT correlation pass over a
    (n_frames, chunk, d) block (the Einstein variant adds only
    (n_frames, chunk)-sized terms, covered by the same bound).

    Terms, with w = d·chunk series, M = 2·next_pow_2(n_frames):

    * the caller-held source, n_frames·w·src_itemsize;
    * its float64 working copy, n_frames·w·8;
    * the zero-padded transform operand, M·w·8;
    * the complex128 spectrum and the FFT library's workspace,
      2·(M/2+1)·w·16;
    * the component-summed power, (M/2+1)·chunk·8;
    * the inverse output and the sliced, normalized result,
      2·M·chunk·8.
    """
    m = 2 * next_pow_2(n_frames)
    half = m // 2 + 1
    w = d * chunk
    return float(
        n_frames * w * (src_itemsize + 8)
        + m * w * 8
        + 2 * half * w * 16
        + half * chunk * 8
        + 2 * m * chunk * 8
    )


def auto_atom_chunk(
    n_frames: int, d: int = 3, hbm_budget_gb: float | None = None,
    dtype=jnp.float64,
) -> int:
    """Largest atom chunk whose FFT correlation pass fits the device
    budget (:func:`device_budget_bytes`) under :func:`fft_peak_bytes`.

    ``dtype`` is the dtype of the block the caller holds on the device
    (float32 for trajectory spools). Raises ``ValueError`` when not even
    one atom fits.
    """
    budget = device_budget_bytes(hbm_budget_gb)
    isize = int(jnp.dtype(dtype).itemsize)
    per_atom = fft_peak_bytes(n_frames, 1, d, isize)
    chunk = int(budget // per_atom)
    if chunk < 1:
        raise ValueError(
            f"a budget of {budget / 1e9:.3g} GB does not hold one atom "
            f"at {n_frames} frames ({per_atom / 1e9:.3g} GB per atom)"
        )
    return chunk


@jax.jit
def raw_autocorr_sumlast(x: jax.Array) -> jax.Array:
    """(N, P, d) → (N, P): unnormalized per-particle autocorrelation
    summed over components, out[lag, p] = Σ_i Σ_d x[i,p,d]·x[i+lag,p,d].

    The component sum is taken on the power spectra (|F|² adds), so the
    inverse transform carries one column per particle instead of d.
    """
    N = x.shape[0]
    M = 2 * next_pow_2(N)
    f = jnp.fft.rfft(x, n=M, axis=0)
    power = (f.real * f.real + f.imag * f.imag).sum(axis=-1)
    return jnp.fft.irfft(power, n=M, axis=0)[:N].astype(x.dtype)


@jax.jit
def _acf_fft_impl(x: jax.Array) -> jax.Array:
    N = x.shape[0]
    raw = raw_autocorr_sumlast(x)
    return raw / (N - jnp.arange(N, dtype=raw.dtype))[:, None]


def acf_fft(x) -> jax.Array:
    """Batched FFT autocorrelation.

    Parameters
    ----------
    x : (N, P, d) array — N frames, P particles, d components.

    Returns
    -------
    (N, P) array: per-particle autocorrelation vs lag.
    """
    x = jnp.asarray(x)
    if x.ndim == 2:
        x = x[:, :, None]
    return _acf_fft_impl(x)


@jax.jit
def _acf_fft_upcast(x32: jax.Array) -> jax.Array:
    return _acf_fft_impl(x32.astype(jnp.float64))


def acf_fft_from_f32(x32) -> jax.Array:
    """Float64 batched FFT autocorrelation of float32 samples.

    Trajectory formats store velocities as float32, which float64
    represents exactly. Keeping the block float32 until it is on the
    device halves host buffers and host-to-device bytes; the upcast
    runs inside the same program as the transform. The result equals
    ``acf_fft(x32.astype(float64))``.
    """
    x32 = jnp.asarray(x32)
    if x32.dtype != jnp.float32:
        raise TypeError(
            f"acf_fft_from_f32 expects float32 samples, got "
            f"{x32.dtype} (use acf_fft for float64 operands)")
    if x32.ndim == 2:
        x32 = x32[:, :, None]
    return _acf_fft_upcast(x32)


@partial(jax.jit, static_argnames=("n_lags",))
def _acf_windowed_impl(x: jax.Array, n_lags: int) -> jax.Array:
    N, P, _ = x.shape
    frame_idx = jnp.arange(N)

    def body(lag, out):
        shifted = jnp.roll(x, -lag, axis=0)
        prod = jnp.sum(x * shifted, axis=-1)  # (N, P) dot over components
        mask = (frame_idx < N - lag)[:, None]
        s = jnp.sum(jnp.where(mask, prod, 0), axis=0)
        return out.at[lag].set(s / (N - lag))

    return jax.lax.fori_loop(
        0, n_lags, body, jnp.zeros((n_lags, P), x.dtype)
    )


def acf_windowed(x, max_lag=None) -> jax.Array:
    """Exact per-lag windowed autocorrelation, (N, P, d) → (n_lags, P).

    Same summation order as the reference's simple algorithm
    (velocityautocorr.py:223-235); O(N·L·P·d) for ``max_lag`` = L lags
    (all N by default), fully on-device as one lax.fori_loop kernel.
    """
    x = jnp.asarray(x)
    if x.ndim == 2:
        x = x[:, :, None]
    n = x.shape[0]
    n_lags = n if max_lag is None else min(int(max_lag), n)
    return _acf_windowed_impl(x, n_lags)


def acf_fft_numpy(x: np.ndarray) -> np.ndarray:
    """Host float64 Wiener–Khinchin autocorrelation (tidynamics.acf
    parity, used as an independent oracle in tests and as the CPU
    baseline in bench.py)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, :, None]
    N = x.shape[0]
    M = 2 * next_pow_2(N)
    f = np.fft.rfft(x, n=M, axis=0)
    raw = np.fft.irfft(f * np.conj(f), n=M, axis=0)[:N].real
    raw = raw.sum(axis=-1)
    return raw / (N - np.arange(N))[:, None]


def acf_windowed_numpy(x: np.ndarray, max_lag=None) -> np.ndarray:
    """Host float64 per-lag windowed autocorrelation, (N, P, d) →
    (n_lags, P): the reference's own loop (velocityautocorr.py:
    223-235), an oracle independent of the FFT."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, :, None]
    n = x.shape[0]
    n_lags = n if max_lag is None else min(int(max_lag), n)
    out = np.empty((n_lags, x.shape[1]))
    for lag in range(n_lags):
        out[lag] = np.einsum("ipd,ipd->p", x[: n - lag], x[lag:]) / (n - lag)
    return out
