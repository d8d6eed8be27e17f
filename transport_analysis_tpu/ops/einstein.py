"""Einstein-difference kernels: Helfand viscosity accumulators and MSD.

The quantity common to the Einstein–Helfand viscosity function
(reference viscosity.py:210-226) and the Einstein MSD is the mean
squared lag-difference of a per-particle series A(t):

    E(lag, p) = 1/(N-lag) * sum_{i<N-lag} sum_d (A[i,p,d] - A[i+lag,p,d])²

(For the Helfand function A = m·v·x and the component axis is *averaged*,
not summed — viscosity.py:222; for the MSD A = r and components are
summed.)

Two implementations:

* ``einstein_difference_windowed`` — the reference's exact O(N²·P·d)
  per-lag summation order, fused into one lax.fori_loop kernel.
* ``einstein_difference_fft`` — O(P·d·N log N) via the
  Kneller/Calandrini decomposition used by tidynamics.msd:

      sum_i (A_i − A_{i+lag})² = S(0, N-lag-1) + S(lag, N-1) − 2·C(lag)

  where S are prefix-sum windows of |A|² and C(lag) is the raw (un-
  normalized) autocorrelation from the FFT kernel. This gives an
  asymptotically faster Helfand/MSD path than the reference, which
  only ships the O(N²) loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .acf import next_pow_2, raw_autocorr_sumlast


@partial(jax.jit, static_argnames=("reduce_mode", "n_lags"))
def _einstein_windowed_impl(
    a: jax.Array, reduce_mode: str, n_lags: int
) -> jax.Array:
    N, P, d = a.shape
    frame_idx = jnp.arange(N)
    denom_d = d if reduce_mode == "mean" else 1

    def body(lag, out):
        shifted = jnp.roll(a, -lag, axis=0)
        diff = a - shifted
        sq = jnp.sum(diff * diff, axis=-1) / denom_d  # (N, P)
        mask = (frame_idx < N - lag)[:, None]
        s = jnp.sum(jnp.where(mask, sq, 0), axis=0)
        return out.at[lag].set(s / (N - lag))

    # lag 0 row stays 0 (reference viscosity.py:207 starts lags at 1)
    return jax.lax.fori_loop(
        1, n_lags, body, jnp.zeros((n_lags, P), a.dtype)
    )


def einstein_difference_windowed(
    a, reduce_mode: str = "mean", max_lag=None
) -> jax.Array:
    """Exact windowed mean-squared lag difference,
    (N, P, d) → (n_lags, P).

    ``reduce_mode='mean'`` averages over components (Helfand,
    viscosity.py:222); ``'sum'`` sums them (MSD convention). Runs as one
    lax.fori_loop kernel over the lags.
    """
    a = jnp.asarray(a)
    if a.ndim == 2:
        a = a[:, :, None]
    n = a.shape[0]
    n_lags = n if max_lag is None else min(int(max_lag), n)
    return _einstein_windowed_impl(a, reduce_mode, n_lags)


@partial(jax.jit, static_argnames=("reduce_mode", "d"))
def _assemble(sq: jax.Array, corr: jax.Array, reduce_mode: str,
              d: int) -> jax.Array:
    """Kneller/Calandrini assembly from ``sq`` = Σ_d |a_i|² of the
    per-series CENTERED operand and ``corr`` its raw component-summed
    autocorrelation. Centering matters: (s_head + s_tail − 2·corr)
    cancels catastrophically at small lags when the series carries a
    large mean offset (positions routinely do); differences are
    invariant under it."""
    N, P = sq.shape
    css = jnp.cumsum(sq, axis=0)  # css[k] = sum_{i<=k} sq[i]
    total = css[-1]
    # S_head(lag) = sum_{i=0}^{N-lag-1} sq[i] = css[N-lag-1]
    s_head = jnp.flip(css, axis=0)
    # S_tail(lag) = sum_{i=lag}^{N-1} sq[i] = total - css[lag-1]
    css_prev = jnp.concatenate(
        [jnp.zeros((1, P), sq.dtype), css[:-1]], axis=0
    )
    s_tail = total[None, :] - css_prev
    raw = s_head + s_tail - 2.0 * corr
    denom = (N - jnp.arange(N)).astype(sq.dtype)
    if reduce_mode == "mean":
        denom = denom * d
    out = raw / denom[:, None]
    # lag-0 row is exactly 0 by construction; pin it to kill FFT noise
    return out.at[0].set(0.0)


@partial(jax.jit, static_argnames=("reduce_mode",))
def _einstein_fft_impl(a: jax.Array, reduce_mode: str) -> jax.Array:
    c = a - jnp.mean(a, axis=0, keepdims=True)
    sq = jnp.sum(c * c, axis=-1)
    corr = raw_autocorr_sumlast(c)
    return _assemble(sq, corr, reduce_mode, a.shape[-1])


@partial(jax.jit, static_argnames=("reduce_mode",))
def _einstein_fft_upcast(a32: jax.Array, reduce_mode: str) -> jax.Array:
    return _einstein_fft_impl(a32.astype(jnp.float64), reduce_mode)


def einstein_difference_fft(a, reduce_mode: str = "mean",
                            corr=None) -> jax.Array:
    """FFT-accelerated mean-squared lag difference, (N, P, d) → (N, P).

    Advanced: ``corr`` supplies a precomputed raw component-summed
    autocorrelation of ``a`` (``ops.acf.raw_autocorr_sumlast``) — in
    that case ``a`` MUST already be per-series centered
    (``a - a.mean(axis=0)``), since the Kneller/Calandrini identity
    needs corr and the prefix sums to agree. This lets callers batch
    several analyses' correlation passes into one call over
    concatenated particle columns (autocorrelation is per-series
    independent)."""
    a = jnp.asarray(a)
    if a.ndim == 2:
        a = a[:, :, None]
    if corr is None:
        return _einstein_fft_impl(a, reduce_mode)
    return _assemble(jnp.sum(a * a, axis=-1), corr, reduce_mode,
                     a.shape[-1])


def einstein_difference_fft_from_f32(a32, reduce_mode: str = "mean"
                                     ) -> jax.Array:
    """Float64 Helfand/Einstein lag difference of float32 samples (see
    ``acf.acf_fft_from_f32``): the block stays float32 up to the device
    and is upcast inside the same program. The result equals
    ``einstein_difference_fft(a32.astype(float64), reduce_mode)``."""
    a32 = jnp.asarray(a32)
    if a32.dtype != jnp.float32:
        raise TypeError(
            f"einstein_difference_fft_from_f32 expects float32 "
            f"samples, got {a32.dtype}")
    if a32.ndim == 2:
        a32 = a32[:, :, None]
    return _einstein_fft_upcast(a32, reduce_mode)


def msd_fft(r) -> jax.Array:
    """Mean squared displacement per particle, (N, P, d) → (N, P).

    Matches ``tidynamics.msd`` / MDAnalysis ``EinsteinMSD`` semantics
    (components summed; reference test_velocityautocorr.py:589-597 uses
    this as the Einstein cross-check on Green–Kubo diffusivity).
    """
    return einstein_difference_fft(r, reduce_mode="sum")


def einstein_difference_numpy(a, reduce_mode: str = "mean") -> np.ndarray:
    """Host float64 Kneller/Calandrini lag difference, (N, P, d) →
    (N, P): numpy FFTs and ``np.cumsum`` on the centered series (the
    tidynamics.msd algorithm), an oracle for the device paths."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 2:
        a = a[:, :, None]
    n, p, d = a.shape
    c = a - a.mean(axis=0, keepdims=True)
    sq = np.sum(c * c, axis=-1)
    m = 2 * next_pow_2(n)
    f = np.fft.rfft(c, n=m, axis=0)
    power = (f.real ** 2 + f.imag ** 2).sum(axis=-1)
    corr = np.fft.irfft(power, n=m, axis=0)[:n]
    css = np.cumsum(sq, axis=0)
    lags = np.arange(n)
    s_head = css[n - 1 - lags]
    s_tail = css[-1][None, :] - np.concatenate(
        [np.zeros((1, p)), css[:-1]], axis=0)
    out = (s_head + s_tail - 2.0 * corr) / (n - lags)[:, None]
    if reduce_mode == "mean":
        out = out / d
    out[0] = 0.0
    return out


def einstein_difference_windowed_numpy(a, reduce_mode: str = "mean",
                                       max_lag=None) -> np.ndarray:
    """Host float64 per-lag squared differences, (N, P, d) →
    (n_lags, P): the reference's loop (viscosity.py:210-226)."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 2:
        a = a[:, :, None]
    n, p, d = a.shape
    n_lags = n if max_lag is None else min(int(max_lag), n)
    out = np.zeros((n_lags, p))
    for lag in range(1, n_lags):
        diff = a[: n - lag] - a[lag:]
        out[lag] = np.einsum("ipd,ipd->p", diff, diff) / (n - lag)
    if reduce_mode == "mean":
        out = out / d
    return out
