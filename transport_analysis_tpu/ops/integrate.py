"""On-device numerical integration and linear fits.

Device-side replacements for the scipy routines the reference calls on
host (``scipy.integrate.trapezoid/simpson/cumulative_trapezoid`` at
velocityautocorr.py:316,355,408 and ``np.polyfit`` at viscosity.py:240):
same numerics, but jittable so Green–Kubo integration fuses with the
correlation kernels on the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def trapezoid(y, x) -> jax.Array:
    """Composite trapezoid rule (scipy.integrate.trapezoid parity)."""
    y = jnp.asarray(y)
    x = jnp.asarray(x, dtype=y.dtype)
    dx = x[1:] - x[:-1]
    return jnp.sum(dx * (y[1:] + y[:-1]) * 0.5)


@jax.jit
def cumulative_trapezoid(y, x, initial: float = 0.0) -> jax.Array:
    """Cumulative trapezoid with an ``initial`` value prepended
    (scipy.integrate.cumulative_trapezoid(..., initial=0) parity)."""
    y = jnp.asarray(y)
    x = jnp.asarray(x, dtype=y.dtype)
    dx = x[1:] - x[:-1]
    partial = jnp.cumsum(dx * (y[1:] + y[:-1]) * 0.5)
    return jnp.concatenate(
        [jnp.full((1,), initial, dtype=y.dtype), partial + initial]
    )


def _simpson_pairs(y, x) -> jax.Array:
    """Composite Simpson over an odd number of points (non-uniform x)."""
    y0, y1, y2 = y[:-2:2], y[1:-1:2], y[2::2]
    x0, x1, x2 = x[:-2:2], x[1:-1:2], x[2::2]
    h0 = x1 - x0
    h1 = x2 - x1
    hsum = h0 + h1
    term = (hsum / 6.0) * (
        (2.0 - h1 / h0) * y0
        + (hsum * hsum / (h0 * h1)) * y1
        + (2.0 - h0 / h1) * y2
    )
    return jnp.sum(term)


@jax.jit
def simpson(y, x) -> jax.Array:
    """Composite Simpson rule (scipy.integrate.simpson parity).

    Odd point counts use pairwise composite Simpson with non-uniform
    spacing. Even point counts apply Cartwright's parabolic correction
    for the final interval, matching modern scipy's default.
    """
    y = jnp.asarray(y)
    x = jnp.asarray(x, dtype=y.dtype)
    n = y.shape[0]
    if n < 3:
        return trapezoid(y, x)
    if n % 2 == 1:
        return _simpson_pairs(y, x)
    main = _simpson_pairs(y[:-1], x[:-1])
    h0 = x[-2] - x[-3]
    h1 = x[-1] - x[-2]
    alpha = (2.0 * h1 * h1 + 3.0 * h0 * h1) / (6.0 * (h0 + h1))
    beta = (h1 * h1 + 3.0 * h0 * h1) / (6.0 * h0)
    eta = h1 ** 3 / (6.0 * h0 * (h0 + h1))
    return main + alpha * y[-1] + beta * y[-2] - eta * y[-3]


@jax.jit
def polyfit_linear(x, y):
    """Degree-1 least-squares fit → (slope, intercept)
    (np.polyfit(x, y, 1) parity; reference viscosity.py:240-245).

    Dtype: follows the *floating* dtype of the inputs; pure-integer
    inputs promote to float64. (The old ``result_type(x, float32)``
    was a bug: jax promotes int64 + float32 → float32, so integer
    lagtimes silently ran the whole fit in f32 — a ~1e-5 relative
    error on the fitted viscosity.)
    """
    dtype = jnp.result_type(jnp.asarray(x).dtype, jnp.asarray(y).dtype)
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.float64
    x = jnp.asarray(x, dtype=dtype)
    y = jnp.asarray(y, dtype=dtype)
    xm = jnp.mean(x)
    ym = jnp.mean(y)
    dx = x - xm
    slope = jnp.sum(dx * (y - ym)) / jnp.sum(dx * dx)
    return slope, ym - slope * xm
