"""Frame-axis-sharded four-step FFT (sequence-parallel spectral path).

The FFT path's frame axis is this framework's "sequence" (SURVEY.md
§5); at the 1M-frame north star it cannot live on one chip. This
module distributes the matmul-decomposition FFT (ops/fft.py) over a
mesh axis with the Bailey four-step factorization N = N1·N2, N1 sharded:

forward (input natural order, frame-block sharded: device d holds
rows j = j1·N2 + j2 for its j1 block):
  1. DFT over j1 — the only *distributed* contraction: each device
     multiplies the full (N1, N1) DFT matrix's columns for its local
     j1 block against its rows, then a single ``psum_scatter`` over
     the mesh axis both reduces and re-shards the result by k1 block.
     Communication = one reduce-scatter of (N1, N2·B) per transform;
     there is no all-to-all of raw frames.
  2. twiddle W_N^{k1·j2} — elementwise, local (k1 rows are local).
  3. DFT over j2 — fully local recursive matmul FFT (no comm).

The output stays in "transposed" order — device d holds (k1_local,
k2) — which costs nothing for autocorrelation: the power spectrum is
elementwise, and the inverse transform consumes exactly that layout
(steps run mirrored: local DFT over k2, twiddle, distributed DFT over
k1 with a closing reduce-scatter back to natural frame-block order).

Unlike the single-chip path (ops/fft.py two-for-one packing), the
sharded autocorrelation transforms each real series as a full complex
FFT: Hermitian-symmetry unpacking needs an index reversal across the
sharded k1 axis (communication), whereas |Z|² is purely elementwise.
The 2× transform count is the price of zero extra collectives.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..ops import fft as fft_mod
from ..ops.acf import next_pow_2


def _phase_rows(rows, n_cols: int, period: int, sign: float, dtype):
    """(cos, sin) of e^{sign·2πi·(r·c mod period)/period} for traced
    global row indices ``rows`` — the sharded twin of
    ops/fft.py:_phase_tables (same integer-mod reduction, so large
    global indices carry no large-angle rounding)."""
    c = jnp.arange(n_cols, dtype=jnp.int64)[None, :]
    m = (rows.astype(jnp.int64)[:, None] * c) % period
    theta = (2.0 * np.pi / period) * m.astype(dtype)
    sin_sign = jnp.asarray(np.sign(sign), dtype=dtype)
    return jnp.cos(theta), sin_sign * jnp.sin(theta)


def _reduce_scatter(x, axis: str, n_dev: int):
    """Sum ``x`` (rows, cols) over the mesh axis, returning this
    device's row block (rows/n_dev, cols)."""
    if n_dev == 1:
        return x
    return jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)


def _forward_local(re_l, im_l, n1: int, n_dev: int, axis: str):
    """Per-device forward four-step. Input: natural-order local rows
    (M/D, B); output: transposed-order local rows (k1_loc·N2 + k2)."""
    d = jax.lax.axis_index(axis)
    rows_l, b = re_l.shape
    n1_loc = n1 // n_dev
    n2 = rows_l // n1_loc
    dtype = re_l.dtype

    # step 1: distributed DFT over j1. C[:, j1_block] is the transpose
    # of C[j1_block, :] (the DFT matrix is symmetric).
    j1 = d * n1_loc + jnp.arange(n1_loc, dtype=jnp.int64)
    cc, cs = _phase_rows(j1, n1, n1, -1.0, dtype)  # (n1_loc, n1)
    pr, pi = fft_mod.complex_matmul(
        cc.T, cs.T,
        re_l.reshape(n1_loc, n2 * b),
        im_l.reshape(n1_loc, n2 * b),
    )  # (n1, n2·b) partial sums
    kr = _reduce_scatter(pr, axis, n_dev)
    ki = _reduce_scatter(pi, axis, n_dev)

    # step 2: twiddle W_N^{k1·j2} on the local k1 block
    k1 = d * n1_loc + jnp.arange(n1_loc, dtype=jnp.int64)
    tc, ts = _phase_rows(k1, n2, n1 * n2, -1.0, dtype)  # (n1_loc, n2)
    kr = kr.reshape(n1_loc, n2, b)
    ki = ki.reshape(n1_loc, n2, b)
    yr = kr * tc[:, :, None] - ki * ts[:, :, None]
    yi = kr * ts[:, :, None] + ki * tc[:, :, None]

    # step 3: local DFT over j2
    yr = jnp.moveaxis(yr, 1, 0).reshape(n2, n1_loc * b)
    yi = jnp.moveaxis(yi, 1, 0).reshape(n2, n1_loc * b)
    zr, zi = fft_mod._fft_recursive(yr, yi, -1.0)  # k2 on axis 0
    zr = jnp.moveaxis(zr.reshape(n2, n1_loc, b), 1, 0)
    zi = jnp.moveaxis(zi.reshape(n2, n1_loc, b), 1, 0)
    return zr.reshape(rows_l, b), zi.reshape(rows_l, b)


def _inverse_local(zr_l, zi_l, n1: int, n_dev: int, axis: str):
    """Per-device inverse four-step consuming transposed order,
    producing natural frame-block order (includes the 1/N scale)."""
    d = jax.lax.axis_index(axis)
    rows_l, b = zr_l.shape
    n1_loc = n1 // n_dev
    n2 = rows_l // n1_loc
    m_total = n1 * n2
    dtype = zr_l.dtype

    # step 1': local inverse DFT over k2
    ar = jnp.moveaxis(zr_l.reshape(n1_loc, n2, b), 1, 0)
    ai = jnp.moveaxis(zi_l.reshape(n1_loc, n2, b), 1, 0)
    br, bi = fft_mod._fft_recursive(
        ar.reshape(n2, n1_loc * b), ai.reshape(n2, n1_loc * b), 1.0
    )  # j2 on axis 0
    br = jnp.moveaxis(br.reshape(n2, n1_loc, b), 1, 0)  # (n1_loc, n2, b)
    bi = jnp.moveaxis(bi.reshape(n2, n1_loc, b), 1, 0)

    # step 2': twiddle W_N^{+k1·j2} on the local k1 block
    k1 = d * n1_loc + jnp.arange(n1_loc, dtype=jnp.int64)
    tc, ts = _phase_rows(k1, n2, m_total, 1.0, dtype)
    cr = br * tc[:, :, None] - bi * ts[:, :, None]
    ci = br * ts[:, :, None] + bi * tc[:, :, None]

    # step 3': distributed inverse DFT over k1, reduce-scatter to j1
    cc, cs = _phase_rows(k1, n1, n1, 1.0, dtype)  # rows k1 of C⁺
    pr, pi = fft_mod.complex_matmul(
        cc.T, cs.T,
        cr.reshape(n1_loc, n2 * b),
        ci.reshape(n1_loc, n2 * b),
    )
    xr = _reduce_scatter(pr, axis, n_dev)
    xi = _reduce_scatter(pi, axis, n_dev)
    scale = jnp.asarray(1.0 / m_total, dtype)
    return (
        (xr * scale).reshape(rows_l, b),
        (xi * scale).reshape(rows_l, b),
    )


def _pick_n1(m: int, n_dev: int) -> int:
    """N1 must be a power of two, a multiple of the device count, and
    divide M; 128 when M is large enough."""
    n1 = max(n_dev, min(128, m // n_dev))
    if m % n1 or n1 % n_dev:
        raise ValueError(
            f"cannot factor M={m} over {n_dev} devices (need pow2 M, "
            f"pow2 device count, M ≥ devices²)"
        )
    return n1


def sharded_fft(re, im, mesh: Mesh, axis_name: str = "frames",
                inverse: bool = False, transposed_output: bool = True):
    """Distributed complex FFT along axis 0 of global (M, B) arrays.

    Forward maps natural order → transposed (k1-major) order; inverse
    maps transposed → natural. Round-tripping forward + inverse
    returns the original natural-order array (this is how the
    autocorrelation uses it — elementwise ops in between are layout-
    blind). ``transposed_output`` is part of the contract, not an
    optimization flag; it exists so callers document which layout they
    hold.
    """
    if not transposed_output:
        raise NotImplementedError(
            "natural-order spectral output needs a k1 all-to-all; "
            "autocorrelation never materializes it"
        )
    n_dev = mesh.shape[axis_name]
    m = re.shape[0]
    n1 = _pick_n1(m, n_dev)
    fn = _jitted_fft(mesh, axis_name, n1, n_dev, bool(inverse))
    return fn(_place(re, mesh, axis_name), _place(im, mesh, axis_name))


def _place(x, mesh: Mesh, axis_name: str):
    """Row-shard ``x`` over the mesh axis straight from the host (each
    device receives only its block)."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name, None)))


@lru_cache(maxsize=64)
def _jitted_fft(mesh: Mesh, axis_name: str, n1: int, n_dev: int,
                inverse: bool):
    """Cached jitted transform per (mesh, axis, n1, direction) — a
    fresh shard_map closure per call would retrace and recompile the
    identical program every time (vacf_out_of_core_sharded calls once
    per atom chunk)."""
    body = _inverse_local if inverse else _forward_local
    return jax.jit(shard_map(
        partial(body, n1=n1, n_dev=n_dev, axis=axis_name),
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=(P(axis_name, None), P(axis_name, None)),
    ))


@lru_cache(maxsize=64)
def _jitted_autocorr(mesh: Mesh, axis_name: str, n1: int, n_dev: int):
    return jax.jit(shard_map(
        partial(_autocorr_local, n1=n1, n_dev=n_dev, axis=axis_name),
        mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=P(axis_name, None),
    ))


def _autocorr_local(x_l, n1: int, n_dev: int, axis: str):
    """fwd FFT → power spectrum → inv FFT, all on local shards."""
    zr, zi = _forward_local(x_l, jnp.zeros_like(x_l), n1, n_dev, axis)
    power = zr * zr + zi * zi
    gr, _ = _inverse_local(power, jnp.zeros_like(power), n1, n_dev, axis)
    return gr


def sharded_raw_autocorr(x, mesh: Mesh, axis_name: str = "frames"):
    """Raw linear autocorrelation per column of global (M, S) real
    input (already zero-padded to M ≥ 2·series_length, M a power of
    two), frame-sharded over ``axis_name``. Returns the full (M, S)
    circular result in natural order (callers slice [:n_out])."""
    n_dev = mesh.shape[axis_name]
    m = x.shape[0]
    n1 = _pick_n1(m, n_dev)
    fn = _jitted_autocorr(mesh, axis_name, n1, n_dev)
    return fn(_place(x, mesh, axis_name))


def sharded_acf_fft(x, mesh: Mesh, axis_name: str = "frames"):
    """Frame-sharded batched VACF: (N, P, d) → (N, P), matching
    ops.acf_fft (reference velocityautocorr.py:208-215 semantics) with
    the frame axis distributed over the mesh."""
    x = np.asarray(x)
    n, p, d = x.shape
    m = 2 * next_pow_2(n)
    xp = np.zeros((m, p * d), x.dtype)
    xp[:n] = x.reshape(n, p * d)
    raw = np.asarray(sharded_raw_autocorr(xp, mesh, axis_name))[:n]
    raw = raw.reshape(n, p, d).sum(axis=-1)
    return raw / (n - np.arange(n))[:, None]


def sharded_msd_fft(a, mesh: Mesh, axis_name: str = "frames",
                    reduce_mode: str = "sum"):
    """Frame-sharded Einstein lag-difference curve: (N, P, d) → (N, P).

    Same identity as ops.einstein_difference_fft — centered series,
    S_head + S_tail − 2·corr — with the correlation term computed by
    the distributed FFT and the prefix sums done on host (O(N·P),
    negligible next to the transform).
    """
    a = np.asarray(a, np.float64)
    n, p, d = a.shape
    a = a - a.mean(axis=0, keepdims=True)

    m = 2 * next_pow_2(n)
    ap = np.zeros((m, p * d), a.dtype)
    ap[:n] = a.reshape(n, p * d)
    corr = np.asarray(sharded_raw_autocorr(ap, mesh, axis_name))[:n]
    corr = corr.reshape(n, p, d).sum(axis=-1)

    sq = np.sum(a * a, axis=-1)
    css = np.cumsum(sq, axis=0)
    total = css[-1]
    lags = np.arange(n)
    s_head = css[n - 1 - lags]
    css_prev = np.concatenate([np.zeros((1, p)), css[:-1]], axis=0)
    s_tail = total[None, :] - css_prev
    raw = s_head + s_tail - 2.0 * corr
    out = raw / (n - lags)[:, None]
    if reduce_mode == "mean":
        out = out / d
    out[0] = 0.0
    return out
