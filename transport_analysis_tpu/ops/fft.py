"""Matmul-decomposition FFT.

This module implements the DFT as a recursion of *dense matrix
multiplies* — the Bailey four-step / Cooley–Tukey factorization:

    DFT_N = (DFT_N2 ⊗ I) · twiddle · (I ⊗ DFT_N1),  N = N1·N2

Each level applies a small (≤256²) DFT matrix to a huge batch with a
single real-matmul triple (large batched GEMMs) followed by an
elementwise twiddle. Complex values are carried as separate (re, im)
real arrays, which keeps everything in plain float32 or float64.

The single-device correlation path uses the native FFT
(``jnp.fft``, ops/acf.py); this decomposition serves the frame-sharded
transform (parallel/sharded_fft.py), whose distributed first level is
a matrix product over the sharded axis.

Real-input autocorrelation uses the classic two-for-one packing: two
real series ride one complex FFT (z = x1 + i·x2), and because power
spectra are real, the inverse transform also carries two results at
once — zero FFT-count overhead versus rfft.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# largest DFT applied as a single dense matmul (cost ∝
# BASE·ceil(log_BASE(M)); 128 beats 256 for every M ≥ 2^14)
_BASE = 128


def _phase_tables(n_rows: int, n_cols: int, period: int, sign: float,
                  dtype):
    """(cos, sin) of e^{sign·2πi·(r·c mod period)/period}, computed on
    device at trace time.

    Embedding these as HLO literals makes programs multi-MB and
    compile-bound; generating them from iotas keeps the HLO tiny. The
    integer ``mod period`` reduction keeps every phase in [0, 2π), so
    the trig arguments carry no large-angle rounding — *better* than
    materializing θ = 2π·r·c/period directly.
    """
    r = jnp.arange(n_rows, dtype=jnp.int64)[:, None]
    c = jnp.arange(n_cols, dtype=jnp.int64)[None, :]
    m = (r * c) % period
    theta = (2.0 * np.pi / period) * m.astype(dtype)
    sin_sign = jnp.asarray(np.sign(sign), dtype=dtype)
    return jnp.cos(theta), sin_sign * jnp.sin(theta)


def complex_matmul(c, s, re, im):
    """(c + i·s) @ (re + i·im) as a Karatsuba/3M complex product (three
    real matmuls instead of four). Precision.HIGHEST keeps float32
    operands out of reduced-precision (TF32) tensor-core modes."""
    hi = jax.lax.Precision.HIGHEST
    p1 = jnp.matmul(c, re, precision=hi)
    p2 = jnp.matmul(s, im, precision=hi)
    p3 = jnp.matmul(c + s, re + im, precision=hi)
    return p1 - p2, p3 - p1 - p2


def _apply_dft(re, im, sign: float):
    """Dense DFT along axis 0 (length ≤ _BASE)."""
    n = re.shape[0]
    c, s = _phase_tables(n, n, n, sign, re.dtype)
    return complex_matmul(c, s, re, im)


def _twiddles(n1: int, n2: int, sign: float, dtype):
    """Twiddle factors W_{n1·n2}^{k1·j2} with shape (n1, n2)."""
    return _phase_tables(n1, n2, n1 * n2, sign, dtype)


def _fft_recursive(re, im, sign: float):
    """Complex DFT along axis 0 of (N, B) re/im arrays. N = 2^k.

    Returns arrays in natural frequency order.
    """
    n = re.shape[0]
    if n <= _BASE:
        return _apply_dft(re, im, sign)

    n1 = _BASE
    n2 = n // n1
    b = re.shape[1]
    # x[j1·n2 + j2] → view (n1, n2·B): DFT over j1 is a strided
    # decimation, i.e. reshape with j1 as the leading axis
    re2 = re.reshape(n1, n2 * b)
    im2 = im.reshape(n1, n2 * b)
    re2, im2 = _apply_dft(re2, im2, sign)  # k1 on axis 0

    # twiddle W^{k1·j2}
    tc, ts = _twiddles(n1, n2, sign, re.dtype)
    tc = tc[:, :, None]
    ts = ts[:, :, None]
    re3 = re2.reshape(n1, n2, b)
    im3 = im2.reshape(n1, n2, b)
    re4 = re3 * tc - im3 * ts
    im4 = re3 * ts + im3 * tc

    # DFT over j2 for each k1: move j2 to the front and recurse
    re5 = jnp.moveaxis(re4, 1, 0).reshape(n2, n1 * b)
    im5 = jnp.moveaxis(im4, 1, 0).reshape(n2, n1 * b)
    re6, im6 = _fft_recursive(re5, im5, sign)  # k2 on axis 0

    # output index k = k2·n1 + k1: (n2, n1·b) flattens to exactly that
    # ordering, so a plain reshape merges the axes correctly
    return re6.reshape(n, b), im6.reshape(n, b)


def matmul_fft(re, im, inverse: bool = False):
    """Complex FFT along axis 0 via matmul decomposition.

    ``re``/``im``: (N, B) with N a power of two. The inverse transform
    includes the 1/N scale.
    """
    sign = 1.0 if inverse else -1.0
    out_re, out_im = _fft_recursive(re, im, sign)
    if inverse:
        out_re = out_re / re.shape[0]
        out_im = out_im / re.shape[0]
    return out_re, out_im


def _reverse_index(z):
    """z[(M - k) % M] along axis 0."""
    return jnp.roll(jnp.flip(z, axis=0), 1, axis=0)


# max complex columns processed per sequential block: bounds live FFT
# intermediates to ~B·M·dtype·(a few buffers) regardless of batch width
_SERIES_BLOCK = 256
# statically unroll the block loop up to this many blocks; beyond it,
# fall back to lax.map to bound program size
_UNROLL_BLOCKS = 16


def _autocorr_packed(re, im, n_out: int):
    """Autocorrelation of 2·B real series packed as B complex columns."""
    zr, zi = matmul_fft(re, im, inverse=False)
    zr_rev = _reverse_index(zr)
    zi_rev = _reverse_index(zi)

    # F1 = (Z + conj(Z_rev))/2 ; F2 = (Z - conj(Z_rev))/(2i)
    f1r = 0.5 * (zr + zr_rev)
    f1i = 0.5 * (zi - zi_rev)
    f2r = 0.5 * (zi + zi_rev)
    f2i = 0.5 * (zr_rev - zr)

    s1 = f1r * f1r + f1i * f1i  # |F1|² (real, symmetric)
    s2 = f2r * f2r + f2i * f2i

    # inverse transform of (s1 + i·s2): real part → acf1, imag → acf2
    gr, gi = matmul_fft(s1, s2, inverse=True)
    return gr[:n_out], gi[:n_out]


@partial(jax.jit, static_argnames=("n_out",))
def raw_autocorr_matmul(x, n_out: int):
    """Raw (unnormalized) linear autocorrelation per column.

    ``x``: (M, S) real, already zero-padded to M ≥ 2·series_length with
    M a power of two. Returns (n_out, S) with
    out[lag, s] = Σ_i x[i, s]·x[i+lag, s].

    Packs column pairs into complex FFTs (two real series per
    transform, recovered via Hermitian symmetry), so the FFT count is
    the same as a native rfft implementation. Wide batches run as
    sequential column blocks to bound device-resident intermediates.
    """
    m, s = x.shape
    half = (s + 1) // 2
    if half <= _SERIES_BLOCK:
        n_blocks = 1
        half_padded = half
    else:
        n_blocks = -(-half // _SERIES_BLOCK)
        half_padded = n_blocks * _SERIES_BLOCK
    # pad so re/im halves split evenly into blocks
    x = jnp.pad(x, ((0, 0), (0, 2 * half_padded - s)))
    re = x[:, :half_padded]
    im = x[:, half_padded:]

    if n_blocks == 1:
        gr, gi = _autocorr_packed(re, im, n_out)
    elif n_blocks <= _UNROLL_BLOCKS:
        # static unroll; the _UNROLL_BLOCKS cap only guards program
        # size
        B = _SERIES_BLOCK
        parts = [
            _autocorr_packed(
                re[:, b * B:(b + 1) * B], im[:, b * B:(b + 1) * B],
                n_out,
            )
            for b in range(n_blocks)
        ]
        gr = jnp.concatenate([p[0] for p in parts], axis=1)
        gi = jnp.concatenate([p[1] for p in parts], axis=1)
    else:
        re_blocks = jnp.moveaxis(
            re.reshape(m, n_blocks, _SERIES_BLOCK), 1, 0
        )
        im_blocks = jnp.moveaxis(
            im.reshape(m, n_blocks, _SERIES_BLOCK), 1, 0
        )
        gr, gi = jax.lax.map(
            lambda ab: _autocorr_packed(ab[0], ab[1], n_out),
            (re_blocks, im_blocks),
        )
        gr = jnp.moveaxis(gr, 0, 1).reshape(n_out, half_padded)
        gi = jnp.moveaxis(gi, 0, 1).reshape(n_out, half_padded)
    out = jnp.concatenate([gr, gi], axis=1)
    return out[:, :s]
