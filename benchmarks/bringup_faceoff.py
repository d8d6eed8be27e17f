"""Bring-up face-offs on one GPU at the chip_smoke shapes (3,680 atoms ×
10,000 frames, d = 3, float64), each timed in this one process:

* ``fft``       the float64 correlation: native ``jnp.fft`` (cuFFT,
                ops.acf.raw_autocorr_sumlast) against the dense matmul
                DFT (ops.fft.raw_autocorr_matmul, float64 GEMMs);
* ``prefix``    the Einstein prefix sum on (N, P): ``jnp.cumsum``
                against a triangular-GEMM blocked prefix, both checked
                against ``np.cumsum`` (1e-12 relative);
* ``windowed``  the exact windowed VACF loop (ops.acf.acf_windowed,
                max_lag=1000): bytes it must move against the HBM bound;
* ``kneller``   the Kneller assembly (ops.einstein._assemble): bytes
                against the HBM bound;
* ``copy``      a large device copy, the reachable bandwidth;
* ``memory``    compiled memory of the VACF and Helfand steps at the
                four-card comparison size on one card.

Prints one JSON line per face-off, then the card's name and power
limit. Exits non-zero without a GPU.

Usage: python benchmarks/bringup_faceoff.py [--frames N] [--atoms P]
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import transport_analysis_tpu  # noqa: E402,F401  (float64 on)
from transport_analysis_tpu.ops import acf, einstein  # noqa: E402
from transport_analysis_tpu.ops.fft import raw_autocorr_matmul  # noqa: E402
from transport_analysis_tpu.utils.runtime import (  # noqa: E402
    enable_compile_cache, gpu_name_and_power_limit, require_gpu,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def timeit(fn, *args, reps=5):
    """(median, first) wall of fn(*args) ending in block_until_ready."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), first, walls


def prefix_sum_tri(x, b=128):
    """Inclusive prefix along axis 0 as one lower-triangular GEMM per
    b-row block plus a recursive combine of the block totals."""
    n, p = x.shape
    n_blocks = -(-n // b)
    blocks = jnp.pad(x, ((0, n_blocks * b - n), (0, 0))).reshape(
        n_blocks, b, p)
    tri = jnp.tril(jnp.ones((b, b), x.dtype))
    intra = jnp.einsum("lk,bkp->blp", tri, blocks,
                       precision=jax.lax.Precision.HIGHEST)
    totals = intra[:, -1, :]
    csum = (prefix_sum_tri(totals, b) if n_blocks > b
            else jnp.cumsum(totals, axis=0))
    out = intra + (csum - totals)[:, None, :]
    return out.reshape(n_blocks * b, p)[:n]


def rel(got, want):
    got = np.asarray(got)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def faceoff_fft(x):
    n, p, d = x.shape
    m = 2 * acf.next_pow_2(n)
    native = jax.jit(acf.raw_autocorr_sumlast)

    @jax.jit
    def matmul(v):
        flat = jnp.pad(v.reshape(n, p * d), ((0, m - n), (0, 0)))
        return raw_autocorr_matmul(flat, n).reshape(n, p, d).sum(-1)

    t_nat, c_nat, _ = timeit(native, x)
    t_mm, c_mm, _ = timeit(matmul, x, reps=3)
    ref = np.asarray(native(x))
    return {
        "faceoff": "fft", "shape": [n, p, d],
        "jnp_fft_s": t_nat, "jnp_fft_first_s": c_nat,
        "matmul_dft_s": t_mm, "matmul_dft_first_s": c_mm,
        "matmul_vs_fft_rel": rel(matmul(x), ref),
        "faster": "jnp_fft" if t_nat < t_mm else "matmul_dft",
    }


def faceoff_prefix(sq):
    want = np.cumsum(np.asarray(sq), axis=0)
    cum = jax.jit(lambda v: jnp.cumsum(v, axis=0))
    tri = jax.jit(prefix_sum_tri)
    t_cum, _, _ = timeit(cum, sq)
    t_tri, _, _ = timeit(tri, sq)
    nbytes = 2 * sq.size * 8
    return {
        "faceoff": "prefix", "shape": list(sq.shape),
        "cumsum_s": t_cum, "tri_gemm_s": t_tri,
        "cumsum_rel_err": rel(cum(sq), want),
        "tri_gemm_rel_err": rel(tri(sq), want),
        "min_bytes": nbytes,
        "hbm_bound_s": nbytes / HBM_BYTES_PER_S,
        "faster": "cumsum" if t_cum < t_tri else "tri_gemm",
    }


def faceoff_windowed(x, max_lag):
    n, p, d = x.shape
    fn = jax.jit(lambda v: acf._acf_windowed_impl(v, max_lag))
    t, first, _ = timeit(fn, x, reps=3)
    # each lag reads the (N, P, d) series at least twice (x[i] and
    # x[i+lag]) when nothing is reused across lags
    two_reads = 2.0 * x.size * 8 * max_lag
    one_read = x.size * 8.0 * max_lag
    flops = 2.0 * n * p * d * max_lag
    return {
        "faceoff": "windowed", "shape": [n, p, d], "max_lag": max_lag,
        "wall_s": t, "first_s": first,
        "bytes_two_reads_per_lag": two_reads,
        "achieved_bytes_per_s_two_reads": two_reads / t,
        "hbm_bound_two_reads_s": two_reads / HBM_BYTES_PER_S,
        "hbm_bound_one_read_s": one_read / HBM_BYTES_PER_S,
        "share_of_hbm_bound_two_reads": two_reads / HBM_BYTES_PER_S / t,
        "flops": flops,
    }


def faceoff_kneller(sq, corr, d):
    fn = jax.jit(lambda s, c: einstein._assemble(s, c, "mean", d))
    t, first, _ = timeit(fn, sq, corr)
    nbytes = 3.0 * sq.size * 8  # read sq, corr; write the result
    return {
        "faceoff": "kneller", "shape": list(sq.shape), "wall_s": t,
        "first_s": first, "min_bytes": nbytes,
        "hbm_bound_s": nbytes / HBM_BYTES_PER_S,
        "share_of_hbm_bound": nbytes / HBM_BYTES_PER_S / t,
    }


def copy_bandwidth(n_bytes=4 * 2 ** 30):
    x = jnp.ones((n_bytes // 8,), jnp.float64)
    fn = jax.jit(lambda v: v * 1.0000001)
    t, _, _ = timeit(fn, x)
    return {"faceoff": "copy", "bytes": 2 * n_bytes, "wall_s": t,
            "bytes_per_s": 2 * n_bytes / t}


def memory_at(n_frames, n_atoms):
    spec = jax.ShapeDtypeStruct((n_frames, n_atoms, 3), jnp.float32)
    out = {"faceoff": "memory", "shape": [n_frames, n_atoms, 3],
           "model_peak_bytes": acf.fft_peak_bytes(n_frames, n_atoms, 3, 4)}
    for name, fn in (("vacf", acf._acf_fft_upcast),
                     ("helfand", lambda a: einstein._einstein_fft_upcast(
                         a, "mean"))):
        ma = jax.jit(fn).lower(spec).compile().memory_analysis()
        out[name] = {
            k: int(getattr(ma, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "alias_size_in_bytes")
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10000)
    ap.add_argument("--atoms", type=int, default=3680)
    ap.add_argument("--max-lag", type=int, default=1000)
    args = ap.parse_args()
    device = require_gpu()
    enable_compile_cache()

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.normal(0, 5, (args.frames, args.atoms, 3)))
    sq = jnp.sum(x * x, axis=-1)
    corr = acf.raw_autocorr_sumlast(x)
    for rec in (faceoff_fft(x), faceoff_prefix(sq),
                faceoff_windowed(x, args.max_lag),
                faceoff_kneller(sq, corr, 3), copy_bandwidth(),
                memory_at(16384, 16384), memory_at(16384, 8192)):
        rec["device"] = device
        print(json.dumps(rec), flush=True)
    print(f"gpu: {gpu_name_and_power_limit()}")


if __name__ == "__main__":
    main()
