"""Benchmark: fused VACF + Einstein-Helfand viscosity throughput on one GPU.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {"platform", "kind", "count"}}

The reported value is the geometric mean of two rungs, so it moves when
either the short-series or the long-series path does:

* short rung — BASELINE.json configs #2/#3: per-particle VACF via FFT
  autocorrelation + Green-Kubo diffusivity, and the Helfand viscosity
  function + linear-fit slope, on an (N_FRAMES, N_ATOMS, 3) float64
  velocity/position block resident on the device, as one jitted step
  through the public ops (``acf_fft``, ``einstein_difference_fft``).
* long rung — ``ops.acf_fft`` at N=131072 frames, P=16, float64.

Metric: effective atom-frame-lags per second — each analysis produces
Sum_lag (N - lag) = N(N+1)/2 lag-window reductions per atom (the work
unit of the reference's windowed algorithm; the FFT path produces
identical output in O(N log N)).

Timing: median wall over REPS calls, each ending in
``block_until_ready``, after one warm-up call that compiles.

Baseline: the reference's own algorithm structure on this host —
tidynamics-style FFT autocorrelation called serially per particle
(reference velocityautocorr.py:210-213) plus (short rung only) the
O(N^2) windowed numpy Helfand lag loop (viscosity.py:210-226), the only
viscosity algorithm the reference has. The Helfand baseline is timed
on a lag subsample and extrapolated by measured per-element throughput
(a full run would take hours). vs_baseline = geometric mean of the
per-rung speedups.

Env overrides: BENCH_FRAMES, BENCH_ATOMS, BENCH_DTYPE (float32|float64),
BENCH_SKIP_LONG=1 (short rung only). Exits non-zero without a GPU.
"""

import json
import os
import statistics
import time

import numpy as np

import jax
import jax.numpy as jnp

import transport_analysis_tpu  # noqa: F401  (x64 on)
from transport_analysis_tpu import ops
from transport_analysis_tpu.ops.acf import acf_fft_numpy
from transport_analysis_tpu.utils.runtime import (
    enable_compile_cache, require_gpu,
)
from transport_analysis_tpu.utils.units import constants

N_FRAMES = int(os.environ.get("BENCH_FRAMES", 8192))
N_ATOMS = int(os.environ.get("BENCH_ATOMS", 512))
DTYPE = np.dtype(os.environ.get("BENCH_DTYPE", "float64"))
REPS = 5
KB = constants["Boltzmann_constant"]
TEMP = 300.0
VOL = 8000.0


def make_data(n_frames, n_atoms, dtype):
    rng = np.random.RandomState(0)
    vel = rng.normal(0, 5, (n_frames, n_atoms, 3)).astype(dtype)
    pos = np.cumsum(vel, axis=0) * 0.002 + rng.uniform(
        0, 20, (1, n_atoms, 3)
    ).astype(dtype)
    masses = rng.uniform(1, 16, n_atoms).astype(dtype)
    times = np.arange(n_frames, dtype=np.float64) * 0.002
    return vel, pos, masses, times


@jax.jit
def analysis_step(vel, pos, masses, times):
    """VACF + GK diffusivity + Helfand function + slope, one program."""
    n = vel.shape[0]
    vacf_ts = ops.acf_fft(vel).mean(axis=1)
    diffusivity = ops.trapezoid(vacf_ts, times) / 3.0
    accum = masses[None, :, None] * vel * pos
    visc_ts = ops.einstein_difference_fft(accum, "mean").mean(axis=1) / (
        2.0 * KB * VOL * TEMP)
    lags = jnp.arange(1, n, dtype=visc_ts.dtype)
    w = slice(n // 8, n // 2)
    slope, _ = ops.polyfit_linear(lags[w], visc_ts[w])
    return vacf_ts, diffusivity, visc_ts, slope


def median_wall(fn, *args):
    out = jax.block_until_ready(fn(*args))  # compile + warm
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), out


def baseline_pipeline(vel, pos, masses, times):
    """Reference-structured host implementation, partially extrapolated."""
    n, p, d = vel.shape
    vel64 = vel.astype(np.float64)
    pos64 = pos.astype(np.float64)

    # VACF: FFT autocorrelation per particle, serial Python loop
    t0 = time.perf_counter()
    vacf_bp = np.zeros((n, p))
    for i in range(p):
        # tidynamics.acf semantics: components summed per particle
        vacf_bp[:, i] = acf_fft_numpy(vel64[:, i, :]).sum(axis=1)
    vacf_ts = vacf_bp.mean(axis=1)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    trapezoid(vacf_ts, times)
    vacf_time = time.perf_counter() - t0

    # Helfand: windowed numpy lag loop, timed on a subsample of lags
    accum = masses[None, :, None].astype(np.float64) * vel64 * pos64
    k = min(64, n - 1)
    t0 = time.perf_counter()
    visc = np.zeros((n, p))
    for lag in range(1, k + 1):
        diff = accum[:-lag] - accum[lag:]
        visc[lag] = np.square(diff).mean(axis=-1).mean(axis=0)
    sub_time = time.perf_counter() - t0
    sub_elements = sum((n - lag) * p * d for lag in range(1, k + 1))
    total_elements = (n * (n - 1) // 2) * p * d
    helfand_time = sub_time * total_elements / sub_elements

    return vacf_time + helfand_time, vacf_ts


LONG_FRAMES, LONG_ATOMS = 131072, 16


def long_rung():
    """ops.acf_fft at a long series vs the reference-structured serial
    per-particle host FFT loop. Returns (lags_per_s,
    baseline_lags_per_s, rel_err)."""
    n, p = LONG_FRAMES, LONG_ATOMS
    rng = np.random.RandomState(7)
    x = rng.normal(0, 5, (n, p, 3))
    xd = jax.device_put(x)
    wall, got = median_wall(ops.acf_fft, xd)

    t0 = time.perf_counter()
    ref_bp = np.empty((n, p))
    for i in range(p):
        ref_bp[:, i] = acf_fft_numpy(x[:, i, :]).sum(axis=1)
    base_wall = time.perf_counter() - t0

    rel_err = float(np.max(np.abs(np.asarray(got) - ref_bp))
                    / np.abs(ref_bp).max())
    lag_work = (n * (n + 1) // 2) * p
    return lag_work / wall, lag_work / base_wall, rel_err


def main():
    device = require_gpu()
    enable_compile_cache()
    vel, pos, masses, times = make_data(N_FRAMES, N_ATOMS, DTYPE)
    args = tuple(jax.device_put(a) for a in (vel, pos, masses, times))
    wall, out = median_wall(analysis_step, *args)
    base_wall, base_vacf = baseline_pipeline(vel, pos, masses, times)

    # accuracy cross-check against the host float64 reference
    ours = np.asarray(out[0])
    rel_err = float(np.max(np.abs(ours - base_vacf))
                    / np.max(np.abs(base_vacf)))

    lag_work = 2 * (N_FRAMES * (N_FRAMES + 1) // 2) * N_ATOMS
    short_rate = lag_work / wall
    short_base = lag_work / base_wall

    if os.environ.get("BENCH_SKIP_LONG"):
        value, baseline_value = short_rate, short_base
        long_note = "long rung skipped"
    else:
        long_rate, long_base, long_err = long_rung()
        rel_err = max(rel_err, long_err)
        value = float(np.sqrt(short_rate * long_rate))
        baseline_value = float(np.sqrt(short_base * long_base))
        long_note = f"N={LONG_FRAMES} P={LONG_ATOMS}: {long_rate:.3e}"

    print(json.dumps({
        "metric": (
            f"VACF+Helfand atom-frame-lags/s, geomean of short rung "
            f"(N={N_FRAMES}, P={N_ATOMS}, d=3, {DTYPE.name}: "
            f"{short_rate:.3e}) and long rung ({long_note}), "
            f"max_rel_err_vs_f64_host={rel_err:.2e}"
        ),
        "value": value,
        "unit": "atom-frame-lags/s",
        "vs_baseline": value / baseline_value,
        "device": device,
    }))


if __name__ == "__main__":
    main()
